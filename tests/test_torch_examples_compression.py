"""The port's compression example (``scalablevectorsearch_tpu_torch/
examples/example_compression.py``) against the JAX package's example's
calls on the CPU, as ``tests/test_torch_examples.py`` says: the f32 and
LVQ-8 indexes here, SQ-int8 and LeanVec in
``tests/test_torch_examples_compression_sq_leanvec.py`` (one file with
all four JAX builds takes more than 90 s on one core).
"""

import torch

from scalablevectorsearch_tpu.core.recall import k_recall_at_n
from scalablevectorsearch_tpu.index.flat import exhaustive_search as jexh
from scalablevectorsearch_tpu.index.vamana.params import (
    VamanaBuildParameters as JParams)
from scalablevectorsearch_tpu.orchestrators.vamana import Vamana as JVamana
from scalablevectorsearch_tpu.quantization.lvq import LVQDataset as JLVQ

from scalablevectorsearch_tpu_torch.examples import example_compression

torch.set_num_threads(1)

COMPRESSION = dict(n=600, n_queries=40)


def test_compression_example_f32_and_lvq8_match_jax():
    """f32 and LVQ-8 recall@10 at window 40 identical to the JAX package's
    indexes over the example's data (the builds equal JAX's adjacency on
    the CPU); the bytes per vector as the JAX example prints them."""
    out = example_compression.run("cpu", **COMPRESSION)
    data, queries = example_compression.anisotropic_data(**COMPRESSION)
    gt = jexh(data, queries, 10)
    params = JParams(graph_max_degree=32, window_size=64)
    for key, dataset in (("float32", data), ("lvq8", JLVQ.compress(data))):
        index = JVamana.build(params, dataset, "l2")
        index.search_window_size = 40
        assert out[key] == k_recall_at_n(gt, index.search(queries, 10)), key
    assert out["bytes_per_vector"] == {"float32": 512, "sq_int8": 128,
                                       "lvq8": 136, "leanvec": 208}
