"""The port's compression example against the JAX package's example's
calls on the CPU: SQ-int8 and LeanVec (``tests/
test_torch_examples_compression.py`` holds f32 and LVQ-8).
"""

import torch

from scalablevectorsearch_tpu.core.recall import k_recall_at_n
from scalablevectorsearch_tpu.index.flat import exhaustive_search as jexh
from scalablevectorsearch_tpu.index.vamana.params import (
    VamanaBuildParameters as JParams)
from scalablevectorsearch_tpu.orchestrators.vamana import Vamana as JVamana
from scalablevectorsearch_tpu.quantization.leanvec import (
    LeanVecVamana as JLeanVecVamana)
from scalablevectorsearch_tpu.quantization.scalar import SQDataset as JSQ

from scalablevectorsearch_tpu_torch.examples import example_compression

torch.set_num_threads(1)

COMPRESSION = dict(n=600, n_queries=40)


def test_compression_example_sq_and_leanvec_match_jax():
    """SQ-int8 recall@10 at window 40 within 0.02 of the JAX package's (its
    build agrees with JAX's on 93% of rows: exact ties, ROADMAP queue 3);
    LeanVec 128 -> 64 with the rerank of 3 within 0.01."""
    out = example_compression.run("cpu", **COMPRESSION)
    data, queries = example_compression.anisotropic_data(**COMPRESSION)
    gt = jexh(data, queries, 10)
    params = JParams(graph_max_degree=32, window_size=64)
    for key, index, tol in (
            ("sq_int8", JVamana.build(params, JSQ.compress(data), "l2"), 0.02),
            ("leanvec", JLeanVecVamana.build(params, data, "l2",
                                             target_dim=64,
                                             rerank_multiplier=3), 0.01)):
        index.search_window_size = 40
        assert abs(out[key] - k_recall_at_n(
            gt, index.search(queries, 10))) <= tol, key
