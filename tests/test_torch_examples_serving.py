"""The port's serving example (``scalablevectorsearch_tpu_torch/examples/
example_serving.py``) against the JAX package's example's calls on the
CPU, as ``tests/test_torch_examples.py`` says.
"""

import torch

from scalablevectorsearch_tpu.core.io import generate_test_dataset as jgen
from scalablevectorsearch_tpu.core.recall import k_recall_at_n
from scalablevectorsearch_tpu.index.flat import exhaustive_search as jexh
from scalablevectorsearch_tpu.index.vamana.params import (
    VamanaBuildParameters as JParams)
from scalablevectorsearch_tpu.orchestrators.vamana import Vamana as JVamana

from scalablevectorsearch_tpu_torch.examples import example_serving

torch.set_num_threads(1)

SERVING = dict(n=1200, n_queries=100, dim=32, reps=2)


def test_serving_example_matches_jax():
    """Recall@10 identical to the JAX package's sampled-entries build with
    packed serving at window 12; the pipelined searches' ids equal the
    blocking search's (the example asserts it); the QPS and latency keys
    present (host times, not compared)."""
    out = example_serving.run("cpu", **SERVING)

    data, queries = jgen(SERVING["n"], SERVING["n_queries"], SERVING["dim"],
                         seed=9)
    gt = jexh(data, queries, 10)
    index = JVamana.build(JParams(alpha=1.1, graph_max_degree=32,
                                  window_size=100,
                                  max_candidate_pool_size=300, prune_to=28),
                          data, "l2", sampled_entries=True)
    index.enable_packed_serving()
    index.search_window_size = 12
    assert out["recall"] == k_recall_at_n(gt, index.search(queries, 10))
    for key in ("qps_blocking", "qps_pipelined", "p50_ms", "p95_ms"):
        assert out[key] > 0, key
    assert out["batch_queries"] == index.index.query_batch_size
