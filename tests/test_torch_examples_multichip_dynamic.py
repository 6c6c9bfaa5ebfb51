"""The port's multi-device example's sharded dynamic index over 8 x
``"cpu"`` (``scalablevectorsearch_tpu_torch/examples/example_multichip.py``)
against the port's and the JAX package's single-device indexes, on the
CPU; ``tests/test_torch_examples_multichip.py`` holds the other parts.
"""

import numpy as np
import torch

from scalablevectorsearch_tpu.core.io import generate_test_dataset as jgen
from scalablevectorsearch_tpu.index.flat import exhaustive_search as jexh
from scalablevectorsearch_tpu.index.vamana.dynamic import (
    MutableVamanaIndex as JMutable)
from scalablevectorsearch_tpu.index.vamana.params import (
    VamanaBuildParameters as JParams)

import scalablevectorsearch_tpu_torch as svt
from scalablevectorsearch_tpu_torch.examples import example_multichip

torch.set_num_threads(1)

MULTICHIP = dict(n=2000, n_queries=40, dim=32, num_centroids=16, m=800,
                 n_add=100, n_delete=50)


def test_multichip_sharded_dynamic_matches_one_device():
    """The sharded dynamic index returns the ids of the port's
    single-device index through the same mutations, bit for bit (on the
    CPU both compute the same keys), and its recall is within 0.02 of the
    JAX package's single-device index (consolidate is unstable, ROADMAP
    queue 3).  The JAX package's sharded dynamic index is not run: its
    8-device all-reduce times out on a loaded CPU (ROADMAP queue 3)."""
    out = example_multichip.run("cpu", **MULTICHIP)
    n, nq, m, n_add, n_delete = (MULTICHIP[k] for k in (
        "n", "n_queries", "m", "n_add", "n_delete"))
    data, queries = jgen(n, nq, MULTICHIP["dim"], seed=3)
    vparams = JParams(graph_max_degree=24, window_size=48)
    live = np.concatenate([data[n_delete:m], data[m:m + n_add]])
    live_ext = np.concatenate([np.arange(n_delete, m),
                               np.arange(100_000, 100_000 + n_add)])
    gt_live = jexh(live, queries, 10)
    recalls = []
    for index in (svt.MutableVamanaIndex(
                      svt.VamanaBuildParameters(graph_max_degree=24,
                                                window_size=48),
                      data[:m], np.arange(m), "l2", device="cpu"),
                  JMutable(vparams, data[:m], np.arange(m), "l2")):
        index.add_points(data[m:m + n_add],
                         np.arange(100_000, 100_000 + n_add))
        index.delete_points(np.arange(0, n_delete))
        index.consolidate()
        index.compact()
        res = index.search(queries, 10)
        if isinstance(index, svt.MutableVamanaIndex):
            np.testing.assert_array_equal(out["sharded_dynamic_ids"],
                                          res.ids)
        recalls.append(np.mean([len(set(live_ext[g]) & set(r)) / 10
                                for g, r in zip(gt_live.ids, res.ids)]))
    assert out["sharded_dynamic"] == recalls[0]
    assert abs(out["sharded_dynamic"] - recalls[1]) <= 0.02
