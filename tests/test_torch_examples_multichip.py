"""The port's multi-device example (``scalablevectorsearch_tpu_torch/
examples/example_multichip.py``) over 8 x ``"cpu"`` against the JAX
package's example's calls over the 8 virtual devices of
``tests/conftest.py``, as ``tests/test_torch_examples.py`` says: the four
static parts here, the sharded dynamic index in
``tests/test_torch_examples_multichip_dynamic.py`` (both in one file take
more than 90 s on one core).
"""

import numpy as np
import torch

import jax.numpy as jnp

from scalablevectorsearch_tpu.core.data import VectorDataset as JDataset
from scalablevectorsearch_tpu.core.io import generate_test_dataset as jgen
from scalablevectorsearch_tpu.core.recall import k_recall_at_n
from scalablevectorsearch_tpu.index.flat import exhaustive_search as jexh
from scalablevectorsearch_tpu.index.ivf import kmeans as jkm
from scalablevectorsearch_tpu.index.ivf.index import IVFIndex as JIVF
from scalablevectorsearch_tpu.index.ivf.params import (
    IVFBuildParameters as JIVFParams)
from scalablevectorsearch_tpu.index.vamana.index import VamanaIndex as JIndex
from scalablevectorsearch_tpu.index.vamana.params import (
    VamanaBuildParameters as JParams)
from scalablevectorsearch_tpu.lib.datatypes import pad_matrix as jpad
from scalablevectorsearch_tpu.parallel import mesh as jmesh
from scalablevectorsearch_tpu.parallel import sharded as jsharded
from scalablevectorsearch_tpu.quantization.lvq import LVQDataset as JLVQ

from scalablevectorsearch_tpu_torch.examples import example_multichip
from scalablevectorsearch_tpu_torch.index.ivf import kmeans as tkm

torch.set_num_threads(1)

MULTICHIP = dict(n=2000, n_queries=40, dim=32, num_centroids=16, m=800,
                 n_add=100, n_delete=50)


def jax_init(x, seed, k):
    """The JAX package's k-means++ draws, as the port's seeding."""
    return torch.from_numpy(np.asarray(jkm._kmeanspp_init(
        jnp.asarray(x.numpy()), seed, k)))


def test_multichip_example_matches_jax(monkeypatch):
    """Over 8 shards: the flat search's recall identical to the JAX
    package's sharded flat search; the sharded IVF search (the JAX
    package's k-means++ draws as the port's seeding) within 0.01; the
    query-parallel search and the sharded search over LVQ-8 codes
    identical in recall to the JAX package's over its 8 virtual
    devices."""
    monkeypatch.setattr(tkm, "_kmeanspp_init", jax_init)
    out = example_multichip.run("cpu", **MULTICHIP)
    assert (out["devices"], out["mesh"]) == (8, "8 logical shards of cpu")

    nq = MULTICHIP["n_queries"]
    data, queries = jgen(MULTICHIP["n"], nq, MULTICHIP["dim"], seed=3)
    gt = jexh(data, queries, 10)
    q = jnp.asarray(jpad(queries))
    mesh = jmesh.make_mesh(8, axis_name="shard")
    ds = jsharded.shard_dataset(JDataset.from_array(data), mesh)
    _keys, ids = jsharded.sharded_flat_search(mesh, ds, q, 10, "l2")
    assert out["flat"] == k_recall_at_n(gt.ids, np.asarray(ids)[:nq])

    ivf = JIVF.build(JIVFParams(num_centroids=MULTICHIP["num_centroids"],
                                num_iterations=5, training_fraction=0.5),
                     data, "l2")
    _keys, ids = jsharded.sharded_ivf_search(mesh, ivf, q, 10, n_probes=16)
    assert abs(out["ivf"] - k_recall_at_n(gt.ids,
                                          np.asarray(ids)[:nq])) <= 0.01

    vparams = JParams(graph_max_degree=24, window_size=48)
    v = JIndex.build(vparams, data, "l2")
    entry = jnp.asarray([v.entry_point], jnp.int32)
    search = dict(window=40, capacity=40, max_iters=100, distance="l2")
    res = jsharded.dp_greedy_search(jmesh.make_mesh(8, axis_name="dp"),
                                    v.graph, v.data, q, entry, **search)
    assert out["dp_vamana"] == k_recall_at_n(
        gt.ids, np.asarray(res.ids)[:nq, :10])
    res = jsharded.sharded_greedy_search(
        mesh, v.graph, JLVQ.compress(data, bits=8), q, entry, **search)
    assert out["sharded_lvq8"] == k_recall_at_n(
        gt.ids, np.asarray(res.ids)[:nq, :10])
