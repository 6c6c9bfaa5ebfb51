"""Ops and containers of the PyTorch port against the JAX package.

Each test feeds the same numpy inputs, made from a seed, to the JAX function
and to its port counterpart on the CPU and compares the outputs.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from scalablevectorsearch_tpu.core import data as jdata
from scalablevectorsearch_tpu.core import graph as jgraph
from scalablevectorsearch_tpu.core import io as jio
from scalablevectorsearch_tpu.core.medioid import compute_medioid as jmedioid
from scalablevectorsearch_tpu.lib import datatypes as jdt
from scalablevectorsearch_tpu.ops import distance as jdist
from scalablevectorsearch_tpu.ops import prune as jprune
from scalablevectorsearch_tpu.ops import topk as jtopk

from scalablevectorsearch_tpu_torch.core import io as tio
from scalablevectorsearch_tpu_torch.core.data import VectorDataset
from scalablevectorsearch_tpu_torch.core.graph import NeighborGraph
from scalablevectorsearch_tpu_torch.core.medioid import compute_medioid
from scalablevectorsearch_tpu_torch.lib import datatypes as tdt
from scalablevectorsearch_tpu_torch.ops import distance as tdist
from scalablevectorsearch_tpu_torch.ops import prune as tprune
from scalablevectorsearch_tpu_torch.ops import topk as ttopk

torch.set_num_threads(1)

METRICS = ["L2", "MIP", "Cosine"]


def T(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("distribution", ["clustered", "uniform", "overlap"])
def test_generate_test_dataset_byte_identical(distribution):
    a = jio.generate_test_dataset(300, 20, 24, seed=5,
                                  distribution=distribution)
    b = tio.generate_test_dataset(300, 20, 24, seed=5,
                                  distribution=distribution)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


def test_vecs_roundtrip(tmp_path):
    x = np.random.default_rng(0).normal(size=(7, 5)).astype(np.float32)
    tio.write_vecs(str(tmp_path / "a.fvecs"), x)
    np.testing.assert_array_equal(jio.read_vecs(str(tmp_path / "a.fvecs")), x)
    np.testing.assert_array_equal(tio.read_vecs(str(tmp_path / "a.fvecs")), x)


def test_padding_rules_and_bf16_view():
    for n in (0, 1, 7, 8, 9, 100, 129):
        assert tdt.padded_dim(n) == jdt.padded_dim(n)
        for name in ("float32", "bfloat16", "int8"):
            assert tdt.padded_count(n, name) == jdt.padded_count(n, name)
    x = np.random.default_rng(1).normal(size=(3, 4)).astype(jnp.bfloat16)
    t = tdt.to_torch(x)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), x.astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vector_dataset_matches_jax(dtype):
    x = np.random.default_rng(2).normal(size=(13, 20)).astype(np.float32)
    j = jdata.VectorDataset.from_array(x, dtype=dtype)
    t = VectorDataset.from_array(x, dtype=dtype, device="cpu")
    assert tuple(t.vectors.shape) == j.vectors.shape
    np.testing.assert_array_equal(
        t.vectors.float().numpy(), np.asarray(j.vectors, np.float32))
    np.testing.assert_allclose(t.norms_sq.numpy(), np.asarray(j.norms_sq),
                               rtol=1e-6)
    assert np.isinf(t.norms_sq.numpy()[13:]).all()
    ids = np.array([[-1, 0, 5], [12, 3, -1]], np.int32)
    # -1 reads row 0, as the JAX clip-mode gather does
    np.testing.assert_array_equal(t.get_f32(T(ids)).numpy(),
                                  np.asarray(j.get_f32(jnp.asarray(ids))))
    np.testing.assert_allclose(t.norms_of(T(ids)).numpy(),
                               np.asarray(j.norms_of(jnp.asarray(ids))),
                               rtol=1e-6)
    np.testing.assert_array_equal(t.to_numpy(),
                                  np.asarray(j.to_numpy(), np.float32))


def test_neighbor_graph_sink_scatters_match_jax():
    rng = np.random.default_rng(3)
    n, r = 21, 6
    adj = np.full((n, r), -1, np.int32)
    for i in range(n):
        deg = rng.integers(0, r + 1)
        adj[i, :deg] = rng.choice(n, deg, replace=False)
    j = jgraph.NeighborGraph.from_array(adj)
    t = NeighborGraph.from_array(adj, device="cpu")
    assert t.capacity == j.capacity
    # replace rows; an id of `capacity` is dropped (sink row)
    ids = np.array([2, 5, j.capacity, 7], np.int32)
    rows = np.full((4, r), -1, np.int32)
    rows[:, :2] = [[1, 3], [4, 0], [9, 9], [8, 2]]
    degs = np.array([2, 2, 2, 2], np.int32)
    j = j.replace_rows(jnp.asarray(ids), jnp.asarray(rows), jnp.asarray(degs))
    t = t.replace_rows(T(ids), T(rows), T(degs))
    np.testing.assert_array_equal(t.adjacency.numpy(), np.asarray(j.adjacency))
    np.testing.assert_array_equal(t.degrees.numpy(), np.asarray(j.degrees))
    # edges at explicit slots; invalid entries are dropped
    dst = np.array([2, 5, 7, 3, 2], np.int32)
    degs_now = t.degrees.numpy()[dst]
    slot = degs_now + np.array([0, 0, 0, 0, 1])
    src = np.array([11, 12, 13, 14, 15], np.int32)
    valid = np.array([True, True, False, slot[3] < r, True])
    j = j.scatter_edges(jnp.asarray(dst), jnp.asarray(slot), jnp.asarray(src),
                        jnp.asarray(valid))
    t = t.scatter_edges(T(dst), T(slot), T(src), T(valid))
    np.testing.assert_array_equal(t.adjacency.numpy(), np.asarray(j.adjacency))
    np.testing.assert_array_equal(t.degrees.numpy(), np.asarray(j.degrees))
    a, dg = t.adjacency.numpy(), t.degrees.numpy()
    for i in range(t.capacity):      # adjacency[i, degrees[i]:] == -1
        assert (a[i, dg[i]:] == -1).all() and (a[i, :dg[i]] >= 0).all()
    assert t.neighbors(T(np.array([-1]))).numpy().tolist() == \
        [a[0].tolist()]
    assert t.mean_degree() == pytest.approx(j.mean_degree())


@pytest.mark.parametrize("metric", METRICS)
def test_distance_keys_match_jax(metric):
    rng = np.random.default_rng(4)
    q = rng.normal(size=(9, 128)).astype(np.float32)
    x = rng.normal(size=(40, 128)).astype(np.float32)
    norms = (x ** 2).sum(-1)
    norms[-3:] = np.inf           # padding rows lose every L2 comparison
    want = jdist.pairwise_keys(metric, jnp.asarray(q), jnp.asarray(x),
                               vector_norms_sq=jnp.asarray(norms))
    got = tdist.pairwise_keys(metric, T(q), T(x), vector_norms_sq=T(norms))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    g = rng.normal(size=(9, 17, 128)).astype(np.float32)
    want = jdist.gathered_keys(metric, jnp.asarray(q), jnp.asarray(g))
    got = tdist.gathered_keys(metric, T(q), T(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    vals = tdist.value_from_key(metric, got)
    np.testing.assert_array_equal(
        vals.numpy(), np.asarray(jdist.value_from_key(metric,
                                                      jnp.asarray(got))))
    assert torch.equal(tdist.key_from_value(metric, vals), got)
    assert tdist.as_distance(metric.lower()) == tdist.DistanceType(metric)


@pytest.mark.parametrize("k", [3, 10, 80])
def test_topk_ops_match_jax(k):
    rng = np.random.default_rng(5)
    keys = rng.normal(size=(6, 120)).astype(np.float32)
    keys[rng.random(keys.shape) < 0.2] = np.inf
    ids = rng.integers(0, 50, size=(6, 120)).astype(np.int32)
    jk, ji = jtopk.smallest_k(jnp.asarray(keys), jnp.asarray(ids), k)
    tk, ti = ttopk.smallest_k(T(keys), T(ids), k)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    jk, ji = jtopk.smallest_k(jnp.asarray(keys), None, k)
    tk, ti = ttopk.smallest_k(T(keys), None, k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    jk, ji = jtopk.merge_smallest(jnp.asarray(keys[:, :60]),
                                  jnp.asarray(ids[:, :60]),
                                  jnp.asarray(keys[:, 60:]),
                                  jnp.asarray(ids[:, 60:]), k)
    tk, ti = ttopk.merge_smallest(T(keys[:, :60]), T(ids[:, :60]),
                                  T(keys[:, 60:]), T(ids[:, 60:]), k)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(
        ttopk.mask_first_duplicates(T(keys), T(ids)).numpy(),
        np.asarray(jtopk.mask_first_duplicates(jnp.asarray(keys),
                                               jnp.asarray(ids))))
    against = ids[:, :k]
    np.testing.assert_array_equal(
        ttopk.mask_duplicate_ids(T(keys), T(ids), T(against)).numpy(),
        np.asarray(jtopk.mask_duplicate_ids(jnp.asarray(keys),
                                            jnp.asarray(ids),
                                            jnp.asarray(against))))


@pytest.mark.parametrize("metric", METRICS)
def test_robust_prune_matches_jax(metric):
    """Identical sorted pools give identical pruned rows for >= 99% of
    nodes (f32 matmuls round differently; near-ties may flip)."""
    data, _ = jio.generate_test_dataset(600, 1, 32, seed=9)
    rng = np.random.default_rng(6)
    b, p, r = 200, 48, 12
    self_ids = rng.choice(600, b, replace=False).astype(np.int32)
    pool_ids = np.stack([rng.choice(600, p, replace=False)
                         for _ in range(b)]).astype(np.int32)
    pool_ids[:, -4:] = -1
    x = data.astype(np.float32)
    q = x[self_ids]
    vecs = x[np.maximum(pool_ids, 0)]
    if metric == "L2":
        keys = ((vecs - q[:, None]) ** 2).sum(-1)
        alpha = 1.2
    elif metric == "MIP":
        keys = -(vecs * q[:, None]).sum(-1)
        alpha = 0.95
    else:
        keys = -(vecs * q[:, None]).sum(-1) / (
            np.linalg.norm(vecs, axis=-1) * np.linalg.norm(q, axis=-1)[:, None])
        alpha = 0.95
    keys = np.where(pool_ids >= 0, keys, np.inf).astype(np.float32)
    order = np.argsort(keys, axis=1, kind="stable")
    keys = np.take_along_axis(keys, order, 1)
    pool_ids = np.take_along_axis(pool_ids, order, 1)
    vecs = x[np.maximum(pool_ids, 0)]
    norms = np.where(pool_ids >= 0, (vecs ** 2).sum(-1), np.inf)
    norms = norms.astype(np.float32)
    jr, jd = jprune.robust_prune(
        jnp.asarray(pool_ids), jnp.asarray(keys), jnp.asarray(vecs),
        jnp.asarray(norms), jnp.asarray(self_ids), alpha, r,
        jdist.as_distance(metric))
    tr, td = tprune.robust_prune(T(pool_ids), T(keys), T(vecs), T(norms),
                                 T(self_ids), alpha, r,
                                 tdist.as_distance(metric))
    same = (tr.numpy() == np.asarray(jr)).all(1)
    assert same.mean() >= 0.99, same.mean()
    assert (td.numpy() == np.asarray(jd))[same].all()


def test_medioid_matches_jax():
    data, _ = jio.generate_test_dataset(1000, 1, 40, seed=11)
    want = jmedioid(jdata.VectorDataset.from_array(data))
    got = compute_medioid(VectorDataset.from_array(data, device="cpu"))
    assert got == want
