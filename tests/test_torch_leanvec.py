"""LeanVec in the PyTorch port against the JAX package.

The same numpy inputs (600 x 48 clustered rows, seed 7) go through the
JAX package's ``quantization/leanvec.py`` and the port's, on the CPU.
Training is numpy on both sides and LVQ compression is bit-identical, so
the projections, means and codes must be equal bit for bit.  Both builds
run over the same LVQ-8 primary; the searches run on one graph (the JAX
index carried across with ``interop``).  Tolerances are stated per test.
"""

import os

import numpy as np
import pytest
import torch

from scalablevectorsearch_tpu.core.io import generate_test_dataset
from scalablevectorsearch_tpu.index.vamana.params import (
    VamanaBuildParameters as JParams)
from scalablevectorsearch_tpu.quantization.leanvec import (
    LeanVecDataset as JLeanVec, LeanVecVamana as JLeanVecVamana)

import scalablevectorsearch_tpu_torch as svt
from scalablevectorsearch_tpu_torch import interop
from scalablevectorsearch_tpu_torch.quantization.leanvec import (
    LeanVecDataset, LeanVecVamana)

torch.set_num_threads(1)

PARAMS = dict(graph_max_degree=16, window_size=24,
              max_candidate_pool_size=60, prune_to=14, alpha=1.1)
LVQ_FIELDS = ("codes", "scales", "biases", "mean", "norms_sq")


@pytest.fixture(scope="module")
def dataset():
    data, queries = generate_test_dataset(600, 40, 48, seed=7)
    # a query training set from the same clusters, apart from the test
    # queries
    _, train_q = generate_test_dataset(600, 240, 48, seed=7)
    return data, queries, train_q[40:]


def lvq_arrays(j) -> dict:
    """``interop.lvq_from_arrays`` arguments for a JAX LVQDataset."""
    return dict(codes=np.asarray(j.codes), scales=np.asarray(j.scales),
                biases=np.asarray(j.biases), mean=np.asarray(j.mean),
                n=j.n, dim=j.dim, bits=j.bits)


def carry_leanvec(j) -> LeanVecDataset:
    pca = j.query_projection is j.projection
    return interop.leanvec_from_arrays(
        j.mean, j.projection, lvq_arrays(j.primary),
        lvq_arrays(j.secondary),
        query_projection=None if pca else j.query_projection,
        query_mean=None if pca else j.query_mean, device="cpu")


def carry(jl) -> LeanVecVamana:
    """The port's LeanVecVamana over a JAX LeanVecVamana's state."""
    ji = jl._index
    lv = carry_leanvec(jl._leanvec)
    index = interop.vamana_from_arrays(
        lv.primary, np.asarray(ji.graph.adjacency),
        np.asarray(ji.graph.degrees), ji.entry_point, ji.distance.value,
        device="cpu")
    return LeanVecVamana(index, lv, jl.rerank_multiplier)


def assert_same_leanvec(t, j, norms_rtol=0.0):
    """Maps, means and both LVQ levels equal; ``norms_rtol``: the JAX
    package recomputes the norms in f32 when it loads a checkpoint (a
    settled divergence), within rtol 1e-6 of the float64 ones."""
    for name in ("mean", "projection", "query_projection", "query_mean"):
        np.testing.assert_array_equal(getattr(t, name),
                                      np.asarray(getattr(j, name)),
                                      err_msg=name)
    assert (t.query_projection is t.projection) == \
        (j.query_projection is j.projection)
    for level in ("primary", "secondary"):
        tl, jl = getattr(t, level), getattr(j, level)
        assert (tl.n, tl.dim, tl.padded_dim, tl.bits) == \
            (jl.n, jl.dim, jl.padded_dim, jl.bits), level
        for name in LVQ_FIELDS:
            np.testing.assert_allclose(getattr(tl, name).numpy(),
                                       np.asarray(getattr(jl, name)),
                                       rtol=norms_rtol if name == "norms_sq"
                                       else 0, atol=0,
                                       err_msg=f"{level}.{name}")


def assert_close_distances(got, want, queries, norms_sq):
    """Where both results hold the same id, the distances differ by at
    most 1e-5 of ||q||^2 + ||x||^2: the rerank's L2 is norm algebra, whose
    terms the two packages sum in other orders (a settled divergence)."""
    exact = got.ids == want.ids
    qn = (queries.astype(np.float64) ** 2).sum(1)
    scale = qn[:, None] + norms_sq[np.maximum(got.ids, 0)]
    assert np.all(np.abs(got.distances - want.distances)[exact]
                  <= 1e-5 * scale[exact])


@pytest.fixture(scope="module")
def trained(dataset):
    data, _queries, train_q = dataset
    out = {}
    for mode in ("pca", "ood"):
        q = train_q if mode == "ood" else None
        out[mode] = (JLeanVec.train(data, queries=q),
                     LeanVecDataset.train(data, queries=q, device="cpu"))
    return out


@pytest.mark.parametrize("mode", ["pca", "ood"])
def test_train_matches_jax_bit_for_bit(trained, dataset, mode):
    """Projections, means and both levels' codes, scales, biases, mean and
    norms equal the JAX package's exactly; projected queries too."""
    j, t = trained[mode]
    assert t.reduced_dim == 24 and t.dim == 48
    assert_same_leanvec(t, j)
    assert_same_leanvec(carry_leanvec(j), j)
    queries = dataset[1]
    np.testing.assert_array_equal(t.project_queries(queries),
                                  j.project_queries(queries))


@pytest.fixture(scope="module")
def built(trained):
    """JAX and port LeanVec indexes built over the same trained datasets."""
    out = {}
    for mode, (j, t) in trained.items():
        jl = JLeanVecVamana.build(JParams(**PARAMS), j, "l2")
        tl = LeanVecVamana.build(svt.VamanaBuildParameters(**PARAMS), t,
                                 "l2")
        out[mode] = (jl, tl)
    return out


@pytest.mark.parametrize("mode", ["pca", "ood"])
def test_build_matches_jax_adjacency(built, mode):
    """The LVQ-8 build over the primary (24 live lanes of 128) gives the
    JAX graph: entry point and degrees equal, every row the same set of
    neighbours.  The order within a row may differ where two neighbours'
    distances are within rounding or where reverse edges were appended in
    another order (the sorts' tie order, a settled divergence): at most 2%
    of the rows."""
    jl, tl = built[mode]
    ji, ti = jl._index, tl.index
    assert ti.data.device.type == "cpu"
    assert ti.entry_point == ji.entry_point
    n = ji.size
    np.testing.assert_array_equal(ti.graph.degrees.numpy()[:n],
                                  np.asarray(ji.graph.degrees)[:n])
    tadj = ti.graph.adjacency.numpy()[:n]
    jadj = np.asarray(ji.graph.adjacency)[:n]
    assert all(set(a) == set(b) for a, b in zip(tadj, jadj))
    reordered = (tadj != jadj).any(1)
    assert reordered.mean() <= 0.02, np.nonzero(reordered)[0]


@pytest.mark.parametrize("mode", ["pca", "ood"])
def test_search_matches_jax(built, dataset, mode):
    """On one graph: ids agree on >= 98% of slots (sorted per query); the
    distances of equal slots differ by at most 1e-5 of ||q||^2 + ||x||^2,
    the terms that the rerank's norm algebra sums in another order than
    the JAX package (a settled divergence); the port's own build searches
    to the same ids and distances."""
    _data, queries, _ = dataset
    jl, tl = built[mode]
    tc = carry(jl)
    for window in (10, 24):
        jl.search_window_size = tc.search_window_size = window
        tl.search_window_size = window
        want = jl.search(queries, 10)
        got = tc.search(queries, 10)
        assert got.ids.shape == (len(queries), 10)
        same = np.sort(got.ids, 1) == np.sort(want.ids, 1)
        assert same.mean() >= 0.98, (window, same.mean())
        assert_close_distances(got, want, queries,
                               tc.leanvec.secondary.norms_sq.numpy())
        own = tl.search(queries, 10)
        np.testing.assert_array_equal(own.ids, got.ids)
        np.testing.assert_array_equal(own.distances, got.distances)


def test_rerank_is_exact_over_the_fetched_ids(built, dataset):
    """The returned k are the fetched k * 3 candidates re-ranked by their
    distance to the secondary's decoded rows: float64 on the host gives
    the same ids, distances within 8 f32 epsilons of ||q||^2 + ||x||^2."""
    _data, queries, _ = dataset
    _jl, tl = built["ood"]
    tl.search_window_size = 24
    got = tl.search(queries, 10)
    fetched = tl.index.search(tl.leanvec.project_queries(queries), 30).ids
    rows = tl.leanvec.secondary.to_numpy().astype(np.float64)
    q = queries.astype(np.float64)
    for i in range(len(queries)):
        x = rows[fetched[i]]
        dist = ((x - q[i]) ** 2).sum(1)
        order = np.argsort(dist, kind="stable")[:10]
        tol = 8 * np.finfo(np.float32).eps * ((x ** 2).sum(1) + q[i] @ q[i])
        np.testing.assert_array_equal(got.ids[i], fetched[i][order])
        assert np.all(np.abs(got.distances[i] - dist[order]) <= tol[order])


@pytest.mark.parametrize("mode", ["pca", "ood"])
def test_checkpoints_cross_both_ways(built, dataset, tmp_path, mode):
    """The JAX package's save assembles in the port, and the port's in the
    JAX package; each copy searches as the index it was saved from: ids
    identical, distances identical in the port, within the norm-algebra
    rounding of :func:`assert_close_distances` in the JAX package, whose
    load recomputes the norms in f32."""
    _data, queries, _ = dataset
    jl, tl = built[mode]
    jl.search_window_size = tl.search_window_size = 16
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jl.save(jdir)
    tl.save(tdir)
    assert os.path.exists(os.path.join(tdir, "leanvec",
                                       "leanvec_config.json"))
    from_jax = LeanVecVamana.assemble(jdir, device="cpu")
    from_torch = JLeanVecVamana.assemble(tdir)
    assert_same_leanvec(from_jax.leanvec, jl._leanvec)
    assert_same_leanvec(tl.leanvec, from_torch._leanvec, norms_rtol=1e-6)
    from_jax.search_window_size = from_torch.search_window_size = 16
    for loaded, live in ((from_jax, carry(jl)), (from_torch, jl)):
        want = live.search(queries, 10)
        got = loaded.search(queries, 10)
        np.testing.assert_array_equal(got.ids, want.ids)
        if loaded is from_jax:
            np.testing.assert_array_equal(got.distances, want.distances)
        else:
            assert_close_distances(got, want, queries,
                                   tl.leanvec.secondary.norms_sq.numpy())
    again = LeanVecVamana.assemble(tdir, device="cpu")
    again.search_window_size = 16
    np.testing.assert_array_equal(again.search(queries, 10).ids,
                                  tl.search(queries, 10).ids)


@pytest.mark.parametrize("bad", [(50, 47), (50,), (2, 50, 48)])
def test_malformed_query_training_set_raises(dataset, bad):
    data = dataset[0][:100]
    q = np.zeros(bad, np.float32)
    with pytest.raises(ValueError, match="query training set"):
        JLeanVec.train(data, queries=q)
    with pytest.raises(ValueError, match="query training set"):
        LeanVecDataset.train(data, queries=q, device="cpu")
    with pytest.raises(ValueError, match="target_dim"):
        LeanVecDataset.train(data, target_dim=49, device="cpu")


def test_sampler_and_query_dim(built, dataset):
    """Sampled entries select on the projected queries; a query of the
    wrong width raises as in JAX."""
    _data, queries, _ = dataset
    jl, tl = built["pca"]
    tc = carry(jl)
    for idx in (jl, tc):
        idx.enable_entry_sampler(n_samples=64, seed=3)
        idx.search_window_size = 16
    try:
        want, got = jl.search(queries, 10), tc.search(queries, 10)
        same = np.sort(got.ids, 1) == np.sort(want.ids, 1)
        assert same.mean() >= 0.98, same.mean()
    finally:
        jl.disable_entry_sampler()
        tc.disable_entry_sampler()
    with pytest.raises(ValueError, match="query dim"):
        tc.search(queries[:, :40], 10)
    assert tc.size == 600 and tc.dimensions == 48
