"""The two-level inverted index of the PyTorch port against the JAX package.

One JAX ``InvertedIndex`` and one port index are built from the same
seeded numpy data (1500 x 32, 150 centroids, primary R 16) on the CPU; the
centroid choice, the primary graph (the port's build runs ``beam_step``'s
plain version), the closure memberships (L2, MIP, cosine), the posting
layout, searches over epsilons, probe caps and both scan routes, query
uploads, checkpoints in both directions and the orchestrator are then held
to the JAX package.  The JAX package takes its CPU (XLA) search branch.
Where result ids differ, the rows are proven ties as in
``tests/test_torch_ivf.py``.
"""

import numpy as np
import pytest
import torch

from scalablevectorsearch_tpu.core.io import generate_test_dataset
from scalablevectorsearch_tpu.index.inverted import index as jinv
from scalablevectorsearch_tpu.index.vamana.params import (
    VamanaBuildParameters as JVParams)

import scalablevectorsearch_tpu_torch as svt
from scalablevectorsearch_tpu_torch import interop
from scalablevectorsearch_tpu_torch.index.inverted import index as tinv
from scalablevectorsearch_tpu_torch.index.vamana import search as tsearch

from test_torch_ivf import assert_same_neighbors

torch.set_num_threads(1)

KW = dict(graph_max_degree=16, window_size=32, max_candidate_pool_size=64,
          prune_to=14, alpha=1.2)


def params(pkg):
    if pkg == "jax":
        return jinv.InvertedBuildParameters(primary_parameters=JVParams(**KW))
    return svt.InvertedBuildParameters(
        primary_parameters=svt.VamanaBuildParameters(**KW))


@pytest.fixture(scope="module")
def data():
    return generate_test_dataset(1500, 48, 32, seed=7)


@pytest.fixture(scope="module")
def built(data):
    x, _ = data
    return (jinv.InvertedIndex.build(params("jax"), x, "l2"),
            tinv.InvertedIndex.build(params("port"), x, "l2", device="cpu"))


def search_pair(j, t, queries, **sp):
    return (j.search(queries, 10, jinv.InvertedSearchParameters(**sp)),
            t.search(queries, 10, svt.InvertedSearchParameters(**sp)))


def test_parameter_tables_equal_jax():
    j, t = params("jax"), params("port")
    assert t.save_table() == j.save_table()
    assert svt.InvertedBuildParameters.from_table(j.save_table()) == t
    for kw in ({}, dict(primary_window_size=20, refinement_epsilon=0.25,
                        max_probes=8)):
        js = jinv.InvertedSearchParameters(**kw)
        ts = svt.InvertedSearchParameters(**kw)
        assert ts.save_table() == js.save_table()
        assert svt.InvertedSearchParameters.from_table(js.save_table()) == ts


def test_build_matches_jax(built):
    """Centroid ids, the primary adjacency, degrees and entry point, and the
    posting layout (slot, ids, rows, padding norms) equal."""
    j, t = built
    np.testing.assert_array_equal(t.centroid_ids.numpy(),
                                  np.asarray(j.centroid_ids))
    np.testing.assert_array_equal(t.graph.adjacency.numpy(),
                                  np.asarray(j.graph.adjacency))
    np.testing.assert_array_equal(t.graph.degrees.numpy(),
                                  np.asarray(j.graph.degrees))
    assert t.entry_point == j.entry_point
    assert t.slot == j.slot and t.n == j.n
    np.testing.assert_array_equal(t.ids_padded.numpy(),
                                  np.asarray(j.ids_padded))
    np.testing.assert_array_equal(t.data.vectors.numpy(),
                                  np.asarray(j.data.vectors))
    np.testing.assert_array_equal(t.data.norms_sq.isinf().numpy(),
                                  np.isinf(np.asarray(j.data.norms_sq)))


def closure_tie(x, cents, a, b, distance, epsilon, alpha, rtol=1e-5):
    """True when two membership lists of point ``x`` differ at a near-tie
    (float64, within ``rtol`` of the keys' scale): a centroid of either
    list at the epsilon bound, two of them at equal keys (their order), or
    an occlusion test of the prune (alpha * pair term against the point's
    term) at equality."""
    x, cents = x.astype(np.float64), cents.astype(np.float64)
    dots = cents @ x
    c2, x2 = (cents ** 2).sum(1), (x ** 2).sum()
    if distance == "l2":
        keys, scale = x2 - 2 * dots + c2, x2 + c2.max()
    elif distance == "mip":
        keys, scale = -dots, np.sqrt(x2 * c2.max()) + c2.max()
    else:
        keys, scale = -dots / np.sqrt(x2 * c2), 1.0
    tol = rtol * scale
    best = keys.min()
    bound = best * (1 + epsilon) if best >= 0 else best / (1 + epsilon)
    u = np.array(sorted((set(a) | set(b)) - {-1}))
    ku = keys[u]
    if (np.abs(ku - bound) <= tol).any():
        return True
    if (np.abs(ku[:, None] - ku[None, :]) + np.eye(u.size) * 2 * tol
            <= tol).any():
        return True
    cu = cents[u]
    if distance == "l2":
        pair = ((cu[:, None] - cu[None, :]) ** 2).sum(-1)
        own = ku[None, :]
    else:
        pair = cu @ cu.T
        if distance == "cosine":
            n = np.sqrt((cu ** 2).sum(1))
            pair = pair / (n[:, None] * n[None, :])
        own = -ku[None, :]
    occl = np.abs(own - alpha * pair) + np.eye(u.size) * 2 * tol
    return bool((occl <= tol).any())


@pytest.mark.parametrize("distance", ["l2", "mip", "cosine"])
def test_closure_assign_matches_jax(data, built, distance):
    """Memberships of every point over the same centroids (chunks of 512,
    so the padded last chunk is exercised): rows equal the JAX package's
    except proven near-ties (:func:`closure_tie`).  A point that is itself
    a centroid ties every occlusion test exactly (its pair terms equal its
    own), so rounding decides its prune; other rows differ in at most 2%.
    The replicated layouts of equal memberships are equal."""
    x, _ = data
    j, t = built
    want = jinv.closure_assign(x, j.centroid_data, distance, 0.05, 8, 1.0,
                               chunk=512)
    got = tinv.closure_assign(x, t.centroid_data, distance, 0.05, 8, 1.0,
                              chunk=512)
    cents = x[t.centroid_ids.numpy()]
    differ = np.nonzero((got != want).any(1))[0]
    for r in differ:
        assert closure_tie(x[r], cents, got[r], want[r], distance, 0.05,
                           1.0), (distance, r, got[r], want[r])
    others = np.setdiff1d(differ, t.centroid_ids.numpy())
    assert others.size <= 0.02 * len(x), others.size
    rows, ids, slot = tinv.pack_padded_clusters_multi(x, want, 150)
    jrows, jids, jslot = jinv.pack_padded_clusters_multi(x, want, 150)
    assert slot == jslot
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(rows, jrows)


def test_search_matches_jax(data, built, monkeypatch):
    """Epsilons 0, 0.25 and 1 at probe caps 8 and 16, and the row-gather
    route at one setting; the primary search runs beam_step in every
    search."""
    monkeypatch.setenv("SVT_QUERY_UPLOAD_DTYPE", "float32")
    x, queries = data
    j, t = built
    calls = []
    step = tsearch.beam_step

    def counting(*args, **kwargs):
        calls.append(1)
        return step(*args, **kwargs)

    monkeypatch.setattr(tsearch, "beam_step", counting)
    ties = 0
    for eps in (0.0, 0.25, 1.0):
        for probes in (8, 16):
            before = len(calls)
            want, got = search_pair(j, t, queries, refinement_epsilon=eps,
                                    max_probes=probes)
            assert len(calls) > before
            ties += assert_same_neighbors(want, got, x, queries, "l2",
                                          label=f"eps {eps} {probes}")
            for row in got.ids:
                assert np.unique(row[row >= 0]).size == (row >= 0).sum()
    monkeypatch.setenv("SVT_IVF_SCAN_LAYOUT", "0")
    t._scan_vecs = t._scan_ids = None
    t._scan_sub = 0
    plain = t.search(queries, 10, svt.InvertedSearchParameters(
        refinement_epsilon=1.0, max_probes=16))
    assert t._scan_vecs is None
    ties += assert_same_neighbors(want, plain, x, queries, "l2",
                                  label="row-gather route")
    assert ties <= 0.05 * 7 * len(queries)


def test_query_upload_dtype_is_honoured(data, built, monkeypatch):
    """The per-index attribute overrides the env default and gives the JAX
    package's search under the same int8 upload."""
    x, queries = data
    j, t = built
    sp = dict(refinement_epsilon=0.25, max_probes=8)
    monkeypatch.setenv("SVT_QUERY_UPLOAD_DTYPE", "float32")
    f32 = t.search(queries, 10, svt.InvertedSearchParameters(**sp))
    monkeypatch.setenv("SVT_QUERY_UPLOAD_DTYPE", "int8")
    env = t.search(queries, 10, svt.InvertedSearchParameters(**sp))
    monkeypatch.setenv("SVT_QUERY_UPLOAD_DTYPE", "float32")
    t.query_upload_dtype = j.query_upload_dtype = "int8"
    try:
        want, got = search_pair(j, t, queries, **sp)
    finally:
        t.query_upload_dtype = j.query_upload_dtype = None
    np.testing.assert_array_equal(got.ids, env.ids)
    np.testing.assert_array_equal(got.distances, env.distances)
    assert not np.array_equal(got.distances, f32.distances)
    scale = np.abs(queries).max(1, keepdims=True) / 127.0
    q_up = (np.rint(queries / scale).astype(np.int8) * scale).astype(
        np.float32)
    assert_same_neighbors(want, got, x, q_up, "l2", rtol=1e-4)


def test_checkpoints_cross_both_ways(data, built, tmp_path, monkeypatch):
    """A checkpoint written by either package assembles in the other and
    searches as the live index does; interop carries the JAX index's
    arrays into an equal port index."""
    monkeypatch.setenv("SVT_QUERY_UPLOAD_DTYPE", "float32")
    x, queries = data
    j, t = built
    sp = dict(refinement_epsilon=1.0, max_probes=8)
    want, got = search_pair(j, t, queries, **sp)
    j.save(str(tmp_path / "jax"))
    t.save(str(tmp_path / "port"))
    tl = svt.Inverted.assemble(str(tmp_path / "jax"), device="cpu").index
    jl = jinv.InvertedIndex.assemble(str(tmp_path / "port"))
    carried = interop.inverted_from_arrays(
        np.asarray(j.centroid_data.vectors)[: j.num_centroids, :32],
        np.asarray(j.centroid_ids), np.asarray(j.graph.adjacency),
        np.asarray(j.graph.degrees), j.entry_point,
        np.asarray(j.data.vectors)[:, :32], np.asarray(j.ids_padded),
        j.slot, j.n, "l2", device="cpu")
    for loaded in (tl, carried):
        np.testing.assert_array_equal(loaded.ids_padded.numpy(),
                                      t.ids_padded.numpy())
        np.testing.assert_array_equal(loaded.graph.adjacency.numpy(),
                                      t.graph.adjacency.numpy())
        assert loaded.entry_point == t.entry_point
        res = loaded.search(queries, 10, svt.InvertedSearchParameters(**sp))
        np.testing.assert_array_equal(res.ids, got.ids)
        np.testing.assert_array_equal(res.distances, got.distances)
    assert tl.build_parameters == t.build_parameters
    res = jl.search(queries, 10, jinv.InvertedSearchParameters(**sp))
    np.testing.assert_array_equal(np.asarray(res.ids), np.asarray(want.ids))


def test_orchestrator(data, built):
    x, queries = data
    _j, t = built
    inv = svt.Inverted(t)
    assert inv.size == 1500 and inv.num_centroids == 150
    assert inv.dimensions == 32
    inv.search_parameters = svt.InvertedSearchParameters(max_probes=8)
    res = inv.search(queries[:8], 5)
    np.testing.assert_array_equal(
        inv.search_async(queries[:8], 5).result().ids, res.ids)
    assert res.ids.shape == (8, 5)
    built_port = svt.Inverted.build(svt.InvertedBuildParameters(
        percent_centroids=0.2, primary_parameters=svt.VamanaBuildParameters(
            **{**KW, "alpha": 0.95})), x[:300], "mip", device="cpu")
    assert built_port.num_centroids == 60
    with pytest.raises(ValueError):
        inv.search(queries[:2, :16], 5)


def test_no_cpu_fallback(data):
    """With no device argument the index goes to the GPU; with no card it
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    x, _ = data
    with pytest.raises((RuntimeError, AssertionError)):
        svt.Inverted.build(params("port"), x[:200], "l2")
