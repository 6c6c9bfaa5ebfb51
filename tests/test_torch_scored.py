"""The scored search route of the PyTorch port against the JAX package.

The same numpy inputs go through the JAX package's ``beam_update``,
``score_rows``, ``gather_score_l2_partial`` (interpret mode), ``SQDataset``
and ``greedy_search`` (whose XLA branch serves these datasets on the CPU),
and through their port counterparts on the CPU, where the kernel wrappers
run their plain PyTorch versions.  The CUDA kernels need the card: their
tests are in ``test_torch_gpu.py``.

Tolerances: keys computed from the same f32 rows in another summation
order agree to rtol 1e-5 (atol 1e-4 of the values' scale); searches agree
on at least 98% of their result slots, since near-tied keys may swap.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scalablevectorsearch_tpu.core.data import VectorDataset as JVectors
from scalablevectorsearch_tpu.core.io import generate_test_dataset
from scalablevectorsearch_tpu.core.recall import k_recall_at_n
from scalablevectorsearch_tpu.index.flat import FlatIndex as JFlat
from scalablevectorsearch_tpu.index.flat import exhaustive_search as jexh
from scalablevectorsearch_tpu.index.vamana import search as jsearch
from scalablevectorsearch_tpu.index.vamana.index import VamanaIndex as JIndex
from scalablevectorsearch_tpu.index.vamana.params import (
    VamanaBuildParameters as JParams)
from scalablevectorsearch_tpu.ops.pallas import gather_distance as jgd
from scalablevectorsearch_tpu.ops.pallas.beam_update import (
    beam_update as jbeam_update, beam_update_reference)
from scalablevectorsearch_tpu.orchestrators.vamana import Vamana as JVamana
from scalablevectorsearch_tpu.quantization.scalar import SQDataset as JSQ

import scalablevectorsearch_tpu_torch as svt
from scalablevectorsearch_tpu_torch import interop
from scalablevectorsearch_tpu_torch.index.vamana import search as tsearch
from scalablevectorsearch_tpu_torch.ops import distance as dist_ops
from scalablevectorsearch_tpu_torch.ops.kernels import beam_update as bu
from scalablevectorsearch_tpu_torch.ops.kernels import gather_distance as gd
from scalablevectorsearch_tpu_torch.quantization.scalar import SQDataset

torch.set_num_threads(1)

PARAMS = dict(graph_max_degree=16, window_size=24,
              max_candidate_pool_size=60, prune_to=14, alpha=1.1)
SQ_DTYPES = ["int8", "uint8", "int16"]


# ---------------------------------------------------------------------------
# beam_update
# ---------------------------------------------------------------------------

def update_case(rng, B, C, K, ties: bool, n_ids=300):
    """beam_update inputs: a sorted beam with visited and empty slots,
    candidates with 20% invalid ids and some ids already in the beam, keys a
    function of (query, id) as in tests/test_pallas.py, a few valid ids
    with +inf keys; ``ties`` puts the keys on a coarse grid so that
    different ids share keys."""
    bids = np.stack([rng.choice(n_ids, C, replace=False)
                     for _ in range(B)]).astype(np.int32)
    table = rng.normal(size=(B, n_ids)).astype(np.float32)
    if ties:
        table = np.round(table * 4) / np.float32(4)
    bkeys = np.take_along_axis(table, bids, 1) + np.float32(0.25)
    order = np.argsort(bkeys, 1, kind="stable")
    bkeys = np.take_along_axis(bkeys, order, 1)
    bids = np.take_along_axis(bids, order, 1)
    n_empty = rng.integers(0, C // 3 + 1, size=B)
    bkeys[np.arange(C)[None, :] >= (C - n_empty)[:, None]] = np.inf
    vis = (rng.random((B, C)) < 0.5).astype(np.int32)
    bpacked = np.where(np.isfinite(bkeys), bids | (vis << 30),
                       -1).astype(np.int32)
    cids = rng.integers(-1, n_ids, size=(B, K)).astype(np.int32)
    ckeys = np.take_along_axis(table, np.maximum(cids, 0), 1)
    ckeys[cids < 0] = np.inf
    ckeys[rng.random((B, K)) < 0.03] = np.inf        # valid id, no key
    return bkeys, bpacked, ckeys, cids


def assert_same_update(got, want):
    """Two beam_update results agree: keys identical; within each key the
    ids identical as multisets and as many of them visited (tie order is
    free, and with it which of a tie group the pops take); the popped ids'
    keys identical; the pools identical as (key, id) sets."""
    gk, gp, gpop, gpk, gpi = (np.asarray(x) for x in got)
    wk, wp, wpop, wpk, wpi = (np.asarray(x) for x in want)
    fin = np.isfinite(wk)
    np.testing.assert_array_equal(np.isfinite(gk), fin)
    np.testing.assert_array_equal(gk[fin], wk[fin])
    assert gpk.shape == wpk.shape and gpi.shape == wpi.shape
    for r in range(wk.shape[0]):
        keys = wk[r][fin[r]]
        g, w = gp[r][fin[r]], wp[r][fin[r]]
        last = keys.max() if keys.size else None
        for v in np.unique(keys):
            if v == last:
                # the tie group cut by the capacity keeps any of its ids
                continue
            sel = keys == v
            assert sorted(g[sel] & 0x3FFFFFFF) == \
                sorted(w[sel] & 0x3FFFFFFF), r
            assert (g[sel] >> 30).sum() == (w[sel] >> 30).sum(), r
        key_of = dict(zip(list(wp[r] & 0x3FFFFFFF), list(wk[r])))
        key_of.update(zip(list(gp[r] & 0x3FFFFFFF), list(gk[r])))
        pops_g = sorted(key_of[i] for i in gpop[r] if i >= 0)
        pops_w = sorted(key_of[i] for i in wpop[r] if i >= 0)
        assert pops_g == pops_w, r
        assert ({(float(k), int(i)) for k, i in zip(gpk[r], gpi[r])
                 if np.isfinite(k)}
                == {(float(k), int(i)) for k, i in zip(wpk[r], wpi[r])
                    if np.isfinite(k)}), r


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("C,window", [(16, 12), (100, 100)])
def test_beam_update_plain_matches_jax(rng, C, window, ties):
    """beam_update_plain against the JAX kernel in interpret mode and its
    XLA reference, K 128, m 4."""
    case = update_case(rng, 16, C, 128, ties)
    kw = dict(window=window, m=4)
    ref = beam_update_reference(*(jnp.asarray(x) for x in case), **kw)
    kern = jbeam_update(*(jnp.asarray(x) for x in case), interpret=True,
                        block_rows=8, **kw)
    before = bu.beam_update.launches
    got = bu.beam_update(*(torch.from_numpy(x) for x in case), **kw)
    assert bu.beam_update.launches == before      # CPU: plain, no launch
    got = [x.numpy() for x in got]
    assert_same_update(got, ref)
    assert_same_update(got, kern)
    # the survivors sit in the first K columns, the last C are empty
    assert np.isinf(got[3][:, 128:]).all() and (got[4][:, 128:] == -1).all()


def test_beam_update_contract():
    """Types and shapes are checked on the CPU too (the 1024-slot limit in
    test_torch_vamana.py)."""
    bk = torch.zeros((2, 8))
    bp = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        bu.beam_update(bk, bp, bk, bp.long(), window=8, m=2)
    with pytest.raises(ValueError, match="inconsistent"):
        bu.beam_update(bk, bp, bk[:1], bp[:1], window=8, m=2)


# ---------------------------------------------------------------------------
# score_rows and gather_score_l2_partial
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,k,d", [(8, 16, 128), (16, 32, 256)])
def test_score_rows_plain_matches_jax(rng, b, k, d):
    rows = rng.normal(size=(b, k, d)).astype(np.float32)
    q = rng.normal(size=(b, d)).astype(np.float32)
    want = jgd.score_rows(jnp.asarray(rows), jnp.asarray(q), interpret=True)
    before = gd.score_rows.launches
    got = gd.score_rows(torch.from_numpy(rows), torch.from_numpy(q))
    assert gd.score_rows.launches == before
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-4 * np.abs(w).max())


@pytest.mark.parametrize("dtype", ["float32", "float16", "int8", "uint8"])
def test_gather_score_l2_partial_matches_jax(rng, dtype):
    """The partial over f32 tables against the JAX kernel in interpret
    mode, and over float16 / int8 / uint8 tables against the JAX kernel
    applied to the table's ``get_f32`` rows."""
    n, d, b, k = 500, 128, 16, 24
    x = rng.normal(size=(n, d)) * (40 if "int" in dtype else 1)
    if dtype == "uint8":
        x = x + 128
    jdata = JVectors.from_array(x.astype(np.float32), dtype=dtype)
    ids = rng.integers(0, jdata.capacity, size=(b, k)).astype(np.int32)
    q = rng.normal(size=(b, d)).astype(np.float32)
    table_f32 = jdata.get_f32(jnp.arange(jdata.capacity))
    want = np.asarray(jgd.gather_score_l2_partial(
        table_f32, jnp.asarray(ids), jnp.asarray(q), interpret=True))
    tdata = svt.VectorDataset.from_array(x.astype(np.float32), dtype=dtype,
                                         device="cpu")
    assert tdata.dtype == getattr(torch, dtype)
    got = gd.gather_score_l2_partial(tdata.vectors, torch.from_numpy(ids),
                                     torch.from_numpy(q)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-4 * np.abs(want).max())
    # + ||q||^2, clamped: the L2 keys of gathered_keys
    keys = dist_ops.keys_from_l2_partial(
        torch.from_numpy(got), torch.from_numpy((q * q).sum(1))).numpy()
    full = ((q[:, None, :] - np.asarray(table_f32)[ids]) ** 2).sum(-1)
    np.testing.assert_allclose(keys, full, rtol=1e-4,
                               atol=1e-4 * full.max())
    # out-of-range ids are clamped, never read outside the table
    wild = torch.from_numpy(ids.copy())
    wild[0, 0], wild[0, 1] = -5, 10 ** 6
    out = gd.gather_score_l2_partial(tdata.vectors, wild,
                                     torch.from_numpy(q)).numpy()
    edge = gd.gather_score_l2_partial(
        tdata.vectors, torch.tensor([[0, tdata.capacity - 1]] * b,
                                    dtype=torch.int32),
        torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(out[0, :2], edge[0])


def test_keys_from_parts_match_gathered_keys(rng):
    rows = torch.from_numpy(rng.normal(size=(4, 9, 64)).astype(np.float32))
    q = torch.from_numpy(rng.normal(size=(4, 64)).astype(np.float32))
    dots, x2 = gd.score_rows(rows, q)
    for distance in ("L2", "MIP", "Cosine"):
        got = dist_ops.keys_from_parts(distance, dots, x2,
                                       q.square().sum(-1))
        want = dist_ops.gathered_keys(distance, q, rows)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------------------
# SQDataset
# ---------------------------------------------------------------------------

def sq_pair(dtype, x):
    return JSQ.compress(x, dtype=dtype), SQDataset.compress(x, dtype=dtype,
                                                            device="cpu")


@pytest.mark.parametrize("dtype", SQ_DTYPES)
def test_sq_compress_matches_jax_bit_for_bit(dtype):
    x = np.random.default_rng(5).normal(size=(300, 52)).astype(np.float32) * 3
    j, t = sq_pair(dtype, x)
    assert t.capacity == j.capacity and t.padded_dim == j.padded_dim
    assert t.dtype == getattr(torch, dtype)
    for name in ("codes", "norms_sq", "code_sums"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)),
                                      err_msg=name)
    assert np.float32(t.scale) == np.asarray(j.scale)
    assert np.float32(t.bias) == np.asarray(j.bias)
    np.testing.assert_array_equal(t.to_numpy(), j.to_numpy())
    np.testing.assert_array_equal(t.decompress([3, 7]), j.decompress([3, 7]))
    assert t.max_abs_error() == j.max_abs_error()
    # carried across, norms and sums are recomputed as compress computes them
    c = interop.sq_from_arrays(np.asarray(j.codes), np.asarray(j.scale),
                               np.asarray(j.bias), n=j.n, dim=j.dim,
                               device="cpu")
    for name in ("codes", "norms_sq", "code_sums"):
        np.testing.assert_array_equal(getattr(c, name).numpy(),
                                      np.asarray(getattr(j, name)),
                                      err_msg=name)
    assert (c.scale, c.bias, c.capacity) == (t.scale, t.bias, t.capacity)


@pytest.mark.parametrize("dtype", SQ_DTYPES)
def test_sq_decode_and_tile_keys_match_jax(dtype):
    rng = np.random.default_rng(11)
    x = rng.normal(size=(300, 52)).astype(np.float32)
    j, t = sq_pair(dtype, x)
    ids = rng.integers(-1, 320, size=(4, 9)).astype(np.int32)
    for name in ("get", "norms_of"):
        np.testing.assert_allclose(
            getattr(t, name)(torch.from_numpy(ids)).numpy(),
            np.asarray(getattr(j, name)(jnp.asarray(ids))), rtol=1e-6,
            atol=1e-6, err_msg=name)
    np.testing.assert_allclose(t.vectors.numpy(), np.asarray(j.vectors),
                               rtol=1e-6, atol=1e-6)
    q = np.zeros((6, t.padded_dim), np.float32)
    q[:, :52] = rng.normal(size=(6, 52))
    np.testing.assert_array_equal(
        t.quantize_queries(torch.from_numpy(q)).numpy(),
        np.asarray(j.quantize_queries(jnp.asarray(q))))
    qn = (q * q).sum(1)
    for distance in ("L2", "MIP", "Cosine"):
        want = np.asarray(j.tile_keys(jnp.asarray(q), jnp.asarray(qn), 64,
                                      128, distance))
        got = t.tile_keys(torch.from_numpy(q), torch.from_numpy(qn), 64, 128,
                          distance).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4,
                                   err_msg=distance)


def test_sq_code_dots_exact_beyond_f32_integer_range():
    """uint8 codes at d 1000: 255^2 * d exceeds 2^24, where one f32 matmul
    would round; the blocked contraction stays exact (the JAX package's
    int32 result)."""
    x = np.random.default_rng(2).uniform(0, 1, size=(64, 1000))
    x[:, 0], x[0] = 0.0, 1.0           # row 0 all-max codes
    j, t = sq_pair("uint8", x.astype(np.float32))
    q = np.zeros((3, t.padded_dim), np.float32)
    q[:, :1000] = 1.0
    qn = (q * q).sum(1)
    want = np.asarray(j.tile_keys(jnp.asarray(q), jnp.asarray(qn), 0, 64,
                                  "MIP"))
    got = t.tile_keys(torch.from_numpy(q), torch.from_numpy(qn), 0, 64,
                      "MIP").numpy()
    np.testing.assert_array_equal(got, want)


def test_flat_index_and_exhaustive_search_over_sq():
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(500, 48)) * 3).astype(np.float32)
    q = (rng.normal(size=(20, 48)) * 3).astype(np.float32)
    for distance in ("l2", "mip", "cosine"):
        jsq = JSQ.compress(x)
        want = JFlat(jsq, distance, data_batch_size=256).search(q, 10)
        got = svt.FlatIndex(SQDataset.compress(x, device="cpu"), distance,
                            data_batch_size=256).search(q, 10)
        assert (np.sort(got.ids, 1) == np.sort(want.ids, 1)).mean() >= 0.98
        np.testing.assert_allclose(np.sort(got.distances, 1),
                                   np.sort(want.distances, 1), rtol=1e-5,
                                   atol=1e-3)
        ex = svt.exhaustive_search(SQDataset.compress(x, device="cpu"), q, 10,
                                   distance)
        np.testing.assert_array_equal(ex.ids, got.ids)


# ---------------------------------------------------------------------------
# greedy_search: the scored route and the wide route
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def graph_and_data():
    """A JAX graph over 500 x 48 rows; every dataset below is searched over
    it in both packages."""
    data, queries = generate_test_dataset(500, 40, 48, seed=7)
    jindex = JVamana.build(JParams(**PARAMS), data, "l2").index
    graph = interop.graph_from_arrays(
        np.asarray(jindex.graph.adjacency), np.asarray(jindex.graph.degrees),
        jindex.size, device="cpu")
    return data, queries, jindex, graph


def dataset_pair(kind, data):
    """(JAX dataset, port dataset) of one kind over the same rows."""
    if kind == "sq-int8":
        j = JSQ.compress(data)
        return j, interop.sq_from_arrays(
            np.asarray(j.codes), np.asarray(j.scale), np.asarray(j.bias),
            n=j.n, dim=j.dim, device="cpu")
    dtype = kind
    rows = data * 20 if dtype == "int8" else data
    j = JVectors.from_array(rows, dtype=dtype)
    return j, interop.dataset_from_array(rows, dtype=dtype, device="cpu")


def run_both(jindex, graph, jdata, tdata, queries, **kw):
    q = np.zeros((queries.shape[0], 128), np.float32)
    q[:, :48] = queries
    entries = np.full((1,), jindex.entry_point, np.int32)
    want = jsearch.greedy_search(jindex.graph, jdata, jnp.asarray(q),
                                 jnp.asarray(entries), **kw)
    want = jax.tree_util.tree_map(np.asarray, want)
    got = tsearch.greedy_search(graph, tdata, torch.from_numpy(q),
                                torch.from_numpy(entries), **kw)
    return want, got


@pytest.mark.parametrize("kind,distance,pool_size", [
    ("sq-int8", "L2", 40), ("sq-int8", "MIP", 0), ("float16", "L2", 0),
    ("float16", "Cosine", 0), ("int8", "L2", 40), ("int8", "MIP", 0)])
def test_scored_route_matches_jax(graph_and_data, kind, distance,
                                  pool_size):
    """The port's scored route (score kernels + beam_update) against the
    JAX XLA branch on one graph, serving and build-pool tracking."""
    data, queries, jindex, graph = graph_and_data
    jdata, tdata = dataset_pair(kind, data)
    kw = dict(window=20, capacity=24, max_iters=56, distance=distance,
              pool_size=pool_size, tail_frac=4)
    want, got = run_both(jindex, graph, jdata, tdata, queries, **kw)
    same = np.sort(want.ids, 1) == np.sort(got.ids.numpy(), 1)
    assert same.mean() >= 0.98, same.mean()
    exact = want.ids == got.ids.numpy()
    np.testing.assert_allclose(got.keys.numpy()[exact], want.keys[exact],
                               rtol=1e-4, atol=1e-4)
    if pool_size:
        overlap = [len(set(a[a >= 0]) & set(b[b >= 0]))
                   / max(len(set(a[a >= 0])), 1)
                   for a, b in zip(want.pool_ids, got.pool_ids.numpy())]
        assert np.mean(overlap) >= 0.98, np.mean(overlap)


@pytest.mark.parametrize("kind,capacity", [("float32", 1100),
                                           ("sq-int8", 1280)])
def test_wide_route_matches_jax(graph_and_data, kind, capacity):
    """Beams above 1024 slots take the wide route (the JAX XLA branch as it
    is), f32 rows scored by the L2 partial, SQ rows by score_rows."""
    data, queries, jindex, graph = graph_and_data
    jdata, tdata = dataset_pair(kind, data)
    kw = dict(window=48, capacity=capacity, max_iters=112, distance="L2",
              pool_size=30, tail_frac=4)
    want, got = run_both(jindex, graph, jdata, tdata, queries, **kw)
    assert got.ids.shape == (queries.shape[0], capacity)
    np.testing.assert_array_equal((got.ids.numpy() >= 0).sum(1),
                                  (want.ids >= 0).sum(1))
    same = np.sort(want.ids[:, :48], 1) == np.sort(got.ids.numpy()[:, :48], 1)
    assert same.mean() >= 0.98, same.mean()
    assert abs(int(got.n_iters) - int(want.n_iters)) <= 2
    overlap = [len(set(a[a >= 0]) & set(b[b >= 0])) / max(len(set(a[a >= 0])),
                                                         1)
               for a, b in zip(want.pool_ids, got.pool_ids.numpy())]
    assert np.mean(overlap) >= 0.98


@pytest.fixture(scope="module")
def sq_builds():
    data, queries = generate_test_dataset(600, 60, 48, seed=7)
    jindex = JIndex.build(JParams(**PARAMS), JSQ.compress(data), "l2")
    tv = svt.Vamana.build(svt.VamanaBuildParameters(**PARAMS),
                          SQDataset.compress(data, device="cpu"), "l2")
    return data, queries, jindex, tv


def test_sq8_build_matches_jax_build(sq_builds):
    """The port's SQ-int8 build on the CPU against the JAX build: mean
    degree within 1%, at least 90% of rows with the JAX graph's neighbour
    set (0.93 measured: SQ keys are multiples of scale^2 up to rounding,
    so exact ties are common and their order follows each package's sums
    and sorts), recall within 0.01 at three windows."""
    data, queries, jindex, tv = sq_builds
    tindex = tv.index
    jdeg, tdeg = jindex.graph.mean_degree(), tindex.graph.mean_degree()
    assert abs(tdeg - jdeg) <= 0.01 * jdeg, (tdeg, jdeg)
    n = jindex.size
    jadj = np.asarray(jindex.graph.adjacency)[:n]
    tadj = tindex.graph.adjacency.numpy()[:n]
    same = np.mean([set(a[a >= 0]) == set(b[b >= 0])
                    for a, b in zip(jadj, tadj)])
    print(f"SQ-int8 build: {same:.4f} of rows with the JAX graph's "
          "neighbour set")
    assert same >= 0.9, same
    gt = jexh(data, queries, 10)
    for window in (10, 16, 24):
        jindex.search_window_size = window
        tindex.search_window_size = window
        rj = k_recall_at_n(gt, jindex.search(queries, 10))
        rt = svt.k_recall_at_n(gt, tindex.search(queries, 10))
        assert abs(rt - rj) <= 0.01, (window, rt, rj)
    np.testing.assert_allclose(tv.reconstruct_at([3, 7]),
                               jindex.reconstruct_at([3, 7]), atol=1e-6)


def test_sq_packed_serving_matches_jax(sq_builds):
    """bf16 packed rows over SQ data, re-scored against the decoded rows at
    the end, on the JAX graph in both packages."""
    _data, queries, jindex, _tv = sq_builds
    tindex = interop.vamana_from_arrays(
        interop.sq_from_arrays(np.asarray(jindex.data.codes),
                               np.asarray(jindex.data.scale),
                               np.asarray(jindex.data.bias), n=jindex.size,
                               dim=jindex.dimensions, device="cpu"),
        np.asarray(jindex.graph.adjacency), np.asarray(jindex.graph.degrees),
        jindex.entry_point, "l2", device="cpu")
    jindex.enable_packed_serving()
    tindex.enable_packed_serving()
    try:
        for index in (jindex, tindex):
            index.search_window_size = 16
        want, got = jindex.search(queries, 10), tindex.search(queries, 10)
    finally:
        jindex.disable_packed_serving()
    same = np.sort(got.ids, 1) == np.sort(want.ids, 1)
    assert same.mean() >= 0.98, same.mean()
    np.testing.assert_allclose(np.sort(got.distances, 1),
                               np.sort(want.distances, 1), rtol=1e-3,
                               atol=1e-3)


@pytest.mark.parametrize("dtype", ["float16", "int8"])
def test_vamana_build_over_dtype_matches_jax(dtype):
    """Vamana.build / search with rows stored as float16 or int8 in both
    packages (the port builds through the scored route): the adjacency
    equals the JAX build's (exactly, when measured; held to 98% of rows),
    recall within 0.01, and the JAX index's graph searched through the port
    gives the JAX search's ids."""
    data, queries = generate_test_dataset(600, 60, 48, seed=7)
    rows = data * 20 if dtype == "int8" else data
    jv = JVamana.build(JParams(**PARAMS), rows, "l2", dtype=dtype)
    tv = svt.Vamana.build(svt.VamanaBuildParameters(**PARAMS), rows, "l2",
                          dtype=dtype, device="cpu")
    assert tv.index.data.dtype == getattr(torch, dtype)
    jadj = np.asarray(jv.index.graph.adjacency)[:600]
    tadj = tv.index.graph.adjacency.numpy()[:600]
    same = np.mean([set(a[a >= 0]) == set(b[b >= 0])
                    for a, b in zip(jadj, tadj)])
    assert same >= 0.98, same
    q = queries * (20 if dtype == "int8" else 1)
    gt = jexh(rows, q, 10)
    jv.search_window_size = tv.search_window_size = 16
    want = jv.search(q, 10)
    rj = k_recall_at_n(gt, want)
    rt = svt.k_recall_at_n(gt, tv.search(q, 10))
    assert abs(rt - rj) <= 0.01, (rt, rj)
    carried = interop.vamana_from_arrays(
        np.asarray(jv.index.data.vectors)[:600, :48],
        np.asarray(jv.index.graph.adjacency),
        np.asarray(jv.index.graph.degrees), jv.index.entry_point, "l2",
        dtype=dtype, device="cpu")
    carried.search_window_size = 16
    same = np.sort(carried.search(q, 10).ids, 1) == np.sort(want.ids, 1)
    assert same.mean() >= 0.98, same.mean()
