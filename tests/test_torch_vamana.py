"""Vamana search and build of the PyTorch port against the JAX package.

The JAX index's state (rows, adjacency, degrees, entry point, sampler ids)
is carried into the port with ``interop.vamana_from_arrays``, so both
packages search one graph; the whole slice (build + search) is compared by
recall and mean degree, since graphs differ where sort ties break
differently.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scalablevectorsearch_tpu.core.io import generate_test_dataset
from scalablevectorsearch_tpu.core.recall import k_recall_at_n
from scalablevectorsearch_tpu.index.flat import exhaustive_search as jexh
from scalablevectorsearch_tpu.index.vamana import search as jsearch
from scalablevectorsearch_tpu.index.vamana.params import (
    VamanaBuildParameters as JParams)
from scalablevectorsearch_tpu.orchestrators.vamana import Vamana as JVamana

import scalablevectorsearch_tpu_torch as svt
from scalablevectorsearch_tpu_torch import interop
from scalablevectorsearch_tpu_torch.index.vamana import search as tsearch

torch.set_num_threads(1)


def carry(jindex, **kw):
    """The port's VamanaIndex over a JAX index's state."""
    sampler = jindex._entry_sampler
    return interop.vamana_from_arrays(
        np.asarray(jindex.data.vectors)[: jindex.size, : jindex.dimensions],
        np.asarray(jindex.graph.adjacency), np.asarray(jindex.graph.degrees),
        jindex.entry_point, jindex.distance.value,
        sampler_ids=None if sampler is None else np.asarray(sampler.ids),
        device="cpu", **kw)


@pytest.fixture(scope="module")
def fixed_graph():
    data, queries = generate_test_dataset(500, 40, 48, seed=7)
    params = JParams(graph_max_degree=16, window_size=24,
                     max_candidate_pool_size=60, prune_to=14, alpha=1.2)
    jindex = JVamana.build(params, data, "l2").index
    return data, queries, jindex, carry(jindex)


@pytest.mark.parametrize("pool_size,visited_size", [(0, 0), (40, 0),
                                                    (0, 64)])
def test_greedy_search_matches_jax_kernel_branch(fixed_graph, monkeypatch,
                                                 pool_size, visited_size):
    """One graph, one set of entries: the port's loop on beam_step_plain
    against the JAX kernel branch (interpret mode), serving, build-pool
    tracking and the visited ring."""
    data, queries, jindex, tindex = fixed_graph
    q = np.zeros((queries.shape[0], 128), np.float32)
    q[:, :48] = queries
    entries = np.full((1,), jindex.entry_point, np.int32)
    kw = dict(window=20, capacity=24, max_iters=56, distance="L2",
              pool_size=pool_size, tail_frac=4, visited_size=visited_size)
    monkeypatch.setenv("SVT_FORCE_BEAM_KERNEL", "1")
    jax.clear_caches()  # the env is read at trace time
    try:
        want = jsearch.greedy_search(jindex.graph, jindex.data,
                                     jnp.asarray(q), jnp.asarray(entries),
                                     **kw)
        want = jax.tree_util.tree_map(np.asarray, want)
    finally:
        monkeypatch.delenv("SVT_FORCE_BEAM_KERNEL")
        jax.clear_caches()
    got = tsearch.greedy_search(tindex.graph, tindex.data,
                                torch.from_numpy(q), torch.from_numpy(entries),
                                **kw)
    ids_j, ids_t = np.sort(want.ids, 1), np.sort(got.ids.numpy(), 1)
    assert (ids_j == ids_t).mean() >= 0.98
    same = want.ids == got.ids.numpy()
    np.testing.assert_allclose(got.keys.numpy()[same], want.keys[same],
                               rtol=1e-4, atol=1e-4)
    if pool_size:
        overlap = [len(set(a[a >= 0]) & set(b[b >= 0]))
                   / max(len(set(a[a >= 0])), 1)
                   for a, b in zip(want.pool_ids, got.pool_ids.numpy())]
        assert np.mean(overlap) >= 0.98


@pytest.fixture(scope="module")
def slice_indexes():
    data, queries = generate_test_dataset(2000, 100, 48, seed=7)
    kw = dict(graph_max_degree=16, window_size=32,
              max_candidate_pool_size=64, prune_to=14)
    jv = JVamana.build(JParams(**kw), data, "l2", sampled_entries=True)
    tv = svt.Vamana.build(svt.VamanaBuildParameters(**kw), data, "l2",
                          sampled_entries=True, device="cpu")
    gt = jexh(data, queries, 10)
    return data, queries, gt, jv, tv


def test_build_and_search_slice_matches_jax(slice_indexes):
    data, queries, gt, jv, tv = slice_indexes
    jdeg = jv.index.graph.mean_degree()
    assert abs(tv.index.graph.mean_degree() - jdeg) <= 0.1 * jdeg
    gt_t = svt.exhaustive_search(data, queries, 10, device="cpu")
    np.testing.assert_array_equal(gt_t.ids, gt.ids)
    for window in (16, 32):
        jv.search_window_size = window
        tv.search_window_size = window
        rj = k_recall_at_n(gt, jv.search(queries, 10))
        rt = svt.k_recall_at_n(gt_t, tv.search(queries, 10))
        assert abs(rt - rj) <= 0.05, (window, rt, rj)


def test_search_on_carried_graph_matches_jax(slice_indexes):
    """The JAX-built graph searched through the port's VamanaIndex gives
    the JAX search's ids (sampled entries, f16 query upload on both)."""
    _data, queries, _gt, jv, _tv = slice_indexes
    tindex = carry(jv.index)
    for window in (16, 32):
        jv.search_window_size = window
        tindex.search_window_size = window
        want = jv.search(queries, 10)
        got = tindex.search(queries, 10)
        same = np.sort(got.ids, 1) == np.sort(want.ids, 1)
        assert same.mean() >= 0.98, (window, same.mean())
        np.testing.assert_allclose(np.sort(got.distances, 1),
                                   np.sort(want.distances, 1), rtol=1e-3,
                                   atol=1e-3)


def test_packed_bf16_serving_and_int8_upload(slice_indexes, monkeypatch):
    """bf16 packed neighborhoods (re-scored against the exact rows) and
    int8 query uploads keep recall on the port's own index."""
    data, queries, gt, _jv, tv = slice_indexes
    tv.search_window_size = 32
    base = svt.k_recall_at_n(gt, tv.search(queries, 10))
    tv.enable_packed_serving()
    try:
        packed = svt.k_recall_at_n(gt, tv.search(queries, 10))
        monkeypatch.setenv("SVT_QUERY_UPLOAD_DTYPE", "int8")
        int8 = svt.k_recall_at_n(gt, tv.search(queries, 10))
    finally:
        tv.disable_packed_serving()
    assert packed >= base - 0.02 and int8 >= base - 0.05
    vec = tv.reconstruct_at([3])[0]
    np.testing.assert_array_equal(vec, data[3])


def test_bf16_dataset_search_matches_jax():
    """A bf16 dataset carried across (ml_dtypes rows through a uint16
    view) searches like the JAX index over the same rows and graph."""
    data, queries = generate_test_dataset(600, 30, 48, seed=3)
    params = JParams(graph_max_degree=16, window_size=24,
                     max_candidate_pool_size=60, prune_to=14)
    jindex = JVamana.build(params, data, "l2", dtype="bfloat16").index
    tindex = carry(jindex)
    assert tindex.data.dtype == torch.bfloat16
    for index in (jindex, tindex):
        index.search_window_size = 16
    want, got = jindex.search(queries, 10), tindex.search(queries, 10)
    same = np.sort(got.ids, 1) == np.sort(want.ids, 1)
    assert same.mean() >= 0.98, same.mean()


def test_capacity_above_kernel_limit_raises(fixed_graph):
    """The beam kernels refuse more than 1024 slots; a search with a larger
    beam takes the wide route instead and gives the JAX search's ids."""
    from scalablevectorsearch_tpu_torch.ops.kernels.beam_update import (
        beam_update)
    _data, queries, jindex, tindex = fixed_graph
    beam = torch.full((2, 1100), float("inf"))
    ids = torch.full((2, 1100), -1, dtype=torch.int32)
    with pytest.raises(ValueError, match="1024"):
        beam_update(beam, ids, beam[:, :8], ids[:, :8], window=8, m=2)
    for index in (jindex, tindex):
        index.search_window_size = 1100
    try:
        want, got = jindex.search(queries, 10), tindex.search(queries, 10)
    finally:
        jindex.search_window_size = tindex.search_window_size = 20
    same = np.sort(got.ids, 1) == np.sort(want.ids, 1)
    assert same.mean() >= 0.98, same.mean()


def test_query_upload_dtype_attribute_overrides_env(slice_indexes,
                                                    monkeypatch):
    """A per-index ``query_upload_dtype`` wins over SVT_QUERY_UPLOAD_DTYPE
    in both packages: int8 uploads set on the index under a float32 env
    give the env's int8 search, and the JAX index's ids with the same
    settings."""
    _data, queries, _gt, jv, _tv = slice_indexes
    tindex = carry(jv.index)
    jv.search_window_size = tindex.search_window_size = 16
    monkeypatch.setenv("SVT_QUERY_UPLOAD_DTYPE", "int8")
    env_int8 = tindex.search(queries, 10)
    monkeypatch.setenv("SVT_QUERY_UPLOAD_DTYPE", "float32")
    f32 = tindex.search(queries, 10)
    jv.index.query_upload_dtype = tindex.query_upload_dtype = "int8"
    try:
        want, got = jv.search(queries, 10), tindex.search(queries, 10)
    finally:
        del jv.index.query_upload_dtype
    np.testing.assert_array_equal(got.ids, env_int8.ids)
    np.testing.assert_array_equal(got.distances, env_int8.distances)
    assert not np.array_equal(got.distances, f32.distances)
    same = np.sort(got.ids, 1) == np.sort(want.ids, 1)
    assert same.mean() >= 0.98, same.mean()


def test_int8_upload_with_host_rerank_matches_jax(slice_indexes):
    """int8 uploads with the exact host-side rerank of the fetched beam:
    the JAX index's ids with the same settings, the same exact distances
    where the ids agree, and no recall below int8 without the rerank.
    The port is given rows with extra columns, which it cuts off."""
    data, queries, gt, jv, _tv = slice_indexes
    tindex = carry(jv.index)
    jv.search_window_size = tindex.search_window_size = 16
    jv.index.query_upload_dtype = tindex.query_upload_dtype = "int8"
    try:
        plain = svt.k_recall_at_n(gt, tindex.search(queries, 10))
        jv.enable_host_rerank(data)
        tindex.enable_host_rerank(np.pad(data, ((0, 0), (0, 16))))
        want, got = jv.search(queries, 10), tindex.search(queries, 10)
    finally:
        jv.disable_host_rerank()
        del jv.index.query_upload_dtype
    same = np.sort(got.ids, 1) == np.sort(want.ids, 1)
    assert same.mean() >= 0.98, same.mean()
    exact = got.ids == want.ids
    np.testing.assert_allclose(got.distances[exact], want.distances[exact],
                               rtol=1e-6)
    assert svt.k_recall_at_n(gt, got) >= plain


@pytest.mark.parametrize("cut", ["columns", "rows", "flat"])
def test_host_rerank_rejects_host_vectors_of_wrong_shape(slice_indexes,
                                                         cut):
    data, _queries, _gt, _jv, tv = slice_indexes
    bad = {"columns": data[:, :-1], "rows": data[:-1],
           "flat": data.reshape(-1)}[cut]
    with pytest.raises(ValueError, match="host_vectors"):
        tv.enable_host_rerank(bad)
    assert tv.index._host_rerank is None
