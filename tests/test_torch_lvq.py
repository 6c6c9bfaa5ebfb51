"""LVQ compression of the PyTorch port against the JAX package.

The same numpy inputs go through the JAX package's ``quantization/lvq.py``,
``beam_step_lvq`` and LVQ serving, and through their port counterparts on
the CPU (where ``beam_step_lvq`` runs its plain PyTorch version).  Graphs
and datasets carry across with ``interop``, so both packages search one
graph.  The CUDA kernel needs the card: its tests are in
``test_torch_gpu.py``.
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
from scalablevectorsearch_tpu.index.vamana.index import VamanaIndex as JIndex
from scalablevectorsearch_tpu.index.vamana.params import (
    VamanaBuildParameters as JParams)
from scalablevectorsearch_tpu.ops.pallas.beam_step import (
    beam_step_lvq as jbeam_step_lvq, beam_step_reference)
from scalablevectorsearch_tpu.quantization.lvq import LVQDataset as JLVQ

import scalablevectorsearch_tpu_torch as svt
from scalablevectorsearch_tpu_torch import interop
from scalablevectorsearch_tpu_torch.index.vamana import search as tsearch
from scalablevectorsearch_tpu_torch.index.vamana.packed import (
    PackedLVQNeighborhoods)
from scalablevectorsearch_tpu_torch.ops.kernels import beam_step as bs
from scalablevectorsearch_tpu_torch.quantization.lvq import LVQDataset

from test_torch_beam_step import assert_same_step, make_case

torch.set_num_threads(1)

KINDS = [(8, 0), (8, 8), (4, 0), (4, 8)]
PARAMS = dict(graph_max_degree=16, window_size=24,
              max_candidate_pool_size=60, prune_to=14, alpha=1.1)


def carry_lvq(j):
    """The port's LVQDataset over a JAX LVQDataset's state."""
    return interop.lvq_from_arrays(
        np.asarray(j.codes), np.asarray(j.scales), np.asarray(j.biases),
        np.asarray(j.mean), n=j.n, dim=j.dim, bits=j.bits,
        residual_bits=j.residual_bits, res_codes=np.asarray(j.res_codes),
        res_scales=np.asarray(j.res_scales), device="cpu")


def carry_index(jindex):
    """The port's VamanaIndex over a JAX LVQ index's state."""
    return interop.vamana_from_arrays(
        carry_lvq(jindex.data), np.asarray(jindex.graph.adjacency),
        np.asarray(jindex.graph.degrees), jindex.entry_point,
        jindex.distance.value, device="cpu")


@pytest.mark.parametrize("bits,res", KINDS)
def test_compress_matches_jax_bit_for_bit(bits, res):
    x = np.random.default_rng(bits + res).normal(size=(300, 52)) \
        .astype(np.float32) * 3
    j = JLVQ.compress(x, bits=bits, residual_bits=res)
    t = LVQDataset.compress(x, bits=bits, residual_bits=res, device="cpu")
    assert t.kind == j.kind and t.capacity == j.capacity
    assert t.padded_dim == j.padded_dim
    for name in ("codes", "scales", "biases", "mean", "norms_sq",
                 "res_codes", "res_scales", "full_norms_sq"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)),
                                      err_msg=name)
    # carried across, the norms are recomputed as compress computes them
    c = carry_lvq(j)
    for name in ("codes", "norms_sq", "full_norms_sq", "res_codes"):
        np.testing.assert_array_equal(getattr(c, name).numpy(),
                                      np.asarray(getattr(j, name)),
                                      err_msg=name)


@pytest.mark.parametrize("bits,res", KINDS)
def test_decode_and_tile_keys_match_jax(bits, res):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(300, 52)).astype(np.float32)
    j = JLVQ.compress(x, bits=bits, residual_bits=res)
    t = LVQDataset.compress(x, bits=bits, residual_bits=res, device="cpu")
    ids = rng.integers(-1, 320, size=(4, 9)).astype(np.int32)
    for name in ("get", "get_full"):
        np.testing.assert_allclose(
            getattr(t, name)(torch.from_numpy(ids)).numpy(),
            np.asarray(getattr(j, name)(jnp.asarray(ids))), rtol=1e-5,
            atol=1e-5, err_msg=name)
    np.testing.assert_allclose(t.to_numpy(), j.to_numpy(), rtol=1e-5,
                               atol=1e-5)
    q = np.zeros((6, t.padded_dim), np.float32)
    q[:, :52] = rng.normal(size=(6, 52))
    qn = (q * q).sum(1)
    for distance in ("L2", "MIP", "Cosine"):
        want = np.asarray(j.tile_keys(jnp.asarray(q), jnp.asarray(qn), 64,
                                      128, distance))
        got = t.tile_keys(torch.from_numpy(q), torch.from_numpy(qn), 64, 128,
                          distance).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4,
                                   err_msg=distance)
        got_full = t.full_view().tile_keys(
            torch.from_numpy(q), torch.from_numpy(qn), 64, 128,
            distance).numpy()
        want_full = np.asarray(j.full_view().tile_keys(
            jnp.asarray(q), jnp.asarray(qn), 64, 128, distance))
        np.testing.assert_allclose(got_full, want_full, rtol=1e-5,
                                   atol=1e-4, err_msg=distance)


def lvq_case(rng, B, C, K, dim, d_pad=128):
    """beam_step_lvq inputs as tests/test_pallas.py builds them: live-lane
    codes, per-id scales and biases, a mean and queries zero in the dead
    lanes (``n_dead = d_pad - dim``)."""
    bk, bp, _vecs, cids, _q = make_case(rng, B, C, K, d_pad)
    n_ids = 400
    codes = rng.integers(-128, 128, size=(n_ids, d_pad)).astype(np.int8)
    codes[:, dim:] = 0
    scales = rng.uniform(0.01, 0.1, size=n_ids).astype(np.float32)
    biases = rng.normal(size=n_ids).astype(np.float32)
    mean = np.zeros(d_pad, np.float32)
    mean[:dim] = rng.normal(size=dim)
    q = np.zeros((B, d_pad), np.float32)
    q[:, :dim] = rng.normal(size=(B, dim))
    cl = np.maximum(cids, 0)
    return (bk, bp, codes[cl], scales[cl], biases[cl], mean[None, :], cids,
            q)


@pytest.mark.parametrize("metric", [0, 1, 2])
def test_beam_step_lvq_plain_matches_jax(rng, metric):
    B, C, K, dim, window, m = 8, 8, 16, 48, 8, 2
    case = lvq_case(rng, B, C, K, dim)
    bk, bp, codes, sc, bi, mean, cids, q = case
    kw = dict(metric=metric, window=window, m=m)
    n_dead = 128 - dim
    ref = beam_step_reference(
        jnp.asarray(bk), jnp.asarray(bp), jnp.asarray(codes),
        jnp.asarray(cids), jnp.asarray(q),
        decode=(jnp.asarray(sc), jnp.asarray(bi), jnp.asarray(mean),
                n_dead), **kw)
    kern = jbeam_step_lvq(*(jnp.asarray(x) for x in case), n_dead=n_dead,
                          interpret=True, block_rows=8, **kw)
    before = bs.beam_step_lvq.launches
    got = bs.beam_step_lvq(*(torch.from_numpy(x) for x in case),
                           n_dead=n_dead, **kw)
    assert bs.beam_step_lvq.launches == before      # CPU: plain, no launch
    got = [x.numpy() for x in got]
    assert_same_step(got, ref, 1e-5)
    assert_same_step(got, kern, 1e-5)


@pytest.fixture(scope="module")
def lvq8_graph():
    """A JAX index built over JAX LVQ-8 data (600 rows), and the port's
    over its state."""
    data, queries = generate_test_dataset(600, 60, 48, seed=7)
    jindex = JIndex.build(JParams(**PARAMS), JLVQ.compress(data, bits=8),
                          "l2")
    return data, queries, jindex, carry_index(jindex)


def test_greedy_search_lvq8_matches_jax_kernel_branch(lvq8_graph,
                                                      monkeypatch):
    """Unpacked LVQ-8 on one graph: the port's loop on beam_step_lvq
    against the JAX kernel branch (beam_step_lvq in interpret mode)."""
    _data, queries, jindex, tindex = lvq8_graph
    q = np.zeros((queries.shape[0], 128), np.float32)
    q[:, :48] = queries
    entries = np.full((1,), jindex.entry_point, np.int32)
    kw = dict(window=12, capacity=16, max_iters=40, distance="L2",
              pool_size=24, tail_frac=4)
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
    same = np.sort(want.ids, 1) == np.sort(got.ids.numpy(), 1)
    assert same.mean() >= 0.98, same.mean()
    exact = want.ids == got.ids.numpy()
    np.testing.assert_allclose(got.keys.numpy()[exact], want.keys[exact],
                               rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def served(lvq8_graph):
    """JAX LVQ indexes (LVQ-8, LVQ-4, two-level LVQ8x8) over the LVQ-8
    graph, as the JAX bench serves compressed data over a built graph, and
    the port's indexes over the same state."""
    data, queries, base, _ = lvq8_graph
    out = {}
    for bits, res in ((8, 0), (4, 0), (8, 8)):
        jindex = JIndex(base.graph, JLVQ.compress(
            data, bits=bits, residual_bits=res), base.entry_point, "l2")
        out[(bits, res)] = (jindex, carry_index(jindex))
    return data, queries, out


@pytest.mark.parametrize("bits,res", [(8, 0), (4, 0), (8, 8)])
def test_serving_matches_jax(served, bits, res):
    """Packed LVQ serving (and, for LVQ8x8, the two-level rerank over the
    retained beam) agrees with the JAX package's on one graph."""
    _data, queries, indexes = served
    jindex, tindex = indexes[(bits, res)]
    jindex.enable_packed_serving()
    tindex.enable_packed_serving()
    assert isinstance(tindex._packed, PackedLVQNeighborhoods)
    try:
        for window in (16,):
            jindex.search_window_size = window
            tindex.search_window_size = window
            want = jindex.search(queries, 10)
            got = tindex.search(queries, 10)
            same = np.sort(got.ids, 1) == np.sort(want.ids, 1)
            assert same.mean() >= 0.98, (window, same.mean())
            np.testing.assert_allclose(np.sort(got.distances, 1),
                                       np.sort(want.distances, 1),
                                       rtol=1e-3, atol=1e-3)
    finally:
        jindex.disable_packed_serving()
        tindex.disable_packed_serving()


@pytest.mark.parametrize("bits,res", [(8, 0), (4, 0), (8, 8)])
def test_packed_serving_bit_identical_to_unpacked(served, bits, res):
    """Both LVQ routes of a kind feed the same codes to the same step, so
    packed and unpacked serving agree exactly at every window."""
    _data, queries, indexes = served
    tindex = indexes[(bits, res)][1]
    for window in (8, 16, 32):
        tindex.search_window_size = window
        plain = tindex.search(queries, 10)
        tindex.enable_packed_serving()
        try:
            packed = tindex.search(queries, 10)
        finally:
            tindex.disable_packed_serving()
        np.testing.assert_array_equal(plain.ids, packed.ids)
        np.testing.assert_array_equal(plain.distances, packed.distances)


def test_two_level_explicit_split_matches_jax(served, monkeypatch):
    """LVQ8x8 with an explicit window/capacity split (12, 20): both packages
    retain the 20 slots given, not the 2x window a defaulted config
    retains, and agree on the ids."""
    from scalablevectorsearch_tpu.index.vamana import params as jparams
    from scalablevectorsearch_tpu_torch.index.vamana import index as tindex
    _data, queries, indexes = served
    jindex, tv = indexes[(8, 8)]
    capacities = []

    def spy(*args, capacity, **kwargs):
        capacities.append(capacity)
        return greedy_search(*args, capacity=capacity, **kwargs)

    greedy_search = tindex.search_mod.greedy_search
    monkeypatch.setattr(tindex.search_mod, "greedy_search", spy)
    split = jparams.VamanaSearchParameters(
        buffer_config=jparams.SearchBufferConfig(12, 20))
    want = jindex.search(queries, 10, parameters=split)
    got = tv.search(queries, 10, parameters=svt.VamanaSearchParameters(
        buffer_config=svt.SearchBufferConfig(12, 20)))
    tv.search_window_size = 12
    tv.search(queries, 10)
    assert capacities == [20, 24]
    same = np.sort(got.ids, 1) == np.sort(want.ids, 1)
    assert same.mean() >= 0.98, same.mean()
    np.testing.assert_allclose(np.sort(got.distances, 1),
                               np.sort(want.distances, 1), rtol=1e-3,
                               atol=1e-3)


def test_lvq8_build_matches_jax_build(lvq8_graph):
    """The port's LVQ-8 build on the CPU against the JAX build on the same
    data: recall within 0.01 at three windows; mean degree within 2%."""
    data, queries, jindex, _ = lvq8_graph
    tv = svt.Vamana.build(svt.VamanaBuildParameters(**PARAMS),
                          LVQDataset.compress(data, bits=8, device="cpu"),
                          "l2")
    tindex = tv.index
    assert tindex.data.device.type == "cpu"
    jdeg, tdeg = jindex.graph.mean_degree(), tindex.graph.mean_degree()
    assert abs(tdeg - jdeg) <= 0.02 * jdeg, (tdeg, jdeg)
    # the port scores LVQ-8 codes with the dead-lane correction where the
    # JAX build scores decoded rows, so rounding may move a few rows
    n = jindex.size
    jadj = np.asarray(jindex.graph.adjacency)[:n]
    tadj = tindex.graph.adjacency.numpy()[:n]
    same = np.mean([set(a[a >= 0]) == set(b[b >= 0])
                    for a, b in zip(jadj, tadj)])
    print(f"LVQ-8 build: adjacency identical {np.array_equal(jadj, tadj)}, "
          f"{same:.4f} of rows with the JAX graph's neighbour set")
    assert same >= 0.95, same
    gt = jexh(data, queries, 10)
    for window in (10, 16, 24):
        jindex.search_window_size = window
        tindex.search_window_size = window
        rj = k_recall_at_n(gt, jindex.search(queries, 10))
        rt = svt.k_recall_at_n(gt, tindex.search(queries, 10))
        assert abs(rt - rj) <= 0.01, (window, rt, rj)
    np.testing.assert_allclose(tv.reconstruct_at([3, 7]),
                               jindex.reconstruct_at([3, 7]), atol=1e-5)


def test_flat_index_over_lvq_matches_jax():
    from scalablevectorsearch_tpu.index.flat import FlatIndex as JFlat
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(500, 48)) * 3).astype(np.float32)
    q = (rng.normal(size=(20, 48)) * 3).astype(np.float32)
    for distance in ("l2", "mip", "cosine"):
        want = JFlat(JLVQ.compress(x), distance, data_batch_size=256) \
            .search(q, 10)
        got = svt.FlatIndex(LVQDataset.compress(x, device="cpu"), distance,
                            data_batch_size=256).search(q, 10)
        assert (np.sort(got.ids, 1) == np.sort(want.ids, 1)).mean() >= 0.98
    with pytest.raises(TypeError, match="dataset protocol"):
        svt.FlatIndex(np.zeros((4, 4), np.float32), "l2")
