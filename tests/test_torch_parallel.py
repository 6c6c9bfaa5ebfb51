"""The PyTorch port's multi-device package on a mesh of 8 x "cpu".

Every sharded result is held to the port's single-device result: bit for
bit in ids and keys wherever both compute the same keys (8 shards against
1 and 2, float16 and SQ searches, the dp paths, the streamed load, the
sharded dynamic index through add and consolidate, its entry point after
compact), and up to keys within 1e-5 relative where the single device
scores on another route (f32 and LVQ-8 rows take the beam-step kernels
there, the shard views ``beam_update``).  One case per public function is
held to the JAX package's single-device function, at least 98% of slots
agreeing (the routes differ).  The JAX package's ``shard_map`` functions
are not called here: its own tests hold them to its single-device ones.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from scalablevectorsearch_tpu.core.data import VectorDataset as JDataset
from scalablevectorsearch_tpu.core.graph import NeighborGraph as JGraph
from scalablevectorsearch_tpu.index.flat import exhaustive_search as jexh
from scalablevectorsearch_tpu.index.ivf.index import IVFIndex as JIVF
from scalablevectorsearch_tpu.index.ivf.params import (
    IVFBuildParameters as JIVFParams, IVFSearchParameters as JIVFSearch)
from scalablevectorsearch_tpu.index.vamana import build as jbuild
from scalablevectorsearch_tpu.index.vamana import dynamic as jdyn
from scalablevectorsearch_tpu.index.vamana import search as jsearch
from scalablevectorsearch_tpu.index.vamana.params import (
    VamanaBuildParameters as JParams)

import scalablevectorsearch_tpu_torch as svt
from scalablevectorsearch_tpu_torch import interop
from scalablevectorsearch_tpu_torch.core import io as core_io
from scalablevectorsearch_tpu_torch.core.data import VectorDataset
from scalablevectorsearch_tpu_torch.core.graph import NeighborGraph
from scalablevectorsearch_tpu_torch.index import flat as flat_mod
from scalablevectorsearch_tpu_torch.index.vamana import build as build_mod
from scalablevectorsearch_tpu_torch.index.vamana.dynamic import (
    MutableVamanaIndex)
from scalablevectorsearch_tpu_torch.index.vamana.entry import build_sampler
from scalablevectorsearch_tpu_torch.index.vamana.search import (
    default_max_iters, greedy_search)
from scalablevectorsearch_tpu_torch.lib.datatypes import pad_matrix
from scalablevectorsearch_tpu_torch.parallel import mesh as mesh_mod
from scalablevectorsearch_tpu_torch.parallel import sharded
from scalablevectorsearch_tpu_torch.parallel.dynamic import (
    ShardedMutableVamanaIndex)
from scalablevectorsearch_tpu_torch.quantization.lvq import LVQDataset
from scalablevectorsearch_tpu_torch.quantization.scalar import SQDataset

torch.set_num_threads(1)

CPU8 = ["cpu"] * 8
KW = dict(window=16, capacity=16, max_iters=40, distance="l2")
BUILD = dict(graph_max_degree=12, window_size=24, max_candidate_pool_size=48,
             prune_to=10)


def mesh(n=8, axis="shard"):
    return mesh_mod.make_mesh(n, axis, devices=CPU8)


def same_output(got, want, pool: bool = False):
    assert torch.equal(got.ids, want.ids)
    assert torch.equal(got.keys, want.keys)
    if pool:
        assert torch.equal(got.pool_ids, want.pool_ids)
        assert torch.equal(got.pool_keys, want.pool_keys)


def close_output(got, want):
    """Ids agree on >= 98% of sorted slots and keys of equal ids within
    1e-5 relative: the rounding of another route."""
    gi, wi = got.ids.numpy(), want.ids.numpy()
    assert (np.sort(gi, 1) == np.sort(wi, 1)).mean() >= 0.98
    same = (gi == wi) & (gi >= 0)
    np.testing.assert_allclose(got.keys.numpy()[same], want.keys.numpy()[same],
                               rtol=1e-5, atol=1e-5)


def random_index(n=2000, d=32, r=12, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    adj = rng.integers(0, n, size=(n, r)).astype(np.int32)
    q = pad_matrix(rng.normal(size=(16, d)).astype(np.float32))
    return (x, adj, q, VectorDataset.from_array(x, device="cpu"),
            NeighborGraph.from_array(adj, device="cpu"), torch.from_numpy(q))


class TestMesh:
    def test_shapes_and_layouts(self):
        m = mesh()
        assert m.shape == {"shard": 8} and m.lead == torch.device("cpu")
        with pytest.raises(ValueError):
            mesh_mod.make_mesh(9, devices=CPU8)
        m2 = mesh_mod.make_mesh_2d(2, 4, devices=CPU8)
        assert m2.shape == {"dp": 2, "shard": 4}
        assert len(m2.axis_devices("dp")) == 2
        assert len(mesh_mod.row_sharded(m2, "shard").devices) == 4
        assert len(mesh_mod.replicated(m2).devices) == 8
        with pytest.raises(ValueError):
            mesh_mod.make_mesh_2d(3, 3, devices=CPU8)

    def test_no_gpu_and_no_devices_raises(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(ValueError, match="no CUDA device"):
            mesh_mod.make_mesh(2)


class TestShardedFlat:
    @pytest.mark.parametrize("distance", ["l2", "mip"])
    def test_matches_single_device(self, distance):
        data, queries = svt.generate_test_dataset(3000, 40, 32, seed=11)
        ds = VectorDataset.from_array(data, device="cpu")
        q = torch.from_numpy(pad_matrix(queries))
        keys, ids = sharded.sharded_flat_search(
            mesh(), sharded.shard_dataset(ds, mesh()), q, 10, distance,
            tile=128)
        want_keys, want_ids = flat_mod.flat_search_kernel(
            ds, q, 10, 1000, svt.DistanceType(
                {"l2": "L2", "mip": "MIP"}[distance]))
        assert torch.equal(ids, want_ids) and torch.equal(keys, want_keys)
        gt = jexh(data, queries, 10, distance=distance)
        assert svt.k_recall_at_n(gt.ids, ids.numpy()[:40]) >= 0.999

    def test_global_ids_cover_all_shards(self):
        rng = np.random.default_rng(0)
        data = rng.normal(size=(800, 16)).astype(np.float32)
        ds = sharded.shard_dataset(VectorDataset.from_array(data,
                                                            device="cpu"),
                                   mesh())
        picks = np.arange(0, 800, 100)
        _keys, ids = sharded.sharded_flat_search(
            mesh(), ds, torch.from_numpy(pad_matrix(data[picks])), 1, "l2",
            tile=128)
        np.testing.assert_array_equal(ids.numpy()[: len(picks), 0], picks)


class TestDpSearch:
    @pytest.mark.parametrize("kind", ["f32", "lvq8", "float16"])
    def test_matches_single_device(self, kind):
        """The beam_step, beam_step_lvq and scored routes split 8 ways give
        one search's ids, keys, pools and pops."""
        _x, adj, *_ = random_index()
        data, queries = svt.generate_test_dataset(2000, 64, 32, seed=3)
        ds = {"f32": lambda: VectorDataset.from_array(data, device="cpu"),
              "lvq8": lambda: LVQDataset.compress(data, bits=8,
                                                  device="cpu"),
              "float16": lambda: VectorDataset.from_array(
                  data, dtype=torch.float16, device="cpu")}[kind]()
        graph = NeighborGraph.from_array(
            np.pad(adj, ((0, ds.capacity - 2000), (0, 0)),
                   constant_values=-1), n=2000, device="cpu")
        q = torch.from_numpy(pad_matrix(queries))
        entry = torch.tensor([0], dtype=torch.int32)
        kw = dict(KW, pool_size=24, tail_frac=4)
        single = greedy_search(graph, ds, q, entry, **kw)
        multi = sharded.dp_greedy_search(mesh(8, "dp"), graph, ds, q, entry,
                                         **kw)
        same_output(multi, single, pool=True)
        assert torch.equal(multi.n_pops, single.n_pops)
        assert multi.n_iters == single.n_iters

    def test_against_jax(self):
        x, adj, q, ds, graph, qt = random_index(seed=5)
        entry = np.asarray([0], np.int32)
        want = jsearch.greedy_search(JGraph.from_array(adj),
                                     JDataset.from_array(x), jnp.asarray(q),
                                     jnp.asarray(entry), **KW)
        got = sharded.dp_greedy_search(mesh(8, "dp"), graph, ds, qt,
                                       torch.from_numpy(entry), **KW)
        same = np.sort(got.ids.numpy(), 1) == np.sort(np.asarray(want.ids), 1)
        assert same.mean() >= 0.98


class TestDpBuildRound:
    def _round(self, round_fn, graph, ds, sampler=None):
        b = 64
        ids = torch.arange(100, 100 + b, dtype=torch.int32)
        valid = torch.arange(b) < 60
        return round_fn(
            graph, ds, ids, valid, torch.tensor([0], dtype=torch.int32),
            sampler, None if sampler is None else torch.zeros(
                sampler.ids.shape[0], dtype=torch.bool),
            window=16, capacity=16, max_iters=default_max_iters(16),
            distance=svt.DistanceType.L2, pool_size=32, gen_alpha=1.2,
            rev_alpha=1.2, prune_to=8, max_degree=8, prune_chunk=8,
            tail_frac=4)

    @pytest.mark.parametrize("sampled", [False, True])
    def test_equals_build_round(self, sampled):
        data, _ = svt.generate_test_dataset(512, 8, 16, seed=5)
        ds = VectorDataset.from_array(data, device="cpu")
        graph, _e = build_mod.build_graph(
            VectorDataset.from_array(data[:100], device="cpu"),
            svt.VamanaBuildParameters(graph_max_degree=8, window_size=16),
            "l2")
        graph = dataclasses.replace(graph.with_capacity(512), n=512)
        sampler = build_sampler(ds, 32) if sampled else None
        want, want_dropped = self._round(build_mod.build_round, graph, ds,
                                         sampler)
        got, dropped = self._round(
            lambda *a, **kw: sharded.dp_build_round(mesh(8, "dp"), *a, **kw),
            graph, ds, sampler)
        assert torch.equal(got.adjacency, want.adjacency)
        assert torch.equal(got.degrees, want.degrees)
        assert int(dropped) == int(want_dropped)
        assert int(got.degrees.max()) <= 8

    def test_against_jax(self):
        """One round over an empty graph: the JAX round's degree profile."""
        data, _ = svt.generate_test_dataset(512, 8, 16, seed=5)
        b = 64
        kw = dict(window=16, capacity=16, max_iters=default_max_iters(16),
                  pool_size=32, gen_alpha=1.2, rev_alpha=1.2, prune_to=8,
                  max_degree=8, prune_chunk=8)
        want, _ = jbuild.build_round(
            JGraph.empty(512, 8), JDataset.from_array(data),
            jnp.arange(b, dtype=jnp.int32), jnp.ones((b,), bool),
            jnp.asarray([0], jnp.int32), distance="l2", **kw)
        got, _ = sharded.dp_build_round(
            mesh(8, "dp"), NeighborGraph.empty(512, 8, device="cpu"),
            VectorDataset.from_array(data, device="cpu"),
            torch.arange(b, dtype=torch.int32), torch.ones(b, dtype=bool),
            torch.tensor([0], dtype=torch.int32),
            distance=svt.DistanceType.L2, **kw)
        jd, td = np.asarray(want.degrees[:b]), got.degrees[:b].numpy()
        assert td.max() <= 8 and td[1:].min() >= 1
        assert abs(td.mean() - jd.mean()) <= 0.1 * jd.mean()


class TestShardedIVF:
    @pytest.fixture(scope="class")
    def ivf(self):
        data, queries = svt.generate_test_dataset(3000, 40, 32, seed=13)
        j = JIVF.build(JIVFParams(num_centroids=60, num_iterations=4,
                                  training_fraction=0.5,
                                  is_hierarchical=False), data, "l2")
        t = interop.ivf_from_arrays(
            np.asarray(j.centroids), np.asarray(j.data.vectors)[
                :, : j.data.dim], np.asarray(j.ids_padded), j.slot, j.n,
            j.num_centroids, "l2", device="cpu")
        t.query_upload_dtype = "float32"
        return j, t, queries

    @pytest.mark.parametrize("n_shards", [8, 3])
    @pytest.mark.parametrize("scan", ["1", "0"])
    def test_matches_single_device(self, ivf, n_shards, scan, monkeypatch):
        """60 probe units over 8 shards (the last owns 4) or 3, both scan
        routes: the single-device search's ids and distances."""
        monkeypatch.setenv("SVT_IVF_SCAN_LAYOUT", scan)
        _j, t, queries = ivf
        want = t.search(queries, 10, svt.IVFSearchParameters(n_probes=16))
        keys, ids = sharded.sharded_ivf_search(
            mesh(n_shards), t, torch.from_numpy(pad_matrix(queries)), 10,
            n_probes=16)
        np.testing.assert_array_equal(ids.numpy()[:40], want.ids)
        np.testing.assert_array_equal(keys.numpy()[:40], want.distances)

    def test_against_jax(self, ivf, monkeypatch):
        monkeypatch.setenv("SVT_QUERY_UPLOAD_DTYPE", "float32")
        j, t, queries = ivf
        want = j.search(queries, 10, JIVFSearch(n_probes=16))
        _keys, ids = sharded.sharded_ivf_search(
            mesh(), t, torch.from_numpy(pad_matrix(queries)), 10,
            n_probes=16)
        assert (ids.numpy()[:40] == want.ids).mean() > 0.98


class TestShardedGraph:
    @pytest.mark.parametrize("n_shards", [1, 2, 8])
    def test_search_bit_identical(self, n_shards):
        _x, _adj, _q, data, graph, q = random_index()
        eids = torch.tensor([0], dtype=torch.int32)
        ref = greedy_search(graph, data, q, eids, **KW)
        out = sharded.sharded_greedy_search(mesh(n_shards), graph, data, q,
                                            eids, **KW)
        same_output(out, ref)

    def test_search_with_sampler_bit_identical(self):
        _x, _adj, _q, data, graph, q = random_index()
        sampler = build_sampler(data, 64, seed=2)
        ref = greedy_search(graph, data, q, sampler.select("l2", q), **KW)
        zero = torch.tensor([0], dtype=torch.int32)
        out = sharded.sharded_greedy_search(mesh(), graph, data, q, zero,
                                            sampler=sampler, **KW)
        same_output(out, ref)
        out_dp = sharded.dp_greedy_search(mesh(8, "dp"), graph, data, q,
                                          zero, sampler=sampler, **KW)
        same_output(out_dp, ref)

    def test_search_with_pool_tracking(self):
        _x, _adj, _q, data, graph, q = random_index()
        eids = torch.tensor([0], dtype=torch.int32)
        kw = dict(KW, pool_size=32)
        ref = greedy_search(graph, data, q, eids, **kw)
        out = sharded.sharded_greedy_search(mesh(), graph, data, q, eids,
                                            **kw)
        same_output(out, ref, pool=True)

    def test_search_against_jax(self):
        x, adj, q, _data, graph, qt = random_index(seed=4)
        want = jsearch.greedy_search(
            JGraph.from_array(adj), JDataset.from_array(x), jnp.asarray(q),
            jnp.asarray([0], jnp.int32), **KW)
        got = sharded.sharded_greedy_search(
            mesh(), graph, VectorDataset.from_array(x, device="cpu"), qt,
            torch.tensor([0], dtype=torch.int32), **KW)
        same = np.sort(got.ids.numpy(), 1) == np.sort(np.asarray(want.ids), 1)
        assert same.mean() >= 0.98

    @pytest.mark.parametrize("knobs", [
        dict(), dict(first_pass_window=12, tail_frac=4, prune_pool=32),
        dict(sampled_entries=True)], ids=["plain", "knobs", "sampled"])
    def test_build_identical_graph(self, knobs):
        """8 shards (and 2, plain) build the single-device graph: plain,
        with build_graph's levers, with sampled entries."""
        _x, _adj, _q, data, _g, _ = random_index(n=600)
        params = svt.VamanaBuildParameters(**BUILD)
        g_one, e_one = build_mod.build_graph(data, params, "l2",
                                             batch_size=128, **knobs)
        for n_shards in ((8,) if knobs else (2, 8)):
            g_sh, e_sh = sharded.sharded_build_graph(
                mesh(n_shards), data, params, "l2", batch_size=128, **knobs)
            assert e_sh == e_one
            assert torch.equal(g_sh.adjacency, g_one.adjacency)
            assert torch.equal(g_sh.degrees, g_one.degrees)

    def test_build_against_jax(self):
        data, queries = svt.generate_test_dataset(600, 50, 24, seed=21)
        g_j, e_j = jbuild.build_graph(JDataset.from_array(data),
                                      JParams(**BUILD), "l2", batch_size=128)
        g_t, e_t = sharded.sharded_build_graph(
            mesh(), data, svt.VamanaBuildParameters(**BUILD), "l2",
            batch_size=128)
        assert e_t == e_j
        jd = g_j.mean_degree()
        assert abs(g_t.mean_degree() - jd) <= 0.1 * jd
        gt = jexh(data, queries, 10)
        q = torch.from_numpy(pad_matrix(queries))
        out = greedy_search(g_t, VectorDataset.from_array(data, device="cpu"),
                            q, torch.tensor([e_t], dtype=torch.int32),
                            window=32, capacity=32,
                            max_iters=default_max_iters(32), distance="l2")
        want = jsearch.greedy_search(
            g_j, JDataset.from_array(data), jnp.asarray(q.numpy()),
            jnp.asarray([e_j], jnp.int32), window=32, capacity=32,
            max_iters=default_max_iters(32), distance="l2")
        rt = svt.k_recall_at_n(gt.ids, out.ids.numpy()[:50, :10])
        rj = svt.k_recall_at_n(gt.ids, np.asarray(want.ids)[:50, :10])
        assert abs(rt - rj) <= 0.05, (rt, rj)


class TestShardAtLoad:
    def test_streamed_matches_host_staged(self, tmp_path):
        rng = np.random.default_rng(3)
        x = rng.normal(size=(1003, 20)).astype(np.float32)
        path = str(tmp_path / "x.fvecs")
        core_io.write_vecs(path, x)
        # block_rows=37: ragged blocks, bounds that do not divide
        streamed = sharded.shard_dataset_from_file(path, mesh(),
                                                   block_rows=37)
        staged = sharded.shard_dataset(
            VectorDataset.from_array(core_io.read_vecs(path), device="cpu"),
            mesh())
        assert (streamed.n, streamed.dim, streamed.capacity) == \
            (staged.n, staged.dim, staged.capacity)
        for a, b in zip(streamed.shards, staged.shards):
            assert torch.equal(a.vectors, b.vectors)
            assert torch.equal(a.norms_sq, b.norms_sq)
        want = JDataset.from_array(x)
        got = streamed.gather()
        np.testing.assert_array_equal(got.vectors.numpy()[:want.capacity],
                                      np.asarray(want.vectors))
        np.testing.assert_allclose(got.norms_sq.numpy()[:1003],
                                   np.asarray(want.norms_sq)[:1003],
                                   rtol=1e-6)

    def test_streamed_build_matches_host_staged(self, tmp_path):
        data, _ = svt.generate_test_dataset(601, 8, 24, seed=21)
        path = str(tmp_path / "d.fvecs")
        core_io.write_vecs(path, data)
        params = svt.VamanaBuildParameters(**BUILD)
        g_sh, e_sh = sharded.sharded_build_graph(mesh(), path, params, "l2",
                                                 batch_size=128)
        g_one, e_one = build_mod.build_graph(
            VectorDataset.from_array(data, device="cpu"), params, "l2",
            batch_size=128)
        assert e_sh == e_one
        assert torch.equal(g_sh.adjacency, g_one.adjacency)

    def test_ranged_reads_match_full_read(self, tmp_path):
        rng = np.random.default_rng(4)
        x = (rng.normal(size=(101, 7)) * 10).astype(np.float32)
        path = str(tmp_path / "r.fvecs")
        core_io.write_vecs(path, x)
        assert core_io.probe_vecs_shape(path) == (101, 7)
        np.testing.assert_array_equal(core_io.read_vecs_rows(path, 40, 30),
                                      x[40:70])
        np.testing.assert_array_equal(core_io.read_vecs_rows(path, 90, 50),
                                      x[90:])
        assert core_io.read_vecs_rows(path, 101, 5).shape == (0, 7)


class TestShardedCompressed:
    def _graph_queries(self, n, d, r, seed=7):
        rng = np.random.default_rng(seed)
        x = rng.normal(size=(n, d)).astype(np.float32)
        adj = rng.integers(0, n, size=(n, r)).astype(np.int32)
        return x, adj, rng.normal(size=(16, d)).astype(np.float32)

    def _graph(self, adj, capacity):
        return NeighborGraph.from_array(
            np.pad(adj, ((0, capacity - adj.shape[0]), (0, 0)),
                   constant_values=-1), n=adj.shape[0], device="cpu")

    @pytest.mark.parametrize("bits,residual", [(8, 0), (4, 8), (8, 8)])
    def test_lvq_search(self, bits, residual):
        """8 shards equal 1 and 2 bit for bit; against one device (LVQ-8:
        beam_step_lvq's rounding; LVQ-4 decodes to beam_step's formula,
        bit for bit)."""
        x, adj, queries = self._graph_queries(1200, 24, 10)
        lvq = LVQDataset.compress(x, bits=bits, residual_bits=residual,
                                  device="cpu")
        graph = self._graph(adj, lvq.capacity)
        q = torch.from_numpy(pad_matrix(queries, d_pad=lvq.padded_dim))
        eids = torch.tensor([0], dtype=torch.int32)
        kw = dict(window=12, capacity=12, max_iters=32, distance="l2")
        outs = [sharded.sharded_greedy_search(mesh(s), graph, lvq, q, eids,
                                              **kw) for s in (1, 2, 8)]
        for out in outs[1:]:
            same_output(out, outs[0])
        ref = greedy_search(graph, lvq, q, eids, **kw)
        if bits == 4:
            same_output(outs[-1], ref)
        else:
            close_output(outs[-1], ref)

    def test_lvq_shard_view_get_matches(self):
        x, _, _ = self._graph_queries(600, 20, 8)
        lvq = LVQDataset.compress(x, bits=8, residual_bits=8, device="cpu")
        view = sharded.shard_lvq(lvq, mesh())
        assert isinstance(view, sharded.ShardedLVQShard)
        ids = torch.tensor([0, 5, 599, 300], dtype=torch.int32)
        assert torch.equal(view.get(ids), lvq.get(ids))
        assert torch.equal(view.get_full(ids), lvq.get_full(ids))
        assert torch.equal(view.norms_of(ids), lvq.norms_of(ids))

    @pytest.mark.parametrize("kind", ["sq", "float16"])
    def test_scored_search_bit_identical(self, kind):
        """SQ-int8 and float16 rows take the scored route on one device
        too: equal bit for bit, 8 shards against one device."""
        x, adj, queries = self._graph_queries(1000, 24, 10, seed=9)
        data = SQDataset.compress(x, device="cpu") if kind == "sq" else \
            VectorDataset.from_array(x, dtype=torch.float16, device="cpu")
        graph = self._graph(adj, data.capacity)
        q = torch.from_numpy(pad_matrix(queries, d_pad=data.padded_dim))
        eids = torch.tensor([0], dtype=torch.int32)
        kw = dict(window=12, capacity=12, max_iters=32, distance="l2")
        ref = greedy_search(graph, data, q, eids, **kw)
        out = sharded.sharded_greedy_search(mesh(), graph, data, q, eids,
                                            **kw)
        same_output(out, ref)
        view = sharded.shard_any_dataset(data, mesh())
        assert isinstance(view, sharded.ShardedSQShard if kind == "sq"
                          else sharded.ShardedDataShard)
        ids = torch.tensor([0, 7, 999, 500], dtype=torch.int32)
        assert torch.equal(view.get(ids), data.get(ids))


class TestShardedDynamic:
    def _params(self):
        return svt.VamanaBuildParameters(alpha=1.1, **BUILD)

    def test_mutation_parity_with_single_chip(self):
        """The same mutations on a single-device index and its 8-shard
        copy: identical searches and adjacency after add and consolidate,
        the same entry point (by external id) and searches after
        compact."""
        data, queries = svt.generate_test_dataset(800, 24, 24, seed=13)
        sc = MutableVamanaIndex(self._params(), data[:700],
                                np.arange(700), "l2", device="cpu")
        sh = ShardedMutableVamanaIndex.from_single_chip(sc, mesh())

        def same_search():
            a, b = sc.search(queries, 5), sh.search(queries, 5)
            np.testing.assert_array_equal(a.ids, b.ids)
            np.testing.assert_array_equal(a.distances, b.distances)

        def same_graph():
            g = sh.graph.gather()
            cap = sc.graph.capacity
            assert torch.equal(g.adjacency[:cap], sc.graph.adjacency)
            assert torch.equal(g.degrees[:cap], sc.graph.degrees)

        same_search()
        sc.add_points(data[700:800], np.arange(900, 1000))
        sh.add_points(data[700:800], np.arange(900, 1000))
        same_graph()
        same_search()
        sc.delete_points(np.arange(10, 60))
        sh.delete_points(np.arange(10, 60))
        assert sc.entry_point == sh.entry_point
        sc.consolidate()
        sh.consolidate()
        same_graph()
        same_search()
        sc.compact()
        sh.compact()
        assert sc.size == sh.size
        np.testing.assert_array_equal(sc.all_ids(), sh.all_ids())
        assert sc.translator.to_external([sc.entry_point])[0] == \
            sh.translator.to_external([sh.entry_point])[0]
        same_search()

    def test_deleted_entry_point_moves_alike(self):
        """Deleting the entry point draws the medioid of the VALID rows
        over the rows the mean counts, on both."""
        data, queries = svt.generate_test_dataset(500, 16, 24, seed=19)
        sc = MutableVamanaIndex(self._params(), data[:400], np.arange(400),
                                "l2", device="cpu")
        sh = ShardedMutableVamanaIndex.from_single_chip(sc, mesh())
        for _ in range(3):
            ext = sc.translator.to_external([sc.entry_point])
            sc.delete_points(ext)
            sh.delete_points(ext)
            assert sc.entry_point == sh.entry_point
        sc.consolidate()
        sh.consolidate()
        np.testing.assert_array_equal(sc.search(queries, 5).ids,
                                      sh.search(queries, 5).ids)

    def test_growth_across_capacity(self):
        data, queries = svt.generate_test_dataset(900, 24, 24, seed=31)
        sc = MutableVamanaIndex(self._params(), data[:403], np.arange(403),
                                "l2", capacity=403, device="cpu")
        sh = ShardedMutableVamanaIndex.from_single_chip(sc, mesh())
        cap0 = sh.capacity
        sc.add_points(data[403:], np.arange(1000, 1497))
        sh.add_points(data[403:], np.arange(1000, 1497))
        assert sh.capacity > cap0 and sh.capacity % 8 == 0
        np.testing.assert_array_equal(sc.search(queries, 5).ids,
                                      sh.search(queries, 5).ids)

    def test_lifecycle_from_scratch(self):
        """The sharded constructor builds the single-device graph; a cycle
        of add, delete, consolidate and compact keeps recall."""
        data, queries = svt.generate_test_dataset(300, 24, 24, seed=17)
        idx = ShardedMutableVamanaIndex(self._params(), data[:240],
                                        np.arange(240), "l2", mesh())
        sc = MutableVamanaIndex(self._params(), data[:240], np.arange(240),
                                "l2", device="cpu")
        assert idx.entry_point == sc.entry_point
        assert torch.equal(idx.graph.gather().adjacency[:sc.graph.capacity],
                           sc.graph.adjacency)
        gt = svt.exhaustive_search(data[:240], queries, 5, device="cpu")
        assert svt.k_recall_at_n(gt, idx.search(queries, 5)) >= 0.85
        idx.add_points(data[240:300], np.arange(2000, 2060))
        idx.delete_points(np.arange(0, 60))
        idx.consolidate()
        idx.compact()
        assert idx.size == 240
        live_ext = np.concatenate([np.arange(60, 240),
                                   np.arange(2000, 2060)])
        np.testing.assert_array_equal(idx.all_ids(), np.sort(live_ext))
        gt2 = svt.exhaustive_search(np.concatenate([data[60:240],
                                                    data[240:300]]),
                                    queries, 5, device="cpu")
        res = idx.search(queries, 5)
        overlap = np.mean([len(set(a) & set(b)) / 5
                           for a, b in zip(live_ext[gt2.ids], res.ids)])
        assert overlap >= 0.80, overlap

    def test_entry_sampler_tracks_mutations(self):
        data, queries = svt.generate_test_dataset(300, 24, 24, seed=17)
        idx = ShardedMutableVamanaIndex(self._params(), data[:240],
                                        np.arange(240), "l2", mesh())
        gt = svt.exhaustive_search(data[:240], queries, 5, device="cpu")
        base = svt.k_recall_at_n(gt, idx.search(queries, 5))
        idx.enable_entry_sampler(n_samples=64, seed=0)
        rec = svt.k_recall_at_n(gt, idx.search(queries, 5))
        assert idx._entry_sampler is not None
        assert rec >= base - 0.05, (rec, base)
        assert (idx.status[idx._entry_sampler.ids.numpy()] == 1).all()
        idx.add_points(data[240:300], np.arange(2000, 2060))
        assert idx._entry_sampler is None
        idx.search(queries, 5)
        idx.delete_points(np.arange(0, 60))
        assert idx._entry_sampler is None        # a delete redraws it
        res = idx.search(queries, 5)
        assert idx._entry_sampler is not None
        assert not np.isin(res.ids, np.arange(0, 60)).any()
        idx.consolidate()
        assert idx._entry_sampler is None
        idx.compact()
        assert (idx.search(queries, 5).ids >= 0).all()
        assert (idx.status[idx._entry_sampler.ids.numpy()] == 1).all()
        idx.disable_entry_sampler()
        assert idx._entry_sampler is None

    def test_roundtrip_to_single_chip(self, tmp_path):
        data, queries = svt.generate_test_dataset(200, 16, 16, seed=23)
        idx = ShardedMutableVamanaIndex(self._params(), data, np.arange(200),
                                        "l2", mesh())
        idx.delete_points(np.arange(30))
        single = idx.to_single_chip()
        back = ShardedMutableVamanaIndex.from_single_chip(single, mesh())
        for other in (single, back):
            np.testing.assert_array_equal(other.status, idx.status)
            assert other.entry_point == idx.entry_point
            assert other.data.n == idx.data.n
            np.testing.assert_array_equal(idx.search(queries, 5).ids,
                                          other.search(queries, 5).ids)
        assert torch.equal(back.graph.gather().adjacency,
                           idx.graph.gather().adjacency)
        assert torch.equal(back.data.gather().vectors,
                           idx.data.gather().vectors)
        idx.save(str(tmp_path / "dyn"))
        loaded = ShardedMutableVamanaIndex.assemble(str(tmp_path / "dyn"),
                                                    mesh())
        state = ShardedMutableVamanaIndex.from_state(
            single.data, single.graph, single.status[: single.data.n],
            single.translator.to_external(np.arange(single.data.n)),
            single.entry_point, "l2", single.parameters, mesh=mesh())
        for other in (loaded, state):
            np.testing.assert_array_equal(idx.search(queries, 5).ids,
                                          other.search(queries, 5).ids)
        with pytest.raises(NotImplementedError):
            idx.enable_packed_serving()

    def test_against_jax(self):
        """A JAX dynamic index, carried into the port and sharded: its
        searches after an add and a delete agree with JAX's."""
        data, queries = svt.generate_test_dataset(500, 24, 24, seed=13)
        j = jdyn.MutableVamanaIndex(JParams(alpha=1.1, **BUILD), data[:400],
                                    np.arange(400), "l2")
        n = j.data.n
        t = interop.dynamic_vamana_from_arrays(
            np.asarray(j.data.vectors)[:n, : j.data.dim],
            np.asarray(j.graph.adjacency), np.asarray(j.graph.degrees),
            j.status[:n], j.translator.to_external(np.arange(n)),
            j.entry_point, j.distance.value,
            svt.VamanaBuildParameters(**dataclasses.asdict(j.parameters)),
            capacity=j.data.capacity, device="cpu")
        sh = ShardedMutableVamanaIndex.from_single_chip(t, mesh())
        for step in ("add", "delete"):
            if step == "add":
                j.add_points(data[400:], np.arange(1000, 1100))
                sh.add_points(data[400:], np.arange(1000, 1100))
            else:
                j.delete_points(np.arange(0, 50))
                sh.delete_points(np.arange(0, 50))
            want, got = j.search(queries, 10), sh.search(queries, 10)
            agree = (np.sort(got.ids, 1) == np.sort(want.ids, 1)).mean()
            assert agree >= 0.98, (step, agree)
