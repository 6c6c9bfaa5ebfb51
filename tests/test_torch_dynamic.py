"""The dynamic indexes of the PyTorch port against the JAX package.

One JAX ``MutableVamanaIndex`` (600 x 48, R 16) is built once and carried
into the port with ``interop.dynamic_vamana_from_arrays``; the container
mutations, the consolidation and compaction functions, one mutation
sequence (add with growth, delete, consolidate, add into reused slots,
compact), the dynamic flat index, checkpoints in both directions and the
multi-vector index are then held to the JAX package on the same inputs.
The JAX searches of the sequence take its kernel branch (the beam-step
kernel in interpret mode, ``SVT_FORCE_BEAM_KERNEL=1``).

Where adjacency rows differ, the test shows that the rows hold the same
neighbours and that only near-ties (distances within 1e-4 relative, the
known L2 rounding-order difference of the two packages) changed places.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scalablevectorsearch_tpu.core.data import VectorDataset as JData
from scalablevectorsearch_tpu.core.graph import NeighborGraph as JGraph
from scalablevectorsearch_tpu.core.io import generate_test_dataset
from scalablevectorsearch_tpu.core.translation import (
    IDTranslator as JTranslator)
from scalablevectorsearch_tpu.index.dynamic_flat import (
    DynamicFlatIndex as JFlat)
from scalablevectorsearch_tpu.index.vamana import dynamic as jdyn
from scalablevectorsearch_tpu.index.vamana import multi as jmulti
from scalablevectorsearch_tpu.index.vamana.params import (
    VamanaBuildParameters as JParams)
from scalablevectorsearch_tpu.utils.dynamic_helper import (
    ReferenceDataset as JRef)

import scalablevectorsearch_tpu_torch as svt
from scalablevectorsearch_tpu_torch import interop
from scalablevectorsearch_tpu_torch.core.graph import NeighborGraph
from scalablevectorsearch_tpu_torch.index.vamana import build as tbuild
from scalablevectorsearch_tpu_torch.index.vamana import dynamic as tdyn
from scalablevectorsearch_tpu_torch.index.vamana import multi as tmulti
from scalablevectorsearch_tpu_torch.index.vamana import search as tsearch
from scalablevectorsearch_tpu_torch.orchestrators.dynamic_vamana import (
    DynamicFlat, DynamicVamana)

torch.set_num_threads(1)

KW = dict(graph_max_degree=16, window_size=24, max_candidate_pool_size=60,
          prune_to=14, alpha=1.2)
SEED = 5


def carry(j):
    """The port's MutableVamanaIndex over a JAX dynamic index's state."""
    n = j.data.n
    return interop.dynamic_vamana_from_arrays(
        np.asarray(j.data.vectors)[:n, : j.data.dim],
        np.asarray(j.graph.adjacency), np.asarray(j.graph.degrees),
        j.status[:n], j.translator.to_external(np.arange(n)),
        j.entry_point, j.distance.value,
        svt.VamanaBuildParameters(**dataclasses.asdict(j.parameters)),
        capacity=j.data.capacity, sampler_cfg=j._sampler_cfg, device="cpu")


def jcopy(j):
    """A JAX dynamic index that mutates apart from ``j`` (its device
    arrays are immutable; status and translator are copied)."""
    c = copy.copy(j)
    c.status = j.status.copy()
    c.translator = j.translator.copy()
    return c


def assert_same_state(j, t):
    """Status, deleted mask, translator (both directions), entry point and
    high-water mark equal."""
    np.testing.assert_array_equal(t.status, j.status)
    np.testing.assert_array_equal(t.deleted_mask.numpy(),
                                  np.asarray(j.deleted_mask))
    np.testing.assert_array_equal(t.translator.all_external_ids(),
                                  j.translator.all_external_ids())
    n = j.data.n
    assert t.data.n == n and t.graph.n == j.graph.n
    np.testing.assert_array_equal(t.translator.to_external(np.arange(n)),
                                  j.translator.to_external(np.arange(n)))
    assert t.entry_point == j.entry_point


def adjacency_rows(j, t):
    """(rows equal in order, rows that differ at a near-tie): a near-tie
    is a neighbour whose distance to the row's vertex, or whose alpha
    occlusion test against another neighbour of the row, is within 1e-4
    relative of the other side's (the L2 keys of the two packages differ
    at that level)."""
    ja, ta = np.asarray(j.graph.adjacency), t.graph.adjacency.numpy()
    assert ja.shape == ta.shape
    same = (ja == ta).all(1)
    vecs = np.asarray(j.data.vectors, np.float64)
    alpha = float(j.parameters.alpha)

    def dist(a, b):
        return float(((vecs[a] - vecs[b]) ** 2).sum())

    ties = np.zeros_like(same)
    for r in np.nonzero(~same)[0]:
        a, b = set(ja[r][ja[r] >= 0]), set(ta[r][ta[r] >= 0])
        swapped = [(x, y) for x, y in zip(ja[r], ta[r]) if x != y]
        if a == b:
            ties[r] = all(abs(dist(r, x) - dist(r, y)) <= 1e-4 * dist(r, x)
                          for x, y in swapped)
        else:
            ties[r] = any(abs(alpha * dist(p, e) - dist(r, e))
                          <= 1e-4 * dist(r, e)
                          for e in a ^ b for p in a | b if p != e)
    return same, ties


def assert_adjacency_equal(j, t, step: str):
    """Every row equal or differing at a near-tie (shown, and at most 2% of
    the rows)."""
    same, ties = adjacency_rows(j, t)
    assert (same | ties).all(), (step, np.nonzero(~(same | ties))[0][:10])
    assert ties.sum() <= 0.02 * same.size, (step, ties.sum())


def assert_search_agrees(j, t, queries, ref, step: str):
    """Search ids agree on >= 98% of slots; no deleted or unknown id."""
    want = j.search(queries, 10)
    got = t.search(queries, 10)
    ref.check_ids(got)
    agree = (np.sort(got.ids, 1) == np.sort(want.ids, 1)).mean()
    assert agree >= 0.98, (step, agree)
    return got


@pytest.fixture(scope="module")
def pool():
    return generate_test_dataset(1200, 40, 48, seed=11)


@pytest.fixture(scope="module")
def built(pool):
    """A JAX index over 600 rows in storage for 640, so that the first add
    of 100 rows grows it."""
    data, _queries = pool
    jref = JRef(data, seed=SEED)
    pts, ids = jref.new_batch(600)
    return jdyn.MutableVamanaIndex(JParams(**KW), pts, ids, "l2",
                                   capacity=640)


def refs(pool, n_taken: int = 600):
    """Twin reference datasets (JAX, port) after the initial draw."""
    data, _ = pool
    jref, tref = JRef(data, seed=SEED), svt.ReferenceDataset(
        data, seed=SEED, device="cpu")
    jref.new_batch(n_taken)
    tref.new_batch(n_taken)
    return jref, tref


def test_translator_matches_jax():
    rng = np.random.default_rng(0)
    j, t = JTranslator(8), svt.IDTranslator(8)
    ext = rng.choice(10_000, size=40, replace=False)
    slots = rng.permutation(40)
    for tr in (j, t):
        tr.insert(ext[:30], slots[:30])
        tr.remove(ext[5:12])
        tr.insert(ext[30:], slots[5:15])
        tr.remap({int(s): 60 - i for i, s in enumerate(slots[:4])})
        tr.remap(np.where(np.arange(50) % 3 == 0, np.arange(50) + 100, -1))
    for name in ("_ext_sorted", "_slot_for_ext", "_int_to_ext"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    probe = np.arange(-2, 200)
    np.testing.assert_array_equal(t.to_external(probe), j.to_external(probe))
    np.testing.assert_array_equal(t.to_internal(ext[20:25]),
                                  j.to_internal(ext[20:25]))
    assert len(t) == len(j) and (int(ext[0]) in t) == (int(ext[0]) in j)
    calls = [lambda tr: tr.insert([1, 1], [0, 1]),
             lambda tr: tr.insert(ext[:1], [99]),
             lambda tr: tr.remove([ext[5]]),
             lambda tr: tr.remove([ext[20], ext[20]]),
             lambda tr: tr.to_internal([-7])]
    for call in calls:
        errors = []
        for tr in (j, t):
            with pytest.raises((ValueError, KeyError)) as info:
                call(tr)
            errors.append((info.type, str(info.value)))
        assert errors[0] == errors[1]


def test_container_mutations_bit_equal():
    """Rows, adjacency and degrees bit-equal; the recomputed norms within
    rtol 1e-6, since XLA and torch sum the f32 squares in other orders (as
    for ``VectorDataset.from_array``, tests/test_torch_ops.py)."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(37, 20)).astype(np.float32)
    rows = rng.normal(size=(6, 20)).astype(np.float32)
    slots = np.array([3, -1, 40, 39, 0, 44])         # -1 and 44 dropped
    jd = JData.from_array(x, capacity=45)
    td = svt.VectorDataset.from_array(x, capacity=45, device="cpu")
    pairs = [
        (jd.scatter_rows(jnp.asarray(slots), jnp.asarray(rows), new_n=41),
         td.scatter_rows(torch.from_numpy(slots), rows, new_n=41)),
        (jd.set_rows(30, jnp.asarray(rows)), td.set_rows(30, rows)),
        (jd.set_rows(42, jnp.asarray(rows), new_n=48),
         td.set_rows(42, rows, new_n=48)),           # moved back to fit
        (jd.with_capacity(100), td.with_capacity(100))]
    for want, got in pairs:
        assert got.n == want.n and got.capacity == want.capacity
        np.testing.assert_array_equal(got.vectors.numpy(),
                                      np.asarray(want.vectors))
        np.testing.assert_allclose(got.norms_sq.numpy(),
                                   np.asarray(want.norms_sq), rtol=1e-6)
    np.testing.assert_array_equal(td.vectors.numpy(), np.asarray(jd.vectors))

    adj = rng.integers(-1, 30, size=(30, 6)).astype(np.int32)
    jg, tg = JGraph.from_array(adj), NeighborGraph.from_array(adj,
                                                             device="cpu")
    ids = np.array([2, 5, -1, 31, 2])
    for want, got in [(jg.clear_rows(jnp.asarray(ids)),
                       tg.clear_rows(torch.from_numpy(ids))),
                      (jg.with_capacity(61), tg.with_capacity(61)),
                      (jg.with_capacity(8), tg.with_capacity(8))]:
        assert got.capacity == want.capacity and got.n == want.n
        np.testing.assert_array_equal(got.adjacency.numpy(),
                                      np.asarray(want.adjacency))
        np.testing.assert_array_equal(got.degrees.numpy(),
                                      np.asarray(want.degrees))


def test_padded_build_chunk_writes_nothing(built):
    """``_build_over`` pads a chunk with its first slot marked invalid:
    padding with another slot gives the same graph, and rows outside the
    chunk and its neighbourhood stay as they were."""
    t = carry(built)
    chunk = torch.tensor([10, 11, 12, 13, 14], dtype=torch.int32)
    p = t.parameters
    out = {}
    for filler in (10, 300):
        ids = torch.cat([chunk, torch.full((3,), filler, dtype=torch.int32)])
        valid = torch.arange(8) < 5
        out[filler], _ = tbuild.build_round(
            t.graph, t.data, ids, valid,
            torch.tensor([t.entry_point], dtype=torch.int32),
            window=p.window_size, capacity=p.window_size,
            max_iters=2 * p.window_size + 16, distance=t.distance,
            pool_size=p.max_candidate_pool_size, gen_alpha=p.alpha,
            rev_alpha=p.alpha, prune_to=p.prune_to,
            max_degree=p.graph_max_degree, prune_chunk=128, pop_width=4,
            tail_frac=4)
    assert torch.equal(out[10].adjacency, out[300].adjacency)
    assert torch.equal(out[10].degrees, out[300].degrees)
    assert not torch.equal(out[10].adjacency, t.graph.adjacency)


def test_consolidation_functions_match_jax(built, pool):
    j = jcopy(built)
    jref, _ = refs(pool)
    dead = jref.delete_batch(150)
    j.delete_points(dead)
    t = carry(j)
    valid = np.asarray(j.status == tdyn.SLOT_VALID)
    want = np.asarray(jdyn._affected_by_deleted(
        j.graph.adjacency, j.deleted_mask, jnp.asarray(valid)))
    got = tdyn._affected_by_deleted(t.graph.adjacency, t.deleted_mask,
                                    torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(got, want)
    affected = np.nonzero(want)[0]
    assert affected.size > 128

    ids = np.zeros(256, np.int32)
    ids[:200] = affected[:200]
    ok = np.arange(256) < 200
    r = KW["graph_max_degree"]
    kw = dict(prune_to=KW["prune_to"], alpha=KW["alpha"], max_degree=r,
              prune_chunk=128, pool_cap=min(r * (r + 1), 4 * r))
    j.graph = jdyn.consolidate_round(
        j.graph, j.data, jnp.asarray(ids), jnp.asarray(ok), j.deleted_mask,
        distance=j.distance, **kw)
    t.graph = tdyn.consolidate_round(
        t.graph, t.data, torch.from_numpy(ids), torch.from_numpy(ok),
        t.deleted_mask, distance=t.distance, **kw)
    assert_adjacency_equal(j, t, "consolidate_round")

    # compaction through a slot permutation, on the same integer inputs
    cap = j.data.capacity
    rng = np.random.default_rng(2)
    alive = np.sort(rng.choice(600, size=450, replace=False))
    o2n = np.full(cap, -1, np.int32)
    o2n[alive] = np.arange(alive.size)
    perm = np.zeros(cap, np.int32)
    perm[: alive.size] = alive
    want = jdyn._compact_kernel(j.graph.adjacency, j.data.vectors,
                                j.data.norms_sq, jnp.asarray(perm),
                                jnp.asarray(o2n), jnp.int32(alive.size))
    got = tdyn._compact_kernel(
        torch.from_numpy(np.array(j.graph.adjacency)),
        torch.from_numpy(np.array(j.data.vectors)),
        torch.from_numpy(np.array(j.data.norms_sq)), torch.from_numpy(perm),
        torch.from_numpy(o2n), alive.size)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    # deleted slots dropped from a beam; ties kept in column order
    keys = np.round(rng.uniform(0, 4, size=(16, 20)), 0).astype(np.float32)
    beam = rng.integers(-1, 600, size=(16, 20)).astype(np.int32)
    mask = np.asarray(j.deleted_mask)
    wk, wi = jdyn._drop_deleted(jnp.asarray(keys), jnp.asarray(beam),
                                jnp.asarray(mask), 10)
    gk, gi = tdyn._drop_deleted(torch.from_numpy(keys),
                                torch.from_numpy(beam),
                                torch.from_numpy(mask.copy()), 10)
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    # keys tie exactly here (rounded to integers); the ids of tied keys
    # may come out in another order, so >= 98% of rows hold equal ids
    rows_equal = (gi.numpy() == np.asarray(wi)).all(1).mean()
    assert rows_equal >= 0.98, rows_equal
    np.testing.assert_array_equal(np.sort(gi.numpy(), 1),
                                  np.sort(np.asarray(wi), 1))


def test_mutation_sequence_matches_jax(built, pool, monkeypatch):
    """add (grows 640 -> 1280), delete, consolidate, add into reused
    slots, compact: applied to both packages, with sampled entries."""
    _data, queries = pool
    j = jcopy(built)
    jref, tref = refs(pool)
    t = carry(j)
    for index in (j, t):
        index.search_window_size = 20
        index.enable_entry_sampler(n_samples=64, seed=3)
    monkeypatch.setenv("SVT_FORCE_BEAM_KERNEL", "1")
    jax.clear_caches()   # the env is read at trace time
    try:
        pts, ids = jref.new_batch(100)
        np.testing.assert_array_equal(tref.new_batch(100)[1], ids)
        slots = [index.add_points(pts, ids) for index in (j, t)]
        np.testing.assert_array_equal(slots[1], slots[0])
        assert t.data.capacity == j.data.capacity == 1280
        assert_same_state(j, t)
        assert_adjacency_equal(j, t, "add")
        assert_search_agrees(j, t, queries, tref, "add")

        dead = jref.delete_batch(150)
        np.testing.assert_array_equal(tref.delete_batch(150), dead)
        for index in (j, t):
            index.delete_points(dead)
        assert t._entry_sampler is None
        j._entry_sampler = None   # the JAX code keeps its sample; redraw
        assert_same_state(j, t)
        res = assert_search_agrees(j, t, queries, tref, "delete")
        assert not np.isin(res.ids, dead).any()

        for index in (j, t):
            index.consolidate()
        assert_same_state(j, t)
        assert_adjacency_equal(j, t, "consolidate")
        assert_search_agrees(j, t, queries, tref, "consolidate")

        pts, ids = jref.new_batch(120)
        tref.new_batch(120)
        slots = [index.add_points(pts, ids) for index in (j, t)]
        np.testing.assert_array_equal(slots[1], slots[0])
        assert slots[0].max() < 700                 # reused slots only
        assert_same_state(j, t)
        assert_adjacency_equal(j, t, "add into reused slots")
        assert_search_agrees(j, t, queries, tref, "add into reused slots")

        for index in (j, t):
            index.compact()
        assert_same_state(j, t)
        assert_adjacency_equal(j, t, "compact")
        np.testing.assert_array_equal(t.data.vectors.numpy(),
                                      np.asarray(j.data.vectors))
        np.testing.assert_array_equal(
            np.asarray(t._ensure_sampler()[0].ids.numpy()),
            np.asarray(j._ensure_sampler()[0].ids))
        assert_search_agrees(j, t, queries, tref, "compact")
        assert t.size == len(tref.live)
    finally:
        monkeypatch.delenv("SVT_FORCE_BEAM_KERNEL")
        jax.clear_caches()


def test_dynamic_flat_matches_jax(pool):
    data, queries = pool
    j = JFlat(data[:300], np.arange(300) + 7, "l2", capacity=320,
              data_batch_size=128)
    t = svt.DynamicFlatIndex(data[:300], np.arange(300) + 7, "l2",
                             capacity=320, data_batch_size=128, device="cpu")
    steps = [lambda i: i.add_points(data[300:400], np.arange(300, 400) + 7),
             lambda i: i.delete_points(np.arange(0, 120, 3) + 7),
             lambda i: i.add_points(data[400:430], np.arange(400, 430) + 7),
             lambda i: i.compact()]
    for step in steps:
        for index in (j, t):
            step(index)
        np.testing.assert_array_equal(t.status, j.status)
        np.testing.assert_array_equal(t.all_ids(), j.all_ids())
        want, got = j.search(queries, 10), t.search(queries, 10)
        # identical ids; one whose column differs sits at a near-tie (JAX
        # gives query 19 two equal keys that the port's rounding orders)
        np.testing.assert_array_equal(np.sort(got.ids, 1),
                                      np.sort(want.ids, 1))
        moved = got.ids != want.ids
        assert moved.any(1).mean() <= 0.05
        np.testing.assert_allclose(got.distances, want.distances, rtol=1e-4,
                                   atol=1e-3)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_crosses_both_ways(built, pool, writer, tmp_path):
    """A save with deleted slots pending: both packages assemble it to the
    same state and arrays, and each copy searches as the index it was
    saved from (its own package's live index) does."""
    _data, queries = pool
    j = jcopy(built)
    jref, _ = refs(pool)
    j.delete_points(jref.delete_batch(60))
    j.enable_entry_sampler(n_samples=64, seed=1)
    t = carry(j)
    assert (j.status == tdyn.SLOT_DELETED).sum() == 60
    path = str(tmp_path / "dyn")
    (j if writer == "jax" else t).save(path)
    jl = jdyn.MutableVamanaIndex.assemble(path)
    tl = svt.DynamicVamana.assemble(path, device="cpu").index
    assert jl._sampler_cfg == tl._sampler_cfg == (64, 1, 1)
    assert_same_state(jl, tl)
    for name in ("adjacency", "degrees"):
        np.testing.assert_array_equal(getattr(tl.graph, name).numpy(),
                                      np.asarray(getattr(jl.graph, name)))
    np.testing.assert_array_equal(tl.data.vectors.numpy(),
                                  np.asarray(jl.data.vectors))
    np.testing.assert_allclose(tl.data.norms_sq.numpy(),       # f32 sums
                               np.asarray(jl.data.norms_sq), rtol=1e-6)
    n = j.data.n
    np.testing.assert_array_equal(jl.status[:n], j.status[:n])
    np.testing.assert_array_equal(np.asarray(jl.graph.adjacency)[:n],
                                  np.asarray(j.graph.adjacency)[:n])
    results = {}
    for name, index in (("j", j), ("t", t), ("jl", jl), ("tl", tl)):
        index.search_window_size = 20
        results[name] = index.search(queries, 10)
    np.testing.assert_array_equal(results["jl"].ids, results["j"].ids)
    np.testing.assert_array_equal(results["tl"].ids, results["t"].ids)
    np.testing.assert_array_equal(results["tl"].distances,
                                  results["t"].distances)
    agree = (np.sort(results["tl"].ids, 1)
             == np.sort(results["jl"].ids, 1)).mean()
    assert agree >= 0.98, agree


def test_query_upload_dtype_is_honoured(built, pool, monkeypatch):
    """The per-index attribute overrides the env default, as in the JAX
    package, and an int8 upload gives the JAX package's int8 search."""
    _data, queries = pool
    j = jcopy(built)
    t = carry(j)
    for index in (j, t):
        index.search_window_size = 20
    monkeypatch.setenv("SVT_QUERY_UPLOAD_DTYPE", "float32")
    f32 = t.search(queries, 10)
    monkeypatch.setenv("SVT_QUERY_UPLOAD_DTYPE", "int8")
    int8_env = t.search(queries, 10)
    monkeypatch.setenv("SVT_QUERY_UPLOAD_DTYPE", "float32")
    t.query_upload_dtype = j.query_upload_dtype = "int8"
    int8_attr = t.search(queries, 10)
    np.testing.assert_array_equal(int8_attr.ids, int8_env.ids)
    np.testing.assert_array_equal(int8_attr.distances, int8_env.distances)
    assert not np.array_equal(int8_attr.distances, f32.distances)
    want = j.search(queries, 10)
    assert (np.sort(int8_attr.ids, 1) == np.sort(want.ids, 1)).mean() >= 0.98
    np.testing.assert_allclose(np.sort(int8_attr.distances, 1),
                               np.sort(want.distances, 1), rtol=1e-3,
                               atol=1e-3)


def test_entry_point_survives_deletion(built, pool):
    _data, queries = pool
    t = carry(built)
    entry_ext = t.translator.to_external([t.entry_point])[0]
    t.delete_points([entry_ext])
    assert t.status[t.entry_point] == tdyn.SLOT_VALID
    j = jcopy(built)
    j.delete_points([entry_ext])
    assert t.entry_point == j.entry_point
    res = t.search(queries[:4], 5)
    assert (res.ids >= 0).all() and entry_ext not in res.ids


def test_serving_state_follows_mutations(built, pool):
    """Packed rows survive a soft delete and are rebuilt after add,
    consolidate and compact; the sample is drawn again from the VALID
    slots after every mutation (the JAX package's code keeps it on a soft
    delete); deleted ids never surface."""
    data, queries = pool
    t = carry(built)
    t.search_window_size = 20
    plain = t.search(queries, 5)
    t.enable_packed_serving(dtype=torch.float32)   # exact: same search
    np.testing.assert_array_equal(t.search(queries, 5).ids, plain.ids)
    t.enable_entry_sampler(n_samples=64, seed=0)
    t.search(queries[:8], 5)
    assert t._packed is not None and t._entry_sampler is not None

    t.add_points(data[1000:1100], np.arange(5000, 5100))
    assert t._packed is None and t._entry_sampler is None
    t.search(queries[:8], 5)
    assert t._packed.shape[0] == t.graph.capacity == 1280
    sampled = t._entry_sampler.ids.numpy()
    assert (t.status[sampled] == tdyn.SLOT_VALID).all()

    dead = np.arange(5000, 5050)
    t.delete_points(dead)
    assert t._packed is not None and t._entry_sampler is None
    assert not np.isin(t.search(queries, 5).ids, dead).any()
    t.consolidate()
    assert t._packed is None and t._entry_sampler is None
    t.compact()
    res = t.search(queries, 5)
    assert (res.ids >= 0).all() and not np.isin(res.ids, dead).any()
    sampled = t._entry_sampler.ids.numpy()
    assert (t.status[sampled] == tdyn.SLOT_VALID).all()


def test_dynamic_vamana_surface(pool, tmp_path):
    """The orchestrators' surface, as ``tests/test_dynamic.py`` drives the
    JAX package's."""
    data, queries = pool
    params = svt.VamanaBuildParameters(graph_max_degree=16, window_size=32)
    dv = DynamicVamana.build(params, data[:400], np.arange(400), "l2",
                             device="cpu")
    assert dv.size == 400 and dv.has_id(3)
    dv.add_points(data[400:450], np.arange(400, 450))
    dv.delete_points(np.arange(10))
    dv.consolidate().compact()
    assert dv.size == 440 and not dv.has_id(3)
    assert dv.search(queries[:8], 5).ids.shape == (8, 5)
    assert dv.alpha == pytest.approx(1.2)
    dv.enable_packed_serving()
    dv.enable_entry_sampler(n_samples=64, seed=0)
    res = dv.search_async(queries[:8], 5).result()
    assert res.ids.shape == (8, 5) and (res.ids >= 0).all()
    dv.disable_entry_sampler()
    dv.disable_packed_serving()
    dv.pop_width = 2
    dv.search_window_size = 12
    assert dv.index.pop_width == 2 and dv.search_parameters.buffer_config \
        .search_window_size == 12 and dv.dimensions == 48
    np.testing.assert_array_equal(dv.all_ids(), np.arange(10, 450))
    d = dv.get_distance(403, queries[0])
    want = ((queries[0] - data[403]) ** 2).sum()
    assert abs(d - want) / want < 1e-4
    dv.save(str(tmp_path / "dv"))
    dv2 = DynamicVamana.assemble(str(tmp_path / "dv"), device="cpu")
    dv2.search_window_size = 12
    np.testing.assert_array_equal(dv2.search(queries[:8], 5).ids,
                                  dv.search(queries[:8], 5).ids)
    dv2.add_points(data[450:460], np.arange(450, 460))
    assert dv2.size == dv.size + 10

    df = DynamicFlat.build(data[:100], np.arange(100), "l2", device="cpu")
    df.add_points(data[100:120], np.arange(100, 120))
    df.delete_points([0, 1])
    assert df.consolidate().compact().size == 118 and df.dimensions == 48
    res = df.search(queries[:4], 3)
    assert 0 not in res.ids and 1 not in res.ids
    with pytest.raises(ValueError):
        df.add_points(data[10:12], [5, 100])


def test_dedup_by_label_matches_jax():
    rng = np.random.default_rng(4)
    labels = rng.integers(-1, 6, size=(30, 12)).astype(np.int64)
    values = np.sort(rng.uniform(size=(30, 12)), 1).astype(np.float32)
    for k in (1, 3, 8):
        for a, b in zip(tmulti.dedup_by_label(labels, values, k),
                        jmulti.dedup_by_label(labels, values, k)):
            np.testing.assert_array_equal(a, b)


def test_multi_vector_search_matches_jax(pool, tmp_path):
    data, queries = pool
    labels = np.repeat(np.arange(100), 2)
    kw = dict(graph_max_degree=16, window_size=24)
    j = jmulti.MultiMutableVamanaIndex(JParams(**kw), data[:200], labels,
                                       "l2")
    t = svt.MultiMutableVamanaIndex(svt.VamanaBuildParameters(**kw),
                                    data[:200], labels, "l2", device="cpu")
    for index in (j, t):
        index.add_points(data[200:240], np.arange(90, 130))
        index.delete_points([3, 4, 120])
        index.search_window_size = 16
    assert t.size == j.size and t.num_vectors == j.num_vectors
    np.testing.assert_array_equal(t.all_labels(), j.all_labels())
    want, got = j.search(queries, 5), t.search(queries, 5)
    assert (np.sort(got.ids, 1) == np.sort(want.ids, 1)).mean() >= 0.98
    for row in got.ids:
        live = row[row >= 0]
        assert live.size == np.unique(live).size
        assert not np.isin(live, [3, 4, 120]).any()
    t.save(str(tmp_path / "multi"))
    loaded = jmulti.MultiMutableVamanaIndex.assemble(str(tmp_path / "multi"))
    np.testing.assert_array_equal(loaded._vid_label, j._vid_label)
    assert loaded._label_counts == j._label_counts


def test_dynamic_index_needs_a_card_by_default(pool):
    """With no device argument the index goes to the GPU; without one it
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    data, _ = pool
    params = svt.VamanaBuildParameters(graph_max_degree=16, window_size=16)
    for build in (lambda: svt.DynamicVamana.build(params, data[:64],
                                                  np.arange(64), "l2"),
                  lambda: svt.DynamicFlat.build(data[:64], np.arange(64),
                                                "l2")):
        with pytest.raises((RuntimeError, AssertionError)):
            build()


def test_beam_keeps_2k_slots_under_deletion(built, pool, monkeypatch):
    """At window 11 and k 10 the beam holds 20 slots (the kernel route is
    unchanged), so k live results survive the drop of deleted slots."""
    _data, queries = pool
    t = carry(built)
    dead = t.translator.to_external(np.arange(0, 600, 10))
    t.delete_points(dead)
    t.search_window_size = 11
    seen = []
    greedy = tsearch.greedy_search

    def spy(*args, **kwargs):
        seen.append((kwargs["window"], kwargs["capacity"]))
        return greedy(*args, **kwargs)

    monkeypatch.setattr(tsearch, "greedy_search", spy)
    res = t.search(queries, 10)
    assert seen and set(seen) == {(11, 20)}
    assert (res.ids >= 0).all()
    assert not np.isin(res.ids, dead).any()
