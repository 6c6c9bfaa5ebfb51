"""The batch iterator and calibration of the PyTorch port against the JAX
package.

One JAX Vamana index (600 x 48 clustered rows, R 16) is built once and
carried into the port with ``interop.vamana_from_arrays``, so both packages
page and calibrate over one graph on the CPU; a smaller one (300 rows)
is paged to exhaustion, the first also past capacity 1024 (the wide route
with a candidate pool), and a JAX dynamic index, carried with
``interop.dynamic_vamana_from_arrays``, after soft deletes.  Tolerances
are stated per test.
"""

import dataclasses

import numpy as np
import pytest
import torch

from scalablevectorsearch_tpu.core.io import generate_test_dataset
from scalablevectorsearch_tpu.index.flat import exhaustive_search as jexh
from scalablevectorsearch_tpu.index.vamana import calibrate as jcal
from scalablevectorsearch_tpu.index.vamana import dynamic as jdyn
from scalablevectorsearch_tpu.index.vamana import iterator as jit
from scalablevectorsearch_tpu.index.vamana.index import VamanaIndex as JIndex
from scalablevectorsearch_tpu.index.vamana.params import (
    VamanaBuildParameters as JParams)

import scalablevectorsearch_tpu_torch as svt
from scalablevectorsearch_tpu_torch import interop
from scalablevectorsearch_tpu_torch.index.vamana import calibrate as tcal
from scalablevectorsearch_tpu_torch.index.vamana import iterator as tit
from scalablevectorsearch_tpu_torch.index.vamana import search as tsearch

torch.set_num_threads(1)

KW = dict(graph_max_degree=16, window_size=32, max_candidate_pool_size=64,
          prune_to=14, alpha=1.2)


def carry(j, sampler: bool = False):
    """The port's VamanaIndex over a JAX index's state."""
    n = j.size
    t = interop.vamana_from_arrays(
        np.asarray(j.data.vectors)[:n, : j.data.dim],
        np.asarray(j.graph.adjacency), np.asarray(j.graph.degrees),
        j.entry_point, j.distance.value,
        sampler_ids=np.asarray(j._entry_sampler.ids) if sampler else None,
        device="cpu")
    t.search_window_size = j.search_window_size
    return t


@pytest.fixture(scope="module")
def pool():
    return generate_test_dataset(1200, 60, 48, seed=13)


@pytest.fixture(scope="module")
def built(pool):
    data, queries = pool
    j = JIndex.build(JParams(**KW), data[:600], "l2")
    j.search_window_size = 12
    return j, carry(j), data[:600], queries


def pages(it, n_pages: int, batch_size=None) -> list:
    return [it.next(batch_size) for _ in range(n_pages)]


def assert_pages_agree(got: list, want: list) -> None:
    """Page by page: >= 98% of the id slots equal (sorted per page), no id
    yielded twice, nearest-first within each page, the page's distances
    equal within rtol 1e-4 where the ids are."""
    g = np.concatenate([p.ids[0] for p in got])
    w = np.concatenate([p.ids[0] for p in want])
    assert g.shape == w.shape
    same = [np.sort(a.ids[0]) == np.sort(b.ids[0])
            for a, b in zip(got, want)]
    assert np.concatenate(same).mean() >= 0.98
    live = g[g >= 0]
    assert len(np.unique(live)) == live.size
    for a, b in zip(got, want):
        d = a.distances[0][a.ids[0] >= 0]
        assert np.all(np.diff(d) >= 0)
        eq = a.ids[0] == b.ids[0]
        np.testing.assert_allclose(a.distances[0][eq], b.distances[0][eq],
                                   rtol=1e-4, atol=1e-4)


def test_pages_match_jax(built):
    """Five pages of 10 for four queries from the index's window (12), the
    schedule's default; then restart for the same and another query."""
    j, t, _data, queries = built
    for qi in range(4):
        jit_ = jit.BatchIterator(j, queries[qi], batch_size=10)
        tit_ = tit.BatchIterator(t, queries[qi], batch_size=10)
        want, got = pages(jit_, 5), pages(tit_, 5)
        assert_pages_agree(got, want)
        assert tit_.batch_number == 5 and not tit_.done()
        tit_.restart()
        np.testing.assert_array_equal(tit_.next().ids, got[0].ids)
        tit_.restart(query=queries[qi + 10])
        jit_.restart(query=queries[qi + 10])
        assert_pages_agree(pages(tit_, 2), pages(jit_, 2))


def test_first_page_recall_and_deep_coverage(built):
    """First pages reach recall@10 >= 0.9 and ten pages of 10 cover
    >= 0.95 of the exact top-100, in both packages alike."""
    _j, t, data, queries = built
    gt = jexh(data, queries[:8], 100).ids
    first, cover = [], []
    for qi in range(8):
        it = tit.BatchIterator(t, queries[qi], batch_size=10)
        got = pages(it, 10)
        first.append(len(set(got[0].ids[0]) & set(gt[qi, :10])) / 10)
        ids = np.concatenate([p.ids[0] for p in got])
        cover.append(len(set(ids) & set(gt[qi])) / 100)
    assert np.mean(first) >= 0.9, first
    assert np.mean(cover) >= 0.95, cover


def test_linear_schedule_exhausts_like_jax(pool):
    """Pages of 100 under LinearSchedule(100, 100) over 300 rows: the same
    pages as JAX, done() at the same page, every row yielded once."""
    data, queries = pool
    j = JIndex.build(JParams(**KW), data[:300], "l2")
    t = carry(j)
    sched = dict(batch_size=100)
    ji = jit.BatchIterator(j, queries[0],
                           schedule=jit.LinearSchedule(100, 100), **sched)
    ti = tit.BatchIterator(t, queries[0],
                           schedule=tit.LinearSchedule(100, 100), **sched)
    got, want = [], []
    while not ti.done() and len(got) < 8:
        got.append(ti.next())
        want.append(ji.next())
        assert ti.done() == ji.done()
    assert ti.done()
    assert_pages_agree(got, want)
    ids = np.concatenate([p.ids[0] for p in got])
    assert (ids >= 0).sum() >= 0.99 * 300


def test_wide_route_pages_match_jax(built):
    """A page past capacity 1024 (window 1030 over 600 rows) runs the wide
    route with a candidate pool (1670 slots: size + need + capacity): the
    same ids as the JAX XLA branch, and no beam-step kernel; the next page
    repeats none."""
    from scalablevectorsearch_tpu_torch.ops.kernels import beam_step as bs
    j, t, _data, queries = built
    kw = dict(batch_size=40)
    ji = jit.BatchIterator(j, queries[1], schedule=jit.LinearSchedule(1030, 8),
                           **kw)
    ti = tit.BatchIterator(t, queries[1],
                           schedule=tit.LinearSchedule(1030, 8), **kw)
    calls = []
    wide = tsearch._wide_search

    def spy(*args, **kwargs):
        calls.append(kwargs["pool_size"])
        return wide(*args, **kwargs)

    tsearch._wide_search = spy
    before = bs.beam_step.launches
    try:
        got, want = pages(ti, 1), pages(ji, 1)
        got += pages(ti, 1)
    finally:
        tsearch._wide_search = wide
    assert calls == [600 + 40 + 1030, 600 + 80 + 1038]
    assert bs.beam_step.launches == before
    assert_pages_agree(got[:1], want)
    ids = np.concatenate([p.ids[0] for p in got])
    assert len(np.unique(ids)) == ids.size == 80


def test_iterator_honours_the_entry_sampler(pool):
    """A sampled-entries graph is searched from the index's sampler: the
    same pages as JAX, first-page recall >= 0.8 (the JAX test's bar)."""
    data, queries = pool
    j = JIndex.build(JParams(**KW), data[:600], "l2", sampled_entries=True,
                     entry_sample_size=128)
    t = carry(j, sampler=True)
    gt = jexh(data[:600], queries[:4], 10).ids
    hits = 0
    for qi in range(4):
        got = pages(tit.BatchIterator(t, queries[qi]), 1)
        assert_pages_agree(got, pages(jit.BatchIterator(j, queries[qi]), 1))
        hits += len(set(got[0].ids[0]) & set(gt[qi]))
    assert hits / 40 >= 0.8


@pytest.fixture(scope="module")
def dynamic(pool):
    """A JAX dynamic index over 400 rows with the 128 nearest rows of query
    0 soft-deleted, and the port's over its state."""
    data, queries = pool
    j = jdyn.MutableVamanaIndex(JParams(**KW), data[:400], np.arange(400),
                                "l2")
    doomed = np.asarray(jexh(data[:400], queries[:1], 128).ids[0])
    j.delete_points(doomed)
    n = j.data.n
    t = interop.dynamic_vamana_from_arrays(
        np.asarray(j.data.vectors)[:n, : j.data.dim],
        np.asarray(j.graph.adjacency), np.asarray(j.graph.degrees),
        j.status[:n], j.translator.to_external(np.arange(n)),
        j.entry_point, j.distance.value,
        svt.VamanaBuildParameters(**dataclasses.asdict(j.parameters)),
        capacity=j.data.capacity, device="cpu")
    return j, t, doomed, queries


def test_deleted_slots_never_yielded(dynamic):
    """Deleted slots take pool room but are never yielded, and their
    crowding does not fake exhaustion: every one of five pages yields live
    neighbours, the pages JAX yields."""
    j, t, doomed, queries = dynamic
    assert t.size == j.size == 400 - 128
    for qi in (0, 3):
        ti = tit.BatchIterator(t, queries[qi], batch_size=10)
        ji = jit.BatchIterator(j, queries[qi], batch_size=10)
        got, want = pages(ti, 5), pages(ji, 5)
        assert not ti.done()
        assert_pages_agree(got, want)
        assert all((p.ids[0] >= 0).any() for p in got)
        ids = np.concatenate([p.ids[0] for p in got])
        ids = ids[ids >= 0]
        assert not set(ids.tolist()) & set(doomed.tolist())
        assert np.all(t.status[ids] == 1)


def test_sampler_on_the_dynamic_index(dynamic):
    """With the dynamic index's lazy sampler on, pages are drawn from it
    (the sample of VALID slots, as JAX draws it) and stay live."""
    j, t, doomed, queries = dynamic
    j.enable_entry_sampler(n_samples=64, seed=2)
    t.enable_entry_sampler(n_samples=64, seed=2)
    try:
        got = pages(tit.BatchIterator(t, queries[5]), 3)
        want = pages(jit.BatchIterator(j, queries[5]), 3)
    finally:
        j.disable_entry_sampler()
        t.disable_entry_sampler()
    assert_pages_agree(got, want)
    ids = np.concatenate([p.ids[0] for p in got])
    assert not set(ids.tolist()) & set(doomed.tolist())


def one_axis(**kw):
    """One value per axis, no split probes: the window is chosen by the
    recall alone, so both packages must choose the same."""
    base = dict(pop_widths=(4,), tail_fracs=(4,), capacity_multipliers=(1,),
                try_packed=False, trim_capacity=False, timing_reps=1,
                search_window_upper=32)
    base.update(kw)
    return base


def same_buffer(got, want) -> bool:
    """Two calibration results chose the same window and capacity."""
    g = got.search_parameters.buffer_config
    w = want.search_parameters.buffer_config
    return (g.search_window_size, g.search_buffer_capacity) == \
        (w.search_window_size, w.search_buffer_capacity)


@pytest.mark.parametrize("target", [0.8, 0.95])
def test_calibrated_window_equals_jax(built, target):
    j, t, data, queries = built
    gt = jexh(data, queries, 10).ids
    want = jcal.calibrate_full(j, queries, gt, 10, target,
                               jcal.CalibrationParameters(**one_axis()))
    got = tcal.calibrate_full(t, queries, gt, 10, target,
                              tcal.CalibrationParameters(**one_axis()))
    assert same_buffer(got, want)
    assert got.trials == want.trials
    assert abs(got.recall - want.recall) <= 0.01
    assert got.recall >= target
    assert t.search_parameters == got.search_parameters
    assert (got.pop_width, got.tail_frac, got.packed) == (4, 4, False)
    assert svt.k_recall_at_n(gt, t.search(queries, 10)) >= target


def test_int8_upload_axis(built):
    """try_int8_uploads probes int8 query uploads as an outermost axis
    (searches run under both dtypes); the winning dtype is recorded and set
    on the index, and its recall holds within 0.02 of the target.  Which
    state wins is decided by host-clock QPS, so the window is compared
    with JAX's with int8 uploads set beforehand, where recall alone
    decides it."""
    j, t, data, queries = built
    gt = jexh(data, queries, 10).ids
    seen, search = [], t.search

    def spy(*args, **kwargs):
        seen.append(t.query_upload_dtype)
        return search(*args, **kwargs)

    t.search = spy
    try:
        got = tcal.calibrate_full(t, queries, gt, 10, 0.9,
                                  tcal.CalibrationParameters(**one_axis(
                                      try_int8_uploads=True)))
        assert set(seen) == {None, "int8"}
        assert got.query_upload_dtype in (None, "int8")
        assert t.query_upload_dtype == got.query_upload_dtype
        rec = svt.k_recall_at_n(gt, t.search(queries, 10))
        assert rec >= 0.9 - 0.02, rec
        j.query_upload_dtype = t.query_upload_dtype = "int8"
        want = jcal.calibrate_full(j, queries, gt, 10, 0.9,
                                   jcal.CalibrationParameters(**one_axis()))
        got = tcal.calibrate_full(t, queries, gt, 10, 0.9,
                                  tcal.CalibrationParameters(**one_axis()))
        assert same_buffer(got, want)
        assert (got.query_upload_dtype, got.trials, got.recall) == \
            ("int8", want.trials, want.recall)
    finally:
        del t.search
        j.query_upload_dtype = t.query_upload_dtype = None


def test_unreachable_target_and_fractional_multiplier(built):
    """An unreachable target returns the best effort at the upper window,
    as JAX does; fractional capacity multipliers give int capacities; the
    orchestrator's ``.index`` calibrates (the quick start's call)."""
    j, t, data, queries = built
    gt = jexh(data, queries, 10).ids
    want = jcal.calibrate_full(j, queries, gt, 10, 1.01,
                               jcal.CalibrationParameters(**one_axis()))
    got = tcal.calibrate_full(t, queries, gt, 10, 1.01,
                              tcal.CalibrationParameters(**one_axis()))
    assert got.search_parameters.buffer_config.search_window_size == 32
    assert (got.qps, got.trials) == (0.0, want.trials)
    assert abs(got.recall - want.recall) <= 0.01
    res = tcal.calibrate_full(t, queries, gt, 10, 0.9, tcal.
                              CalibrationParameters(**one_axis(
                                  trim_capacity=True,
                                  capacity_multipliers=(1, 1.5))))
    cap = res.search_parameters.buffer_config.search_buffer_capacity
    assert isinstance(cap, int)
    assert res.recall >= 0.9
    vamana = svt.Vamana(t)
    params = svt.calibrate(vamana.index, queries, gt, 10, 0.9,
                           svt.CalibrationParameters(**one_axis()))
    assert vamana.index.search_parameters == params


def test_int8_axis_skips_the_dynamic_index_as_jax_does(dynamic, pool):
    """Only the static index declares ``query_upload_dtype``, in both
    packages, so ``try_int8_uploads`` adds no int8 trials on the dynamic
    index: both packages run the same trials, every search uploads in the
    default dtype, and neither index is left with an upload dtype."""
    j, t, _doomed, queries = dynamic
    data, _ = pool
    alive = np.nonzero(j.status[: j.data.n] == 1)[0]
    gt = jexh(data[:400][alive], queries, 10).ids
    gt = j.translator.to_external(alive)[gt]
    seen, search = [], t.search

    def spy(*args, **kwargs):
        seen.append(getattr(t, "query_upload_dtype", None))
        return search(*args, **kwargs)

    t.search = spy
    try:
        kw = one_axis(try_int8_uploads=True)
        want = jcal.calibrate_full(j, queries, gt, 10, 0.9,
                                   jcal.CalibrationParameters(**kw))
        got = tcal.calibrate_full(t, queries, gt, 10, 0.9,
                                  tcal.CalibrationParameters(**kw))
    finally:
        del t.search
    assert seen and set(seen) == {None}
    assert got.trials == want.trials
    assert got.query_upload_dtype is None and want.query_upload_dtype is None
    assert not hasattr(t, "query_upload_dtype")
    assert not hasattr(j, "query_upload_dtype")
    assert same_buffer(got, want)
