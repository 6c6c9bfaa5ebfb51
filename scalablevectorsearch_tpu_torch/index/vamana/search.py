"""Lockstep batched greedy graph search.

PyTorch counterpart of ``scalablevectorsearch_tpu/index/vamana/search.py::
greedy_search``, both its branches.  A whole batch of queries advances in
lockstep: the search buffer is a dense (B, C) beam sorted ascending by key,
and every iteration gathers the popped nodes' neighbors, scores them, and
merges them into the beam.

Beams of up to 1024 slots (the JAX package's ``capacity <= 1024`` rule)
run the loop of the JAX kernel branch (``search.py:253-375``): an initial
pop, then expand -> step -> pop, where one kernel launch per iteration
scores (or takes scored keys), dedups, merges and pops on the GPU.  Each
kind of row has one route:
- f32 / bf16 ``VectorDataset`` rows, or bf16 / f32 packed super-rows:
  :func:`beam_step`;
- LVQ-8 codes, gathered per neighbour (``LVQDataset`` with 8 bits) or as
  packed code super-rows (``PackedLVQNeighborhoods`` with 8 bits):
  :func:`beam_step_lvq`, which decodes the codes in registers.  The JAX
  package decodes packed LVQ-8 super-rows to f32 and runs ``beam_step``
  instead (``search.py:322-326``); the function computed is the same, but on
  the GPU decoding inside the kernel avoids writing an f32 block four times
  the code bytes and reading it back.  Packed and unpacked LVQ-8 thus feed
  the same codes to the same kernel and give identical results;
- LVQ-4 rows, packed or not, and the two-level ``LVQFullView``: decoded to
  f32 (``affine_decode``), then :func:`beam_step`.  For unpacked LVQ-4 the
  JAX package takes its XLA branch; the function is the same;
- every other dataset, unpacked (float16 / int8 / uint8 ``VectorDataset``,
  ``SQDataset``): the **scored route**.  The candidates are scored first —
  an L2 ``VectorDataset`` by :func:`gather_score_l2_partial` straight from
  its table plus ``||q||^2``; decoded rows (``SQDataset.get``) and MIP /
  cosine by :func:`score_rows` over the gathered f32 rows — and
  :func:`beam_update` merges and pops.  The JAX package serves these
  datasets through its XLA branch, which pops first and merges last
  (``search.py:377-506``); popping at the end of one iteration or at the
  start of the next is the same search, and the tests hold the two to the
  same results.  In build mode the pool takes ``beam_update``'s survivors,
  which leave out candidates already in the beam; those entered the pool
  when they entered the beam, so the pool is the JAX branch's.

Beams of more than 1024 slots, for any dataset, take the **wide route**:
the JAX XLA branch ported as it is (pop the first m, expand, score as the
scored route does, torch sort-merge of beam and candidates, tail
compaction).  The route follows from the capacity before any launch; a
kernel that fails raises on either route.

The JAX ``while_loop`` is a Python loop here: its condition is read on the
host once per iteration.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ...core.data import VectorDataset
from ...core.graph import NeighborGraph
from ...ops import distance as dist_ops
from ...ops import topk as topk_ops
from ...ops.kernels.beam_step import (ID_MASK, MAX_WIDTH, VIS_BIT, beam_step,
                                      beam_step_lvq)
from ...ops.kernels.beam_update import beam_update
from ...ops.kernels.gather_distance import (gather_score_l2_partial,
                                            score_rows)
from ...quantization.lvq import LVQDataset, LVQFullView
from .packed import PackedLVQNeighborhoods

# Default multi-pop width for serving searches.
SERVING_POP_WIDTH = 4

_METRIC_CODES = {dist_ops.DistanceType.L2: 0, dist_ops.DistanceType.MIP: 1,
                 dist_ops.DistanceType.Cosine: 2}


@dataclasses.dataclass
class SearchOutput:
    """Beam contents (sorted ascending) + optional build pool per query.

    ``n_pops`` is the per-query expansion count (distance computes =
    n_pops * R)."""

    ids: torch.Tensor        # (B, C) int32, -1 where invalid
    keys: torch.Tensor       # (B, C) f32, +inf where invalid
    n_iters: int             # lockstep iterations executed
    n_pops: torch.Tensor     # (B,) int32: expansions per query
    pool_ids: torch.Tensor   # (B, P) int32 or (B, 0) when not tracked
    pool_keys: torch.Tensor  # (B, P) f32


def _compact_tail_phase(state, queries, b2, run, active_of):
    """Finish a lockstep search on a compacted straggler slice.

    ``state`` is ``(it, *row_tensors)``.  Unconverged queries are permuted
    to a dense prefix, the loop continues on the first ``b2`` rows only
    (per-iteration cost is linear in rows), and the finished rows are put
    back in order.
    """
    it0, *rows_state = state
    order = torch.argsort((~active_of(state)).to(torch.uint8), stable=True)
    inv = torch.argsort(order)
    perm = [x[order] for x in rows_state]
    sub_state = run((it0, *[x[:b2] for x in perm]), queries[order][:b2], 0)
    it1, *sub_rows = sub_state
    merged = [torch.cat([s, px[b2:]], dim=0)[inv]
              for s, px in zip(sub_rows, perm)]
    return (it1, *merged)


def _candidate_scorer(data, distance: dist_ops.DistanceType):
    """Scoring of the scored and wide routes: ``score(ids, q_rows, q2,
    rows=None)`` -> (B, K) keys, +inf for ids outside ``[0, n)``.

    An L2 ``VectorDataset`` without given rows goes through
    :func:`gather_score_l2_partial` over its table; everything else through
    :func:`score_rows` over ``rows`` (or ``data.get_f32`` of the ids)."""
    table = data.vectors if isinstance(data, VectorDataset) and \
        distance == dist_ops.DistanceType.L2 else None
    inf = float("inf")

    def score(ids, q_rows, q2, rows=None):
        clamped = ids.clamp(0, data.capacity - 1)
        if rows is None and table is not None:
            keys = dist_ops.keys_from_l2_partial(
                gather_score_l2_partial(table, clamped, q_rows), q2)
        else:
            if rows is None:
                rows = data.get_f32(clamped)
            dots, x2 = score_rows(rows.float().contiguous(), q_rows)
            keys = dist_ops.keys_from_parts(distance, dots, x2, q2)
        return torch.where((ids >= 0) & (ids < data.n), keys, inf)

    return score


def _beam_rows(data) -> bool:
    """Datasets whose rows go to the beam-step kernels (f32 / bf16 rows,
    LVQ codes or their decode); the others take the scored route."""
    return isinstance(data, (LVQDataset, LVQFullView)) or (
        isinstance(data, VectorDataset)
        and data.dtype in (torch.float32, torch.bfloat16))


def greedy_search(graph: NeighborGraph,
                  data,
                  queries: torch.Tensor,
                  entry_ids: torch.Tensor,
                  *,
                  window: int,
                  capacity: int,
                  max_iters: int,
                  distance: dist_ops.DistanceType,
                  pool_size: int = 0,
                  pop_width: int = SERVING_POP_WIDTH,
                  packed: Optional[torch.Tensor] = None,
                  tail_frac: int = 1,
                  visited_size: int = 0) -> SearchOutput:
    """Run lockstep greedy search for a batch of queries.

    Args:
      data: a ``VectorDataset`` (any element type), an ``SQDataset``, an
        ``LVQDataset`` or an ``LVQFullView``.
      queries: (B, d_pad) tensor on the dataset's device (f32 or bf16
        scored as given by the beam-step kernels; cast to f32 elsewhere).
      entry_ids: (E,) or (B, E) int32 entry points seeded into the beam.
      window: pop horizon; capacity: beam size (>= window; above 1024 the
        wide route).
      max_iters: iteration bound.
      pool_size: if > 0, track the running top-``pool_size`` of all scored
        candidates (build mode).
      pop_width: beam entries expanded per lockstep iteration.
      packed: optional (capacity, R, d) packed neighborhoods
        (``packed.pack_neighborhoods``), or ``PackedLVQNeighborhoods`` for
        LVQ data; with a lossy packed dtype the final beam is re-scored
        against the exact rows (LVQ decoding is exact: no re-score).
      tail_frac: F > 1 finishes the last B/F unconverged queries on a
        compacted slice.
      visited_size: > 0 keeps a per-query ring of the last popped ids and
        drops candidates found in it (rounded up to a multiple of
        ``pop_width``).

    Returns: SearchOutput with beams sorted ascending by key.
    """
    distance = dist_ops.as_distance(distance)
    b = queries.shape[0]
    c = capacity
    r = graph.max_degree
    m = pop_width
    if window > capacity:
        raise ValueError(f"window {window} > capacity {capacity}")
    if data.n > ID_MASK:
        raise ValueError(f"{data.n} rows: ids must stay below 2^30")
    device = queries.device
    inf = float("inf")

    if entry_ids.ndim == 1:
        entry_ids = entry_ids[None, :].expand(b, -1)
    entry_ids = entry_ids.to(torch.int32)
    e = entry_ids.shape[1]
    q_norms = queries.float().square().sum(-1)

    def score(ids: torch.Tensor) -> torch.Tensor:
        """(B, K) ids -> (B, K) keys with +inf for invalid ids."""
        vecs = data.get(ids.clamp_min(0))
        keys = dist_ops.gathered_keys(distance, queries, vecs,
                                      query_norms_sq=q_norms)
        return torch.where((ids >= 0) & (ids < data.n), keys, inf)

    # ---- seed the beam with the entry points --------------------------------
    entry_keys = topk_ops.mask_first_duplicates(score(entry_ids), entry_ids)
    if c >= e:
        beam_ids = torch.cat([entry_ids, entry_ids.new_full((b, c - e), -1)],
                             dim=1)
        beam_keys = torch.cat([entry_keys,
                               entry_keys.new_full((b, c - e), inf)], dim=1)
    else:
        beam_ids, beam_keys = entry_ids[:, :c], entry_keys[:, :c]
    beam_keys, beam_ids = topk_ops.sort_by_key(beam_keys, beam_ids)

    track = pool_size > 0
    p = pool_size if track else 0
    pool_ids0 = torch.full((b, p), -1, dtype=torch.int32, device=device)
    pool_keys0 = torch.full((b, p), inf, device=device)
    if track:
        pool_keys0, pool_ids0 = topk_ops.merge_smallest(
            pool_keys0, pool_ids0, entry_keys, entry_ids, p)

    # cross-iteration visited ring (a multiple of m, so each iteration
    # writes one aligned m-block)
    v = -(-visited_size // m) * m if visited_size > 0 else 0
    ring0 = torch.full((b, v), -1, dtype=torch.int32, device=device)

    packed_lvq = isinstance(packed, PackedLVQNeighborhoods)
    if c > MAX_WIDTH:
        return _wide_search(
            graph, data, queries.float().contiguous(), beam_ids, beam_keys,
            (pool_ids0, pool_keys0, ring0), _candidate_scorer(data, distance),
            score, window=window, max_iters=max_iters, pool_size=p,
            pop_width=m, packed=packed, tail_frac=tail_frac)

    metric = _METRIC_CODES[distance]
    n_data = data.n
    scored = packed is None and not _beam_rows(data)
    # LVQ-8 codes go to beam_step_lvq, packed or not; every other
    # quantized row is decoded to f32 before beam_step
    if packed_lvq:
        lvq8 = packed.bits == 8
    else:
        lvq8 = isinstance(data, LVQDataset) and data.bits == 8
    if lvq8 or scored or queries.dtype not in (torch.float32,
                                                 torch.bfloat16):
        queries = queries.float()
    queries = queries.contiguous()
    score_cands = _candidate_scorer(data, distance) if scored else None
    if lvq8:
        lvq_mean = data.mean if packed is None else packed.mean
        n_dead = data.padded_dim - data.dim
    # initial pop: the beam is sorted and unvisited — take the first m
    # finite in-window slots and mark them visited
    iota_c = torch.arange(c, device=device)
    in_win0 = (iota_c[None, :] < min(m, window)) & torch.isfinite(beam_keys)
    popped = torch.where(in_win0[:, :m], beam_ids[:, :m], -1)
    beam_packed = torch.where(torch.isfinite(beam_keys),
                              beam_ids + torch.where(in_win0, VIS_BIT, 0),
                              -1).to(torch.int32)

    def body(state, q_rows, q2):
        it, bk, bp, popped, n_pops, pool_ids, pool_keys, ring = state
        rows = q_rows.shape[0]
        has = popped >= 0                                   # (rows, m)
        n_pops = n_pops + has.sum(1, dtype=torch.int32)
        popped_flat = popped.clamp_min(0).reshape(-1)
        nbrs = graph.neighbors(popped_flat).reshape(rows, m * r)
        nbrs = torch.where(has.repeat_interleave(r, dim=1), nbrs, -1)
        nbrs = torch.where(nbrs < n_data, nbrs, -1)
        if v:
            # record this iteration's pops, drop candidates popped within
            # the last v expansions
            col = (it * m) % v
            ring = ring.clone()
            ring[:, col:col + m] = torch.where(has, popped, -1)
            seen = (nbrs[:, :, None] == ring[:, None, :]).any(-1)
            nbrs = torch.where(seen, -1, nbrs)
        if scored:
            cand_keys = score_cands(nbrs, q_rows, q2)
            bk, bp, popped, cand_keys, cand_ids = beam_update(
                bk, bp, cand_keys, nbrs, window=window, m=m)
            # the survivors sit in the first m * r columns
            cand_keys, cand_ids = cand_keys[:, :m * r], cand_ids[:, :m * r]
        # packed: m super-row gathers per query instead of m * r row
        # gathers; rows of masked ids are garbage, masked by id in the
        # kernel
        elif lvq8:
            if packed_lvq:
                codes, sc, bi = packed.gather(popped_flat, rows)
            else:
                cl = nbrs.clamp_min(0)
                codes, sc, bi = data.codes[cl], data.scales[cl], \
                    data.biases[cl]
            bk, bp, popped, cand_keys, cand_ids = beam_step_lvq(
                bk, bp, codes, sc, bi, lvq_mean, nbrs, q_rows,
                metric=metric, window=window, m=m, n_dead=n_dead)
        else:
            if packed_lvq:
                vecs = packed.decode(popped_flat, rows)
            elif packed is not None:
                vecs = packed[popped_flat.clamp_max(packed.shape[0] - 1)]
                vecs = vecs.reshape(rows, m * r, packed.shape[2])
            else:
                vecs = data.get(nbrs.clamp_min(0))
            bk, bp, popped, cand_keys, cand_ids = beam_step(
                bk, bp, vecs, nbrs, q_rows, metric=metric, window=window,
                m=m)
        if track:
            # mask candidates already pooled: hub nodes are re-scored in
            # every expansion that reaches them, and their copies would
            # crowd the pool
            cand_keys = topk_ops.mask_duplicate_ids(cand_keys, cand_ids,
                                                    pool_ids)
            pool_keys, pool_ids = topk_ops.merge_smallest(
                pool_keys, pool_ids, cand_keys, cand_ids, p)
        return (it + 1, bk, bp, popped, n_pops, pool_ids, pool_keys, ring)

    def run(state, q_rows, thresh):
        q2 = q_rows.float().square().sum(-1) if scored else None
        while state[0] < max_iters and \
                int((state[3] >= 0).any(1).sum()) > thresh:
            state = body(state, q_rows, q2)
        return state

    state = (0, beam_keys, beam_packed, popped,
             torch.zeros((b,), dtype=torch.int32, device=device),
             pool_ids0, pool_keys0, ring0)
    b2 = b // tail_frac if tail_frac > 1 else 0
    compact_tail = tail_frac > 1 and b2 >= 8
    state = run(state, queries, b2 if compact_tail else 0)
    if compact_tail:
        state = _compact_tail_phase(
            state, queries, b2, run,
            active_of=lambda s: (s[3] >= 0).any(1))
    it, beam_keys, beam_packed, popped, n_pops, pool_ids, pool_keys, _ = state
    beam_ids = torch.where(torch.isfinite(beam_keys), beam_packed & ID_MASK,
                           -1)
    if packed is not None and packed.dtype != data.dtype:
        # lossy packed traversal: re-score the final beam against the exact
        # rows and re-sort
        beam_keys, beam_ids = topk_ops.sort_by_key(score(beam_ids), beam_ids)
        beam_ids = torch.where(torch.isfinite(beam_keys), beam_ids, -1)
    return SearchOutput(ids=beam_ids, keys=beam_keys, n_iters=it,
                        n_pops=n_pops, pool_ids=pool_ids,
                        pool_keys=pool_keys)


def _wide_search(graph, data, queries, beam_ids, beam_keys, pools,
                 score_cands, score, *, window: int, max_iters: int,
                 pool_size: int, pop_width: int, packed, tail_frac: int
                 ) -> SearchOutput:
    """The wide route: the JAX package's XLA branch (``search.py:377-506``)
    as it is, for beams above the kernels' 1024 slots.  Each iteration pops
    the first m unvisited window slots, expands them, scores the
    candidates (``score_cands``: the scored route's kernels), masks
    repeats, tracks the pool, and sort-merges beam and candidates with a
    stable ``torch.sort``.  ``queries`` are f32."""
    pool_ids0, pool_keys0, ring0 = pools
    b, c = beam_keys.shape
    r = graph.max_degree
    m = pop_width
    v = ring0.shape[1]
    track = pool_size > 0
    device = queries.device
    iota_c = torch.arange(c, device=device)
    window_mask = (iota_c < window)[None, :]
    big = c + 1
    packed_lvq = isinstance(packed, PackedLVQNeighborhoods)
    beam_ids = beam_ids.to(torch.int32)
    beam_vis = torch.zeros((b, c), dtype=torch.int32, device=device)

    def unvisited_mask(keys, vis):
        return torch.isfinite(keys) & (vis == 0) & window_mask

    def body(state, q_rows, q2):
        it, beam_ids, beam_keys, beam_vis, n_pops, pool_ids, pool_keys, \
            ring = state
        rows = q_rows.shape[0]
        unvis = unvisited_mask(beam_keys, beam_vis)
        # the first m unvisited positions (the beam is sorted: the best m)
        pos_score = torch.where(unvis, iota_c[None, :], big)
        pos = torch.topk(pos_score, m, dim=1, largest=False).values
        has = pos < big
        pos_c = pos.clamp_max(c - 1)
        popped = torch.gather(beam_ids, 1, pos_c)
        hit = ((iota_c[None, None, :] == pos_c[:, :, None])
               & has[:, :, None]).any(1)
        beam_vis = torch.where(hit, 1, beam_vis)
        n_pops = n_pops + has.sum(1, dtype=torch.int32)

        popped_flat = popped.clamp_min(0).reshape(-1)
        nbrs = graph.neighbors(popped_flat).reshape(rows, m * r)
        nbrs = torch.where(has.repeat_interleave(r, dim=1), nbrs, -1)
        if v:
            col = (it * m) % v
            ring = ring.clone()
            ring[:, col:col + m] = torch.where(has, popped, -1)
            seen = (nbrs[:, :, None] == ring[:, None, :]).any(-1)
            nbrs = torch.where(seen, -1, nbrs)
        if packed_lvq:
            vecs = packed.decode(popped_flat, rows)
        elif packed is not None:
            vecs = packed[popped_flat.clamp_max(packed.shape[0] - 1)]
            vecs = vecs.reshape(rows, m * r, packed.shape[2])
        else:
            vecs = None
        cand_keys = score_cands(nbrs, q_rows, q2, rows=vecs)
        cand_keys = topk_ops.mask_first_duplicates(cand_keys, nbrs)
        if track:
            pool_cand_keys = topk_ops.mask_duplicate_ids(cand_keys, nbrs,
                                                         pool_ids)
            pool_keys, pool_ids = topk_ops.merge_smallest(
                pool_keys, pool_ids, pool_cand_keys, nbrs, pool_size)

        # beam dedup + sort-merge insert (ids packed with the visited flag)
        cand_keys = topk_ops.mask_duplicate_ids(cand_keys, nbrs, beam_ids)
        all_keys = torch.cat([beam_keys, cand_keys], 1)
        packed_rows = torch.cat([beam_ids + beam_vis * VIS_BIT, nbrs], 1)
        s_keys, order = torch.sort(all_keys, dim=1, stable=True)
        new_packed = torch.gather(packed_rows, 1, order)[:, :c]
        keep = has.any(1)[:, None]
        # empty (-1) entries unpack to garbage ids, but their keys stay
        # +inf; the final extraction restores -1
        beam_ids = torch.where(keep, new_packed & ID_MASK, beam_ids)
        beam_vis = torch.where(keep, new_packed >> 30, beam_vis)
        beam_keys = torch.where(keep, s_keys[:, :c], beam_keys)
        return (it + 1, beam_ids, beam_keys, beam_vis, n_pops, pool_ids,
                pool_keys, ring)

    def run(state, q_rows, thresh):
        q2 = q_rows.square().sum(-1)
        while state[0] < max_iters and int(unvisited_mask(
                state[2], state[3]).any(1).sum()) > thresh:
            state = body(state, q_rows, q2)
        return state

    state = (0, beam_ids, beam_keys, beam_vis,
             torch.zeros((b,), dtype=torch.int32, device=device),
             pool_ids0, pool_keys0, ring0)
    b2 = b // tail_frac if tail_frac > 1 else 0
    compact_tail = tail_frac > 1 and b2 >= 8
    state = run(state, queries, b2 if compact_tail else 0)
    if compact_tail:
        state = _compact_tail_phase(
            state, queries, b2, run,
            active_of=lambda s: unvisited_mask(s[2], s[3]).any(1))
    it, beam_ids, beam_keys, _vis, n_pops, pool_ids, pool_keys, _ = state
    beam_ids = torch.where(torch.isfinite(beam_keys), beam_ids, -1)
    if packed is not None and packed.dtype != data.dtype:
        beam_keys, beam_ids = topk_ops.sort_by_key(score(beam_ids), beam_ids)
        beam_ids = torch.where(torch.isfinite(beam_keys), beam_ids, -1)
    return SearchOutput(ids=beam_ids, keys=beam_keys, n_iters=it,
                        n_pops=n_pops, pool_ids=pool_ids,
                        pool_keys=pool_keys)


def default_max_iters(window: int) -> int:
    """Iteration bound: 2W + 16 (the JAX package's rule)."""
    return 2 * window + 16
