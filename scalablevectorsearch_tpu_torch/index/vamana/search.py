"""Lockstep batched greedy graph search.

PyTorch counterpart of the kernel branch of
``scalablevectorsearch_tpu/index/vamana/search.py::greedy_search``
(``search.py:253-375``).  A whole batch of queries advances in lockstep: the
search buffer is a dense (B, C) beam sorted ascending by key, and every
iteration gathers the popped nodes' neighbors, fetches their rows (from the
dataset, or from packed neighborhoods) and runs one beam-step kernel, which
scores, dedups, merges and pops on the GPU.

Each kind of row has one route:
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
  JAX package takes its XLA branch; the function is the same.

The JAX ``while_loop`` is a Python loop here: its condition (some query
still popped a node, within ``max_iters``) is read on the host once per
iteration.  The XLA branch of the JAX function (sharded data, capacities
above 1024) is not part of this package yet; such calls raise.
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
      data: a ``VectorDataset`` (f32 / bf16), an ``LVQDataset`` or an
        ``LVQFullView``.
      queries: (B, d_pad) tensor on the dataset's device (f32 or bf16
        scored as given; other dtypes are cast to f32).
      entry_ids: (E,) or (B, E) int32 entry points seeded into the beam.
      window: pop horizon; capacity: beam size (>= window, <= 1024).
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
    if capacity > MAX_WIDTH:
        raise ValueError(f"capacity {capacity} > {MAX_WIDTH}: the beam-step "
                         "kernel takes at most 1024 slots, and the JAX "
                         "package's XLA search branch is not ported")
    if not (isinstance(data, (LVQDataset, LVQFullView))
            or (isinstance(data, VectorDataset)
                and data.dtype in (torch.float32, torch.bfloat16))):
        raise ValueError(f"dataset {type(data).__name__} "
                         f"({getattr(data, 'dtype', None)}): searchable here "
                         "are float32 / bfloat16 VectorDatasets, "
                         "LVQDatasets and LVQFullViews")
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

    metric = _METRIC_CODES[distance]
    n_data = data.n
    packed_lvq = isinstance(packed, PackedLVQNeighborhoods)
    # LVQ-8 codes go to beam_step_lvq, packed or not; every other
    # quantized row is decoded to f32 before beam_step
    if packed_lvq:
        lvq8 = packed.bits == 8
    else:
        lvq8 = isinstance(data, LVQDataset) and data.bits == 8
    if lvq8 or queries.dtype not in (torch.float32, torch.bfloat16):
        queries = queries.float()
    queries = queries.contiguous()
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

    def body(state, q_rows):
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
        # packed: m super-row gathers per query instead of m * r row
        # gathers; rows of masked ids are garbage, masked by id in the
        # kernel
        if lvq8:
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
        while state[0] < max_iters and \
                int((state[3] >= 0).any(1).sum()) > thresh:
            state = body(state, q_rows)
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


def default_max_iters(window: int) -> int:
    """Iteration bound: 2W + 16 (the JAX package's rule)."""
    return 2 * window + 16
