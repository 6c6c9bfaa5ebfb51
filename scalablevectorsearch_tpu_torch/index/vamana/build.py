"""Batched synchronous Vamana graph construction.

PyTorch counterpart of ``scalablevectorsearch_tpu/index/vamana/build.py``,
with the same round structure (the reference's ``VamanaBuilder``,
``vamana_build.h``):

  1. greedy search with pool tracking for every node of the batch over the
     round-start graph, pool ∪ current adjacency, batched RobustPrune with
     the build alpha, whole-row commit;
  2. reverse edges: sort by destination, rank within each destination, and
     append the first (R - degree) backedges in place; overflowing
     destinations are re-pruned to ``prune_to`` with the pass alpha over
     {adjacency ∪ overflow backedges}.

Two passes over all batches, reverse-edge alphas 1.0 then ``alpha``.  The
dataset is any dataset-protocol object (``VectorDataset`` of any element
type, ``SQDataset``, ``LVQDataset``, ``LVQFullView``): rows go through
``get`` / ``get_f32`` and norms through ``norms_of``, so compressed data is
searched and pruned on its decoded rows (float16 / int8 / SQ searches take
``greedy_search``'s scored route).  The
JAX package's ``associative_scan(jnp.maximum)`` is ``torch.cummax`` here,
and its dropped (``mode="drop"``) scatters write into sink slots that are
sliced off.  Sorts are stable, so the build is deterministic for a fixed
batch size; graphs differ from the JAX package's where its sorts break ties
differently, and parity is statistical (recall, mean degree).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ...core.graph import NeighborGraph
from ...core.medioid import compute_medioid
from ...lib import logging as svs_logging
from ...lib import timing
from ...ops import distance as dist_ops
from ...ops import prune as prune_ops
from ...ops import topk as topk_ops
from . import search as search_mod
from .params import VamanaBuildParameters

_INT_MAX = 2 ** 31 - 1
MAX_BACKEDGES = 16   # per-destination reverse-edge overflow cap per round


def _score_against(data, distance, queries, q_norms, ids):
    """Keys from each query row to its gathered candidate ids (+inf invalid)."""
    clamped = ids.clamp_min(0)
    keys = dist_ops.gathered_keys(distance, queries, data.get(clamped),
                                  gathered_norms_sq=data.norms_of(clamped),
                                  query_norms_sq=q_norms)
    return torch.where((ids >= 0) & (ids < data.n), keys, float("inf"))


def _prune_pools(data, pool_ids, pool_keys, self_ids,
                 alpha: float, max_result: int, distance, chunk: int):
    """Chunked batched RobustPrune: gathers pool vectors per chunk to bound
    the (chunk, P, P) pairwise matrix in memory."""
    rows, degs = [], []
    for start in range(0, pool_ids.shape[0], chunk):
        ids = pool_ids[start:start + chunk]
        clamped = ids.clamp_min(0)
        norms = torch.where(ids >= 0, data.norms_of(clamped), float("inf"))
        r, dg = prune_ops.robust_prune(
            ids, pool_keys[start:start + chunk], data.get_f32(clamped), norms,
            self_ids[start:start + chunk], alpha, max_result, distance)
        rows.append(r)
        degs.append(dg)
    return torch.cat(rows), torch.cat(degs)


def _pad_cols(rows: torch.Tensor, width: int) -> torch.Tensor:
    if rows.shape[1] >= width:
        return rows
    return torch.cat([rows, rows.new_full((rows.shape[0],
                                           width - rows.shape[1]), -1)], 1)


def build_round(graph: NeighborGraph,
                data,
                batch_ids: torch.Tensor,
                batch_valid: torch.Tensor,
                entry_ids: torch.Tensor,
                sampler=None,
                sample_invalid: Optional[torch.Tensor] = None,
                *,
                window: int, capacity: int, max_iters: int,
                distance: dist_ops.DistanceType, pool_size: int,
                gen_alpha: float, rev_alpha: float, prune_to: int,
                max_degree: int, prune_chunk: int, pop_width: int = 4,
                prune_pool: int = 0, tail_frac: int = 1):
    """One synchronous build round over a batch of nodes: search -> prune
    -> commit -> reverse-edge append -> overflow grouping -> reprune.

    Returns (graph, dropped_backedges): ``dropped_backedges`` is a device
    scalar counting overflow backedges beyond the per-round caps.
    """
    r = max_degree
    b = batch_ids.shape[0]
    device = batch_ids.device
    queries = data.get(batch_ids)
    q_norms = data.norms_of(batch_ids)

    if sampler is not None:
        # per-node sampled entries; ``sample_invalid`` masks sample rows
        # not yet inserted, and with none valid (round 0) the given entry
        # is used
        sel = sampler.select(distance, queries, invalid=sample_invalid)
        ok = sampler.ids >= 0
        if sample_invalid is not None:
            ok = ok & ~sample_invalid
        fallback = entry_ids[:1][None, :].expand(sel.shape).to(sel.dtype)
        entry_ids = torch.where(ok.any(), sel, fallback)

    # --- 1. search with pool tracking -----------------------------------
    out = search_mod.greedy_search(
        graph, data, queries, entry_ids,
        window=window, capacity=capacity, max_iters=max_iters,
        distance=distance, pool_size=pool_size, pop_width=pop_width,
        tail_frac=tail_frac)
    pool_ids, pool_keys = out.pool_ids, out.pool_keys

    # --- merge current adjacency (vamana_build.h:424-441) ----------------
    own = graph.neighbors(batch_ids)
    own_keys = _score_against(data, distance, queries, q_norms, own)
    own_keys = topk_ops.mask_duplicate_ids(own_keys, own, pool_ids)
    pool_keys, pool_ids = topk_ops.merge_smallest(
        pool_keys, pool_ids, own_keys, own, pool_size)
    # drop duplicate ids introduced by search re-scoring, keep best-sorted
    pool_keys = topk_ops.mask_first_duplicates(pool_keys, pool_ids)
    pool_keys, pool_ids = topk_ops.sort_by_key(pool_keys, pool_ids)
    pool_ids = torch.where(torch.isfinite(pool_keys), pool_ids, -1)

    # --- 2. prune + commit ----------------------------------------------
    pp = prune_pool if 0 < prune_pool < pool_size else pool_size
    new_rows, new_degs = _prune_pools(
        data, pool_ids[:, :pp], pool_keys[:, :pp], batch_ids, gen_alpha, r,
        distance, prune_chunk)
    new_rows = _pad_cols(new_rows, r)
    commit_ids = torch.where(batch_valid, batch_ids, graph.capacity)
    graph = graph.replace_rows(commit_ids, new_rows, new_degs)

    # --- 3. reverse edges -------------------------------------------------
    dst = new_rows.reshape(-1)
    src = batch_ids[:, None].expand(b, r).reshape(-1)
    valid_e = (dst >= 0) & batch_valid[:, None].expand(b, r).reshape(-1)
    # drop edges whose src is already in dst's adjacency
    already = (graph.neighbors(dst.clamp_min(0)) == src[:, None]).any(1)
    valid_e = valid_e & ~already

    sort_key = torch.where(valid_e, dst, _INT_MAX)
    sort_key, order = torch.sort(sort_key, stable=True)
    dst_s, src_s = dst[order], src[order]
    valid_s = sort_key != _INT_MAX
    e = dst_s.shape[0]
    iota_e = torch.arange(e, device=device)
    seg_start = torch.ones(e, dtype=torch.bool, device=device)
    seg_start[1:] = sort_key[1:] != sort_key[:-1]
    group_start = torch.cummax(torch.where(seg_start, iota_e, 0), 0).values
    rank = iota_e - group_start

    slot = graph.degrees_of(dst_s.clamp_min(0)) + rank
    append_ok = valid_s & (slot < r)
    graph = graph.scatter_edges(dst_s, slot, src_s, append_ok)

    # --- 4. overflow grouping + reprune ------------------------------------
    # overflow entries are contiguous per destination in the sorted edge
    # stream; group them into an (m_cap, kb) backedge matrix on the device
    overflow = valid_s & (slot >= r)
    m_cap, kb = b, MAX_BACKEDGES
    prev_ov = torch.zeros_like(overflow)
    prev_ov[1:] = overflow[:-1]
    ov_first = overflow & (~prev_ov | seg_start)
    group_id = torch.cumsum(ov_first.to(torch.int64), 0) - 1
    first_ov_idx = torch.cummax(torch.where(ov_first, iota_e, 0), 0).values
    col = iota_e - first_ov_idx
    in_cap = overflow & (group_id < m_cap) & (col < kb)
    dropped = (overflow & ~in_cap).sum()

    back_flat = torch.full((m_cap * kb + 1,), -1, dtype=torch.int32,
                           device=device)
    back_flat[torch.where(in_cap, group_id * kb + col, m_cap * kb)] = src_s
    backedges = back_flat[:m_cap * kb].reshape(m_cap, kb)

    ov_ids = torch.zeros((m_cap + 1,), dtype=torch.int32, device=device)
    ov_ids[torch.where(ov_first & (group_id < m_cap), group_id, m_cap)] = \
        dst_s
    ov_ids = ov_ids[:m_cap]
    n_groups = ov_first.sum()
    ov_valid = torch.arange(m_cap, device=device) < \
        torch.clamp_max(n_groups, m_cap)

    graph = _reprune_body(graph, data, ov_ids, ov_valid, backedges,
                          alpha=rev_alpha, prune_to=prune_to,
                          distance=distance, max_degree=r,
                          prune_chunk=prune_chunk)
    return graph, dropped


def _reprune_body(graph: NeighborGraph,
                  data,
                  node_ids: torch.Tensor,
                  node_valid: torch.Tensor,
                  backedges: torch.Tensor,
                  *,
                  alpha: float, prune_to: int,
                  distance: dist_ops.DistanceType, max_degree: int,
                  prune_chunk: int) -> NeighborGraph:
    """Re-prune overflowing destinations (vamana_build.h:510-579): candidate
    set = current adjacency ∪ overflow backedges, pruned to ``prune_to``."""
    queries = data.get(node_ids)
    q_norms = data.norms_of(node_ids)
    adj = graph.neighbors(node_ids.clamp_min(0))
    cand_ids = torch.cat([adj, backedges], dim=1)
    cand_keys = _score_against(data, distance, queries, q_norms, cand_ids)
    cand_keys = topk_ops.mask_first_duplicates(cand_keys, cand_ids)
    cand_keys = torch.where(node_valid[:, None], cand_keys, float("inf"))
    cand_keys, cand_ids = topk_ops.sort_by_key(cand_keys, cand_ids)
    cand_ids = torch.where(torch.isfinite(cand_keys), cand_ids, -1)

    rows, degs = _prune_pools(data, cand_ids, cand_keys, node_ids,
                              alpha, prune_to, distance, prune_chunk)
    commit = torch.where(node_valid, node_ids, graph.capacity)
    return graph.replace_rows(commit, _pad_cols(rows, max_degree), degs)


# ---------------------------------------------------------------------------
# Host-side build loop
# ---------------------------------------------------------------------------

def default_batch_size(n: int) -> int:
    """Reference batch schedule: num_batches = max(40, n/4096)
    (vamana_build.h:239-249) => batch = min(4096, ceil(n/40))."""
    return max(8, min(4096, -(-n // 40)))


def build_graph(data,
                params: VamanaBuildParameters,
                distance,
                *,
                entry_point: Optional[int] = None,
                batch_size: Optional[int] = None,
                prune_chunk: int = 256,
                pop_width: int = 4,
                prune_pool: int = 0,
                tail_frac: int = 1,
                first_pass_window: Optional[int] = None,
                sampled_entries: bool = False,
                entry_sample_size: Optional[int] = None,
                logger=None,
                timer: Optional[timing.Timer] = None,
                ) -> Tuple[NeighborGraph, int]:
    """Build a Vamana graph over ``data``; returns (graph, entry_point).

    Medioid entry point, then two construct passes (reverse-edge alphas 1.0
    then alpha).  ``first_pass_window``: optional smaller search window for
    pass 1.  ``sampled_entries``: start each node's build search from its
    nearest row in a resident sample instead of the medioid (pass 1 masks
    sample rows not yet inserted).
    """
    distance = dist_ops.as_distance(distance)
    params = params.resolved(distance)
    logger = svs_logging.as_logger(logger)
    timer = timing.as_timer(timer)
    n = data.n
    r = params.graph_max_degree
    device = data.device

    with timer.scope("entry point"):
        entry = entry_point if entry_point is not None else \
            compute_medioid(data)
    entry_ids = torch.tensor([entry], dtype=torch.int32, device=device)

    sampler = None
    sample_ids_host = None
    if sampled_entries:
        from .entry import build_sampler
        sampler = build_sampler(data, entry_sample_size, seed=0)
        sample_ids_host = sampler.ids.cpu().numpy()

    graph = NeighborGraph.empty(n, r, device=device)
    b = batch_size if batch_size is not None else default_batch_size(n)
    pool_size = params.max_candidate_pool_size
    num_batches = -(-n // b)
    pass_alphas = (1.0, float(params.alpha))
    pass_windows = (first_pass_window or params.window_size,
                    params.window_size)
    logger.info("vamana build: n=%d R=%d windows=%s pool=%d batch=%d "
                "(%d rounds/pass)", n, r, pass_windows, pool_size, b,
                num_batches)

    dropped_total = torch.zeros((), dtype=torch.int64, device=device)
    for pass_idx, rev_alpha in enumerate(pass_alphas):
        window = pass_windows[pass_idx]
        max_iters = search_mod.default_max_iters(window)
        with timer.scope(f"pass {pass_idx + 1}"):
            for batch_idx in range(num_batches):
                start = batch_idx * b
                ids = np.arange(start, start + b, dtype=np.int32)
                valid = ids < n
                ids = np.minimum(ids, n - 1)
                # pass 1 inserts in id order: sample rows >= start have no
                # adjacency yet and must not be selected as entries
                sample_invalid = None if sampler is None else \
                    torch.from_numpy(sample_ids_host >= (
                        n if pass_idx else start)).to(device)
                graph, dropped = build_round(
                    graph, data, torch.from_numpy(ids).to(device),
                    torch.from_numpy(valid).to(device),
                    entry_ids, sampler, sample_invalid,
                    window=window, capacity=window, max_iters=max_iters,
                    distance=distance, pool_size=pool_size,
                    gen_alpha=float(params.alpha),
                    rev_alpha=float(rev_alpha), prune_to=params.prune_to,
                    max_degree=r, prune_chunk=prune_chunk,
                    pop_width=pop_width, prune_pool=prune_pool,
                    tail_frac=tail_frac)
                dropped_total += dropped
        logger.info("pass %d/%d complete (alpha=%.3f)", pass_idx + 1,
                    len(pass_alphas), rev_alpha)
    if int(dropped_total):
        logger.debug("build dropped %d overflow backedges beyond static "
                     "caps", int(dropped_total))
    return graph, int(entry)
