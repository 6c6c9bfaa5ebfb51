"""Batched vectorized RobustPrune (alpha-RNG neighbor selection).

PyTorch counterpart of ``scalablevectorsearch_tpu/ops/prune.py`` with the
same rules: a whole batch of nodes is pruned in lockstep, the candidate
pairwise matrix is one batched matmul, and the sequential "select best
available, then suppress" recurrence is a fixed-length loop of masked steps
(one selection per step across the batch).

* **progressive** (L2): per-candidate ``ratio = max_p key(q,t) / D(p,t)``;
  a candidate is available at level ``a`` iff ``ratio <= a``; levels
  {1.0, alpha}.  Like the JAX package, and unlike SVS (prune.h:224), the
  ratios accumulate for every later candidate, suppressed ones included —
  a deliberate departure the JAX package documents.
* **iterative** (MIP/cosine): boolean exclusion
  ``cur_alpha * sim(p, t) > sim(q, t)`` with the pruned state reset between
  the two rounds (no reset when alpha == 1.0).

Candidate pools must be sorted ascending by key.  The pool vectors are
whatever the dataset's ``get_f32`` returns: the decoded rows for a
compressed dataset, as in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import distance as dist_ops

_UNSELECTED = 2 ** 30


def robust_prune(pool_ids: torch.Tensor,
                 pool_keys: torch.Tensor,
                 pool_vectors: torch.Tensor,
                 pool_norms_sq: torch.Tensor,
                 self_ids: torch.Tensor,
                 alpha: float,
                 max_result: int,
                 distance: dist_ops.DistanceType
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prune candidate pools for a batch of nodes.

    Args:
      pool_ids: (b, P) int32 candidate ids sorted ascending by key; -1 = pad.
      pool_keys: (b, P) f32 keys node->candidate (+inf for padding).
      pool_vectors: (b, P, d) candidate vectors (already gathered).
      pool_norms_sq: (b, P) f32 squared norms of candidates.
      self_ids: (b,) the node each pool belongs to (excluded from results).
      alpha: pruning parameter (> 1 for L2, < 1 for MIP/cosine).
      max_result: max neighbors to keep.

    Returns:
      (b, max_result) int32 selected ids, -1-padded, in selection order;
      (b,) int32 result degrees.
    """
    distance = dist_ops.as_distance(distance)
    b, p = pool_ids.shape
    device = pool_ids.device
    iota_p = torch.arange(p, device=device)
    rows = torch.arange(b, device=device)
    inf = float("inf")

    vf = pool_vectors.float()
    with dist_ops.matmul_precision(dist_ops.HIGHEST):
        dots = torch.bmm(vf, vf.transpose(1, 2))
    if distance == dist_ops.DistanceType.L2:
        pair = (pool_norms_sq[:, :, None] - 2.0 * dots
                + pool_norms_sq[:, None, :]).clamp_min(0.0)
    elif distance == dist_ops.DistanceType.MIP:
        pair = dots  # similarities
    else:  # Cosine
        norms = pool_norms_sq.clamp_min(1e-30).sqrt()
        pair = dots / (norms[:, :, None] * norms[:, None, :])

    valid = (pool_ids >= 0) & (pool_ids != self_ids[:, None]) & \
        torch.isfinite(pool_keys)
    progressive = distance == dist_ops.DistanceType.L2
    steps_per_round = max_result
    alpha32 = np.float32(alpha)
    levels = (torch.tensor(1.0, device=device),
              torch.tensor(alpha32, device=device))

    sel_step = torch.full((b, p), _UNSELECTED, dtype=torch.int32,
                          device=device)
    if progressive:
        aux = torch.full((b, p), -inf, device=device)
    else:
        aux = torch.zeros((b, p), device=device)  # 1.0 = pruned this round
    sims_q = -pool_keys
    n_sel = torch.zeros((b,), dtype=torch.int32, device=device)

    for i in range(2 * steps_per_round):
        cur_alpha = levels[i // steps_per_round]
        unselected = sel_step == _UNSELECTED
        not_pruned = aux <= cur_alpha if progressive else aux == 0.0
        available = valid & unselected & not_pruned & \
            (n_sel < max_result)[:, None]
        has = available.any(1)
        pos = available.to(torch.int8).argmax(1)   # first available
        one_hot = (iota_p[None, :] == pos[:, None]) & has[:, None]
        sel_step = torch.where(one_hot, i, sel_step)
        n_sel = n_sel + has.to(torch.int32)

        # suppress later candidates using the selected row of `pair`
        pair_row = pair[rows, pos]                       # (b, p)
        later_sel = (iota_p[None, :] > pos[:, None]) & has[:, None]
        if progressive:
            contrib = torch.where(pair_row > 0.0, pool_keys / pair_row, inf)
            aux = torch.where(later_sel, torch.maximum(aux, contrib), aux)
            aux = torch.where(one_hot, inf, aux)
        else:
            prune_now = cur_alpha * pair_row > sims_q
            aux = torch.where(later_sel & prune_now, 1.0, aux)
            # reset pruned state at the round boundary (prune.h:168-172)
            if i == steps_per_round - 1 and alpha32 != 1.0:
                aux = torch.zeros_like(aux)

    # ids in selection order, -1 padded
    order_key, order = torch.sort(sel_step, dim=1, stable=True)
    result = torch.gather(pool_ids, 1, order)[:, :max_result]
    kept = order_key[:, :max_result] < _UNSELECTED
    result = torch.where(kept, result, -1)
    return result.to(torch.int32), n_sel
