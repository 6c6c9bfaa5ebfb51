"""Top-k selection and streaming merge primitives.

PyTorch counterpart of ``scalablevectorsearch_tpu/ops/topk.py``.  Every
selection is a stable sort (``torch.sort(stable=True)``): ties keep their
column order, as ``lax.top_k`` does.  ``torch.topk`` fixes no order for
ties, so it is not used here.

All keys are smaller-is-better (see ops.distance); INVALID ids are -1.
"""

from __future__ import annotations

from typing import Tuple

import torch

INVALID_ID = -1


def smallest_k(keys: torch.Tensor, ids: torch.Tensor | None, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Select the k smallest keys per row.

    Args:
      keys: (B, N) float32, +inf marks masked entries.
      ids: optional (B, N) or (N,) int32 ids; defaults to column indices.
      k: number of results.

    Returns:
      (B, k) keys ascending, (B, k) int32 ids (INVALID_ID where key is +inf).
    """
    s_keys, order = torch.sort(keys, dim=-1, stable=True)
    order = order[..., :k]
    out_keys = s_keys[..., :k]
    if ids is None:
        out_ids = order.to(torch.int32)
    elif ids.ndim == 1:
        out_ids = ids[order].to(torch.int32)
    else:
        out_ids = torch.gather(ids, -1, order).to(torch.int32)
    out_ids = torch.where(torch.isinf(out_keys), INVALID_ID, out_ids)
    return out_keys, out_ids


def merge_smallest(keys_a: torch.Tensor, ids_a: torch.Tensor,
                   keys_b: torch.Tensor, ids_b: torch.Tensor, k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge two per-row top-k sets into the combined k smallest."""
    keys = torch.cat([keys_a, keys_b], dim=-1)
    ids = torch.cat([ids_a, ids_b], dim=-1)
    return smallest_k(keys, ids, k)


def sort_by_key(keys: torch.Tensor, *operands: torch.Tensor
                ) -> Tuple[torch.Tensor, ...]:
    """Ascending stable sort of each row by key, carrying operand rows."""
    s_keys, order = torch.sort(keys, dim=-1, stable=True)
    return (s_keys,) + tuple(torch.gather(op, -1, order) for op in operands)


def mask_duplicate_ids(keys: torch.Tensor, ids: torch.Tensor,
                       against_ids: torch.Tensor) -> torch.Tensor:
    """Set keys to +inf where ``ids`` (B, R) appear in ``against_ids`` (B, C)."""
    dup = (ids[:, :, None] == against_ids[:, None, :]).any(-1)
    return torch.where(dup, float("inf"), keys)


def mask_first_duplicates(keys: torch.Tensor, ids: torch.Tensor
                          ) -> torch.Tensor:
    """Set keys to +inf for repeated ids *within* each row (keep first)."""
    r = ids.shape[1]
    eq = ids[:, :, None] == ids[:, None, :]
    earlier = torch.ones((r, r), dtype=torch.bool,
                         device=ids.device).tril(-1)[None]
    dup = (eq & earlier).any(-1)
    return torch.where(dup & (ids != INVALID_ID), float("inf"), keys)
