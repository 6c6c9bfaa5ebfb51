"""IVF index: the full-precision rerank pass.

PyTorch counterpart of the part of ``scalablevectorsearch_tpu/index/ivf/
index.py`` that the Vamana index uses: :func:`rerank_kernel`, which two-level
LVQ serving runs on the retained beam.  The IVF index itself is not part of
this package yet.
"""

from __future__ import annotations

import torch

from ...ops import distance as dist_ops
from ...ops import topk as topk_ops


def rerank_kernel(rerank_data, queries: torch.Tensor, cand_keys,
                  cand_ids: torch.Tensor, *, k: int,
                  distance: dist_ops.DistanceType):
    """Re-score candidates against ``rerank_data`` (any dataset-protocol
    object: ``get`` / ``norms_of``) and keep the k smallest.  ``cand_keys``
    is ignored, as in the JAX package.  Returns keys (B, k), ids (B, k)."""
    del cand_keys
    q_norms = queries.float().square().sum(-1)
    clamped = cand_ids.clamp_min(0)
    keys = dist_ops.gathered_keys(distance, queries,
                                  rerank_data.get(clamped),
                                  gathered_norms_sq=rerank_data.norms_of(
                                      clamped),
                                  query_norms_sq=q_norms)
    keys = torch.where(cand_ids >= 0, keys, float("inf"))
    return topk_ops.smallest_k(keys, cand_ids, k)
