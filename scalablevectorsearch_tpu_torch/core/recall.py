"""Recall computation.

Analog of the reference's ``k_recall_at_n`` (``include/svs/core/recall.h:181``):
the mean over queries of |groundtruth[:k] ∩ results[:n]| / k.
"""

from __future__ import annotations

import numpy as np


def k_recall_at_n(groundtruth, results, n: int | None = None,
                  k: int | None = None) -> float:
    """Compute mean k-recall@n.

    Args:
      groundtruth: (n_queries, >=k) true neighbor ids.
      results: (n_queries, >=n) returned ids (QueryResult.ids or raw array).
      n: number of returned entries to consider (default: results width).
      k: number of groundtruth entries that must be recovered (default: n).
    """
    gt = np.asarray(getattr(groundtruth, "ids", groundtruth))
    res = np.asarray(getattr(results, "ids", results))
    if gt.shape[0] != res.shape[0]:
        raise ValueError("query count mismatch between groundtruth and results")
    if n is None:
        n = res.shape[1]
    if k is None:
        k = n
    if k > gt.shape[1]:
        raise ValueError(f"k={k} exceeds groundtruth width {gt.shape[1]}")
    if n > res.shape[1]:
        raise ValueError(f"n={n} exceeds results width {res.shape[1]}")
    if k > n:
        raise ValueError(f"k={k} > n={n}")
    hits = 0
    for row_gt, row_res in zip(gt[:, :k], res[:, :n]):
        hits += len(set(row_gt.tolist()) & set(row_res.tolist()))
    return hits / (k * gt.shape[0])
