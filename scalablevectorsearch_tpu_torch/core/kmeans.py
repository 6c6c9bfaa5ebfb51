"""Minimal Lloyd's k-means over device tensors.

PyTorch counterpart of ``scalablevectorsearch_tpu/core/kmeans.py`` (the
reference's ``core/kmeans.h`` ``kmeans_clustering``): the small
general-purpose clustering utility.  The IVF training pipeline (minibatch +
hierarchical) lives in ``index/ivf/kmeans.py`` and shares its seeding and its
fixed-order per-cluster sums.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..index.ivf.kmeans import _kmeanspp_init, _segment_sums
from ..ops import distance as dist_ops


def assign_clusters(x: torch.Tensor, centroids: torch.Tensor
                    ) -> torch.Tensor:
    """(N, d), (K, d) -> (N,) argmin-L2 assignment via one matmul."""
    keys = dist_ops.pairwise_keys(dist_ops.DistanceType.L2, x, centroids)
    return torch.argmin(keys, dim=-1).to(torch.int32)


def _lloyd_step(x: torch.Tensor, centroids: torch.Tensor, num_clusters: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    assign = assign_clusters(x, centroids)
    sums, counts = _segment_sums(x, assign, num_clusters)
    new_centroids = sums / counts.clamp_min(1.0)[:, None]
    # keep empty clusters where they were
    new_centroids = torch.where((counts > 0)[:, None], new_centroids,
                                centroids)
    return new_centroids, assign


def kmeans_clustering(x, num_clusters: int, num_iterations: int = 10,
                      seed: int = 0, device="cuda"
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Run Lloyd's iterations on ``device``; returns (centroids (K, d),
    assignments (N,)) on the host."""
    x = torch.from_numpy(np.asarray(x, dtype=np.float32)).to(device)
    n = x.shape[0]
    if num_clusters > n:
        raise ValueError(f"num_clusters {num_clusters} > n {n}")
    centroids = _kmeanspp_init(x, seed, num_clusters)
    assign = None
    for _ in range(num_iterations):
        centroids, assign = _lloyd_step(x, centroids, num_clusters)
    return (centroids.cpu().numpy(),
            None if assign is None else assign.cpu().numpy())
