"""Per-query sampled entry-point selection.

PyTorch counterpart of ``scalablevectorsearch_tpu/index/vamana/entry.py``.
A small uniform sample of the dataset stays resident, and each query starts
its greedy search at its nearest sampled row, found with one matmul against
the sample, instead of walking from the medioid.  The sample size scales
with the dataset (``auto_samples``); above ``SELECT_CHUNK`` rows the
selection folds over chunks of the sample with a running minimum, which
bounds the (B, S) key panel.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ...ops import distance as dist_ops
from ...ops import topk as topk_ops

DEFAULT_SAMPLES = 1024
MAX_SAMPLES = 65536
SELECT_CHUNK = 8192


def auto_samples(n: int) -> int:
    """Scale-aware default sample size: ~n/128 rows, floored at 1024 and
    capped at 65536 (the JAX package's measured settings)."""
    return int(min(max(DEFAULT_SAMPLES, n // 128), MAX_SAMPLES))


@dataclasses.dataclass
class EntrySampler:
    """Resident dataset sample for per-query entry selection.

    ``ids`` slots may be -1 (excluded); their keys are masked to +inf so
    ``select`` never returns them.
    """

    vectors: torch.Tensor    # (S, d_pad) f32
    norms_sq: torch.Tensor   # (S,) f32
    ids: torch.Tensor        # (S,) int32, -1 = excluded slot

    def select(self, distance, queries: torch.Tensor, n_entries: int = 1,
               invalid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, d_pad) queries -> (B, n_entries) int32 entry ids.

        ``invalid``: optional (S,) bool marking slots to exclude for this
        call."""
        distance = dist_ops.as_distance(distance)
        q = queries.float()
        bad = self.ids < 0
        if invalid is not None:
            bad = bad | invalid
        if self.vectors.shape[0] > SELECT_CHUNK:
            return self._select_chunked(distance, q, bad, n_entries)
        keys = dist_ops.pairwise_keys(distance, q, self.vectors,
                                      vector_norms_sq=self.norms_sq)
        keys = torch.where(bad[None, :], float("inf"), keys)
        if n_entries == 1:
            return self.ids[torch.argmin(keys, dim=-1)][:, None]
        _, idx = torch.sort(keys, dim=-1, stable=True)
        return self.ids[idx[:, :n_entries]]

    def _select_chunked(self, distance, q: torch.Tensor, bad: torch.Tensor,
                        n_entries: int = 1) -> torch.Tensor:
        """Running-min fold over SELECT_CHUNK-row sample slices (ties go to
        the lowest slot, as in the one-shot select)."""
        b, inf = q.shape[0], float("inf")
        best_keys = torch.full((b, n_entries), inf, device=q.device)
        best_ids = torch.full((b, n_entries), -1, dtype=torch.int32,
                              device=q.device)
        for start in range(0, self.vectors.shape[0], SELECT_CHUNK):
            stop = start + SELECT_CHUNK
            keys = dist_ops.pairwise_keys(
                distance, q, self.vectors[start:stop],
                vector_norms_sq=self.norms_sq[start:stop])
            keys = torch.where(bad[None, start:stop], inf, keys)
            ids = self.ids[start:stop][None, :].expand(b, -1)
            if n_entries == 1:
                j = torch.argmin(keys, dim=-1, keepdim=True)
                ck = torch.gather(keys, 1, j)
                better = ck < best_keys
                best_keys = torch.where(better, ck, best_keys)
                best_ids = torch.where(better, torch.gather(ids, 1, j),
                                       best_ids)
            else:
                best_keys, best_ids = topk_ops.merge_smallest(
                    best_keys, best_ids, keys, ids, n_entries)
        # all-invalid rows: the one-shot argmin over an all-inf panel
        # returns slot 0's id; match it
        return torch.where(best_ids < 0, self.ids[0], best_ids)


def build_sampler(data, n_samples: Optional[int] = None, *,
                  ids: Optional[np.ndarray] = None,
                  seed: int = 0) -> EntrySampler:
    """Sample ``n_samples`` rows uniformly from ``data`` (``None`` =
    :func:`auto_samples`).  The draw is ``numpy.random.default_rng(seed)``,
    as in the JAX package, so both packages pick the same rows.  ``ids``
    overrides the uniform sample."""
    if n_samples is None:
        n_samples = auto_samples(data.n)
    if ids is None:
        rng = np.random.default_rng(seed)
        ids = rng.choice(data.n, size=min(n_samples, data.n),
                         replace=False).astype(np.int32)
    else:
        ids = np.array(ids, dtype=np.int32)[:n_samples]
    dev_ids = torch.from_numpy(ids).to(data.device)
    vectors = data.get_f32(dev_ids)
    return EntrySampler(vectors=vectors, norms_sq=vectors.square().sum(-1),
                        ids=dev_ids)
