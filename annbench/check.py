"""The comparison that decides ``correct``, and the recall it reads.

Every answer served in the window is judged against the plain reference
(``reference.py``), once the window has closed:

- ``bad_slots``: result slots that say something wrong whatever the
  search's approximation: an id outside ``[0, n)`` (an unanswered slot
  reads -1), an id repeated within its row, a distance that is not
  finite, or a distance below the one before it in its row.  Exact:
  its limit is 0.
- ``dist_gap``: the widest gap between a served distance and the float64
  distance of the served id, over every valid slot, as a share of that
  distance or of the median exact 10th-neighbour distance of the pool,
  whichever is larger.  Its limit lies between what sound runs read and
  what the configuration's control (the program with its next lower
  precision switched on) reads.
- ``recall_at_10``: the share of each answered query's exact top-k that
  its answer holds, over every query answered.  It is an end-to-end
  metric, not a part of ``correct``: an exact search in a lower precision
  recalls more than the approximate search, so no control can set it a
  limit.
"""

from __future__ import annotations

import numpy as np
import torch

from . import reference

# queries judged per block
BLOCK = 1 << 16


def judge(rows: torch.Tensor, pool: torch.Tensor, answers: list, k: int,
          limits: dict) -> dict:
    """Judge ``answers``, a list of ``(pool indices (nq,), ids (nq, k),
    distances (nq, k))`` as served (host arrays), against the exact search
    over ``rows`` (n, d) for the ``pool`` queries (both float32 on the
    reference's device).  Returns the numbers, their limits and
    ``correct``."""
    device = rows.device
    n = rows.shape[0]
    truth_ids, truth_d = reference.exact_knn(rows, pool, k)
    scale = float(truth_d[:, -1].median())
    qidx = np.concatenate([a[0] for a in answers])
    ids = np.concatenate([np.asarray(a[1])[:, :k] for a in answers])
    dists = np.concatenate([np.asarray(a[2])[:, :k] for a in answers])
    bad_slots = 0
    bad_queries = 0
    gap = 0.0
    hits = 0
    for s in range(0, qidx.shape[0], BLOCK):
        qi = torch.from_numpy(qidx[s:s + BLOCK]).to(device)
        got = torch.from_numpy(ids[s:s + BLOCK]).to(device, torch.int64)
        dist = torch.from_numpy(dists[s:s + BLOCK]).to(device,
                                                       torch.float64)
        valid = (got >= 0) & (got < n)
        srt = torch.sort(torch.where(valid, got, -1 - torch.arange(
            k, device=device)), dim=1).values
        repeated = torch.zeros_like(valid)
        repeated[:, 1:] = srt[:, 1:] == srt[:, :-1]
        descends = torch.zeros_like(valid)
        descends[:, 1:] = dist[:, 1:] < dist[:, :-1]
        bad = ~valid | ~torch.isfinite(dist) | repeated | descends
        bad_slots += int(bad.sum())
        bad_queries += int(bad.any(1).sum())
        exact = reference.pair_distances(rows, pool[qi],
                                         got.clamp(0, n - 1))
        rel = (dist - exact).abs() / exact.clamp_min(scale)
        rel = torch.where(valid & torch.isfinite(dist), rel, 0.0)
        gap = max(gap, float(rel.max()))
        hits += int((got[:, :, None] == truth_ids[qi][:, None, :]).any(-1)
                    .sum())
    numbers = {"bad_slots": bad_slots, "dist_gap": gap}
    return {"numbers": numbers,
            "limits": {name: limits[name] for name in numbers},
            "correct": all(numbers[name] <= limits[name] for name in numbers),
            "answered": int(qidx.shape[0]), "failed": bad_queries,
            "recall_at_10": hits / max(1, qidx.shape[0] * k)}
