"""Randomized mutation harness for dynamic indexes.

PyTorch counterpart of ``scalablevectorsearch_tpu/utils/dynamic_helper.py``
(the reference's ``svs::misc::ReferenceDataset``,
``include/svs/misc/dynamic_helper.h:102-380``): keeps the ground-truth id ->
row map beside a mutable index, draws random add and delete batches, and
checks returned ids and recall after each operation.  Its ground truth is
this package's exact search, on ``device`` (``"cuda"`` unless given).
"""

from __future__ import annotations

import numpy as np

from ..core.recall import k_recall_at_n
from ..index.flat import exhaustive_search


class ReferenceDataset:
    """Ground-truth mirror of a mutable index's contents."""

    def __init__(self, all_points: np.ndarray, distance="l2", seed: int = 0,
                 device="cuda"):
        self.pool = np.asarray(all_points, dtype=np.float32)
        self.distance = distance
        self.device = device
        self.rng = np.random.default_rng(seed)
        self.live: dict[int, int] = {}      # external id -> pool row
        self.next_id = 0
        self.free_rows = list(range(self.pool.shape[0]))

    # -- mutation generators ---------------------------------------------------
    def new_batch(self, m: int):
        """Draw m unused pool rows with fresh external ids."""
        m = min(m, len(self.free_rows))
        rows = [self.free_rows.pop() for _ in range(m)]
        ids = np.arange(self.next_id, self.next_id + m, dtype=np.int64)
        self.next_id += m
        for e, r in zip(ids, rows):
            self.live[int(e)] = r
        return self.pool[rows], ids

    def delete_batch(self, m: int) -> np.ndarray:
        keys = np.fromiter(self.live.keys(), dtype=np.int64)
        m = min(m, keys.size)
        picked = self.rng.choice(keys, size=m, replace=False)
        for e in picked:
            self.free_rows.append(self.live.pop(int(e)))
        return picked

    # -- validation ----------------------------------------------------------------
    def groundtruth(self, queries: np.ndarray, k: int):
        ids = np.fromiter(self.live.keys(), dtype=np.int64)
        rows = np.array([self.live[int(e)] for e in ids], dtype=np.int64)
        res = exhaustive_search(self.pool[rows], queries, k,
                                distance=self.distance, device=self.device)
        mapped = np.where(res.ids >= 0, ids[np.maximum(res.ids, 0)], -1)
        return mapped

    def check_ids(self, result) -> None:
        """Every returned id must be live (reference id checks
        dynamic_helper.h:247-256)."""
        returned = np.asarray(result.ids)
        bad = [int(e) for e in np.unique(returned[returned >= 0])
               if int(e) not in self.live]
        if bad:
            raise AssertionError(
                f"index returned non-live external ids: {bad[:10]}")

    def check_recall(self, index, queries: np.ndarray, k: int,
                     floor: float) -> float:
        res = index.search(queries, k)
        self.check_ids(res)
        gt = self.groundtruth(queries, k)
        rec = k_recall_at_n(gt, res)
        if rec < floor:
            raise AssertionError(f"recall {rec:.4f} below floor {floor}")
        return rec
