"""Dynamic (mutable) flat index.

PyTorch counterpart of ``scalablevectorsearch_tpu/index/dynamic_flat.py``
(the reference's ``DynamicFlatIndex``, ``include/svs/index/flat/
dynamic_flat.h``): rows in blocked device storage, an :class:`IDTranslator`
and a slot status on the host, and the exhaustive search of
``index/flat.py`` (``FlatIndex``) with the empty slots masked out through
its ``row_mask``.
There is no graph to maintain, so a delete frees its slot at once and
``consolidate`` has nothing to do.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.data import VectorDataset
from ..core.query_result import QueryResult
from ..core.translation import IDTranslator
from ..lib import datatypes as dt
from ..ops import distance as dist_ops
from .flat import FlatIndex

SLOT_EMPTY, SLOT_VALID = 0, 1


class DynamicFlatIndex:
    def __init__(self, data, external_ids, distance, *,
                 capacity: Optional[int] = None,
                 data_batch_size: int = 32768,
                 query_batch_size: int = 512, device="cuda"):
        x = np.asarray(data, dtype=np.float32)
        n = x.shape[0]
        self.distance = dist_ops.as_distance(distance)
        cap = dt.padded_count(capacity if capacity is not None
                              else max(2 * n, 64))
        self.translator = IDTranslator(cap)
        self.translator.insert(np.asarray(external_ids, np.int64),
                               np.arange(n, dtype=np.int64))
        self.data = VectorDataset.from_array(x, capacity=cap, device=device)
        self.status = np.full(cap, SLOT_EMPTY, dtype=np.int8)
        self.status[:n] = SLOT_VALID
        self.data_batch_size = data_batch_size
        self.query_batch_size = query_batch_size

    @property
    def size(self) -> int:
        return int((self.status == SLOT_VALID).sum())

    @property
    def dimensions(self) -> int:
        return self.data.dim

    def all_ids(self) -> np.ndarray:
        return np.sort(self.translator.all_external_ids())

    def has_id(self, external_id: int) -> bool:
        return external_id in self.translator

    # -- search ----------------------------------------------------------------
    def search(self, queries, k: int, cancel=None) -> QueryResult:
        """Exact top-k over the VALID slots, as external ids, through
        :class:`FlatIndex` (f32 queries); ``cancel``: an optional predicate
        checked between query batches."""
        queries = np.asarray(queries)
        if queries.ndim == 1:
            queries = queries[None, :]
        flat = FlatIndex(self.data, self.distance, self.data_batch_size,
                         self.query_batch_size)
        mask = np.zeros(flat.data.capacity, dtype=bool)
        mask[: self.status.size] = self.status == SLOT_VALID
        pending = flat.search_async(queries, k, row_mask=mask, cancel=cancel)
        translator = self.translator
        pending.translate_ids = lambda slots: np.where(
            slots >= 0, translator.to_external(slots), -1)
        return pending.result()

    # -- mutation ------------------------------------------------------------------
    def add_points(self, points, external_ids) -> np.ndarray:
        """Insert rows under new external ids into empty slots below the
        high-water mark first, then new ones (the storage doubles when
        they do not fit); returns the slots."""
        points = np.asarray(points, dtype=np.float32)
        external_ids = np.asarray(external_ids, np.int64)
        m = points.shape[0]
        high = self.data.n
        empty = np.nonzero(self.status[:high] == SLOT_EMPTY)[0]
        reuse = empty[:m]
        n_new = m - reuse.size
        slots = np.concatenate([reuse,
                                np.arange(high, high + n_new)]).astype(np.int64)
        if high + n_new > self.data.capacity:
            new_cap = dt.padded_count(
                max(2 * self.data.capacity, high + n_new))
            self.data = self.data.with_capacity(new_cap)
            self.status = np.pad(self.status,
                                 (0, new_cap - self.status.size))
        self.translator.insert(external_ids, slots)
        self.data = self.data.scatter_rows(
            torch.from_numpy(slots).to(self.data.device), points,
            new_n=high + n_new)
        self.status[slots] = SLOT_VALID
        return slots

    def delete_points(self, external_ids) -> None:
        slots = self.translator.remove(external_ids)
        self.status[slots] = SLOT_EMPTY

    def consolidate(self) -> None:
        """Nothing to do: no slot references a deleted one."""

    def compact(self) -> None:
        """Move the VALID rows to a dense prefix, on the device, and remap
        the slots."""
        high = self.data.n
        alive = np.nonzero(self.status[:high] == SLOT_VALID)[0]
        if alive.size == high:
            return
        rows = self.data.vectors[torch.from_numpy(alive).to(
            self.data.device)][:, : self.data.dim]
        self.data = VectorDataset.from_array(rows, capacity=self.data.capacity,
                                             device=self.data.device)
        new_status = np.full(self.status.size, SLOT_EMPTY, np.int8)
        new_status[: alive.size] = SLOT_VALID
        self.status = new_status
        old_to_new = np.full(high, -1, dtype=np.int64)
        old_to_new[alive] = np.arange(alive.size)
        self.translator.remap(old_to_new)
