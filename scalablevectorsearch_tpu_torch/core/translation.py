"""Bidirectional external <-> internal id translation for dynamic indexes.

A copy of ``scalablevectorsearch_tpu/core/translation.py`` (pure numpy; the
port imports nothing of the JAX package).  Analog of the reference's
``IDTranslator`` (``include/svs/core/translation.h:44``, ``insert`` at
``:100``).  Internal slot ids are dense row indices into the device-resident
dataset and graph; external ids are arbitrary user int64s.  The map lives on
the host and is vectorized: a sorted external-id array with
``np.searchsorted`` lookups forward and a dense slot -> external array
backward, so bulk inserts and removes are O(n log n) numpy operations.
Translation happens at the API boundary (the reference's
``dynamic_index.h:423-443``), never on the device.
"""

from __future__ import annotations

import numpy as np


class IDTranslator:
    def __init__(self, capacity: int = 0):
        # externals, kept sorted; slots aligned with them
        self._ext_sorted = np.empty(0, dtype=np.int64)
        self._slot_for_ext = np.empty(0, dtype=np.int64)
        self._int_to_ext = np.full(max(capacity, 1), -1, dtype=np.int64)

    def __len__(self) -> int:
        return self._ext_sorted.size

    def __contains__(self, external_id: int) -> bool:
        e = np.int64(external_id)
        pos = np.searchsorted(self._ext_sorted, e)
        return bool(pos < self._ext_sorted.size and self._ext_sorted[pos] == e)

    def _find(self, external_ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Positions of ``external_ids`` in the sorted table + found mask."""
        pos = np.searchsorted(self._ext_sorted, external_ids)
        if self._ext_sorted.size == 0:
            return pos, np.zeros(external_ids.shape, dtype=bool)
        clipped = np.minimum(pos, self._ext_sorted.size - 1)
        found = ((pos < self._ext_sorted.size)
                 & (self._ext_sorted[clipped] == external_ids))
        return pos, found

    def insert(self, external_ids, internal_slots) -> None:
        """Insert a batch of (external, internal) pairs; raises on duplicate
        external ids (reference behavior: translation.h:100 throws)."""
        external_ids = np.asarray(external_ids, dtype=np.int64).ravel()
        internal_slots = np.asarray(internal_slots, dtype=np.int64).ravel()
        if external_ids.size == 0:
            return
        order = np.argsort(external_ids, kind="stable")
        se, ss = external_ids[order], internal_slots[order]
        if np.any(se[1:] == se[:-1]):
            dup = se[1:][se[1:] == se[:-1]][0]
            raise ValueError(f"external id {int(dup)} duplicated in batch")
        pos, found = self._find(se)
        if np.any(found):
            raise ValueError(
                f"external id {int(se[found][0])} already present")
        self._ext_sorted = np.insert(self._ext_sorted, pos, se)
        self._slot_for_ext = np.insert(self._slot_for_ext, pos, ss)

        max_slot = int(internal_slots.max(initial=-1))
        if max_slot >= self._int_to_ext.size:
            grow = max(max_slot + 1, 2 * self._int_to_ext.size)
            new = np.full(grow, -1, dtype=np.int64)
            new[: self._int_to_ext.size] = self._int_to_ext
            self._int_to_ext = new
        self._int_to_ext[internal_slots] = external_ids

    def remove(self, external_ids) -> np.ndarray:
        """Remove external ids, returning their internal slots (input order)."""
        ext = np.asarray(external_ids, dtype=np.int64).ravel()
        if ext.size == 0:
            return np.empty(0, dtype=np.int64)
        if np.unique(ext).size != ext.size:
            raise KeyError("duplicate external id in remove batch")
        pos, found = self._find(ext)
        if not np.all(found):
            raise KeyError(
                f"external id {int(ext[~found][0])} not present")
        slots = self._slot_for_ext[pos]
        self._int_to_ext[slots] = -1
        self._ext_sorted = np.delete(self._ext_sorted, pos)
        self._slot_for_ext = np.delete(self._slot_for_ext, pos)
        return slots

    def to_external(self, internal_slots) -> np.ndarray:
        """Vectorized internal->external; unmapped slots map to -1."""
        slots = np.asarray(internal_slots, dtype=np.int64)
        out = np.full(slots.shape, -1, dtype=np.int64)
        valid = (slots >= 0) & (slots < self._int_to_ext.size)
        out[valid] = self._int_to_ext[slots[valid]]
        return out

    def to_internal(self, external_ids) -> np.ndarray:
        ext = np.asarray(external_ids, dtype=np.int64)
        flat = ext.ravel()
        pos, found = self._find(flat)
        if not np.all(found):
            raise KeyError(f"external id {int(flat[~found][0])} not present")
        return self._slot_for_ext[pos].reshape(ext.shape)

    def remap(self, old_to_new) -> None:
        """Apply a slot remapping (compaction, reference core/compact.h).

        ``old_to_new`` is either a dict {old_slot: new_slot} (identity for
        missing keys) or a dense int array indexed by old slot where negative
        entries mean identity.
        """
        if self._slot_for_ext.size == 0:
            return
        max_old = int(self._slot_for_ext.max(initial=-1))
        dense = np.arange(max_old + 1, dtype=np.int64)
        if isinstance(old_to_new, dict):
            if old_to_new:
                olds = np.fromiter(old_to_new.keys(), dtype=np.int64,
                                   count=len(old_to_new))
                news = np.fromiter(old_to_new.values(), dtype=np.int64,
                                   count=len(old_to_new))
                in_range = olds <= max_old
                dense[olds[in_range]] = news[in_range]
        else:
            arr = np.asarray(old_to_new, dtype=np.int64)
            k = min(arr.size, dense.size)
            mapped = arr[:k] >= 0
            dense[:k][mapped] = arr[:k][mapped]
        self._slot_for_ext = dense[self._slot_for_ext]

        new_size = max(int(self._slot_for_ext.max(initial=-1)) + 1, 1)
        new_int_to_ext = np.full(max(new_size, self._int_to_ext.size), -1,
                                 dtype=np.int64)
        new_int_to_ext[self._slot_for_ext] = self._ext_sorted
        self._int_to_ext = new_int_to_ext

    def all_external_ids(self) -> np.ndarray:
        """All live external ids, ascending."""
        return self._ext_sorted.copy()
