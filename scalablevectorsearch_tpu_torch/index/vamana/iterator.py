"""Batch iterator: paged "give me the next k" retrieval over one query.

PyTorch counterpart of ``scalablevectorsearch_tpu/index/vamana/
iterator.py``, with the restartable schedules that grow the search window
each batch (``DefaultSchedule``, ``LinearSchedule``).

Each ``next()`` re-runs the search at the schedule's current window with a
candidate pool and yields the best not-yet-returned ids.  The yielded set
and the filtering live on the host in numpy; the search runs on the index's
device: ``beam_step`` or ``beam_step_lvq`` up to 1024 beam slots, the wide
route above.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Protocol

import numpy as np
import torch

from ...core.query_result import QueryResult
from ...lib import datatypes as dt
from ...ops import distance as dist_ops
from . import search as search_mod
from .dynamic import SLOT_DELETED, SLOT_VALID


class IteratorSchedule(Protocol):
    """Maps iteration number -> (window, capacity)."""

    def for_iteration(self, iteration: int) -> tuple[int, int]: ...


@dataclasses.dataclass(frozen=True)
class DefaultSchedule:
    """Window grows by the batch size each iteration."""

    base_window: int
    batch_size: int

    def for_iteration(self, iteration: int) -> tuple[int, int]:
        w = self.base_window + self.batch_size * iteration
        return w, w + self.batch_size


@dataclasses.dataclass(frozen=True)
class LinearSchedule:
    """Window grows by a fixed step."""

    base_window: int
    step: int

    def for_iteration(self, iteration: int) -> tuple[int, int]:
        w = self.base_window + self.step * iteration
        return w, w


class BatchIterator:
    """Paged retrieval for a single query over a ``VamanaIndex`` or a
    ``MutableVamanaIndex`` (whose deleted slots are never yielded; ids
    are the index's internal slots, as in the JAX package)."""

    def __init__(self, index, query, batch_size: int = 10,
                 schedule: Optional[IteratorSchedule] = None):
        self._index = index
        self._query = np.asarray(query, dtype=np.float32).reshape(1, -1)
        if self._query.shape[1] != index.data.dim:
            raise ValueError(
                f"query dim {self._query.shape[1]} != dataset dim "
                f"{index.data.dim}")
        self._batch_size = batch_size
        self._schedule = schedule or DefaultSchedule(
            max(batch_size, index.search_window_size
                if hasattr(index, "search_window_size") else batch_size),
            batch_size)
        self._iteration = 0
        self._yielded = np.empty(0, dtype=np.int64)   # sorted
        self._exhausted = False

    @property
    def batch_number(self) -> int:
        return self._iteration

    def done(self) -> bool:
        return self._exhausted

    def restart(self, query=None, schedule: Optional[IteratorSchedule] = None
                ) -> None:
        """Reset, optionally for a new query or schedule."""
        if query is not None:
            self._query = np.asarray(query, np.float32).reshape(1, -1)
        if schedule is not None:
            self._schedule = schedule
        self._iteration = 0
        self._yielded = np.empty(0, dtype=np.int64)
        self._exhausted = False

    def next(self, batch_size: Optional[int] = None) -> QueryResult:
        """Yield the next batch of neighbors, nearest-first, no repeats.

        The beam stays at the schedule's (window, capacity) while the
        already-yielded coverage comes from the search's candidate pool
        (the running top-``pool_size`` of every scored candidate).  Pool
        sizes are powers of two, capped at ``size + need + capacity``."""
        m = batch_size or self._batch_size
        index = self._index
        window, capacity = self._schedule.for_iteration(self._iteration)
        capacity = max(capacity, window)
        status = getattr(index, "status", None)
        need = self._yielded.size + m
        if status is not None:
            # deleted slots stay traversable until consolidation and take
            # pool entries: without headroom for all of them a pool crowded
            # by deleted slots could yield nothing and fake exhaustion
            need += int(np.sum(np.asarray(status) == SLOT_DELETED))
        pool = 1 << int(np.ceil(np.log2(max(need + window, 64))))
        pool = min(pool, int(index.size) + need + capacity)

        device = index.data.device
        q = torch.from_numpy(dt.pad_matrix(
            self._query, n_pad=8, d_pad=index.data.padded_dim)).to(device)
        # a sampled-entries graph keeps no medioid approach path, so the
        # index's sampler seeds the search; dynamic indexes draw it lazily
        if getattr(index, "_sampler_cfg", None) is not None:
            sampler, _ = index._ensure_sampler()
        else:
            sampler = getattr(index, "_entry_sampler", None)
        entry_ids = (sampler.select(index.distance, q)
                     if sampler is not None
                     else torch.tensor([index.entry_point],
                                       dtype=torch.int32, device=device))
        out = search_mod.greedy_search(
            index.graph, index.data, q, entry_ids,
            window=window, capacity=capacity,
            max_iters=search_mod.default_max_iters(window),
            distance=index.distance, pool_size=pool)
        ids = out.pool_ids[0].cpu().numpy().astype(np.int64)
        keys = out.pool_keys[0].cpu().numpy()

        # drop padding, deleted slots and already-yielded ids, keeping the
        # pool's nearest-first order
        valid = ids >= 0
        if status is not None:
            st = np.asarray(status)
            valid &= st[np.maximum(ids, 0)] == SLOT_VALID
        if self._yielded.size:
            valid &= ~np.isin(ids, self._yielded, assume_unique=False)
        pick = np.flatnonzero(valid)[:m]
        fresh_ids = ids[pick]
        fresh_keys = keys[pick].astype(np.float32)
        self._iteration += 1
        if fresh_ids.size < m:
            # the whole dataset was yielded, or the wider window found
            # nothing new: the reachable component is exhausted
            self._exhausted = (fresh_ids.size == 0
                               or self._yielded.size + fresh_ids.size
                               >= index.size)
        self._yielded = np.union1d(self._yielded, fresh_ids)

        pad = m - fresh_ids.size
        out_ids = np.concatenate(
            [fresh_ids, np.full(pad, -1, np.int64)])[None, :]
        out_keys = np.concatenate(
            [fresh_keys, np.full(pad, np.inf, np.float32)])[None, :]
        vals = dist_ops.value_from_key(index.distance, out_keys)
        vals[out_ids < 0] = np.inf
        return QueryResult(ids=out_ids, distances=vals)
