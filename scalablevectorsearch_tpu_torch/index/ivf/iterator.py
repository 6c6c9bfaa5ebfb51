"""IVF batch iterator: paged retrieval over one query.

PyTorch counterpart of ``scalablevectorsearch_tpu/index/ivf/iterator.py``
(the reference's IVF ``BatchIterator``, ``include/svs/index/ivf/
iterator.h:311``): each page re-probes with a growing ``n_probes`` and
yields the best ids not yet returned.  Host code over the index's
``search``; a copy of the JAX package's.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ...core.query_result import QueryResult
from .params import IVFSearchParameters


class IVFBatchIterator:
    def __init__(self, index, query, batch_size: int = 10,
                 base_probes: int = 4, probe_step: int = 4):
        self._index = index
        self._query = np.asarray(query, dtype=np.float32).reshape(1, -1)
        if self._query.shape[1] != index.dimensions:
            raise ValueError(
                f"query dim {self._query.shape[1]} != dataset dim "
                f"{index.dimensions}")
        self._batch_size = batch_size
        self._base = base_probes
        self._step = probe_step
        self._iteration = 0
        self._yielded = np.empty(0, dtype=np.int64)   # sorted
        self._exhausted = False

    @property
    def batch_number(self) -> int:
        return self._iteration

    def done(self) -> bool:
        return self._exhausted

    def restart(self, query=None) -> None:
        if query is not None:
            self._query = np.asarray(query, np.float32).reshape(1, -1)
        self._iteration = 0
        self._yielded = np.empty(0, dtype=np.int64)
        self._exhausted = False

    def next(self, batch_size: Optional[int] = None) -> QueryResult:
        m = batch_size or self._batch_size
        probes = min(self._base + self._step * self._iteration,
                     self._index.num_centroids)
        fetch = self._yielded.size + m
        res = self._index.search(
            self._query, fetch,
            IVFSearchParameters(n_probes=probes))
        # vectorized not-yet-yielded filter (deep pages fetch thousands)
        ids = np.asarray(res.ids[0], dtype=np.int64)
        vals = np.asarray(res.distances[0], dtype=np.float32)
        valid = ids >= 0
        if self._yielded.size:
            valid &= ~np.isin(ids, self._yielded, assume_unique=False)
        pick = np.flatnonzero(valid)[:m]
        fresh_ids, fresh_vals = ids[pick], vals[pick]
        self._iteration += 1
        if fresh_ids.size < m:
            self._exhausted = (fresh_ids.size == 0
                               and probes >= self._index.num_centroids) or \
                (self._yielded.size + fresh_ids.size >= self._index.size)
        self._yielded = np.union1d(self._yielded, fresh_ids)
        pad = m - fresh_ids.size
        return QueryResult(
            ids=np.concatenate([fresh_ids,
                                np.full(pad, -1, np.int64)])[None, :],
            distances=np.concatenate(
                [fresh_vals, np.full(pad, np.inf, np.float32)])[None, :])
