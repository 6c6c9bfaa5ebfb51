"""Query result container.

Analog of the reference's ``QueryResult`` (``include/svs/core/query_result.h``):
an ``(n_queries, n_neighbors)`` pair of id + distance matrices.  Ids are int64
(external ids may exceed int32 in dynamic indexes); distances follow the
reference's per-metric convention — squared L2 for L2, raw inner product for
MIP, cosine similarity for cosine (larger-is-better metrics are NOT negated in
the public result).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class QueryResult:
    ids: np.ndarray         # (n_queries, k) int64; -1 marks "no result"
    distances: np.ndarray   # (n_queries, k) float32

    def __post_init__(self):
        self.ids = np.asarray(self.ids, dtype=np.int64)
        self.distances = np.asarray(self.distances, dtype=np.float32)
        if self.ids.shape != self.distances.shape:
            raise ValueError(
                f"ids shape {self.ids.shape} != distances shape "
                f"{self.distances.shape}")

    @property
    def n_queries(self) -> int:
        return self.ids.shape[0]

    @property
    def n_neighbors(self) -> int:
        return self.ids.shape[1]

    def __len__(self) -> int:
        return self.n_queries
