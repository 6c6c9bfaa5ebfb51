"""Flat orchestrator (reference ``svs::Flat``,
``include/svs/orchestrators/exhaustive.h:238``).

PyTorch counterpart of ``scalablevectorsearch_tpu/orchestrators/flat.py``:
``build`` / ``assemble`` / ``search`` / ``save`` over a :class:`FlatIndex`.
"""

from __future__ import annotations

from typing import Optional

from ..core.query_result import QueryResult
from ..index.flat import FlatIndex
from ..ops import distance as dist_ops


class Flat:
    def __init__(self, index: FlatIndex):
        self._index = index

    @staticmethod
    def build(data, distance, dtype=None, **kwargs) -> "Flat":
        """From an (n, d) array, a vecs/npy file path or a dataset;
        ``device`` defaults to ``"cuda"`` for an array or a path."""
        if isinstance(data, str):
            from ..core.io import read_any
            data = read_any(data, dtype=dtype)
        if hasattr(data, "norms_sq"):
            return Flat(FlatIndex(data, dist_ops.as_distance(distance),
                                  **kwargs))
        return Flat(FlatIndex.from_array(data, distance=distance,
                                         dtype=dtype, **kwargs))

    @staticmethod
    def assemble(config_dir: str, data_dir: Optional[str] = None,
                 **kwargs) -> "Flat":
        return Flat(FlatIndex.assemble(config_dir, data_dir, **kwargs))

    def search(self, queries, n_neighbors: int) -> QueryResult:
        return self._index.search(queries, n_neighbors)

    def search_async(self, queries, n_neighbors: int):
        return self._index.search_async(queries, n_neighbors)

    @property
    def size(self) -> int:
        return self._index.size

    @property
    def dimensions(self) -> int:
        return self._index.dimensions

    @property
    def distance(self) -> dist_ops.DistanceType:
        return self._index.distance

    def save(self, config_dir: str, data_dir: Optional[str] = None) -> None:
        self._index.save(config_dir, data_dir)

    @property
    def index(self) -> FlatIndex:
        return self._index
