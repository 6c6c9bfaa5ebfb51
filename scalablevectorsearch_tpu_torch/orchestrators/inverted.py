"""Inverted orchestrator (reference ``svs::Inverted``,
``include/svs/orchestrators/inverted.h:86-140``).

PyTorch counterpart of ``scalablevectorsearch_tpu/orchestrators/inverted.py``;
``device`` (``"cuda"`` unless given) goes to :class:`InvertedIndex`.
"""

from __future__ import annotations

from ..core.query_result import QueryResult
from ..index.inverted.index import (InvertedBuildParameters,
                                    InvertedIndex,
                                    InvertedSearchParameters)


class Inverted:
    def __init__(self, index: InvertedIndex):
        self._index = index

    @staticmethod
    def build(parameters: InvertedBuildParameters, data, distance,
              **kwargs) -> "Inverted":
        return Inverted(InvertedIndex.build(parameters, data, distance,
                                            **kwargs))

    @staticmethod
    def assemble(config_dir: str, **kwargs) -> "Inverted":
        return Inverted(InvertedIndex.assemble(config_dir, **kwargs))

    def search(self, queries, n_neighbors: int) -> QueryResult:
        return self._index.search(queries, n_neighbors)

    def search_async(self, queries, n_neighbors: int):
        return self._index.search_async(queries, n_neighbors)

    @property
    def search_parameters(self) -> InvertedSearchParameters:
        return self._index.search_parameters

    @search_parameters.setter
    def search_parameters(self, p: InvertedSearchParameters) -> None:
        self._index.search_parameters = p

    @property
    def size(self) -> int:
        return self._index.size

    @property
    def dimensions(self) -> int:
        return self._index.dimensions

    @property
    def num_centroids(self) -> int:
        return self._index.num_centroids

    def save(self, config_dir: str) -> None:
        self._index.save(config_dir)

    @property
    def index(self) -> InvertedIndex:
        return self._index
