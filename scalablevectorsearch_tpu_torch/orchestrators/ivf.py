"""IVF orchestrator: the user-facing API.

PyTorch counterpart of ``scalablevectorsearch_tpu/orchestrators/ivf.py``
(the reference's ``svs::IVF``, ``include/svs/orchestrators/ivf.h:142-300``,
and ``bindings/python/src/ivf.cpp:207-380``): ``Clustering.build`` +
``IVF.assemble_from_clustering`` / ``assemble_from_file``.  ``device``
(``"cuda"`` unless given) goes to :class:`IVFIndex`.
"""

from __future__ import annotations

from typing import Optional

from ..core.query_result import QueryResult
from ..index.ivf.clustering import Clustering  # re-export  # noqa: F401
from ..index.ivf.index import IVFIndex
from ..index.ivf.params import IVFBuildParameters, IVFSearchParameters


class IVF:
    """User-facing IVF index manager."""

    def __init__(self, index: IVFIndex):
        self._index = index

    @staticmethod
    def build(parameters: IVFBuildParameters, data, distance,
              **kwargs) -> "IVF":
        return IVF(IVFIndex.build(parameters, data, distance, **kwargs))

    @staticmethod
    def assemble_from_clustering(clustering: Clustering, data, distance,
                                 **kwargs) -> "IVF":
        """(reference ivf.h:237)"""
        return IVF(IVFIndex.assemble_from_clustering(clustering, data,
                                                     distance, **kwargs))

    @staticmethod
    def assemble_from_file(config_dir: str, **kwargs) -> "IVF":
        """(reference ivf.h:281)"""
        return IVF(IVFIndex.assemble_from_file(config_dir, **kwargs))

    def search(self, queries, n_neighbors: int) -> QueryResult:
        return self._index.search(queries, n_neighbors)

    def search_async(self, queries, n_neighbors: int):
        return self._index.search_async(queries, n_neighbors)

    @property
    def search_parameters(self) -> IVFSearchParameters:
        return self._index.search_parameters

    @search_parameters.setter
    def search_parameters(self, params: IVFSearchParameters) -> None:
        self._index.search_parameters = params

    @property
    def n_probes(self) -> int:
        return self._index.search_parameters.n_probes

    @n_probes.setter
    def n_probes(self, value: int) -> None:
        self._index.search_parameters = IVFSearchParameters(
            n_probes=value,
            k_reorder=self._index.search_parameters.k_reorder)

    @property
    def size(self) -> int:
        return self._index.size

    @property
    def dimensions(self) -> int:
        return self._index.dimensions

    @property
    def num_centroids(self) -> int:
        return self._index.num_centroids

    def save(self, config_dir: str, data_dir: Optional[str] = None) -> None:
        self._index.save(config_dir, data_dir)

    @property
    def index(self) -> IVFIndex:
        return self._index
