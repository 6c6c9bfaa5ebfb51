"""DynamicVamana and DynamicFlat orchestrators.

PyTorch counterpart of ``scalablevectorsearch_tpu/orchestrators/
dynamic_vamana.py`` (the reference's ``svs::DynamicVamana``,
``include/svs/orchestrators/dynamic_vamana.h:35-117``, and
``bindings/python/src/dynamic_vamana.cpp``): build from an array with
explicit external ids, add / delete / consolidate / compact, id queries,
save / assemble, and the serving switches.  ``build`` and ``assemble`` put
the index on ``device="cuda"`` unless a caller passes another device.
"""

from __future__ import annotations

import numpy as np

from ..core.query_result import QueryResult
from ..index.vamana.dynamic import MutableVamanaIndex
from ..index.vamana.params import (VamanaBuildParameters,
                                   VamanaSearchParameters)


class DynamicVamana:
    def __init__(self, index: MutableVamanaIndex):
        self._index = index

    @staticmethod
    def build(parameters: VamanaBuildParameters, data, external_ids,
              distance, **kwargs) -> "DynamicVamana":
        return DynamicVamana(MutableVamanaIndex(
            parameters, data, external_ids, distance, **kwargs))

    # -- search -----------------------------------------------------------
    def search(self, queries, n_neighbors: int) -> QueryResult:
        return self._index.search(queries, n_neighbors)

    # -- serving switches (no reference analog) ---------------------------------
    def enable_packed_serving(self, *args, **kwargs) -> None:
        """Packed-neighbourhood serving (see
        MutableVamanaIndex.enable_packed_serving)."""
        self._index.enable_packed_serving(*args, **kwargs)

    def disable_packed_serving(self) -> None:
        self._index.disable_packed_serving()

    def enable_entry_sampler(self, n_samples=None,
                             n_entries: int = 1, seed: int = 0) -> None:
        """Per-query sampled entry points, rebuilt lazily after mutations
        (see MutableVamanaIndex.enable_entry_sampler and entry.py)."""
        self._index.enable_entry_sampler(n_samples, n_entries, seed)

    def disable_entry_sampler(self) -> None:
        self._index.disable_entry_sampler()

    def search_async(self, queries, n_neighbors: int):
        """Dispatch-only search; collect with ``.result()``."""
        return self._index.search_async(queries, n_neighbors)

    @property
    def pop_width(self) -> int:
        """Beam entries expanded per lockstep iteration."""
        return self._index.pop_width

    @pop_width.setter
    def pop_width(self, m: int) -> None:
        self._index.pop_width = m

    # -- mutation ----------------------------------------------------------
    def add_points(self, points, external_ids) -> None:
        """(reference dynamic_vamana.h:72-80)"""
        self._index.add_points(points, external_ids)

    def delete_points(self, external_ids) -> None:
        self._index.delete_points(external_ids)

    def consolidate(self) -> "DynamicVamana":
        self._index.consolidate()
        return self

    def compact(self) -> "DynamicVamana":
        self._index.compact()
        return self

    # -- introspection ---------------------------------------------------------
    def all_ids(self) -> np.ndarray:
        return self._index.all_ids()

    def has_id(self, external_id: int) -> bool:
        return self._index.has_id(external_id)

    @property
    def size(self) -> int:
        return self._index.size

    @property
    def dimensions(self) -> int:
        return self._index.dimensions

    @property
    def search_window_size(self) -> int:
        return self._index.search_window_size

    @search_window_size.setter
    def search_window_size(self, w: int) -> None:
        self._index.search_window_size = w

    @property
    def search_parameters(self) -> VamanaSearchParameters:
        return self._index.search_parameters

    @search_parameters.setter
    def search_parameters(self, p: VamanaSearchParameters) -> None:
        self._index.search_parameters = p

    @property
    def alpha(self) -> float:
        return self._index.parameters.alpha

    def get_distance(self, external_id: int, query) -> float:
        return self._index.get_distance(external_id, query)

    def save(self, config_dir: str) -> None:
        self._index.save(config_dir)

    @staticmethod
    def assemble(config_dir: str, **kwargs) -> "DynamicVamana":
        return DynamicVamana(MutableVamanaIndex.assemble(config_dir,
                                                         **kwargs))

    @property
    def index(self) -> MutableVamanaIndex:
        return self._index


class DynamicFlat:
    """Analog of ``svs::DynamicFlat`` (orchestrators/dynamic_flat.h)."""

    def __init__(self, index):
        self._index = index

    @staticmethod
    def build(data, external_ids, distance, **kwargs) -> "DynamicFlat":
        from ..index.dynamic_flat import DynamicFlatIndex
        return DynamicFlat(DynamicFlatIndex(data, external_ids, distance,
                                            **kwargs))

    def search(self, queries, n_neighbors: int) -> QueryResult:
        return self._index.search(queries, n_neighbors)

    def add_points(self, points, external_ids) -> None:
        self._index.add_points(points, external_ids)

    def delete_points(self, external_ids) -> None:
        self._index.delete_points(external_ids)

    def consolidate(self) -> "DynamicFlat":
        self._index.consolidate()
        return self

    def compact(self) -> "DynamicFlat":
        self._index.compact()
        return self

    def all_ids(self) -> np.ndarray:
        return self._index.all_ids()

    def has_id(self, external_id: int) -> bool:
        return self._index.has_id(external_id)

    @property
    def size(self) -> int:
        return self._index.size

    @property
    def dimensions(self) -> int:
        return self._index.dimensions

    @property
    def index(self):
        return self._index
