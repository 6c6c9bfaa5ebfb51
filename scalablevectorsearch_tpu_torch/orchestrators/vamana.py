"""Vamana orchestrator — the user-facing API.

PyTorch counterpart of ``scalablevectorsearch_tpu/orchestrators/vamana.py``:
``build``, ``assemble`` / ``save`` (directories and single streams, in the
JAX package's format), ``search`` / ``search_async``, the serving switches
(packed neighborhoods, sampled entries, host-side exact rerank, pop width)
and the parameter accessors over a :class:`VamanaIndex`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.query_result import QueryResult
from ..index.vamana.index import VamanaIndex
from ..index.vamana.params import (VamanaBuildParameters,
                                   VamanaSearchParameters)
from ..ops import distance as dist_ops


class Vamana:
    """User-facing static Vamana index manager."""

    def __init__(self, index: VamanaIndex):
        self._index = index

    # -- construction -------------------------------------------------------
    @staticmethod
    def build(parameters: VamanaBuildParameters, data, distance,
              dtype=None, **kwargs) -> "Vamana":
        """Build an index from an (n, d) array, vecs/npy file path, or
        dataset (reference orchestrators/vamana.h:570-600); ``device``
        defaults to ``"cuda"``.  ``dtype`` stores an array's rows as f32,
        bf16, float16, int8 or uint8.  A compressed dataset builds and
        serves as it is: ``Vamana.build(params, SQDataset.compress(x),
        "l2")``, or ``LVQDataset.compress(x)``."""
        if isinstance(data, str):
            from ..core.io import read_any
            data = read_any(data, dtype=dtype)
        return Vamana(VamanaIndex.build(parameters, data, distance,
                                        dtype=dtype, **kwargs))

    @staticmethod
    def assemble(config_dir: str, graph_dir: Optional[str] = None,
                 data_dir: Optional[str] = None, dtype=None,
                 **kwargs) -> "Vamana":
        """Load an index that either package saved (reference
        vamana.h:420-454); ``device`` defaults to ``"cuda"``."""
        return Vamana(VamanaIndex.assemble(config_dir, graph_dir, data_dir,
                                           dtype=dtype, **kwargs))

    @staticmethod
    def assemble_stream(stream, **kwargs) -> "Vamana":
        return Vamana(VamanaIndex.assemble_stream(stream, **kwargs))

    def save(self, config_dir: str, graph_dir: Optional[str] = None,
             data_dir: Optional[str] = None) -> None:
        self._index.save(config_dir, graph_dir, data_dir)

    def save_stream(self, stream) -> None:
        """(reference vamana.h:457 stream save)"""
        self._index.save_stream(stream)

    # -- search ---------------------------------------------------------------
    def search(self, queries, n_neighbors: int) -> QueryResult:
        return self._index.search(queries, n_neighbors)

    def search_async(self, queries, n_neighbors: int):
        """Dispatch-only search; collect with ``.result()``."""
        return self._index.search_async(queries, n_neighbors)

    # -- serving switches ---------------------------------------------------------
    def enable_packed_serving(self, *args, **kwargs) -> None:
        self._index.enable_packed_serving(*args, **kwargs)

    def disable_packed_serving(self) -> None:
        self._index.disable_packed_serving()

    def enable_entry_sampler(self, n_samples=None, n_entries: int = 1,
                             seed: int = 0) -> None:
        self._index.enable_entry_sampler(n_samples, n_entries, seed)

    def disable_entry_sampler(self) -> None:
        self._index.disable_entry_sampler()

    def enable_host_rerank(self, host_vectors) -> None:
        """Exact host-side re-scoring of each returned beam (see
        ``VamanaIndex.enable_host_rerank``), for int8 query uploads."""
        self._index.enable_host_rerank(host_vectors)

    def disable_host_rerank(self) -> None:
        self._index.disable_host_rerank()

    @property
    def pop_width(self) -> int:
        """Beam entries expanded per lockstep iteration."""
        return self._index.pop_width

    @pop_width.setter
    def pop_width(self, m: int) -> None:
        self._index.pop_width = m

    # -- parameter surface ------------------------------------------------------
    @property
    def search_window_size(self) -> int:
        return self._index.search_window_size

    @search_window_size.setter
    def search_window_size(self, window: int) -> None:
        self._index.search_window_size = window

    @property
    def search_parameters(self) -> VamanaSearchParameters:
        return self._index.search_parameters

    @search_parameters.setter
    def search_parameters(self, params: VamanaSearchParameters) -> None:
        self._index.search_parameters = params

    @property
    def alpha(self) -> float:
        bp = self._index.build_parameters
        return bp.alpha if bp else float("nan")

    @property
    def graph_max_degree(self) -> int:
        return self._index.graph.max_degree

    @property
    def size(self) -> int:
        return self._index.size

    @property
    def dimensions(self) -> int:
        return self._index.dimensions

    @property
    def distance(self) -> dist_ops.DistanceType:
        return self._index.distance

    # -- misc --------------------------------------------------------------------
    def reconstruct_at(self, ids) -> np.ndarray:
        return self._index.reconstruct_at(ids)

    def get_distance(self, internal_id: int, query) -> float:
        """Distance between a stored vector and a query (reference
        vamana.h:671)."""
        vec = self._index.reconstruct_at([internal_id])[0]
        q = np.asarray(query, dtype=np.float32).reshape(-1)
        if q.shape[0] != self._index.data.dim:
            raise ValueError(
                f"query dim {q.shape[0]} != {self._index.data.dim}")
        if self._index.distance == dist_ops.DistanceType.L2:
            return float(((q - vec) ** 2).sum())
        ip = float(q @ vec)
        if self._index.distance == dist_ops.DistanceType.MIP:
            return ip
        return ip / max(float(np.linalg.norm(q) * np.linalg.norm(vec)),
                        1e-30)

    @property
    def index(self) -> VamanaIndex:
        return self._index
