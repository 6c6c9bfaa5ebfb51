"""Carry a Vamana index's state from the JAX package into this one.

The state is plain numpy: the dataset rows ``np.asarray(idx.data.vectors)
[:n, :dim]``, ``idx.graph.adjacency`` and ``idx.graph.degrees``,
``idx.entry_point`` and, for a sampled-entries index,
``idx._entry_sampler.ids``.  :func:`vamana_from_arrays` turns it into a
:class:`VamanaIndex` that computes the same search, so the two packages can
be run on one graph.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .core.data import VectorDataset
from .core.graph import NeighborGraph
from .index.vamana.entry import build_sampler
from .index.vamana.index import VamanaIndex


def dataset_from_array(vectors, *, dtype=None, device="cuda"
                       ) -> VectorDataset:
    """(n, dim) rows (bf16 as ``ml_dtypes.bfloat16`` is fine) -> dataset."""
    return VectorDataset.from_array(vectors, dtype=dtype, device=device)


def graph_from_arrays(adjacency, degrees, n: int, *, device="cuda"
                      ) -> NeighborGraph:
    """(capacity, R) adjacency and (capacity,) degrees -> graph, kept as
    given (the padded capacity included)."""
    adjacency = np.array(adjacency, dtype=np.int32)   # writable copies
    degrees = np.array(degrees, dtype=np.int32)
    if adjacency.shape[0] != degrees.shape[0] or adjacency.shape[0] < n:
        raise ValueError(f"adjacency {adjacency.shape} / degrees "
                         f"{degrees.shape} do not hold {n} nodes")
    return NeighborGraph(adjacency=torch.from_numpy(adjacency).to(device),
                         degrees=torch.from_numpy(degrees).to(device),
                         n=n, max_degree=adjacency.shape[1])


def vamana_from_arrays(vectors, adjacency, degrees, entry_point: int,
                       distance, *, sampler_ids: Optional[np.ndarray] = None,
                       dtype=None, device="cuda") -> VamanaIndex:
    """Build a port :class:`VamanaIndex` over a JAX index's state."""
    data = dataset_from_array(vectors, dtype=dtype, device=device)
    graph = graph_from_arrays(adjacency, degrees, data.n, device=device)
    index = VamanaIndex(graph, data, entry_point, distance)
    if sampler_ids is not None:
        index._entry_sampler = build_sampler(data, len(sampler_ids),
                                             ids=sampler_ids)
    return index
