"""Dense padded adjacency graph.

PyTorch counterpart of ``scalablevectorsearch_tpu/core/graph.py``: a dense
``(capacity, R)`` int32 adjacency padded with ``-1`` plus a ``(capacity,)``
degree vector, with the invariant ``adjacency[i, degrees[i]:] == -1``.

Mutation stays functional (each update returns a new graph).  The JAX
package drops out-of-range scatter indices (``mode="drop"``); torch raises
on them, so every scatter here writes into one extra sink row that is
sliced off afterwards.

``save`` / ``load`` and ``save_adjacency_host`` write and read the JAX
package's ``default_graph`` checkpoint.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np
import torch

from ..lib import datatypes as dt
from ..lib import saveload

SENTINEL = -1


@dataclasses.dataclass
class NeighborGraph:
    adjacency: torch.Tensor   # (capacity, R) int32, -1 padded
    degrees: torch.Tensor     # (capacity,) int32
    n: int                    # live node count
    max_degree: int           # R

    @classmethod
    def empty(cls, n: int, max_degree: int, capacity: Optional[int] = None,
              device="cuda") -> "NeighborGraph":
        cap = dt.pad_to(capacity if capacity is not None else n, 8)
        adjacency = torch.full((cap, max_degree), SENTINEL,
                               dtype=torch.int32, device=device)
        degrees = torch.zeros((cap,), dtype=torch.int32, device=device)
        return cls(adjacency=adjacency, degrees=degrees, n=n,
                   max_degree=max_degree)

    @classmethod
    def from_array(cls, adjacency, n: Optional[int] = None,
                   device="cuda") -> "NeighborGraph":
        adjacency = np.asarray(adjacency, dtype=np.int32)
        n = n if n is not None else adjacency.shape[0]
        cap = dt.pad_to(adjacency.shape[0], 8)
        if cap != adjacency.shape[0]:
            pad = np.full((cap - adjacency.shape[0], adjacency.shape[1]),
                          SENTINEL, dtype=np.int32)
            adjacency = np.concatenate([adjacency, pad], axis=0)
        degrees = (adjacency != SENTINEL).sum(axis=1).astype(np.int32)
        return cls(adjacency=torch.from_numpy(adjacency).to(device),
                   degrees=torch.from_numpy(degrees).to(device),
                   n=n, max_degree=adjacency.shape[1])

    @property
    def capacity(self) -> int:
        return self.adjacency.shape[0]

    # -- access ---------------------------------------------------------------
    def neighbors(self, ids: torch.Tensor) -> torch.Tensor:
        """Gather adjacency rows (ids clamped like the JAX ``mode="clip"``
        gather): (...,) -> (..., R) int32 with -1 padding."""
        return self.adjacency[ids.clamp(0, self.capacity - 1)]

    def degrees_of(self, ids: torch.Tensor) -> torch.Tensor:
        return self.degrees[ids.clamp(0, self.capacity - 1)]

    # -- mutation (functional) --------------------------------------------------
    def _sink(self, ids: torch.Tensor) -> torch.Tensor:
        """Map ids outside ``[0, capacity)`` onto the sink row index."""
        ok = (ids >= 0) & (ids < self.capacity)
        return torch.where(ok, ids, self.capacity).long()

    def replace_rows(self, ids: torch.Tensor, rows: torch.Tensor,
                     new_degrees: torch.Tensor) -> "NeighborGraph":
        """Replace whole adjacency rows; ids outside the graph are dropped.
        ``rows`` must already be -1-padded past the degree."""
        idx = self._sink(ids)
        adjacency = torch.cat([self.adjacency,
                               self.adjacency.new_full(
                                   (1, self.max_degree), SENTINEL)])
        adjacency[idx] = rows.to(torch.int32)
        degrees = torch.cat([self.degrees, self.degrees.new_zeros(1)])
        degrees[idx] = new_degrees.to(torch.int32)
        return dataclasses.replace(self, adjacency=adjacency[:-1],
                                   degrees=degrees[:-1])

    def scatter_edges(self, dst: torch.Tensor, slot: torch.Tensor,
                      src: torch.Tensor, valid: torch.Tensor
                      ) -> "NeighborGraph":
        """Write edges dst->src at explicit slots; invalid entries are
        dropped into the sink."""
        sink = self.capacity * self.max_degree
        flat_idx = torch.where(valid, dst.long() * self.max_degree + slot,
                               sink)
        flat = torch.cat([self.adjacency.reshape(-1),
                          self.adjacency.new_full((1,), SENTINEL)])
        flat[flat_idx] = src.to(torch.int32)
        counts = torch.zeros(self.capacity + 1, dtype=torch.int32,
                             device=self.degrees.device)
        counts.index_add_(0, torch.where(valid, dst.long(), self.capacity),
                          valid.to(torch.int32))
        return dataclasses.replace(
            self, adjacency=flat[:-1].reshape(self.adjacency.shape),
            degrees=self.degrees + counts[:-1])

    def clear_rows(self, ids: torch.Tensor) -> "NeighborGraph":
        """Reset the adjacency of the given nodes to empty (the reference's
        ``clear_node``, graph.h:146); ids outside the graph are dropped."""
        ids = ids.to(self.adjacency.device)
        return self.replace_rows(
            ids, self.adjacency.new_full((ids.shape[0], self.max_degree),
                                         SENTINEL),
            self.degrees.new_zeros(ids.shape[0]))

    def with_capacity(self, capacity: int) -> "NeighborGraph":
        """Grow to at least ``capacity`` rows (a multiple of 8) of empty
        adjacency."""
        cap = dt.pad_to(capacity, 8)
        if cap <= self.capacity:
            return self
        grow = cap - self.capacity
        adjacency = torch.cat([self.adjacency, self.adjacency.new_full(
            (grow, self.max_degree), SENTINEL)])
        degrees = torch.cat([self.degrees, self.degrees.new_zeros(grow)])
        return dataclasses.replace(self, adjacency=adjacency,
                                   degrees=degrees)

    def to_numpy(self) -> np.ndarray:
        return self.adjacency[: self.n].cpu().numpy()

    # -- stats -------------------------------------------------------------------
    def mean_degree(self) -> float:
        return float(self.degrees[: self.n].float().mean())

    # -- persistence ---------------------------------------------------------------
    SCHEMA = "default_graph"
    VERSION = saveload.Version(0, 0, 1)

    def save(self, ctx: saveload.SaveContext) -> dict:
        return _graph_table(ctx, self.to_numpy(), self.max_degree)

    @classmethod
    def load(cls, table: dict, ctx: saveload.LoadContext,
             device="cuda") -> "NeighborGraph":
        """Through :meth:`from_array`: capacity ``pad_to(n, 8)`` and the
        degrees counted from ``SENTINEL``, as in the JAX package."""
        saveload.check_table(table, cls.SCHEMA, cls.VERSION)
        return cls.from_array(ctx.load_array(table["binary_file"]),
                              n=table["num_nodes"], device=device)


def save_adjacency_host(directory: str, adjacency: np.ndarray,
                        n: Optional[int] = None) -> None:
    """Write a :class:`NeighborGraph` checkpoint from a host (rows, R)
    adjacency array: the format of :meth:`NeighborGraph.save`."""
    adjacency = np.asarray(adjacency, dtype=np.int32)
    n = adjacency.shape[0] if n is None else n
    table = _graph_table(saveload.SaveContext(directory), adjacency[:n],
                         adjacency.shape[1])
    with open(os.path.join(directory, saveload.CONFIG_FILENAME), "w") as f:
        json.dump(table, f, indent=2)


def _graph_table(ctx: saveload.SaveContext, adjacency: np.ndarray,
                 max_degree: int) -> dict:
    return saveload.save_table(NeighborGraph.SCHEMA, NeighborGraph.VERSION, {
        "name": "neighbor graph",
        "binary_file": ctx.save_array(adjacency),
        "max_degree": int(max_degree),
        "num_nodes": int(adjacency.shape[0]),
    })
