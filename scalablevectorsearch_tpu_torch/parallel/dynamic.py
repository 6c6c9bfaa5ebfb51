"""Sharded dynamic (mutable) Vamana: add / delete / consolidate / compact
over a device mesh.

PyTorch counterpart of ``scalablevectorsearch_tpu/parallel/dynamic.py``:
the port's single-device ``MutableVamanaIndex`` with its graph and its f32
rows behind the shard views of :mod:`.sharded`, graph rows and dataset rows
in contiguous blocks over a mesh axis.  Slots are global ids, so the host
state (the Empty / Valid / Deleted status, the id translator, the high-water
mark) and every step of the single-device index — incremental build
rounds, consolidation re-pruning, search, the soft delete that redraws the
entry sample — run unchanged over the views, and their results are the
single-device index's given the same state (bit for bit on the CPU).

What differs:

* the capacity rounds up so that every shard holds a multiple of 8 rows;
* ``compact`` moves a slot only within its shard, leaving one dense prefix
  per shard (no row crosses devices); the old -> new slot table remaps the
  adjacency on every shard.  The high-water mark is then one past the last
  occupied slot;
* the entry point is ``compute_medioid``'s over the rows the single-device
  index counts into its mean (every slot used since the last compaction,
  those below its high-water mark), in slot order (``sharded_medioid``),
  the arg-min over the VALID rows: the single-device entry point bit for
  bit when both hold the same capacity;
* packed serving is not offered; ``save`` writes the single-device
  checkpoint of :meth:`to_single_chip`.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core.data import VectorDataset
from ..core.graph import NeighborGraph
from ..core.translation import IDTranslator
from ..lib import datatypes as dt
from ..lib import logging as svs_logging
from ..ops import distance as dist_ops
from ..index.vamana import build as build_mod
from ..index.vamana.dynamic import (SLOT_DELETED, SLOT_EMPTY, SLOT_VALID,
                                    MutableVamanaIndex, _affected_by_deleted,
                                    _compact_kernel)
from ..index.vamana.params import VamanaBuildParameters
from . import sharded
from .mesh import Mesh


class ShardedMutableVamanaIndex(MutableVamanaIndex):
    """Mutable Vamana with graph and dataset rows sharded across a mesh
    axis (``self.graph``, ``self.data``: shard views; the beam, the deleted
    mask and the sample on the lead device)."""

    def __init__(self, parameters: VamanaBuildParameters, data, external_ids,
                 distance, mesh: Mesh, *, capacity: Optional[int] = None,
                 axis: str = "shard", query_batch_size: int = 2048,
                 pop_width: int = 4, logger=None):
        """Build over (n, d) rows under ``external_ids`` with the static
        two-pass build over shard views, in storage for ``capacity`` rows
        (default ``max(2n, 64)``, rounded up to the mesh)."""
        x = np.asarray(data, dtype=np.float32)
        n = x.shape[0]
        self.mesh, self.axis = mesh, axis
        self.distance = dist_ops.as_distance(distance)
        self.parameters = parameters.resolved(self.distance)
        rows = sharded.shard_dataset(VectorDataset.from_array(
            x, capacity=dt.padded_count(capacity if capacity is not None
                                        else max(2 * n, 64)),
            device=mesh.lead), mesh, axis)
        translator = IDTranslator(rows.capacity)
        translator.insert(np.asarray(external_ids, dtype=np.int64),
                          np.arange(n, dtype=np.int64))
        logger = svs_logging.as_logger(logger)
        graph, entry = build_mod.build_graph(
            rows, self.parameters, self.distance, logger=logger,
            pop_width=4, tail_frac=4,
            entry_point=sharded.sharded_medioid(rows, np.arange(n),
                                                rows.capacity),
            graph=sharded.shard_graph(NeighborGraph.empty(
                n, self.parameters.graph_max_degree, capacity=rows.capacity,
                device=mesh.lead), mesh, axis))
        self._set_state(rows, graph, np.full(n, SLOT_VALID, np.int8),
                        translator, entry, query_batch_size=query_batch_size,
                        pop_width=pop_width, logger=logger)
        self._counted = np.arange(self.capacity) < n

    # -- layout ------------------------------------------------------------------
    @property
    def n_shards(self) -> int:
        return self.mesh.shape[self.axis]

    @property
    def capacity(self) -> int:
        return self.status.size

    @property
    def rows_per_shard(self) -> int:
        return self.capacity // self.n_shards

    # -- mutation ------------------------------------------------------------------
    def add_points(self, points, external_ids) -> np.ndarray:
        """``MutableVamanaIndex.add_points`` over the views (the storage, if
        it grows, is laid out again over the mesh)."""
        slots = super().add_points(points, external_ids)
        counted = np.zeros(self.capacity, dtype=bool)
        counted[: self._counted.size] = self._counted
        counted[slots] = True
        self._counted = counted
        return slots

    def _affected(self, valid_mask: torch.Tensor) -> np.ndarray:
        """The consolidation scan, shard by shard over the local adjacency
        blocks; only the (capacity,) masks cross devices."""
        rps, parts = self.rows_per_shard, []
        for s, (g, dev) in enumerate(zip(self.graph.shards,
                                         self.graph.layout.devices)):
            parts.append(_affected_by_deleted(
                g.adjacency, self.deleted_mask.to(dev),
                valid_mask[s * rps:(s + 1) * rps].to(dev)).cpu())
        return np.nonzero(torch.cat(parts).numpy())[0]

    def compact(self) -> None:
        """Per-shard compaction: every occupied slot moves to the dense
        prefix of its own shard, in slot order; the adjacency of every
        shard is remapped through the global old -> new table on its
        device (``_compact_kernel`` per shard).  The translator, the status
        and the entry point follow, as in ``MutableVamanaIndex.compact``."""
        cap, rps = self.capacity, self.rows_per_shard
        occupied = self.status != SLOT_EMPTY
        if occupied[: self.data.n].all():
            return
        old_to_new = np.full(cap + 1, -1, dtype=np.int64)
        perm = np.zeros(cap, dtype=np.int64)
        counts = []
        for lo in range(0, cap, rps):
            alive = lo + np.nonzero(occupied[lo:lo + rps])[0]
            old_to_new[alive] = lo + np.arange(alive.size)
            perm[lo:lo + alive.size] = alive - lo
            counts.append(alive.size)
        moved = np.nonzero(occupied)[0]
        o2n = torch.from_numpy(old_to_new[:-1].astype(np.int32))
        graphs, rows = [], []
        for s, (g, d, dev) in enumerate(zip(self.graph.shards,
                                            self.data.shards,
                                            self.graph.layout.devices)):
            adj, degs, vecs, norms = _compact_kernel(
                g.adjacency, d.vectors, d.norms_sq,
                torch.from_numpy(perm[s * rps:(s + 1) * rps]).to(dev),
                o2n.to(dev), counts[s])
            graphs.append(NeighborGraph(adjacency=adj, degrees=degs, n=rps,
                                        max_degree=g.max_degree))
            rows.append(VectorDataset(vectors=vecs, norms_sq=norms, n=rps,
                                      dim=d.dim))
        new_status = np.full(cap, SLOT_EMPTY, dtype=np.int8)
        new_status[old_to_new[moved]] = self.status[moved]
        high = int(old_to_new[moved].max()) + 1 if moved.size else 0
        self.graph = dataclasses.replace(self.graph, shards=graphs, n=high)
        self.data = dataclasses.replace(self.data, shards=rows, n=high)
        self.status = new_status
        self.deleted_mask = torch.from_numpy(
            new_status == SLOT_DELETED).to(self.data.device)
        self.translator.remap(old_to_new)
        self._counted = new_status != SLOT_EMPTY
        self._invalidate_packed()
        self._reset_entry_point()

    def _reset_entry_point(self) -> None:
        """The medioid of the VALID rows, the mean over the rows the
        single-device index counts (see the module docstring)."""
        alive = self.status == SLOT_VALID
        if not alive.any():
            self.entry_point = 0
            return
        counted = np.nonzero(self._counted)[0]
        self.entry_point = sharded.sharded_medioid(
            self.data, counted, self.capacity, valid=alive[counted])
        if not alive[self.entry_point]:
            self.entry_point = int(np.nonzero(alive)[0][0])

    def enable_packed_serving(self, dtype=torch.bfloat16,
                              chunk: int = 65536) -> None:
        raise NotImplementedError("packed serving of a sharded index: use "
                                  "to_single_chip()")

    # -- interop ---------------------------------------------------------------------
    @classmethod
    def from_single_chip(cls, index: MutableVamanaIndex, mesh: Mesh, *,
                         axis: str = "shard") -> "ShardedMutableVamanaIndex":
        """Shard a single-device ``MutableVamanaIndex`` over a mesh axis,
        state and all: later mutations give what the single-device index
        gives for the same calls."""
        if not isinstance(index.data, VectorDataset):
            raise ValueError("from_single_chip takes a VectorDataset-backed "
                             "index")
        data = sharded.shard_dataset(index.data, mesh, axis)
        obj = cls.__new__(cls)
        obj.mesh, obj.axis = mesh, axis
        obj.distance, obj.parameters = index.distance, index.parameters
        obj._set_state(
            data, sharded.shard_graph(index.graph.with_capacity(
                data.capacity), mesh, axis),
            index.status, copy.deepcopy(index.translator), index.entry_point,
            query_batch_size=index.query_batch_size,
            pop_width=index.pop_width, logger=index.logger)
        obj._search_parameters = index.search_parameters
        obj._sampler_cfg = index._sampler_cfg
        obj.tail_frac = index.tail_frac
        obj._counted = np.arange(obj.capacity) < index.data.n
        return obj

    def to_single_chip(self) -> MutableVamanaIndex:
        """The same state in one ``MutableVamanaIndex`` on the lead device
        (the checkpoint format is the single-device one)."""
        obj = MutableVamanaIndex.__new__(MutableVamanaIndex)
        obj.distance, obj.parameters = self.distance, self.parameters
        obj._set_state(self.data.gather(), self.graph.gather(),
                       self.status.copy(), copy.deepcopy(self.translator),
                       self.entry_point,
                       query_batch_size=self.query_batch_size,
                       pop_width=self.pop_width, logger=self.logger)
        obj._search_parameters = self._search_parameters
        obj._sampler_cfg = self._sampler_cfg
        obj.tail_frac = self.tail_frac
        return obj

    def save(self, config_dir: str) -> None:
        """The single-device checkpoint of :meth:`to_single_chip`."""
        self.to_single_chip().save(config_dir)

    @classmethod
    def assemble(cls, config_dir: str, mesh: Mesh, *, axis: str = "shard",
                 **kwargs) -> "ShardedMutableVamanaIndex":
        """A checkpoint either package saved, sharded over ``mesh``."""
        return cls.from_single_chip(MutableVamanaIndex.assemble(
            config_dir, device=mesh.lead, **kwargs), mesh, axis=axis)

    @classmethod
    def from_state(cls, *args, mesh: Mesh, axis: str = "shard", **kwargs
                   ) -> "ShardedMutableVamanaIndex":
        """``MutableVamanaIndex.from_state``, sharded over ``mesh``."""
        return cls.from_single_chip(MutableVamanaIndex.from_state(
            *args, **kwargs), mesh, axis=axis)
