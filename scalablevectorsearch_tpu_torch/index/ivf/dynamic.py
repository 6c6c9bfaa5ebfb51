"""Dynamic (mutable) IVF index.

PyTorch counterpart of ``scalablevectorsearch_tpu/index/ivf/dynamic.py`` (the
reference's ``DynamicIVFIndex``, ``include/svs/index/ivf/dynamic_ivf.h``):
fixed centroids from the initial clustering, mutable posting lists,
external-id translation on the host.

* **add**: one centroid matmul assigns each new point; free slots are
  claimed by a vectorized sort-by-cluster + segment-rank mapping on the
  host, and the rows are scattered into the device dataset;
* **per-cluster growth**: a cluster out of free slots gains whole probe
  units (``slot`` rows each) appended to the layout, whose centroid rows
  repeat the owning cluster's (the reference grows per-cluster blocked
  arrays, dynamic_ivf.h:889-996);
* **delete**: a slot becomes padding again (id -1, norm +inf), which the
  scan masks;
* **compact**: repack the clusters to the smallest aligned slot, one probe
  unit each.

The scan is the static index's (``index.serve_ivf_layout``) over the
row-gather route; it returns slot positions, translated to external ids
at ``result()``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ...core.data import VectorDataset
from ...core.query_result import QueryResult
from ...core.translation import IDTranslator
from ...lib import datatypes as dt
from ...ops import distance as dist_ops
from .clustering import Clustering
from .index import (_pick_subtile, _poison_padding, _resolve_tiles_per_step,
                    serve_ivf_layout)
from .kmeans import assign_full
from .params import IVFBuildParameters, IVFSearchParameters


class DynamicIVFIndex:
    def __init__(self, clustering: Clustering, data, external_ids, distance,
                 *, slot_slack: float = 1.5, query_batch_size: int = 2048,
                 scan_subtile: int = 256, logger=None, device="cuda"):
        x = np.asarray(data, dtype=np.float32)
        external_ids = np.asarray(external_ids, dtype=np.int64)
        self.distance = dist_ops.as_distance(distance)
        self.k = clustering.num_centroids
        self.query_batch_size = query_batch_size
        self.scan_subtile = scan_subtile
        self.scan_tiles_per_step = 0
        self.device = torch.device(device)
        self._d = x.shape[1]
        self._base_centroids = _pad_centroids(clustering.centroids, self._d)
        assign = np.asarray(clustering.assignments)
        sizes = np.bincount(assign, minlength=self.k)
        slot = int(dt.pad_to(max(int(sizes.max() * slot_slack), 8), 8))
        self._init_layout(x, external_ids, assign, slot)

    @classmethod
    def from_state(cls, base_centroids, vectors, ids_padded, slot: int,
                   unit_owner, fill, occupied, translator: IDTranslator,
                   distance, *, query_batch_size: int = 2048,
                   scan_subtile: int = 256, device="cuda"
                   ) -> "DynamicIVFIndex":
        """An index over a given layout, without training or packing:
        (k, d) logical centroids, the (total, d) slot rows, ``ids_padded``
        (slot positions, -1 on free slots), the unit owners, per-unit
        fill, the occupied mask and the translator."""
        self = cls.__new__(cls)
        self.distance = dist_ops.as_distance(distance)
        vectors = np.asarray(vectors, dtype=np.float32)
        self._d = vectors.shape[1]
        self._base_centroids = _pad_centroids(base_centroids, self._d)
        self.k = self._base_centroids.shape[0]
        self.query_batch_size = query_batch_size
        self.scan_subtile = scan_subtile
        self.scan_tiles_per_step = 0
        self.device = torch.device(device)
        self.slot = int(slot)
        self.unit_owner = np.asarray(unit_owner, dtype=np.int32).copy()
        self._fill = np.asarray(fill, dtype=np.int64).copy()
        self._occupied = np.asarray(occupied, dtype=bool).copy()
        self.translator = translator
        total = self.unit_owner.size * self.slot
        ids_padded = np.array(ids_padded, dtype=np.int32)   # writable copy
        self.data = _poison_padding(VectorDataset.from_array(
            vectors, capacity=total, device=self.device), ids_padded)
        self.ids_padded = torch.from_numpy(ids_padded).to(self.device)
        self._upload_unit_centroids()
        return self

    # -- layout ----------------------------------------------------------------
    def _init_layout(self, x, external_ids, assign, slot: int):
        """(Re)pack points into a padded layout with the given slot size,
        one probe unit per logical cluster."""
        k = self.k
        self.slot = slot
        self.unit_owner = np.arange(k, dtype=np.int32)  # unit -> cluster
        total = k * slot
        order = np.argsort(assign, kind="stable")
        sizes = np.bincount(assign, minlength=k)
        if sizes.max() > slot:
            raise ValueError("slot too small for cluster sizes")
        starts = np.zeros(k, dtype=np.int64)
        np.cumsum(sizes[:-1], out=starts[1:])
        rank = np.arange(x.shape[0]) - starts[assign[order]]
        pos = assign[order].astype(np.int64) * slot + rank

        rows = np.zeros((total, x.shape[1]), dtype=np.float32)
        rows[pos] = x[order]
        occupied = np.zeros(total, dtype=bool)
        occupied[pos] = True
        # the scan returns slot positions; the translator maps them to
        # external ids at the API boundary
        ids_padded = np.full(total, -1, dtype=np.int32)
        ids_padded[pos] = pos.astype(np.int32)
        # padding = +inf norms so the scan can never return it
        self.data = _poison_padding(VectorDataset.from_array(
            rows, capacity=total, device=self.device), ids_padded)
        self._fill = sizes.astype(np.int64)          # per-unit live count
        self._occupied = occupied                    # host mirror
        self.translator = IDTranslator(total)
        self.translator.insert(external_ids[order], pos)
        self.ids_padded = torch.from_numpy(ids_padded).to(self.device)
        self._upload_unit_centroids()

    def _upload_unit_centroids(self) -> None:
        """(Re)build the per-probe-unit centroid rows on the device."""
        units = self._base_centroids[self.unit_owner]
        self.centroids = torch.from_numpy(units).to(self.device)
        self.centroid_norms = self.centroids.square().sum(-1)

    def _add_units(self, per_cluster: np.ndarray) -> None:
        """Append ``per_cluster[c]`` empty probe units for each cluster c:
        only overflowing clusters grow, nothing is repacked."""
        new_owners = np.repeat(np.arange(self.k, dtype=np.int32),
                               per_cluster)
        if new_owners.size == 0:
            return
        self.unit_owner = np.concatenate([self.unit_owner, new_owners])
        grow = new_owners.size * self.slot
        total = self.unit_owner.size * self.slot
        self.data = self.data.with_capacity(total)
        self.ids_padded = torch.cat([self.ids_padded, self.ids_padded.new_full(
            (total - self.ids_padded.shape[0],), -1)])
        self._occupied = np.concatenate(
            [self._occupied, np.zeros(grow, dtype=bool)])
        self._fill = np.concatenate(
            [self._fill, np.zeros(new_owners.size, dtype=np.int64)])
        self._upload_unit_centroids()

    # -- properties ------------------------------------------------------------
    @property
    def size(self) -> int:
        return len(self.translator)

    @property
    def dimensions(self) -> int:
        return self._d

    @property
    def num_centroids(self) -> int:
        """Logical cluster count (fixed at construction)."""
        return self.k

    @property
    def num_probe_units(self) -> int:
        """Probe units = centroid rows; grows past ``num_centroids`` when
        clusters overflow (n_probes counts these)."""
        return self.unit_owner.size

    def all_ids(self) -> np.ndarray:
        return np.sort(self.translator.all_external_ids())

    def has_id(self, external_id: int) -> bool:
        return external_id in self.translator

    # -- search ----------------------------------------------------------------
    def search(self, queries, k: int,
               parameters: Optional[IVFSearchParameters] = None,
               cancel=None) -> QueryResult:
        """``cancel``: optional zero-arg predicate checked between query
        batch dispatches."""
        return self.search_async(queries, k, parameters=parameters,
                                 cancel=cancel).result()

    def search_async(self, queries, k: int,
                     parameters: Optional[IVFSearchParameters] = None,
                     cancel=None):
        """Pipelined dispatch (see ``IVFIndex.search_async``) on the
        row-gather route; slot -> external id translation happens on the
        host at ``.result()``."""
        params = parameters or IVFSearchParameters()
        sub = _pick_subtile(self.slot, self.scan_subtile)

        def translate(s):
            return np.where(
                s >= 0, self.translator.to_external(np.maximum(s, 0)), -1)

        return serve_ivf_layout(
            self, queries, k,
            n_probes=min(params.n_probes, self.num_probe_units),
            keep=max(k * params.k_reorder, k),
            tiles=_resolve_tiles_per_step(self.scan_tiles_per_step,
                                          self.slot // sub),
            cancel=cancel, translate_ids=translate)

    # -- mutation --------------------------------------------------------------
    def add_points(self, points, external_ids) -> None:
        """Bulk insert, vectorized: free slots are claimed by sorting the
        new points and the free list by owning cluster and aligning them
        with segment ranks.  Clusters without enough free slots first gain
        whole probe units (:meth:`_add_units`)."""
        points = np.asarray(points, dtype=np.float32)
        external_ids = np.asarray(external_ids, dtype=np.int64)
        assign = assign_full(points, self._base_centroids[:, : self._d],
                             device=self.device).astype(np.int64)
        need = np.bincount(assign, minlength=self.k)
        free_mask = ~self._occupied
        owners_all = np.repeat(self.unit_owner.astype(np.int64), self.slot)
        free_per_cluster = np.bincount(owners_all[free_mask],
                                       minlength=self.k)
        deficit = need - free_per_cluster
        if np.any(deficit > 0):
            self._add_units(np.ceil(np.maximum(deficit, 0)
                                    / self.slot).astype(np.int64))
            free_mask = ~self._occupied
            owners_all = np.repeat(self.unit_owner.astype(np.int64),
                                   self.slot)

        # free slots grouped by owning cluster (stable: position order kept)
        free = np.flatnonzero(free_mask)
        owners = owners_all[free]
        by_owner = np.argsort(owners, kind="stable")
        free, owners = free[by_owner], owners[by_owner]

        order = np.argsort(assign, kind="stable")
        sa = assign[order]
        rank = np.arange(sa.size) - np.searchsorted(sa, sa)
        slots_sorted = free[np.searchsorted(owners, sa) + rank]
        slots = np.empty(sa.size, dtype=np.int64)
        slots[order] = slots_sorted

        self._occupied[slots] = True
        self._fill += np.bincount(slots // self.slot,
                                  minlength=self._fill.size)
        self.translator.insert(external_ids, slots)
        slots_t = torch.from_numpy(slots).to(self.device)
        self.data = self.data.scatter_rows(slots_t, points)
        self.ids_padded = self.ids_padded.index_put(
            (slots_t,), slots_t.to(torch.int32))

    def delete_points(self, external_ids) -> None:
        slots = self.translator.remove(external_ids)
        self._occupied[slots] = False
        self._fill -= np.bincount(slots // self.slot,
                                  minlength=self._fill.size)
        slots_t = torch.from_numpy(slots).to(self.device)
        self.ids_padded = self.ids_padded.index_fill(0, slots_t, -1)
        self.data = dataclasses.replace(
            self.data,
            norms_sq=self.data.norms_sq.index_fill(0, slots_t, float("inf")))

    def compact(self) -> None:
        """Repack to the minimal aligned slot size, collapsing multi-unit
        clusters back to one probe unit each."""
        cluster_fill = np.bincount(self.unit_owner, weights=self._fill,
                                   minlength=self.k).astype(np.int64)
        self._repack(int(cluster_fill.max()))

    def _repack(self, min_slot: int) -> None:
        live = np.nonzero(self._occupied)[0]
        ext = self.translator.to_external(live)
        x = self.data.vectors[torch.from_numpy(live).to(self.device)][
            :, : self._d].float().cpu().numpy()
        assign = self.unit_owner[(live // self.slot)].astype(np.int64)
        self._init_layout(x, ext, assign, int(dt.pad_to(max(min_slot, 8), 8)))

    def consolidate(self) -> None:
        """No graph to repair; kept for API parity."""


def _pad_centroids(centroids, dim: int) -> np.ndarray:
    """(k, dim) f32 centroids padded to the dataset's lane width."""
    centroids = np.asarray(centroids, dtype=np.float32)
    d_pad = dt.padded_dim(dim)
    if centroids.shape[1] < d_pad:
        centroids = np.pad(centroids,
                           ((0, 0), (0, d_pad - centroids.shape[1])))
    return centroids


class DynamicIVF:
    """Orchestrator (reference ``svs::DynamicIVF``, orchestrators/
    dynamic_ivf.h)."""

    def __init__(self, index: DynamicIVFIndex):
        self._index = index

    @staticmethod
    def build(parameters: IVFBuildParameters, data, external_ids, distance,
              device="cuda", **kwargs) -> "DynamicIVF":
        clustering = Clustering.build(parameters, data, device=device)
        return DynamicIVF(DynamicIVFIndex(clustering, data, external_ids,
                                          distance, device=device, **kwargs))

    def search(self, queries, n_neighbors: int) -> QueryResult:
        return self._index.search(queries, n_neighbors)

    def search_async(self, queries, n_neighbors: int):
        return self._index.search_async(queries, n_neighbors)

    def add_points(self, points, external_ids) -> None:
        self._index.add_points(points, external_ids)

    def delete_points(self, external_ids) -> None:
        self._index.delete_points(external_ids)

    def consolidate(self) -> "DynamicIVF":
        self._index.consolidate()
        return self

    def compact(self) -> "DynamicIVF":
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
    def search_parameters(self):
        return getattr(self._index, "_search_parameters",
                       IVFSearchParameters())

    @property
    def index(self) -> DynamicIVFIndex:
        return self._index
