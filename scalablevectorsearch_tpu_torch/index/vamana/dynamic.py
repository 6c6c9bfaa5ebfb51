"""Mutable (dynamic) Vamana index: add / soft delete / consolidate / compact.

PyTorch counterpart of ``scalablevectorsearch_tpu/index/vamana/dynamic.py``
(the reference's ``MutableVamanaIndex``, ``dynamic_index.h:111``):

* slot lifecycle Empty / Valid / Deleted (``dynamic_index.h:67``): the
  ``status`` array and the :class:`IDTranslator` live on the host, a
  ``deleted_mask`` on the index's device.  Deleted nodes stay traversable
  until consolidation but never surface in results (the predicated search
  buffer of ``dynamic_search_buffer.h``);
* ``add_points``: reuse empty slots below the high-water mark, then grow
  the storage in place; scatter the rows, clear their adjacency, and run
  the static build's rounds (``build_round``, so ``beam_step`` on the card)
  over the new slots only (``dynamic_index.h:630-723``);
* ``delete_points``: soft delete (``dynamic_index.h:747-760``);
* ``consolidate``: re-prune, in batches, every vertex adjacent to a deleted
  node over {alive neighbours} ∪ {alive neighbours of deleted neighbours},
  then clear and free the deleted slots (``consolidate.h:139-310``);
* ``compact``: a dense remap of the slots on the device
  (``dynamic_index.h:791-884``).

Packed neighbourhoods and the entry sampler are rebuilt lazily on the next
search after a mutation that invalidates them: add, consolidate and
compact drop both; a soft delete keeps the packed rows (deleted nodes stay
traversable, and their rows and adjacency are unchanged) but drops the
sample, so that it is drawn from the VALID slots of the moment, as an
assembled copy's is (the JAX package's code keeps the sample on a soft
delete).  The JAX package's jitted functions are plain torch
functions here, run on the index's device.  Checkpoints are the JAX
package's ``dynamic_vamana_index_parameters`` v0.0.2 layout, so either
package assembles what the other saved.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np
import torch

from ...core.data import VectorDataset
from ...core.graph import NeighborGraph
from ...core.query_result import QueryResult
from ...core.translation import IDTranslator
from ...lib import datatypes as dt
from ...lib import logging as svs_logging
from ...lib import saveload
from ...ops import distance as dist_ops
from ...ops import topk as topk_ops
from . import build as build_mod
from . import search as search_mod
from .index import (PendingSearch, _BatchPlan, dequantize_queries,
                    upload_batches)
from .params import VamanaBuildParameters, VamanaSearchParameters

SLOT_EMPTY, SLOT_VALID, SLOT_DELETED = 0, 1, 2
CONFIG_FILENAME = "dynamic_vamana_config.json"


def _affected_by_deleted(adjacency: torch.Tensor, deleted_mask: torch.Tensor,
                         valid_mask: torch.Tensor) -> torch.Tensor:
    """(capacity,) bool: valid vertices with at least one deleted neighbour
    (consolidate.h:139's candidate scan, on the device)."""
    neigh_del = deleted_mask[adjacency.clamp(0, deleted_mask.shape[0] - 1)] \
        & (adjacency >= 0)
    return neigh_del.any(1) & valid_mask[: adjacency.shape[0]]


def consolidate_round(graph: NeighborGraph, data, node_ids: torch.Tensor,
                      node_valid: torch.Tensor, deleted_mask: torch.Tensor, *,
                      prune_to: int, alpha: float, distance, max_degree: int,
                      prune_chunk: int, pool_cap: int) -> NeighborGraph:
    """Re-prune one batch of vertices that touch deleted nodes: candidates
    are the alive neighbours and the alive neighbours of deleted
    neighbours, the ``pool_cap`` nearest are kept, and RobustPrune runs
    with the index alpha (consolidate.h:275-278)."""
    r = graph.max_degree
    b = node_ids.shape[0]
    cap = deleted_mask.shape[0]
    adj = graph.neighbors(node_ids.clamp_min(0))                   # (B, R)
    adj_deleted = deleted_mask[adj.clamp(0, cap - 1)] & (adj >= 0)
    # second hop, only through deleted neighbours
    hop2 = graph.neighbors(adj.clamp_min(0).reshape(-1)).reshape(b, r * r)
    hop2 = torch.where(adj_deleted.repeat_interleave(r, dim=1), hop2, -1)
    cand = torch.cat([torch.where(adj_deleted, -1, adj), hop2], dim=1)
    cand_deleted = deleted_mask[cand.clamp(0, cap - 1)]
    cand = torch.where(cand_deleted | (cand < 0), -1, cand)

    queries = data.get(node_ids)
    q_norms = data.norms_of(node_ids)
    keys = build_mod._score_against(data, distance, queries, q_norms, cand)
    keys = topk_ops.mask_first_duplicates(keys, cand)
    keys = torch.where(node_valid[:, None], keys, float("inf"))
    keys, cand = topk_ops.smallest_k(keys, cand, pool_cap)

    rows, degs = build_mod._prune_pools(
        data, cand, keys, node_ids, alpha, prune_to, distance, prune_chunk)
    commit = torch.where(node_valid, node_ids, graph.capacity)
    return graph.replace_rows(commit, build_mod._pad_cols(rows, max_degree),
                              degs)


def _compact_kernel(adjacency: torch.Tensor, vectors: torch.Tensor,
                    norms_sq: torch.Tensor, perm: torch.Tensor,
                    o2n: torch.Tensor, n_alive: int):
    """Gather-remap the graph and the rows through a slot permutation on
    the device (dynamic_index.h:791-884).  ``perm``: (capacity,) new -> old
    slot (rows past ``n_alive`` arbitrary); ``o2n``: (capacity,) old -> new,
    -1 for dropped slots."""
    cap = perm.shape[0]
    live = torch.arange(cap, device=perm.device) < n_alive
    rows = adjacency[perm.clamp(0, adjacency.shape[0] - 1).long()]
    remapped = torch.where(
        rows >= 0, o2n[rows.clamp(0, o2n.shape[0] - 1).long()], -1)
    # edges to dropped slots vanish; the rest move left in their order (a
    # stable sort of the integer "dropped" flag)
    order = torch.argsort((remapped < 0).to(torch.int32), dim=1,
                          stable=True)
    remapped = torch.gather(remapped, 1, order)
    remapped = torch.where(live[:, None], remapped, -1)
    degrees = (remapped >= 0).sum(1, dtype=torch.int32)
    gathered = perm.clamp(0, vectors.shape[0] - 1).long()
    vecs = torch.where(live[:, None], vectors[gathered], 0)
    norms = torch.where(live, norms_sq[gathered], float("inf"))
    return remapped, degrees, vecs, norms


def _drop_deleted(keys: torch.Tensor, ids: torch.Tensor,
                  deleted_mask: torch.Tensor, k: int):
    """Poison deleted slots in the result beam and re-select the top k."""
    is_del = deleted_mask[ids.clamp(0, deleted_mask.shape[0] - 1)]
    keys = torch.where(is_del | (ids < 0), float("inf"), keys)
    return topk_ops.smallest_k(keys, ids, k)


def _dyn_search_batch(graph, data, packed, deleted_mask, sampler, q,
                      q_scale, entry_ids, *, k: int, window: int,
                      capacity: int, max_iters: int, distance,
                      pop_width: int, tail_frac: int, visited_size: int,
                      n_entries: int = 1):
    """One serving dispatch of the dynamic index: dequantize, (optional)
    per-query entry selection, beam search, drop of deleted slots, key ->
    distance conversion."""
    q = dequantize_queries(q, q_scale)
    if sampler is not None:
        entry_ids = sampler.select(distance, q, n_entries=n_entries)
    out = search_mod.greedy_search(
        graph, data, q, entry_ids,
        window=window, capacity=capacity, max_iters=max_iters,
        distance=distance, pop_width=pop_width, packed=packed,
        tail_frac=tail_frac, visited_size=visited_size)
    keys, ids = _drop_deleted(out.keys, out.ids, deleted_mask, k)
    return ids, dist_ops.value_from_key(distance, keys)


class MutableVamanaIndex:
    """Dynamic Vamana index over f32 rows on one device."""

    SCHEMA = "dynamic_vamana_index_parameters"
    VERSION = saveload.Version(0, 0, 2)  # 0.0.2: optional entry_sampler
    # per-index query transfer dtype ("float32"/"float16"/"bfloat16"/
    # "int8"); None defers to the SVT_QUERY_UPLOAD_DTYPE env default
    query_upload_dtype = None

    def __init__(self, parameters: VamanaBuildParameters, data, external_ids,
                 distance, *, capacity: Optional[int] = None,
                 query_batch_size: int = 2048, pop_width: int = 4,
                 logger=None, device="cuda"):
        """Build over (n, d) rows under ``external_ids`` with the static
        two-pass build, in storage for ``capacity`` rows (default
        ``max(2n, 64)``) on ``device``."""
        x = np.asarray(data, dtype=np.float32)
        n = x.shape[0]
        self.distance = dist_ops.as_distance(distance)
        self.parameters = parameters.resolved(self.distance)
        cap = dt.padded_count(capacity if capacity is not None
                              else max(2 * n, 64))
        translator = IDTranslator(cap)        # duplicates raise before
        translator.insert(np.asarray(external_ids, dtype=np.int64),
                          np.arange(n, dtype=np.int64))     # the build
        rows = VectorDataset.from_array(x, capacity=cap, device=device)
        logger = svs_logging.as_logger(logger)
        graph, entry = build_mod.build_graph(
            rows, self.parameters, self.distance, logger=logger,
            pop_width=4, tail_frac=4)
        self._set_state(rows, graph, np.full(n, SLOT_VALID, np.int8),
                        translator, entry, query_batch_size=query_batch_size,
                        pop_width=pop_width, logger=logger)

    @classmethod
    def from_state(cls, data: VectorDataset, graph: NeighborGraph, status,
                   external_ids, entry_point: int, distance,
                   parameters: VamanaBuildParameters, **kwargs
                   ) -> "MutableVamanaIndex":
        """An index over given state, without a build: ``status`` and
        ``external_ids`` are aligned with the slots below the high-water
        mark (the external ids of slots that are not VALID are ignored).
        ``kwargs``: ``query_batch_size``, ``pop_width``, ``logger``."""
        status = np.asarray(status, dtype=np.int8)
        valid = np.nonzero(status == SLOT_VALID)[0]
        translator = IDTranslator(data.capacity)
        translator.insert(np.asarray(external_ids, np.int64)[valid], valid)
        obj = cls.__new__(cls)
        obj.distance = dist_ops.as_distance(distance)
        obj.parameters = parameters
        obj._set_state(data, graph, status, translator, entry_point,
                       **kwargs)
        return obj

    def _set_state(self, data, graph, status, translator, entry_point, *,
                   query_batch_size: int = 2048, pop_width: int = 4,
                   logger=None) -> None:
        cap = data.capacity
        self.data = data
        self.graph = graph.with_capacity(cap)
        # data.n tracks the high-water slot; storage rows past it are unused
        self.status = np.zeros(cap, dtype=np.int8)
        self.status[: status.size] = status
        self.deleted_mask = torch.from_numpy(
            self.status == SLOT_DELETED).to(data.device)
        self.translator = translator
        self.entry_point = int(entry_point)
        self.query_batch_size = query_batch_size
        self.pop_width = pop_width
        self.logger = svs_logging.as_logger(logger)
        self._search_parameters = VamanaSearchParameters()
        self._packed = None          # packed neighbourhoods (lazy)
        self._packed_dtype = None    # None: packed serving off
        self._packed_chunk = 65536
        self._entry_sampler = None   # per-query entries (lazy)
        self._sampler_cfg = None
        self.tail_frac = 4           # lockstep tail compaction (search.py)

    # -- internals ------------------------------------------------------------
    @property
    def _high_water(self) -> int:
        return self.data.n

    def _slots(self, slots: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(slots, np.int64)).to(
            self.data.device)

    def _build_over(self, slots: np.ndarray,
                    batch_size: Optional[int] = None) -> None:
        """Build rounds over the given slots only (the add_points tail of
        dynamic_index.h:630-723).  Each round is padded to the batch size
        with ``slots[0]`` marked invalid: ``build_round`` writes nothing
        for those rows."""
        p = self.parameters
        n_slots = slots.size
        if n_slots == 0:
            return
        b = batch_size or build_mod.default_batch_size(n_slots)
        b = min(b, dt.pad_to(n_slots, 8))
        device = self.data.device
        entry_ids = torch.tensor([self.entry_point], dtype=torch.int32,
                                 device=device)
        window = p.window_size
        for start in range(0, n_slots, b):
            chunk = slots[start: start + b]
            ids = np.full(b, chunk[0], dtype=np.int32)
            ids[: chunk.size] = chunk
            valid = np.zeros(b, dtype=bool)
            valid[: chunk.size] = True
            self.graph, _ = build_mod.build_round(
                self.graph, self.data, torch.from_numpy(ids).to(device),
                torch.from_numpy(valid).to(device), entry_ids,
                window=window, capacity=window,
                max_iters=search_mod.default_max_iters(window),
                distance=self.distance,
                pool_size=p.max_candidate_pool_size,
                gen_alpha=float(p.alpha), rev_alpha=float(p.alpha),
                prune_to=p.prune_to, max_degree=p.graph_max_degree,
                prune_chunk=128, pop_width=4, tail_frac=4)

    # -- properties -------------------------------------------------------------
    @property
    def size(self) -> int:
        return int((self.status == SLOT_VALID).sum())

    @property
    def dimensions(self) -> int:
        return self.data.dim

    @property
    def search_parameters(self) -> VamanaSearchParameters:
        return self._search_parameters

    @search_parameters.setter
    def search_parameters(self, params: VamanaSearchParameters) -> None:
        self._search_parameters = params

    @property
    def search_window_size(self) -> int:
        return self._search_parameters.buffer_config.search_window_size

    @search_window_size.setter
    def search_window_size(self, window: int) -> None:
        self._search_parameters = self._search_parameters.with_window(window)

    def all_ids(self) -> np.ndarray:
        """External ids in the index, ascending (reference all_ids)."""
        return np.sort(self.translator.all_external_ids())

    def has_id(self, external_id: int) -> bool:
        return external_id in self.translator

    # -- packed-neighbourhood serving -------------------------------------------
    def enable_packed_serving(self, dtype=torch.bfloat16,
                              chunk: int = 65536) -> None:
        """Inline neighbour rows for serving (``packed.pack_neighborhoods``),
        built on the next search and rebuilt after add, consolidate and
        compact, at the capacity of the moment."""
        self._packed_dtype = dtype
        self._packed_chunk = chunk
        self._packed = None

    def disable_packed_serving(self) -> None:
        self._packed = None
        self._packed_dtype = None

    def _ensure_packed(self):
        if self._packed_dtype is None:
            return None
        if self._packed is None:
            from .packed import pack_neighborhoods
            self._packed = pack_neighborhoods(
                self.graph, self.data, self._packed_dtype,
                chunk=self._packed_chunk)
        return self._packed

    # -- per-query entry selection ------------------------------------------------
    def enable_entry_sampler(self, n_samples: Optional[int] = None,
                             n_entries: int = 1, seed: int = 0) -> None:
        """Per-query entries from a resident sample of the VALID slots
        (entry.py; ``None`` scales with the live count at each draw),
        drawn on the next search and again after every mutation: slot
        reuse can repoint a sampled id at another vector, consolidation
        empties deleted rows' adjacency, and a copy assembled after a
        delete draws from the VALID slots of that moment."""
        self._sampler_cfg = (n_samples, n_entries, seed)
        self._entry_sampler = None

    def disable_entry_sampler(self) -> None:
        self._sampler_cfg = None
        self._entry_sampler = None

    def _ensure_sampler(self):
        if self._sampler_cfg is None:
            return None, 1
        n_samples, n_entries, seed = self._sampler_cfg
        if self._entry_sampler is None:
            from .entry import auto_samples, build_sampler
            alive = np.nonzero(self.status == SLOT_VALID)[0]
            if n_samples is None:
                n_samples = auto_samples(alive.size)
            rng = np.random.default_rng(seed)
            size = min(n_samples, alive.size)
            ids = rng.choice(alive, size=size, replace=False) \
                if size else np.asarray([self.entry_point])
            self._entry_sampler = build_sampler(self.data, n_samples,
                                                ids=ids)
        return self._entry_sampler, n_entries

    def _invalidate_packed(self) -> None:
        self._packed = None
        self._entry_sampler = None

    # -- search -------------------------------------------------------------------
    def search(self, queries, k: int,
               parameters: Optional[VamanaSearchParameters] = None,
               cancel=None) -> QueryResult:
        """Batch search returning external ids; ``cancel``: an optional
        predicate checked between query-batch dispatches."""
        return self.search_async(queries, k, parameters=parameters,
                                 cancel=cancel).result()

    def search_async(self, queries, k: int,
                     parameters: Optional[VamanaSearchParameters] = None,
                     cancel=None) -> PendingSearch:
        """Dispatch a batch search (see ``VamanaIndex.search_async``); the
        slots are mapped to external ids at ``result()``.

        Deleted entries hold beam slots until consolidation, so the beam
        keeps at least 2k slots and k live results survive the drop of the
        deleted ones."""
        params = parameters or self._search_parameters
        cfg = params.buffer_config
        k_eff = min(k, self.data.n)
        window = max(cfg.search_window_size, 1)
        if cfg.capacity_defaulted and cfg.search_buffer_capacity < k_eff:
            window = k_eff
        capacity = max(cfg.search_buffer_capacity, window, 2 * k_eff)
        max_iters = params.resolved_max_iters()
        visited_size = (self.pop_width * max_iters
                        if params.visited_set else 0)

        queries = np.asarray(queries)
        if queries.ndim == 1:
            queries = queries[None, :]
        nq, dim = queries.shape
        if dim != self.data.dim:
            raise ValueError(f"query dim {dim} != dataset dim {self.data.dim}")
        plan = _BatchPlan.plan(nq, self.query_batch_size)
        device = self.data.device
        entry_ids = torch.tensor([self.entry_point], dtype=torch.int32,
                                 device=device)
        packed = self._ensure_packed()
        sampler, n_entries = self._ensure_sampler()
        translator = self.translator
        pending = PendingSearch(
            rows=plan.rows, nq=nq,
            out_ids=np.full((nq, k), -1, dtype=np.int64),
            out_vals=np.full((nq, k), np.inf, dtype=np.float32),
            translate_ids=lambda slots: np.where(
                slots >= 0, translator.to_external(slots), -1))
        for start, q_i, scale_i in upload_batches(
                queries, plan, self.data.padded_dim, device,
                self.query_upload_dtype, cancel):
            ids, vals = _dyn_search_batch(
                self.graph, self.data, packed, self.deleted_mask, sampler,
                q_i, scale_i, entry_ids,
                k=k_eff, window=window, capacity=capacity,
                max_iters=max_iters, distance=self.distance,
                pop_width=self.pop_width, tail_frac=self.tail_frac,
                visited_size=visited_size, n_entries=n_entries)
            pending.add(start, ids, vals)
        return pending.dispatched()

    # -- mutation ------------------------------------------------------------------
    def add_points(self, points, external_ids) -> np.ndarray:
        """Insert rows under new external ids; returns the slots used
        (empty slots below the high-water mark first, then new ones; the
        storage doubles in place when they do not fit)."""
        points = np.asarray(points, dtype=np.float32)
        external_ids = np.asarray(external_ids, dtype=np.int64)
        if points.shape[0] != external_ids.size:
            raise ValueError("points / external_ids length mismatch")
        m = points.shape[0]
        high = self._high_water
        empty = np.nonzero(self.status[:high] == SLOT_EMPTY)[0]
        reuse = empty[:m]
        n_new = m - reuse.size
        slots = np.concatenate([
            reuse, np.arange(high, high + n_new)]).astype(np.int64)

        if high + n_new > self.data.capacity:
            new_cap = dt.padded_count(max(2 * self.data.capacity,
                                          high + n_new))
            grow = new_cap - self.status.size
            self.data = self.data.with_capacity(new_cap)
            self.graph = self.graph.with_capacity(new_cap)
            self.deleted_mask = torch.cat([
                self.deleted_mask, self.deleted_mask.new_zeros(grow)])
            self.status = np.pad(self.status, (0, grow))

        self.translator.insert(external_ids, slots)
        slots_dev = self._slots(slots)
        self.data = self.data.scatter_rows(slots_dev, points,
                                           new_n=high + n_new)
        self.graph = dataclasses.replace(self.graph.clear_rows(slots_dev),
                                         n=self.data.n)
        self.status[slots] = SLOT_VALID
        self.deleted_mask = self.deleted_mask.index_fill(0, slots_dev, False)
        self._build_over(slots)
        self._invalidate_packed()
        return slots

    def delete_points(self, external_ids) -> None:
        """Soft delete (dynamic_index.h:747-760): the entries stop
        surfacing in results at once; the graph is cleaned up by
        :meth:`consolidate`.  The packed rows stay; the sample is drawn
        again on the next search."""
        slots = self.translator.remove(external_ids)
        self.status[slots] = SLOT_DELETED
        self.deleted_mask = self.deleted_mask.index_fill(
            0, self._slots(slots), True)
        self._entry_sampler = None
        if self.status[self.entry_point] != SLOT_VALID:
            self._reset_entry_point()

    def consolidate(self, batch_size: int = 1024) -> None:
        """Remove the deleted vertices from every adjacency list by
        re-pruning the affected vertices, then free their slots
        (consolidate.h:139-310).  Only the (capacity,) affected mask
        crosses to the host, never the (capacity, R) adjacency."""
        deleted = np.nonzero(self.status == SLOT_DELETED)[0]
        if deleted.size == 0:
            return
        device = self.data.device
        valid_mask = torch.from_numpy(self.status == SLOT_VALID).to(device)
        affected = np.nonzero(_affected_by_deleted(
            self.graph.adjacency, self.deleted_mask,
            valid_mask).cpu().numpy())[0]
        r = self.graph.max_degree
        pool_cap = min(r * (r + 1), 4 * r)   # nearest candidates pruned
        for start in range(0, affected.size, batch_size):
            chunk = affected[start: start + batch_size]
            ids = np.zeros(batch_size, dtype=np.int32)
            ids[: chunk.size] = chunk
            valid = np.zeros(batch_size, dtype=bool)
            valid[: chunk.size] = True
            self.graph = consolidate_round(
                self.graph, self.data, torch.from_numpy(ids).to(device),
                torch.from_numpy(valid).to(device), self.deleted_mask,
                prune_to=self.parameters.prune_to,
                alpha=float(self.parameters.alpha), distance=self.distance,
                max_degree=r, prune_chunk=128, pool_cap=pool_cap)
        deleted_dev = self._slots(deleted)
        self.graph = self.graph.clear_rows(deleted_dev)
        self.status[deleted] = SLOT_EMPTY
        self.deleted_mask = self.deleted_mask.index_fill(0, deleted_dev,
                                                         False)
        self._invalidate_packed()

    def compact(self) -> None:
        """Drop the empty slots and lower the high-water mark by a dense
        remap on the device (dynamic_index.h:791-884): only the (capacity,)
        permutation crosses from the host."""
        high = self._high_water
        alive = np.nonzero(self.status[:high] != SLOT_EMPTY)[0]
        if alive.size == high:
            return
        cap = self.data.capacity
        old_to_new = np.full(cap + 1, -1, dtype=np.int64)
        old_to_new[alive] = np.arange(alive.size)
        new_n = alive.size
        perm = np.zeros(cap, dtype=np.int32)
        perm[:new_n] = alive
        device = self.data.device
        adj, degs, vecs, norms = _compact_kernel(
            self.graph.adjacency, self.data.vectors, self.data.norms_sq,
            torch.from_numpy(perm).to(device),
            torch.from_numpy(old_to_new[:-1].astype(np.int32)).to(device),
            new_n)
        self.data = dataclasses.replace(self.data, vectors=vecs,
                                        norms_sq=norms, n=new_n)
        self.graph = dataclasses.replace(self.graph, adjacency=adj,
                                         degrees=degs, n=new_n)
        new_status = np.full(self.status.size, SLOT_EMPTY, dtype=np.int8)
        new_status[:new_n] = self.status[:high][alive]
        self.status = new_status
        self.deleted_mask = torch.from_numpy(
            new_status == SLOT_DELETED).to(device)
        self.translator.remap(old_to_new)
        self._invalidate_packed()
        self._reset_entry_point()

    def _reset_entry_point(self) -> None:
        """The medioid of the VALID rows: the other rows' norms are set to
        +inf, so none is chosen, though the mean still counts every row
        below the high-water mark (the JAX package's rule)."""
        alive = np.nonzero(self.status == SLOT_VALID)[0]
        if alive.size == 0:
            self.entry_point = 0
            return
        mask = torch.zeros(self.data.capacity, dtype=torch.bool,
                           device=self.data.device)
        mask[self._slots(alive)] = True
        masked = dataclasses.replace(self.data, norms_sq=torch.where(
            mask, self.data.norms_sq, float("inf")))
        from ...core.medioid import compute_medioid
        self.entry_point = compute_medioid(masked)
        if self.status[self.entry_point] != SLOT_VALID:
            self.entry_point = int(alive[0])

    # -- distance + persistence -----------------------------------------------------
    def get_distance(self, external_id: int, query) -> float:
        """Distance between one live entry and a query (reference
        dynamic_vamana.h:55), computed on the host."""
        slot = int(self.translator.to_internal([external_id])[0])
        vec = self.data.get_f32(self._slots([slot]))[0, : self.data.dim]
        vec = vec.cpu().numpy()
        q = np.asarray(query, dtype=np.float32).reshape(-1)
        if q.shape[0] != self.data.dim:
            raise ValueError(f"query dim {q.shape[0]} != {self.data.dim}")
        if self.distance == dist_ops.DistanceType.L2:
            return float(((q - vec) ** 2).sum())
        ip = float(q @ vec)
        if self.distance == dist_ops.DistanceType.MIP:
            return ip
        return ip / max(float(np.linalg.norm(q) * np.linalg.norm(vec)),
                        1e-30)

    def save(self, config_dir: str) -> None:
        """Rows, graph, slot status and external ids (the deleted slots
        included, so any state saves), build parameters and the sampler
        config; packed rows are not saved."""
        os.makedirs(config_dir, exist_ok=True)
        saveload.save_to_disk(self.data, os.path.join(config_dir, "data"))
        saveload.save_to_disk(self.graph, os.path.join(config_dir, "graph"))
        ctx = saveload.SaveContext(config_dir)
        high = self._high_water
        cfg = self._sampler_cfg
        table = saveload.save_table(self.SCHEMA, self.VERSION, {
            "distance": self.distance.value,
            "entry_point": int(self.entry_point),
            "status": ctx.save_array(self.status[:high]),
            "external_ids": ctx.save_array(
                self.translator.to_external(np.arange(high))),
            "build_parameters": dataclasses.asdict(self.parameters),
            "entry_sampler": None if cfg is None else {
                "n_samples": cfg[0], "n_entries": cfg[1], "seed": cfg[2]},
        })
        with open(os.path.join(config_dir, CONFIG_FILENAME), "w") as f:
            json.dump(table, f, indent=2)

    @classmethod
    def assemble(cls, config_dir: str, device="cuda",
                 **kwargs) -> "MutableVamanaIndex":
        """Load an index that either package saved onto ``device``; call
        ``enable_packed_serving()`` again, as packed rows are not saved.
        ``kwargs``: ``query_batch_size``, ``pop_width``, ``logger``."""
        from ...core.loading import dispatch_load
        with open(os.path.join(config_dir, CONFIG_FILENAME)) as f:
            table = json.load(f)
        saveload.check_table(table, cls.SCHEMA, cls.VERSION)
        ctx = saveload.LoadContext(config_dir)
        data = dispatch_load(os.path.join(config_dir, "data"), device=device)
        graph = saveload.load_from_disk(
            NeighborGraph, os.path.join(config_dir, "graph"), device=device)
        fields = {f.name for f in dataclasses.fields(VamanaBuildParameters)}
        params = VamanaBuildParameters(**{
            k: v for k, v in table["build_parameters"].items()
            if k in fields})
        obj = cls.from_state(data, graph, ctx.load_array(table["status"]),
                             ctx.load_array(table["external_ids"]),
                             table["entry_point"], table["distance"],
                             params, **kwargs)
        if table.get("entry_sampler"):
            obj.enable_entry_sampler(**table["entry_sampler"])
        return obj
