"""Static Vamana index.

PyTorch counterpart of ``scalablevectorsearch_tpu/index/vamana/index.py``:
owns the dataset, the neighbor graph, the entry point, the distance and the
search parameters; provides build, batch search (``search`` /
``search_async``) and vector reconstruction.  Queries are split into
equal-size lockstep batches; each batch is uploaded (f16 by default),
dequantized on the device, given sampled entry points when the sampler is
on, searched, reranked with both levels for two-level LVQ data, and its
keys converted to distances.  The dataset is a ``VectorDataset`` (f32,
bf16, float16, int8 or uint8 rows), an ``SQDataset`` or an ``LVQDataset``
(one- or two-level; packed serving packs its codes); ``search.py`` says
which route each takes.

Not part of this package yet: save/assemble and the stream archive, and
the host-side exact rerank.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from ...core.data import VectorDataset
from ...core.graph import NeighborGraph
from ...core.query_result import QueryResult
from ...lib import datatypes as dt
from ...lib import timing
from ...ops import distance as dist_ops
from ..ivf.index import rerank_kernel
from . import build as build_mod
from . import search as search_mod
from .params import VamanaBuildParameters, VamanaSearchParameters


@dataclasses.dataclass(frozen=True)
class _BatchPlan:
    """Equal-size lockstep batch partition of ``nq`` queries (no batch is
    mostly padding)."""

    rows: int       # padded rows per batch (multiple of 8)
    n_batches: int

    @classmethod
    def plan(cls, nq: int, max_rows: int) -> "_BatchPlan":
        nb = max(1, -(-nq // max(max_rows, 8)))
        rows = dt.pad_to(-(-nq // nb), 8)
        nb = max(1, -(-nq // rows))   # padding may shrink the batch count
        return cls(rows=rows, n_batches=nb)


@dataclasses.dataclass
class PendingSearch:
    """Batch search whose device work and device->host copies were started;
    ``result()`` waits for the copies and assembles the answer."""

    rows: int
    nq: int
    out_ids: np.ndarray
    out_vals: np.ndarray
    pending: list = dataclasses.field(default_factory=list)
    done: Optional[torch.cuda.Event] = None

    def add(self, start: int, ids: torch.Tensor, vals: torch.Tensor) -> None:
        """Queue one batch's (ids, values), starting their copy to pinned
        host memory when they live on the GPU."""
        if ids.is_cuda:
            ids = _to_pinned_async(ids)
            vals = _to_pinned_async(vals)
        self.pending.append((start, ids, vals))

    def dispatched(self) -> "PendingSearch":
        """Mark the end of dispatch: later ``result()`` waits for the
        copies queued so far."""
        if self.pending and self.pending[0][1].is_pinned():
            self.done = torch.cuda.Event()
            self.done.record()
        return self

    def result(self) -> QueryResult:
        if self.done is not None:
            self.done.synchronize()
        for start, ids_k, vals_k in self.pending:
            stop = min(start + self.rows, self.nq)
            slots = ids_k[: stop - start].numpy()
            vals = vals_k[: stop - start].numpy()
            # k may exceed the dispatch width (k > n clamps the beam; the
            # extra columns keep their -1 / +inf prefill)
            self.out_ids[start:stop, : slots.shape[1]] = slots
            self.out_vals[start:stop, : slots.shape[1]] = vals
        self.pending = []
        return QueryResult(ids=self.out_ids, distances=self.out_vals)


def _to_pinned_async(t: torch.Tensor) -> torch.Tensor:
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


_UPLOAD_DTYPES = {"float32": torch.float32, "float16": torch.float16,
                  "bfloat16": torch.bfloat16, "int8": torch.int8}


def query_upload_dtype() -> torch.dtype:
    """Host->device query transfer dtype: ``SVT_QUERY_UPLOAD_DTYPE``
    (float32 / float16 / bfloat16 / int8), float16 by default.  Queries are
    cast back to f32 on the device before scoring."""
    return _UPLOAD_DTYPES[os.environ.get("SVT_QUERY_UPLOAD_DTYPE", "float16")]


def upload_dtype_for(q_host: np.ndarray, override=None) -> torch.dtype:
    """Transfer dtype for this query set: ``override`` (a per-index
    ``query_upload_dtype`` name) or the env default — unless the values
    overflow float16's range, which falls back to float32."""
    dtype = _UPLOAD_DTYPES[override] if override else query_upload_dtype()
    if dtype == torch.float16 and q_host.size and \
            np.max(np.abs(q_host)) > np.finfo(np.float16).max:
        return torch.float32
    return dtype


def prepare_query_upload(q_host: np.ndarray, override=None):
    """Quantize/cast a padded f32 host query block for the upload.

    Returns ``(q_upload, q_scale)`` as CPU tensors.  ``q_scale`` is ``None``
    for float dtypes; for int8 it is a per-query (n, 1) f32 max-abs/127
    scale (a zero scale becomes 1.0), computed on the host as in the JAX
    package, and applied on the device by :func:`dequantize_queries`."""
    dtype = upload_dtype_for(q_host, override)
    if dtype == torch.int8:
        scale = np.max(np.abs(q_host), axis=1, keepdims=True) / 127.0
        scale[scale == 0.0] = 1.0
        q = np.rint(q_host / scale).astype(np.int8)
        return torch.from_numpy(q), torch.from_numpy(scale.astype(np.float32))
    return torch.from_numpy(q_host).to(dtype), None


def dequantize_queries(q: torch.Tensor, q_scale: Optional[torch.Tensor]
                       ) -> torch.Tensor:
    """Device-side inverse of :func:`prepare_query_upload`."""
    q = q.float()
    return q if q_scale is None else q * q_scale


def _search_batch(graph, data, packed, rerank_view, sampler, q, q_scale,
                  entry_ids, *, k: int, window: int, capacity: int,
                  max_iters: int, distance, tail_frac: int,
                  visited_size: int, two_level: bool, n_entries: int = 1,
                  pop_width: int = search_mod.SERVING_POP_WIDTH):
    """One serving dispatch: dequantize, (optional) per-query entry
    selection, beam search, (optional) two-level rerank, key->distance
    conversion."""
    q = dequantize_queries(q, q_scale)
    if sampler is not None:
        entry_ids = sampler.select(distance, q, n_entries=n_entries)
    out = search_mod.greedy_search(
        graph, data, q, entry_ids,
        window=window, capacity=capacity, max_iters=max_iters,
        distance=distance, packed=packed, tail_frac=tail_frac,
        visited_size=visited_size, pop_width=pop_width)
    ids, keys = out.ids, out.keys
    if two_level:
        # traversal keys come from the primary level; rerank the retained
        # beam with the residual-corrected reconstruction
        keys, ids = rerank_kernel(rerank_view, q, None, ids, k=k,
                                  distance=distance)
    return ids[:, :k], dist_ops.value_from_key(distance, keys[:, :k])


class VamanaIndex:
    """Static (non-mutable) Vamana graph index."""

    # per-index query transfer dtype override
    # ("float32"/"float16"/"bfloat16"/"int8"); None defers to the
    # SVT_QUERY_UPLOAD_DTYPE env default
    query_upload_dtype = None

    def __init__(self,
                 graph: NeighborGraph,
                 data,
                 entry_point: int,
                 distance,
                 build_parameters: Optional[VamanaBuildParameters] = None,
                 search_parameters: Optional[VamanaSearchParameters] = None,
                 query_batch_size: int = 2048,
                 logger=None):
        self.graph = graph
        self.data = data
        self.entry_point = int(entry_point)
        self.distance = dist_ops.as_distance(distance)
        self.build_parameters = build_parameters
        self._search_parameters = (search_parameters or
                                   VamanaSearchParameters())
        self.query_batch_size = query_batch_size
        self.logger = logger
        self._packed = None          # packed neighborhoods
        self._entry_sampler = None   # per-query entries
        self._entry_n = 1
        # lockstep tail compaction: finish each batch's stragglers on a
        # 1/4-size compacted slice
        self.tail_frac = 4
        self.pop_width = search_mod.SERVING_POP_WIDTH

    # -- construction ---------------------------------------------------------
    @classmethod
    def build(cls,
              parameters: VamanaBuildParameters,
              data,
              distance,
              *,
              dtype=None,
              batch_size: Optional[int] = None,
              pop_width: int = 4,
              build_tail_frac: int = 4,
              first_pass_window: Optional[int] = None,
              sampled_entries: bool = False,
              entry_sample_size: Optional[int] = None,
              timer: Optional[timing.Timer] = None,
              logger=None,
              device="cuda",
              **kwargs) -> "VamanaIndex":
        """Build from an (n, d) array (stored as ``dtype``: f32, bf16,
        float16, int8 or uint8) or a dataset-protocol object
        (``VectorDataset``, ``SQDataset``, ``LVQDataset``; a dataset keeps
        its own device).  Compressed datasets build on their decoded rows;
        two-level LVQ builds over its full reconstruction (``full_view()``);
        serving traverses the primary level."""
        if not hasattr(data, "norms_sq"):   # raw array
            data = VectorDataset.from_array(data, dtype=dtype, device=device)
        distance = dist_ops.as_distance(distance)
        parameters = parameters.resolved(distance)
        build_data = data.full_view() \
            if getattr(data, "residual_bits", 0) else data
        graph, entry = build_mod.build_graph(
            build_data, parameters, distance, batch_size=batch_size,
            pop_width=pop_width, tail_frac=build_tail_frac,
            first_pass_window=first_pass_window,
            sampled_entries=sampled_entries,
            entry_sample_size=entry_sample_size,
            timer=timer, logger=logger)
        index = cls(graph, data, entry, distance,
                    build_parameters=parameters, logger=logger, **kwargs)
        if sampled_entries:
            # a sampled-entries graph keeps no medioid approach path: it is
            # only navigable with per-query sampled entries
            index.enable_entry_sampler(n_samples=entry_sample_size)
        return index

    # -- properties -------------------------------------------------------------
    @property
    def size(self) -> int:
        return self.data.n

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

    # -- packed-neighborhood serving ---------------------------------------------
    def enable_packed_serving(self, dtype=torch.bfloat16,
                              chunk: int = 65536) -> None:
        """Materialize inline neighbor vectors
        (``packed.pack_neighborhoods``): R-fold fewer row gathers per search
        iteration at ``capacity * R * d * itemsize`` bytes of device
        memory.  Over float16 / int8 / SQ data the packed rows are bf16
        (decoded for SQ) and the final beam is re-scored against the
        dataset's rows.  LVQ datasets pack their neighbors' codes instead
        (``packed.pack_neighborhoods_lvq``, ``dtype`` unused): exact
        decoding, so results equal unpacked LVQ serving."""
        from ...quantization.lvq import LVQDataset
        from .packed import pack_neighborhoods, pack_neighborhoods_lvq
        if isinstance(self.data, LVQDataset):
            self._packed = pack_neighborhoods_lvq(self.graph, self.data,
                                                  chunk=chunk)
            return
        if getattr(self.data, "residual_bits", 0) or \
                not hasattr(self.data, "vectors"):
            raise ValueError("packed serving requires a VectorDataset, an "
                             "SQDataset or an LVQDataset")
        self._packed = pack_neighborhoods(self.graph, self.data, dtype,
                                          chunk=chunk)

    def disable_packed_serving(self) -> None:
        self._packed = None

    # -- per-query entry selection -------------------------------------------------
    def enable_entry_sampler(self, n_samples: Optional[int] = None,
                             n_entries: int = 1, seed: int = 0) -> None:
        """Select each query's entry point from a resident dataset sample
        (entry.py); ``n_samples=None`` scales with the dataset size.
        Deterministic given ``seed``."""
        from .entry import auto_samples, build_sampler
        if n_samples is None:
            n_samples = auto_samples(self.data.n)
        self._entry_sampler = build_sampler(self.data, n_samples, seed=seed)
        self._entry_n = n_entries

    def disable_entry_sampler(self) -> None:
        self._entry_sampler = None
        self._entry_n = 1

    # -- search -------------------------------------------------------------------
    def search(self, queries, k: int,
               parameters: Optional[VamanaSearchParameters] = None,
               cancel=None) -> QueryResult:
        """Batch greedy search (reference index.h:556-603).  ``cancel``: an
        optional predicate checked between query-batch dispatches."""
        return self.search_async(queries, k, parameters=parameters,
                                 cancel=cancel).result()

    def search_async(self, queries, k: int,
                     parameters: Optional[VamanaSearchParameters] = None,
                     cancel=None) -> PendingSearch:
        """Dispatch a batch search and return a :class:`PendingSearch`.

        Window and capacity follow the JAX package: the window may sit below
        k when the capacity was set explicitly; single-argument configs keep
        the k floor on both.  k may exceed the dataset: the beam holds at
        most n rows, and the extra result columns stay -1 / +inf."""
        from ...lib.exceptions import check_cancel
        params = parameters or self._search_parameters
        cfg = params.buffer_config
        k_eff = min(k, self.size)
        window = max(cfg.search_window_size, 1)
        if cfg.capacity_defaulted and cfg.search_buffer_capacity < k_eff:
            window = k_eff
        capacity = max(cfg.search_buffer_capacity, window, k_eff)
        # two-level data traverses the primary level and reranks the
        # retained beam with both levels; defaulted configs retain 2x the
        # window so the rerank has candidates (explicit splits are honored)
        two_level = bool(getattr(self.data, "residual_bits", 0))
        if two_level and cfg.capacity_defaulted:
            capacity = max(capacity, 2 * window)
        rerank_view = self.data.full_view() if two_level else None
        max_iters = params.resolved_max_iters()
        # exact visited filter: a ring of pop_width * max_iters ids holds
        # every expansion the bounded loop can make
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
        q_host = dt.pad_matrix(queries.astype(np.float32),
                               n_pad=plan.rows * plan.n_batches,
                               d_pad=self.data.padded_dim)
        q_host, q_scale_host = prepare_query_upload(
            q_host, self.query_upload_dtype)
        if device.type == "cuda":
            q_host = q_host.pin_memory()
            q_scale_host = None if q_scale_host is None else \
                q_scale_host.pin_memory()
        pending = PendingSearch(
            rows=plan.rows, nq=nq,
            out_ids=np.full((nq, k), -1, dtype=np.int64),
            out_vals=np.full((nq, k), np.inf, dtype=np.float32))
        for i in range(plan.n_batches):
            check_cancel(cancel)
            rows = slice(i * plan.rows, (i + 1) * plan.rows)
            q_i = q_host[rows].to(device, non_blocking=True)
            scale_i = None if q_scale_host is None else \
                q_scale_host[rows].to(device, non_blocking=True)
            ids_k, vals_k = _search_batch(
                self.graph, self.data, self._packed, rerank_view,
                self._entry_sampler, q_i, scale_i, entry_ids,
                k=k_eff, window=window, capacity=capacity,
                max_iters=max_iters, distance=self.distance,
                tail_frac=self.tail_frac, visited_size=visited_size,
                two_level=two_level, n_entries=self._entry_n,
                pop_width=self.pop_width)
            pending.add(i * plan.rows, ids_k, vals_k)
        return pending.dispatched()

    # -- reconstruction -----------------------------------------------------------
    def reconstruct_at(self, ids) -> np.ndarray:
        """Return the (decoded: SQ, primary-level for LVQ) vectors for the
        given internal ids through the dataset's ``get_f32`` (reference
        index.h:630-671)."""
        ids = np.asarray(ids, dtype=np.int64)
        if np.any((ids < 0) | (ids >= self.size)):
            raise IndexError("reconstruct_at: id out of bounds")
        flat = torch.from_numpy(ids.reshape(-1)).to(self.data.device)
        vecs = self.data.get_f32(flat)[:, : self.data.dim].cpu().numpy()
        return vecs.reshape(*ids.shape, self.data.dim)
