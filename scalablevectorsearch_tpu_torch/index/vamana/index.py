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

Checkpoints are the JAX package's: ``save`` writes the 3-directory layout
(``vamana_config.json`` + ``graph/`` + ``data/``, each an ``svs_config.json``
table with UUID-named ``.npy`` blobs), ``assemble`` reads one written by
either package (the sampled-entries config included), and
``save_stream`` / ``assemble_stream`` carry the same tree as one archive
stream.  ``enable_host_rerank`` re-scores each query's fetched beam
exactly on the host with the full-precision query, for int8 uploads.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Optional

import numpy as np
import torch

from ...core.data import VectorDataset
from ...core.graph import NeighborGraph
from ...core.query_result import QueryResult
from ...lib import datatypes as dt
from ...lib import saveload
from ...lib import timing
from ...ops import distance as dist_ops
from ..ivf.index import rerank_kernel
from . import build as build_mod
from . import search as search_mod
from .params import VamanaBuildParameters, VamanaSearchParameters

CONFIG_FILENAME = "vamana_config.json"


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


def _value_from_key_host(distance, keys: np.ndarray) -> np.ndarray:
    """``dist_ops.value_from_key`` on a host array: L2 keys are distances,
    MIP and cosine keys negated similarities."""
    return keys if distance == dist_ops.DistanceType.L2 else -keys


def _host_rerank_batch(ids: np.ndarray, q: np.ndarray,
                       vectors: np.ndarray, norms_sq: np.ndarray,
                       distance, k: int):
    """Exact re-scoring of a returned beam on the host, where the
    full-precision query lives: the JAX package's numpy code (norm algebra,
    one gather and one batched row-matvec), so both packages rank alike.
    ``ids`` (b, k') with -1 for empty slots; returns the k best (ids,
    distances)."""
    safe = np.maximum(ids, 0)
    vecs = vectors[safe]                          # (b, k', d)
    dots = np.einsum("bkd,bd->bk", vecs, q, optimize=True)
    if distance == dist_ops.DistanceType.MIP:
        keys = -dots
    else:
        xn = norms_sq[safe]
        qn = np.sum(q * q, axis=-1, dtype=np.float64).astype(np.float32)
        if distance == dist_ops.DistanceType.L2:
            keys = np.maximum(qn[:, None] - 2.0 * dots + xn, 0.0)
        else:                                     # cosine
            denom = np.sqrt(np.maximum(qn[:, None], 1e-30)) * \
                np.sqrt(np.maximum(xn, 1e-30))
            keys = -dots / denom
    keys = np.where(ids < 0, np.inf, keys.astype(np.float32))
    order = np.argsort(keys, axis=1, kind="stable")[:, :k]
    ids_k = np.take_along_axis(ids, order, axis=1)
    keys_k = np.take_along_axis(keys, order, axis=1)
    return ids_k, _value_from_key_host(distance, keys_k)


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
    # (vectors, norms_sq, queries_f32, distance, k): the exact host-side
    # re-scoring of each fetched beam (enable_host_rerank)
    host_rerank: Optional[tuple] = None
    # host map of result slots to external ids (the dynamic indexes)
    translate_ids: Optional[Callable[[np.ndarray], np.ndarray]] = None

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
            if self.host_rerank is not None:
                vectors, norms_sq, queries, distance, k = self.host_rerank
                slots, vals = _host_rerank_batch(
                    slots, queries[start:stop], vectors, norms_sq,
                    distance, k)
            if self.translate_ids is not None:
                slots = self.translate_ids(slots)
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


def saveload_pack_tree(directory: str, stream) -> None:
    """Pack a checkpoint tree (config + graph/ + data/) into one archive
    stream: an 8-byte little-endian header length, a JSON header naming the
    files in sorted relative-path order with their sizes, then their bytes
    (the JAX package's ``svs_tpu_tree`` format, byte for byte)."""
    entries = {}
    for root, _dirs, files in os.walk(directory):
        for name in files:
            path = os.path.join(root, name)
            with open(path, "rb") as f:
                entries[os.path.relpath(path, directory)] = f.read()
    header = json.dumps({"archive": "svs_tpu_tree", "version": "v0.0.1",
                         "files": [{"name": k, "size": len(v)}
                                   for k, v in sorted(entries.items())]}
                        ).encode()
    stream.write(len(header).to_bytes(8, "little"))
    stream.write(header)
    for k in sorted(entries):
        stream.write(entries[k])


def saveload_unpack_tree(stream, directory: str) -> None:
    """Unpack a stream written by :func:`saveload_pack_tree`."""
    header_len = int.from_bytes(stream.read(8), "little")
    header = json.loads(stream.read(header_len))
    if header.get("archive") != "svs_tpu_tree":
        raise ValueError("not an svs_tpu tree archive")
    for entry in header["files"]:
        path = os.path.join(directory, entry["name"])
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(stream.read(entry["size"]))


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


def upload_batches(queries: np.ndarray, plan: _BatchPlan, padded_dim: int,
                   device: torch.device, override=None, cancel=None):
    """Yield ``(start, q_i, scale_i)`` for each lockstep batch of ``plan``.

    The (nq, dim) host queries are padded and cast or quantized for the
    upload once (:func:`prepare_query_upload`, pinned when ``device`` is a
    GPU); each batch is then copied to ``device`` asynchronously, so its
    transfer overlaps the previous batch's search.  ``cancel`` is checked
    before each batch."""
    from ...lib.exceptions import check_cancel
    q_host = dt.pad_matrix(queries.astype(np.float32),
                           n_pad=plan.rows * plan.n_batches, d_pad=padded_dim)
    q_host, q_scale_host = prepare_query_upload(q_host, override)
    if device.type == "cuda":
        q_host = q_host.pin_memory()
        q_scale_host = None if q_scale_host is None else \
            q_scale_host.pin_memory()
    for i in range(plan.n_batches):
        check_cancel(cancel)
        rows = slice(i * plan.rows, (i + 1) * plan.rows)
        yield (i * plan.rows, q_host[rows].to(device, non_blocking=True),
               None if q_scale_host is None else
               q_scale_host[rows].to(device, non_blocking=True))


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

    SCHEMA = "vamana_index_parameters"
    VERSION = saveload.Version(0, 0, 2)  # 0.0.2: optional entry_sampler
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
        self._entry_cfg = None       # sampler config that save persists
        self._host_rerank = None     # (vectors, norms_sq): host rerank
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
        self._entry_cfg = {"n_samples": n_samples, "n_entries": n_entries,
                           "seed": seed}

    def disable_entry_sampler(self) -> None:
        self._entry_sampler = None
        self._entry_n = 1
        self._entry_cfg = None

    # -- host-side exact rerank ----------------------------------------------------
    def enable_host_rerank(self, host_vectors) -> None:
        """Re-score each query's returned beam on the host with the
        full-precision query at ``result()`` time.

        Pairs with int8 query uploads (``query_upload_dtype = "int8"``):
        the device traverses with the quantized query, and the final
        ranking, where most of the int8 recall loss lies, is recovered
        exactly on the host.  The search then fetches the whole retained
        beam instead of k.  ``host_vectors`` is the (n, dim) host array the
        index was built from (an ``np.load(..., mmap_mode="r")`` view of the
        saved rows works); more columns than ``dim`` are cut off, fewer
        raise."""
        host_vectors = np.asarray(host_vectors)
        if host_vectors.ndim != 2 or host_vectors.shape[0] != self.size \
                or host_vectors.shape[1] < self.data.dim:
            raise ValueError(
                f"host_vectors of shape {host_vectors.shape} do not hold "
                f"{self.size} rows of {self.data.dim} columns")
        if host_vectors.dtype != np.float32:
            host_vectors = host_vectors.astype(np.float32)
        host_vectors = host_vectors[:, : self.data.dim]
        norms = np.einsum("nd,nd->n", host_vectors, host_vectors,
                          optimize=True)
        self._host_rerank = (host_vectors, norms.astype(np.float32))

    def disable_host_rerank(self) -> None:
        self._host_rerank = None

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
        # the host rerank fetches the whole retained beam, so that the exact
        # re-scoring has a real candidate pool
        hr = self._host_rerank
        k_fetch = min(capacity, self.size) if hr is not None else k_eff
        pending = PendingSearch(
            rows=plan.rows, nq=nq,
            out_ids=np.full((nq, k), -1, dtype=np.int64),
            out_vals=np.full((nq, k), np.inf, dtype=np.float32),
            host_rerank=None if hr is None else
            (hr[0], hr[1], queries.astype(np.float32), self.distance, k_eff))
        for start, q_i, scale_i in upload_batches(
                queries, plan, self.data.padded_dim, device,
                self.query_upload_dtype, cancel):
            ids_k, vals_k = _search_batch(
                self.graph, self.data, self._packed, rerank_view,
                self._entry_sampler, q_i, scale_i, entry_ids,
                k=k_fetch, window=window, capacity=capacity,
                max_iters=max_iters, distance=self.distance,
                tail_frac=self.tail_frac, visited_size=visited_size,
                two_level=two_level, n_entries=self._entry_n,
                pop_width=self.pop_width)
            pending.add(start, ids_k, vals_k)
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

    # -- persistence -----------------------------------------------------------------
    def save(self, config_dir: str, graph_dir: Optional[str] = None,
             data_dir: Optional[str] = None) -> None:
        """3-directory layout: config / graph / data are loadable on their
        own (reference index.h:795-817).  Rows and adjacency are read back
        from the device; packed neighbourhoods are not saved."""
        graph_dir = graph_dir or os.path.join(config_dir, "graph")
        data_dir = data_dir or os.path.join(config_dir, "data")
        os.makedirs(config_dir, exist_ok=True)
        saveload.save_to_disk(self.graph, graph_dir)
        saveload.save_to_disk(self.data, data_dir)
        self._save_config(config_dir)

    def save_host(self, config_dir: str, host_vectors) -> None:
        """:meth:`save` with the dataset written from the caller's host rows
        (the build input) as f32, in the same format; only the adjacency
        is read back from the device."""
        from ...core.data import save_vectors_host
        from ...core.graph import save_adjacency_host
        from ...lib.transfer import to_host_chunked
        os.makedirs(config_dir, exist_ok=True)
        host_vectors = np.asarray(host_vectors, np.float32)
        if host_vectors.shape[0] != self.size:
            raise ValueError(
                f"host_vectors rows {host_vectors.shape[0]} != index size "
                f"{self.size}")
        adjacency = to_host_chunked(self.graph.adjacency)[: self.graph.n]
        save_adjacency_host(os.path.join(config_dir, "graph"), adjacency)
        save_vectors_host(os.path.join(config_dir, "data"), host_vectors)
        self._save_config(config_dir)

    def _save_config(self, config_dir: str) -> None:
        build_table = (self.build_parameters.save_table()
                       if self.build_parameters else None)
        table = saveload.save_table(self.SCHEMA, self.VERSION, {
            "name": "vamana index parameters",
            "entry_point": self.entry_point,
            "distance": self.distance.value,
            "build_parameters": build_table,
            "search_parameters": self._search_parameters.save_table(),
            # a graph built with sampled entries is only navigable with
            # the sampler on, so its config survives the reload
            "entry_sampler": self._entry_cfg,
        })
        with open(os.path.join(config_dir, CONFIG_FILENAME), "w") as f:
            json.dump(table, f, indent=2)

    def save_stream(self, stream) -> None:
        """:meth:`save` into a temporary directory, packed into ``stream``
        by :func:`saveload_pack_tree` (reference vamana.h:457-535)."""
        import tempfile
        with tempfile.TemporaryDirectory() as tmp:
            self.save(tmp)
            saveload_pack_tree(tmp, stream)

    @classmethod
    def assemble_stream(cls, stream, **kwargs) -> "VamanaIndex":
        import tempfile
        with tempfile.TemporaryDirectory() as tmp:
            saveload_unpack_tree(stream, tmp)
            return cls.assemble(tmp, **kwargs)

    @classmethod
    def assemble(cls, config_dir: str, graph_dir: Optional[str] = None,
                 data_dir: Optional[str] = None, dtype=None, device="cuda",
                 **kwargs) -> "VamanaIndex":
        """Load an index that either package saved onto ``device``: graph,
        dataset (any registered kind; ``dtype`` converts a
        ``VectorDataset``), parameters and the sampled-entries config.
        Every tensor is built on the host and copied once; call
        ``enable_packed_serving()`` again, as packed rows are not saved."""
        from ...core.loading import dispatch_load
        graph_dir = graph_dir or os.path.join(config_dir, "graph")
        data_dir = data_dir or os.path.join(config_dir, "data")
        with open(os.path.join(config_dir, CONFIG_FILENAME)) as f:
            table = json.load(f)
        saveload.check_table(table, cls.SCHEMA, cls.VERSION)
        graph = saveload.load_from_disk(NeighborGraph, graph_dir,
                                        device=device)
        data = dispatch_load(data_dir, device=device,
                             **({"dtype": dtype} if dtype else {}))
        build_params = (VamanaBuildParameters.from_table(
            table["build_parameters"]) if table.get("build_parameters")
            else None)
        search_params = VamanaSearchParameters.from_table(
            table["search_parameters"])
        index = cls(graph, data, table["entry_point"], table["distance"],
                    build_parameters=build_params,
                    search_parameters=search_params, **kwargs)
        sampler_cfg = table.get("entry_sampler")
        if sampler_cfg:
            index.enable_entry_sampler(**sampler_cfg)
        return index
