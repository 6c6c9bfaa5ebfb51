"""Static IVF index.

PyTorch counterpart of ``scalablevectorsearch_tpu/index/ivf/index.py`` (the
reference's ``IVFIndex``, ``include/svs/index/ivf/index.h:111``).  A search
has the JAX package's three phases:

  phase 1: one (B, K) distance matmul to the centroids + top-n_probes
           (the reference's ``search_centroids``, common.h:854-890);
  phase 2: a loop over (probe, chunk) steps where each step gathers one
           posting-list chunk per query and folds it into a running
           top-(k_reorder * k) (``search_leaves``, common.h:897-925);
  phase 3: optional full-precision re-scoring of the survivors
           (:func:`rerank_kernel`, the k_reorder knob) and the final top-k.

Posting lists are stored as uniform padded clusters inside one reordered
dataset (probe unit u owns rows [u*slot, (u+1)*slot)), the dense analog of
the reference's ``DenseClusteredDataset`` (ivf/clustering.h:314).

The JAX ``fori_loop`` of the scan is a Python loop over the steps; every
step is device work (a row gather, a batched contraction, a stable-sort
merge) and nothing is read back to the host until the result.  The
posting scan is PyTorch code, as it is XLA code in the JAX package: no
Pallas kernel is on this path.  The super-row scan layout of a dense
floating dataset is a view of its rows, reshaped (total, d) -> (total/sub,
sub*d), so it costs no memory here (on a TPU it is a re-layout, a second
copy of the dataset).  ``SVT_IVF_SCAN_LAYOUT=0`` selects the row-gather
route and ``SVT_IVF_TILES_PER_STEP`` the chunk size, as in the JAX package.

Checkpoints are the JAX package's (``ivf_config.json`` + ``data/``), so a
checkpoint either package saves loads in the other.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np
import torch

from ...core.data import VectorDataset, save_vectors_host
from ...core.query_result import QueryResult
from ...lib import datatypes as dt
from ...lib import saveload
from ...ops import distance as dist_ops
from ...ops import topk as topk_ops
from .clustering import Clustering, pack_padded_clusters
from .params import IVFBuildParameters, IVFSearchParameters

CONFIG_FILENAME = "ivf_config.json"


def _pick_subtile(slot: int, scan_subtile: int) -> int:
    """Largest divisor of ``slot`` <= ``scan_subtile``: the scan covers
    slot/sub sub-tiles per probe."""
    sub = min(scan_subtile, slot)
    while slot % sub != 0:
        sub -= 1
    return sub


def _resolve_tiles_per_step(requested: int, n_sub: int,
                            use_scan: bool = False) -> int:
    """The per-step chunk size in sub-tiles (0 = auto): the whole probed
    cluster per step on the super-row scan layout, one sub-tile on the
    row-gather route (whose per-step (B, g*sub, d) gather would otherwise
    grow with the slot)."""
    if requested <= 0:
        return n_sub if use_scan else 1
    return min(requested, n_sub)


def _pack_layout_host(clustering, x: np.ndarray, max_posting_factor=None):
    """Pack the padded posting layout on the host.

    Returns ``(centroids, rows, ids_padded, slot, n, n_clusters)`` as numpy
    arrays (``centroids`` already expanded to one row per probe unit when
    oversized clusters were chunked).  See
    :meth:`IVFIndex.assemble_from_clustering` for the slot-cap policy."""
    x = np.asarray(x, dtype=np.float32)
    n = x.shape[0]
    k = clustering.num_centroids
    mean_slot = -(-n // max(k, 1))
    factor = max_posting_factor
    if factor is None:   # auto: only rescue pathological skew at scale
        sizes = np.bincount(np.asarray(clustering.assignments), minlength=k)
        uncapped_total = k * int(dt.pad_to(max(int(sizes.max()), 1), 8))
        # small layouts stay identical to one-unit-per-cluster packing
        factor = 2.0 if (uncapped_total > 4 * n
                         and uncapped_total > 5_000_000) else 0.0
    slot_cap = int(factor * mean_slot) if factor else 0
    rows, ids_padded, slot, owners = pack_padded_clusters(
        x, clustering.assignments, k, slot_cap=slot_cap)
    centroids = np.asarray(clustering.centroids, dtype=np.float32)
    if owners.shape[0] != k:         # chunked: one probe unit per chunk
        centroids = centroids[owners]
    return centroids, rows, np.asarray(ids_padded), slot, n, k


def save_packed_layout_host(config_dir: str, clustering, data, distance,
                            eltype="bfloat16", max_posting_factor=None,
                            search_parameters=None,
                            build_parameters=None) -> None:
    """Pack and write an :class:`IVFIndex` checkpoint from host rows, with
    no dataset on the device: the format of :meth:`IVFIndex.save` with a
    dense ``eltype``-typed reordered dataset."""
    centroids, rows, ids_padded, slot, n, k = _pack_layout_host(
        clustering, data, max_posting_factor=max_posting_factor)
    save_vectors_host(os.path.join(config_dir, "data"), rows, eltype=eltype)
    ctx = saveload.SaveContext(config_dir)
    sp = search_parameters or IVFSearchParameters()
    table = saveload.save_table(IVFIndex.SCHEMA, IVFIndex.VERSION, {
        "distance": dist_ops.as_distance(distance).value,
        "slot": int(slot),
        "num_points": int(n),
        "n_clusters": int(k),
        "centroids": ctx.save_array(centroids),
        "ids_padded": ctx.save_array(np.asarray(ids_padded, np.int32)),
        "search_parameters": sp.save_table(),
        "build_parameters": (build_parameters.save_table()
                             if build_parameters else None),
    })
    with open(os.path.join(config_dir, CONFIG_FILENAME), "w") as f:
        json.dump(table, f, indent=2)


def _poison_padding(data, ids_padded):
    """+inf the norms of the layout's padding rows so they never win.

    ``ids_padded`` (host) has one entry per packed row (``total``), but the
    dataset's capacity may be padded beyond that (bf16 rows pad to 16-row
    tiles): the mask is widened to the capacity with False, since rows past
    the layout are padding by definition."""
    alive = np.asarray(ids_padded) >= 0
    mask = np.zeros(data.norms_sq.shape[0], dtype=bool)
    mask[: alive.shape[0]] = alive
    mask = torch.from_numpy(mask).to(data.norms_sq.device)
    return dataclasses.replace(
        data, norms_sq=torch.where(mask, data.norms_sq, float("inf")))


def ensure_scan_layout(index, sub: int) -> bool:
    """Set the super-row scan layout on any padded-posting index
    (``data`` / ``ids_padded`` / ``slot`` and the ``_scan_*`` fields): the
    (total/sub, sub*d_pad) view of a dense floating dataset's rows and the
    (total/sub, sub) view of ``ids_padded``.  ``.view`` raises rather than
    copy, so the layout never holds a second dataset.  Returns False (the
    row-gather route) under ``SVT_IVF_SCAN_LAYOUT=0``, for compressed
    datasets, and where ``sub`` does not divide the slot."""
    if os.environ.get("SVT_IVF_SCAN_LAYOUT", "1") == "0":
        return False
    if index._scan_sub == sub and index._scan_vecs is not None:
        return True
    total = index.ids_padded.shape[0]
    dense = getattr(index.data, "vectors", None)
    if (dense is None or dense.ndim != 2
            or not dense.dtype.is_floating_point
            or dense.shape[0] < total or index.slot % sub != 0):
        return False
    d_pad = dense.shape[1]
    index._scan_vecs = dense[:total].view(total // sub, sub * d_pad)
    index._scan_ids = index.ids_padded.view(total // sub, sub)
    index._scan_sub = sub
    return True


def scan_padded_clusters(data, ids_padded: torch.Tensor,
                         queries: torch.Tensor, q_norms: torch.Tensor,
                         probes: torch.Tensor, probe_valid: torch.Tensor, *,
                         keep: int, slot: int, sub: int,
                         distance: dist_ops.DistanceType,
                         dedup: bool = False, scan_vecs=None, scan_ids=None,
                         tiles_per_step: int = 1):
    """Posting-list scan over uniform padded clusters (search_leaves analog,
    common.h:897-925): a loop over (probe, chunk) steps, each gathering
    one chunk of g*sub rows per query and folding it into a running
    top-``keep``.  Returns (keys (B, keep), ids (B, keep)).

    ``probes`` (B, P) probe-unit ids per query; ``probe_valid`` (B, P)
    masks probes (the inverted index's epsilon cutoff).

    ``dedup``: mask candidates already in the running buffer before each
    merge.  Required when posting lists replicate points across clusters
    (the inverted index's closure assignment): a replicated id would
    otherwise merge once per probed copy and crowd distinct ids out.

    Super-row route (``scan_vecs`` / ``scan_ids`` given): each step gathers
    g contiguous rows of ``sub * d`` values per query and recomputes their
    norms from the gathered rows.  Row-gather route: g*sub rows through
    ``data.get`` (which decodes compressed rows) with their cached norms.

    ``tiles_per_step`` (g): consecutive sub-tiles of the same probed
    cluster folded per step; chunks never span probes, so a replicated id
    appears at most once per chunk and the mask against the running buffer
    suffices."""
    b = queries.shape[0]
    n_probes = probes.shape[1]
    n_sub = slot // sub
    g = max(1, min(int(tiles_per_step), n_sub))
    while n_sub % g != 0:
        g -= 1
    chunks = n_sub // g
    device = queries.device
    inf = float("inf")
    best_keys = torch.full((b, keep), inf, device=device)
    best_ids = torch.full((b, keep), -1, dtype=torch.int32, device=device)
    use_super = scan_vecs is not None
    if use_super:
        d_pad = scan_vecs.shape[1] // sub
        iota = torch.arange(g, device=device)
        last = scan_vecs.shape[0] - 1
    else:
        iota = torch.arange(g * sub, device=device)
        last = ids_padded.shape[0] - 1
    for step in range(n_probes * chunks):
        p, c = divmod(step, chunks)
        cluster = probes[:, p]
        ok = probe_valid[:, p] & (cluster >= 0)
        if use_super:
            srow = ((cluster.clamp_min(0) * n_sub)[:, None] + c * g
                    + iota[None, :]).clamp_max(last)            # (B, g)
            orig_ids = scan_ids[srow].reshape(b, g * sub)
            vecs = scan_vecs[srow].reshape(b, g * sub, d_pad)
            keys = dist_ops.gathered_keys(distance, queries, vecs,
                                          query_norms_sq=q_norms)
        else:
            rows = (cluster.clamp_min(0) * slot + c * (g * sub))[:, None] \
                + iota[None, :]                                 # (B, g*sub)
            orig_ids = ids_padded[rows.clamp_max(last)]
            keys = dist_ops.gathered_keys(
                distance, queries, data.get(rows),
                gathered_norms_sq=data.norms_of(rows),
                query_norms_sq=q_norms)
        keys = torch.where((orig_ids >= 0) & ok[:, None], keys, inf)
        if dedup:
            keys = topk_ops.mask_duplicate_ids(keys, orig_ids, best_ids)
        best_keys, best_ids = topk_ops.merge_smallest(
            best_keys, best_ids, keys, orig_ids, keep)
    return best_keys, best_ids


def ivf_search_kernel(centroids: torch.Tensor, centroid_norms: torch.Tensor,
                      data, ids_padded: torch.Tensor, queries: torch.Tensor,
                      *, n_probes: int, keep: int, slot: int, sub: int,
                      distance: dist_ops.DistanceType, scan_vecs=None,
                      scan_ids=None, tiles_per_step: int = 1):
    """Two-phase IVF search for a query batch.

    Returns (keys (B, keep), ids (B, keep)) in original-id space.
    """
    distance = dist_ops.as_distance(distance)
    q_norms = queries.float().square().sum(-1)
    # phase 1: centroid distances + top-n_probes (search_centroids)
    ckeys = dist_ops.pairwise_keys(distance, queries, centroids,
                                   vector_norms_sq=centroid_norms,
                                   query_norms_sq=q_norms)
    _, probes = topk_ops.smallest_k(ckeys, None, n_probes)  # (B, P)
    return scan_padded_clusters(data, ids_padded, queries, q_norms, probes,
                                probes >= 0, keep=keep, slot=slot, sub=sub,
                                distance=distance, scan_vecs=scan_vecs,
                                scan_ids=scan_ids,
                                tiles_per_step=tiles_per_step)


def rerank_kernel(rerank_data, queries: torch.Tensor, cand_keys,
                  cand_ids: torch.Tensor, *, k: int,
                  distance: dist_ops.DistanceType):
    """Re-score candidates against ``rerank_data`` (any dataset-protocol
    object: ``get`` / ``norms_of``) and keep the k smallest.  ``cand_keys``
    is ignored, as in the JAX package.  Returns keys (B, k), ids (B, k).
    Two-level LVQ Vamana serving runs it on the retained beam too."""
    del cand_keys
    q_norms = queries.float().square().sum(-1)
    clamped = cand_ids.clamp_min(0)
    keys = dist_ops.gathered_keys(distance, queries,
                                  rerank_data.get(clamped),
                                  gathered_norms_sq=rerank_data.norms_of(
                                      clamped),
                                  query_norms_sq=q_norms)
    keys = torch.where(cand_ids >= 0, keys, float("inf"))
    return topk_ops.smallest_k(keys, cand_ids, k)


def _ivf_serve_batch(centroids, centroid_norms, data, ids_padded,
                     rerank_data, q, q_scale=None, scan_vecs=None,
                     scan_ids=None, *, k: int, n_probes: int, keep: int,
                     slot: int, sub: int, distance: dist_ops.DistanceType,
                     rerank: bool, tiles_per_step: int = 1):
    """One serving dispatch: dequantize the uploaded queries, centroid
    select + posting scan + (optional) rerank + key -> distance."""
    from ..vamana.index import dequantize_queries
    q = dequantize_queries(q, q_scale)
    keys, ids = ivf_search_kernel(
        centroids, centroid_norms, data, ids_padded, q,
        n_probes=n_probes, keep=keep, slot=slot, sub=sub, distance=distance,
        scan_vecs=scan_vecs, scan_ids=scan_ids,
        tiles_per_step=tiles_per_step)
    if rerank:
        keys, ids = rerank_kernel(rerank_data, q, keys, ids, k=k,
                                  distance=distance)
    else:
        keys, ids = keys[:, :k], ids[:, :k]
    return ids, dist_ops.value_from_key(distance, keys)


def serve_ivf_layout(index, queries, k: int, *, n_probes: int, keep: int,
                     rerank_data=None, use_scan: bool = False,
                     tiles: int = 1, cancel=None, translate_ids=None):
    """The serving pipeline of every padded-posting IVF layout (``index``
    has ``centroids``, ``centroid_norms``, ``data``, ``ids_padded``,
    ``slot``, ``scan_subtile``, ``query_batch_size`` and
    ``query_upload_dtype``): equal-size query batches uploaded
    asynchronously in the upload dtype, one dispatch per batch, every
    device -> host copy started before the first blocking read; the
    Vamana family's :class:`PendingSearch` holds them."""
    from ..vamana.index import PendingSearch, _BatchPlan, upload_batches
    queries = np.asarray(queries)
    if queries.ndim == 1:
        queries = queries[None, :]
    nq, dim = queries.shape
    if dim != index.data.dim:
        raise ValueError(f"query dim {dim} != dataset dim {index.data.dim}")
    sub = _pick_subtile(index.slot, index.scan_subtile)
    plan = _BatchPlan.plan(nq, index.query_batch_size)
    pending = PendingSearch(
        rows=plan.rows, nq=nq,
        out_ids=np.full((nq, k), -1, dtype=np.int64),
        out_vals=np.full((nq, k), np.inf, dtype=np.float32),
        translate_ids=translate_ids)
    for start, q_i, scale_i in upload_batches(
            queries, plan, index.data.padded_dim, index.data.device,
            index.query_upload_dtype, cancel):
        ids, vals = _ivf_serve_batch(
            index.centroids, index.centroid_norms, index.data,
            index.ids_padded, rerank_data, q_i, scale_i,
            index._scan_vecs if use_scan else None,
            index._scan_ids if use_scan else None,
            k=k, n_probes=n_probes, keep=keep, slot=index.slot, sub=sub,
            distance=index.distance, rerank=rerank_data is not None,
            tiles_per_step=tiles)
        pending.add(start, ids, vals)
    return pending.dispatched()


class IVFIndex:
    """Static IVF index over padded dense clusters."""

    SCHEMA = "ivf_index_parameters"
    VERSION = saveload.Version(0, 0, 1)
    # per-index query transfer dtype ("float32" / "float16" / "bfloat16" /
    # "int8"); None defers to the SVT_QUERY_UPLOAD_DTYPE env default
    query_upload_dtype = None

    def __init__(self, centroids, data, ids_padded, slot: int, n: int,
                 distance, search_parameters: Optional[IVFSearchParameters]
                 = None, build_parameters: Optional[IVFBuildParameters] = None,
                 rerank_data=None, query_batch_size: int = 2048,
                 scan_subtile: int = 256, logger=None,
                 n_clusters=None):
        """``centroids`` and ``ids_padded`` are host arrays; they go to the
        device of ``data``."""
        centroids = np.array(centroids, dtype=np.float32)   # writable copy
        d_pad = data.padded_dim
        if centroids.shape[1] < d_pad:   # pad to the dataset's width
            centroids = np.pad(
                centroids, ((0, 0), (0, d_pad - centroids.shape[1])))
        device = data.device
        self.centroids = torch.from_numpy(centroids).to(device)
        self.centroid_norms = self.centroids.square().sum(-1)
        self.data = data                      # reordered padded dataset
        self.ids_padded = torch.from_numpy(
            np.array(ids_padded, dtype=np.int32)).to(device)
        self.slot = slot
        self.n = n
        self.distance = dist_ops.as_distance(distance)
        self.search_parameters = search_parameters or IVFSearchParameters()
        self.build_parameters = build_parameters
        self.rerank_data = rerank_data
        self.query_batch_size = query_batch_size
        self.scan_subtile = scan_subtile
        # sub-tiles of one probed cluster folded per scan step (0 = auto)
        self.scan_tiles_per_step = int(
            os.environ.get("SVT_IVF_TILES_PER_STEP", "0"))
        self.logger = logger
        # chunked layouts have more probe units than logical clusters
        self.n_clusters = int(n_clusters if n_clusters is not None
                              else self.centroids.shape[0])
        self._scan_vecs = None      # (total/sub, sub*d_pad) view of the rows
        self._scan_ids = None       # (total/sub, sub) view of ids_padded
        self._scan_sub = 0

    # -- assembly --------------------------------------------------------------
    @classmethod
    def assemble_from_clustering(cls, clustering: Clustering, data,
                                 distance, dataset_cls=VectorDataset,
                                 rerank: bool = False,
                                 max_posting_factor=None, device="cuda",
                                 **kwargs) -> "IVFIndex":
        """Pack posting lists into the padded reordered layout on the host
        and upload it to ``device`` (reference assemble path,
        ivf.cpp:207-380 + clustering.h:314).  ``dataset_cls`` makes the
        reordered dataset from the packed rows, through its ``compress``
        (``LVQDataset``, ``SQDataset``) or ``from_array``, with
        ``device=``; ``rerank`` keeps an f32 copy of the rows for the
        k_reorder pass.

        ``max_posting_factor`` caps the per-probe-unit slot at
        ``factor * ceil(n / K)`` by chunking oversized clusters (probe
        units replicate their cluster's centroid).  ``None`` (default) =
        auto: cap at 2x mean only when the uncapped layout would waste
        more than 4x n rows beyond 5M rows; 0 = never cap."""
        x = data.to_numpy() if hasattr(data, "to_numpy") else \
            np.asarray(data, dtype=np.float32)
        centroids, rows, ids_padded, slot, n, k = _pack_layout_host(
            clustering, x, max_posting_factor=max_posting_factor)
        if hasattr(dataset_cls, "compress"):
            reordered = dataset_cls.compress(rows, device=device)
        else:
            reordered = dataset_cls.from_array(rows, device=device)
        reordered = _poison_padding(reordered, ids_padded)
        rerank_data = VectorDataset.from_array(x, device=device) \
            if rerank else None
        logger = kwargs.get("logger")
        if logger is not None:
            logger.info("ivf assemble: K=%d slot=%d padding factor %.2fx",
                        k, slot, ids_padded.shape[0] / max(n, 1))
        return cls(centroids, reordered, ids_padded, slot, n,
                   distance, rerank_data=rerank_data, n_clusters=k,
                   **kwargs)

    @classmethod
    def build(cls, build_parameters: IVFBuildParameters, data, distance,
              device="cuda", **kwargs) -> "IVFIndex":
        """Train + assemble in one call (reference auto-build path)."""
        clustering = Clustering.build(build_parameters, data, device=device)
        index = cls.assemble_from_clustering(clustering, data, distance,
                                             device=device, **kwargs)
        index.build_parameters = build_parameters
        return index

    # -- properties ------------------------------------------------------------
    @property
    def size(self) -> int:
        return self.n

    @property
    def dimensions(self) -> int:
        return self.data.dim

    @property
    def num_centroids(self) -> int:
        """Logical cluster count (reference semantics)."""
        return self.n_clusters

    @property
    def num_probe_units(self) -> int:
        """Probe units = centroid rows; > num_centroids when oversized
        clusters were chunked (n_probes counts these)."""
        return self.centroids.shape[0]

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
        """Dispatch a batch search and return a ``PendingSearch`` whose
        device work and device -> host copies have all been started."""
        params = parameters or self.search_parameters
        keep = max(k * params.k_reorder, k)
        sub = _pick_subtile(self.slot, self.scan_subtile)
        use_scan = ensure_scan_layout(self, sub)
        rerank = self.rerank_data is not None and keep > k
        return serve_ivf_layout(
            self, queries, k,
            n_probes=min(params.n_probes, self.num_probe_units), keep=keep,
            rerank_data=self.rerank_data if rerank else None,
            use_scan=use_scan,
            tiles=_resolve_tiles_per_step(self.scan_tiles_per_step,
                                          self.slot // sub, use_scan),
            cancel=cancel)

    # -- persistence -----------------------------------------------------------
    def save(self, config_dir: str, data_dir: Optional[str] = None) -> None:
        data_dir = data_dir or os.path.join(config_dir, "data")
        os.makedirs(config_dir, exist_ok=True)
        saveload.save_to_disk(self.data, data_dir)
        ctx = saveload.SaveContext(config_dir)
        table = saveload.save_table(self.SCHEMA, self.VERSION, {
            "distance": self.distance.value,
            "slot": self.slot,
            "num_points": self.n,
            "n_clusters": self.n_clusters,
            "centroids": ctx.save_array(self.centroids.cpu().numpy()),
            "ids_padded": ctx.save_array(self.ids_padded.cpu().numpy()),
            "search_parameters": self.search_parameters.save_table(),
            "build_parameters": (self.build_parameters.save_table()
                                 if self.build_parameters else None),
        })
        with open(os.path.join(config_dir, CONFIG_FILENAME), "w") as f:
            json.dump(table, f, indent=2)

    @classmethod
    def assemble_from_file(cls, config_dir: str,
                           data_dir: Optional[str] = None, device="cuda",
                           **kwargs) -> "IVFIndex":
        """Load a checkpoint either package saved onto ``device``."""
        from ...core.loading import dispatch_load
        data_dir = data_dir or os.path.join(config_dir, "data")
        with open(os.path.join(config_dir, CONFIG_FILENAME)) as f:
            table = json.load(f)
        saveload.check_table(table, cls.SCHEMA, cls.VERSION)
        ctx = saveload.LoadContext(config_dir)
        ids_padded = ctx.load_array(table["ids_padded"])
        data = _poison_padding(dispatch_load(data_dir, device=device),
                               ids_padded)
        sp = IVFSearchParameters.from_table(table["search_parameters"])
        bp = (IVFBuildParameters.from_table(table["build_parameters"])
              if table.get("build_parameters") else None)
        return cls(ctx.load_array(table["centroids"]), data, ids_padded,
                   table["slot"], table["num_points"], table["distance"],
                   search_parameters=sp, build_parameters=bp,
                   n_clusters=table.get("n_clusters"), **kwargs)
