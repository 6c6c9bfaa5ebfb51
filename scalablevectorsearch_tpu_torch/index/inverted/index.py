"""Two-level inverted index: Vamana over a centroid subset + posting lists.

PyTorch counterpart of ``scalablevectorsearch_tpu/index/inverted/index.py``
(the reference's ``InvertedIndex``, ``include/svs/index/inverted/
memory_based.h:334``, and ``inverted/clustering.h``):

* pick ``percent_centroids`` (default 10%) random dataset rows as
  centroids (numpy generator seeded with ``seed``, as in the JAX package);
* build a Vamana graph over them (the primary index, ``build_graph`` with
  pop width 1), which runs the ``beam_step`` CUDA kernel;
* closure multi-assignment: every point joins the posting list of each
  centroid within ``bound_with(closest, epsilon)`` of its closest one,
  RobustPruned to ``max_replicas + 1`` (clustering.h:690-748);
* search: ``greedy_search`` over the primary graph (``beam_step`` again,
  f32 centroid rows), the probes within ``(1 + refinement_epsilon)`` of the
  best, then the IVF posting scan with dedup (``scan_padded_clusters``).

Centroid points are members of their own posting lists, so the scan alone
produces complete results.  Checkpoints are the JAX package's
(``inverted_config.json`` + ``centroid_data/`` + ``graph/`` + ``data/``).
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
from ...lib import datatypes as dt
from ...lib import saveload
from ...lib import timing
from ...ops import distance as dist_ops
from ...ops import prune as prune_ops
from ...ops import topk as topk_ops
from ..ivf.index import (_pick_subtile, _poison_padding,
                         _resolve_tiles_per_step, ensure_scan_layout,
                         scan_padded_clusters)
from ..vamana import build as vamana_build
from ..vamana import search as vamana_search
from ..vamana.params import VamanaBuildParameters

CONFIG_FILENAME = "inverted_config.json"


@dataclasses.dataclass
class InvertedBuildParameters:
    """(reference inverted/memory_build_params.h + ClusteringParameters,
    inverted/clustering.h:46-72)

    ``epsilon`` / ``max_replicas`` / ``refinement_alpha`` drive closure
    multi-assignment: each point joins the posting list of every centroid
    within ``bound_with(closest, epsilon)`` of its closest centroid, with
    the replica set diversity-pruned (RobustPrune at ``refinement_alpha``)
    to ``max_replicas + 1`` (clustering.h:711-748)."""

    percent_centroids: float = 0.10
    primary_parameters: VamanaBuildParameters = dataclasses.field(
        default_factory=VamanaBuildParameters)
    seed: int = 0xFEED
    epsilon: float = 0.05
    max_replicas: int = 8
    refinement_alpha: float = 1.0

    SCHEMA = "inverted_build_parameters"
    VERSION = saveload.Version(0, 0, 2)

    def save_table(self) -> dict:
        return saveload.save_table(self.SCHEMA, self.VERSION, {
            "percent_centroids": self.percent_centroids,
            "seed": self.seed,
            "epsilon": self.epsilon,
            "max_replicas": self.max_replicas,
            "refinement_alpha": self.refinement_alpha,
            "primary_parameters": self.primary_parameters.save_table(),
        })

    @classmethod
    def from_table(cls, table: dict) -> "InvertedBuildParameters":
        saveload.check_table(table, cls.SCHEMA, cls.VERSION)
        return cls(percent_centroids=table["percent_centroids"],
                   seed=table.get("seed", 0xFEED),
                   epsilon=table.get("epsilon", 0.05),
                   max_replicas=table.get("max_replicas", 8),
                   refinement_alpha=table.get("refinement_alpha", 1.0),
                   primary_parameters=VamanaBuildParameters.from_table(
                       table["primary_parameters"]))


@dataclasses.dataclass(frozen=True)
class InvertedSearchParameters:
    """(reference inverted/memory_search_params.h): primary window +
    refinement epsilon (cluster cutoff) + a probe cap."""

    primary_window_size: int = 32
    refinement_epsilon: float = 1.0
    max_probes: int = 16

    SCHEMA = "inverted_search_parameters"
    VERSION = saveload.Version(0, 0, 1)

    def save_table(self) -> dict:
        return saveload.save_table(self.SCHEMA, self.VERSION, {
            "primary_window_size": self.primary_window_size,
            "refinement_epsilon": self.refinement_epsilon,
            "max_probes": self.max_probes,
        })

    @classmethod
    def from_table(cls, table: dict) -> "InvertedSearchParameters":
        saveload.check_table(table, cls.SCHEMA, cls.VERSION)
        return cls(primary_window_size=table["primary_window_size"],
                   refinement_epsilon=table["refinement_epsilon"],
                   max_probes=table["max_probes"])


def _bound_keys(best: torch.Tensor, epsilon) -> torch.Tensor:
    """Per-metric epsilon bound in key space (reference inverted/common.h
    ``bound_with``, in the value domain: L2 distances scale by (1+eps),
    IP/cosine similarities by 1/(1+eps); keys negate similarities, so
    negative keys divide instead)."""
    return torch.where(best >= 0, best * (1.0 + epsilon),
                       best / (1.0 + epsilon))


def _closure_assign_chunk(centroids: VectorDataset, x_chunk: torch.Tensor,
                          alpha: float, epsilon: float, *,
                          n_candidates: int, n_replicas: int, rows: int,
                          distance: dist_ops.DistanceType) -> torch.Tensor:
    """Closure multi-assignment for one chunk of points (reference
    inverted/clustering.h:690-748): the nearest ``n_candidates`` centroids
    by one matmul, the epsilon cutoff around the closest, RobustPrune of
    the survivors to ``n_replicas`` diverse centroids."""
    q_norms = x_chunk.float().square().sum(-1)
    k = centroids.capacity
    keys = centroids.tile_keys(x_chunk, q_norms, 0, k, distance)   # (B, k)
    cand_keys, cand_ids = topk_ops.smallest_k(keys, None,
                                              min(n_candidates, k))
    bound = _bound_keys(cand_keys[:, :1], epsilon)
    cand_keys = torch.where(cand_keys <= bound, cand_keys, float("inf"))
    cand_ids = torch.where(torch.isfinite(cand_keys), cand_ids, -1)
    clamped = cand_ids.clamp_min(0)
    vecs = centroids.get(clamped).float()
    norms = torch.where(cand_ids >= 0, centroids.norms_of(clamped),
                        float("inf"))
    # self id -5 never matches a centroid id (the reference passes I::max)
    selfs = torch.full((rows,), -5, dtype=torch.int32, device=x_chunk.device)
    out, _degs = prune_ops.robust_prune(cand_ids, cand_keys, vecs, norms,
                                        selfs, alpha, n_replicas, distance)
    return out


def closure_assign(x: np.ndarray, centroid_data: VectorDataset,
                   distance, epsilon: float, max_replicas: int,
                   refinement_alpha: float, chunk: int = 4096) -> np.ndarray:
    """(n, max_replicas + 1) centroid memberships per point, -1-padded, on
    ``centroid_data``'s device.  The closest centroid always survives
    (RobustPrune keeps the best candidate first, clustering.h:730)."""
    distance = dist_ops.as_distance(distance)
    n = x.shape[0]
    n_replicas = max_replicas + 1
    n_candidates = max(2 * n_replicas, 16)
    parts = []
    for start in range(0, n, chunk):
        rows = min(chunk, n - start)
        rows_pad = dt.pad_to(rows, 8) if rows < chunk else chunk
        xc = dt.pad_matrix(x[start:start + rows].astype(np.float32),
                           n_pad=rows_pad, d_pad=centroid_data.padded_dim)
        got = _closure_assign_chunk(
            centroid_data, torch.from_numpy(xc).to(centroid_data.device),
            float(refinement_alpha), float(epsilon),
            n_candidates=n_candidates, n_replicas=n_replicas, rows=rows_pad,
            distance=distance)
        parts.append(got[:rows])
    if not parts:
        return np.full((0, n_replicas), -1, dtype=np.int32)
    return torch.cat(parts).cpu().numpy()


def pack_padded_clusters_multi(x: np.ndarray, memberships: np.ndarray,
                               k: int, align: int = 8):
    """Padded-cluster packing with replication: point ``p`` appears in the
    posting list of every centroid in ``memberships[p]`` (-1 = unused slot).
    Same layout contract as ``ivf.clustering.pack_padded_clusters``; a copy
    of the JAX package's numpy function."""
    pt = np.repeat(np.arange(memberships.shape[0], dtype=np.int64),
                   memberships.shape[1])
    c = memberships.reshape(-1).astype(np.int64)
    live = c >= 0
    pt, c = pt[live], c[live]
    sizes = np.bincount(c, minlength=k)
    slot = int(dt.pad_to(max(int(sizes.max()), 1), align))
    order = np.argsort(c, kind="stable")
    sorted_c = c[order]
    starts = np.zeros(k, dtype=np.int64)
    np.cumsum(sizes[:-1], out=starts[1:])
    rank = np.arange(pt.size, dtype=np.int64) - starts[sorted_c]
    pos = sorted_c * slot + rank
    ids_padded = np.full(k * slot, -1, dtype=np.int32)
    ids_padded[pos] = pt[order]
    rows = np.zeros((k * slot, x.shape[1]), dtype=x.dtype)
    rows[pos] = x[pt[order]]
    return rows, ids_padded, slot


def inverted_search_kernel(graph: NeighborGraph,
                           centroid_data: VectorDataset,
                           data, ids_padded: torch.Tensor,
                           queries: torch.Tensor, entry_ids: torch.Tensor,
                           epsilon: float, *, window: int, max_iters: int,
                           max_probes: int, keep: int, slot: int, sub: int,
                           distance: dist_ops.DistanceType, scan_vecs=None,
                           scan_ids=None, tiles_per_step: int = 1):
    """Primary graph search (``beam_step``) -> epsilon cutoff -> posting
    scan with dedup.  Returns (keys (B, keep), ids (B, keep))."""
    distance = dist_ops.as_distance(distance)
    q_norms = queries.float().square().sum(-1)
    out = vamana_search.greedy_search(
        graph, centroid_data, queries, entry_ids, window=window,
        capacity=window, max_iters=max_iters, distance=distance)
    probes = out.ids[:, :max_probes]                       # centroid indices
    probe_keys = out.keys[:, :max_probes]
    # epsilon cutoff (memory_based.h:441-454 via inverted/common.h
    # bound_with): keep probes within the per-metric bound of the best
    probe_valid = (probes >= 0) & (
        probe_keys <= _bound_keys(probe_keys[:, :1], epsilon))
    # replicated posting lists surface one id from several probed clusters:
    # the scan's running merge dedups them
    return scan_padded_clusters(data, ids_padded, queries, q_norms, probes,
                                probe_valid, keep=keep, slot=slot, sub=sub,
                                distance=distance, dedup=True,
                                scan_vecs=scan_vecs, scan_ids=scan_ids,
                                tiles_per_step=tiles_per_step)


def _inverted_serve_batch(graph, centroid_data, data, ids_padded, q, q_scale,
                          entry_ids, epsilon, scan_vecs=None, scan_ids=None,
                          *, window: int, max_iters: int, max_probes: int,
                          keep: int, slot: int, sub: int,
                          distance: dist_ops.DistanceType,
                          tiles_per_step: int = 1):
    """One serving dispatch: dequantize the uploaded queries, primary
    search + scan + key -> distance."""
    from ..vamana.index import dequantize_queries
    q = dequantize_queries(q, q_scale)
    keys, ids = inverted_search_kernel(
        graph, centroid_data, data, ids_padded, q, entry_ids,
        epsilon, window=window, max_iters=max_iters, max_probes=max_probes,
        keep=keep, slot=slot, sub=sub, distance=distance,
        scan_vecs=scan_vecs, scan_ids=scan_ids,
        tiles_per_step=tiles_per_step)
    return ids, dist_ops.value_from_key(distance, keys)


class InvertedIndex:
    SCHEMA = "inverted_index_parameters"
    VERSION = saveload.Version(0, 0, 1)
    # per-index query transfer dtype override (see IVFIndex)
    query_upload_dtype = None

    def __init__(self, graph, centroid_data, centroid_ids, data, ids_padded,
                 slot: int, n: int, entry_point: int, distance,
                 search_parameters: Optional[InvertedSearchParameters] = None,
                 build_parameters: Optional[InvertedBuildParameters] = None,
                 query_batch_size: int = 2048, scan_subtile: int = 256,
                 logger=None):
        """``centroid_ids`` and ``ids_padded`` are host arrays; they go to
        the device of ``data``."""
        device = data.device
        self.graph = graph                    # primary graph over centroids
        self.centroid_data = centroid_data    # centroid vectors (subset)
        self.centroid_ids = torch.from_numpy(     # writable copies
            np.array(centroid_ids, dtype=np.int32)).to(device)
        self.data = data                      # reordered padded full dataset
        self.ids_padded = torch.from_numpy(
            np.array(ids_padded, dtype=np.int32)).to(device)
        self.slot = slot
        self.n = n
        self.entry_point = int(entry_point)
        self.distance = dist_ops.as_distance(distance)
        self.search_parameters = (search_parameters
                                  or InvertedSearchParameters())
        self.build_parameters = build_parameters
        self.query_batch_size = query_batch_size
        self.scan_subtile = scan_subtile
        self.scan_tiles_per_step = 0
        self._scan_vecs = None      # super-row scan layout (a view; see
        self._scan_ids = None       #   ivf/index.py ensure_scan_layout)
        self._scan_sub = 0

    # -- build -----------------------------------------------------------------
    @classmethod
    def build(cls, parameters: InvertedBuildParameters, data, distance,
              device="cuda", timer: Optional[timing.Timer] = None,
              **kwargs) -> "InvertedIndex":
        """auto_build pipeline (memory_based.h:557-612) on ``device``.
        ``timer`` gets the scopes "primary graph", "closure assign" and
        "packing"."""
        timer = timing.as_timer(timer)
        x = data.to_numpy() if hasattr(data, "to_numpy") else \
            np.asarray(data, dtype=np.float32)
        n = x.shape[0]
        distance = dist_ops.as_distance(distance)
        rng = np.random.default_rng(parameters.seed)
        k = max(int(n * parameters.percent_centroids), 1)
        centroid_ids = np.sort(rng.choice(n, size=k, replace=False))

        with timer.scope("primary graph"):
            centroid_data = VectorDataset.from_array(x[centroid_ids],
                                                     device=device)
            pparams = parameters.primary_parameters.resolved(distance)
            graph, entry = vamana_build.build_graph(centroid_data, pparams,
                                                    distance, pop_width=1)
        with timer.scope("closure assign"):
            memberships = closure_assign(
                x, centroid_data, distance, parameters.epsilon,
                parameters.max_replicas, parameters.refinement_alpha)
        with timer.scope("packing"):
            rows, ids_padded, slot = pack_padded_clusters_multi(
                x, memberships, k)
            reordered = _poison_padding(
                VectorDataset.from_array(rows, device=device), ids_padded)
        return cls(graph, centroid_data, centroid_ids, reordered, ids_padded,
                   slot, n, entry, distance, build_parameters=parameters,
                   **kwargs)

    @property
    def size(self) -> int:
        return self.n

    @property
    def dimensions(self) -> int:
        return self.data.dim

    @property
    def num_centroids(self) -> int:
        return self.centroid_ids.shape[0]

    # -- search ----------------------------------------------------------------
    def search(self, queries, k: int,
               parameters: Optional[InvertedSearchParameters] = None,
               cancel=None) -> QueryResult:
        """``cancel``: optional zero-arg predicate checked between query
        batch dispatches."""
        return self.search_async(queries, k, parameters=parameters,
                                 cancel=cancel).result()

    def search_async(self, queries, k: int,
                     parameters: Optional[InvertedSearchParameters] = None,
                     cancel=None):
        """Pipelined dispatch (see ``IVFIndex.search_async``)."""
        from ..vamana.index import PendingSearch, _BatchPlan, upload_batches
        params = parameters or self.search_parameters
        window = max(params.primary_window_size, params.max_probes)
        max_probes = min(params.max_probes, self.num_centroids)
        sub = _pick_subtile(self.slot, self.scan_subtile)
        use_scan = ensure_scan_layout(self, sub)
        tiles = _resolve_tiles_per_step(self.scan_tiles_per_step,
                                        self.slot // sub, use_scan)
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
        pending = PendingSearch(
            rows=plan.rows, nq=nq,
            out_ids=np.full((nq, k), -1, dtype=np.int64),
            out_vals=np.full((nq, k), np.inf, dtype=np.float32))
        for start, q_i, scale_i in upload_batches(
                queries, plan, self.data.padded_dim, device,
                self.query_upload_dtype, cancel):
            ids, vals = _inverted_serve_batch(
                self.graph, self.centroid_data, self.data, self.ids_padded,
                q_i, scale_i, entry_ids, float(params.refinement_epsilon),
                self._scan_vecs if use_scan else None,
                self._scan_ids if use_scan else None,
                window=window,
                max_iters=vamana_search.default_max_iters(window),
                max_probes=max_probes, keep=k, slot=self.slot, sub=sub,
                distance=self.distance, tiles_per_step=tiles)
            pending.add(start, ids, vals)
        return pending.dispatched()

    # -- persistence -----------------------------------------------------------
    def save(self, config_dir: str) -> None:
        os.makedirs(config_dir, exist_ok=True)
        saveload.save_to_disk(self.centroid_data,
                              os.path.join(config_dir, "centroid_data"))
        saveload.save_to_disk(self.graph,
                              os.path.join(config_dir, "graph"))
        saveload.save_to_disk(self.data, os.path.join(config_dir, "data"))
        ctx = saveload.SaveContext(config_dir)
        table = saveload.save_table(self.SCHEMA, self.VERSION, {
            "distance": self.distance.value,
            "slot": self.slot,
            "num_points": self.n,
            "entry_point": self.entry_point,
            "centroid_ids": ctx.save_array(self.centroid_ids.cpu().numpy()),
            "ids_padded": ctx.save_array(self.ids_padded.cpu().numpy()),
            "search_parameters": self.search_parameters.save_table(),
            "build_parameters": (self.build_parameters.save_table()
                                 if self.build_parameters else None),
        })
        with open(os.path.join(config_dir, CONFIG_FILENAME), "w") as f:
            json.dump(table, f, indent=2)

    @classmethod
    def assemble(cls, config_dir: str, device="cuda",
                 **kwargs) -> "InvertedIndex":
        """Load a checkpoint either package saved onto ``device``."""
        from ...core.loading import dispatch_load
        with open(os.path.join(config_dir, CONFIG_FILENAME)) as f:
            table = json.load(f)
        saveload.check_table(table, cls.SCHEMA, cls.VERSION)
        ctx = saveload.LoadContext(config_dir)
        centroid_data = dispatch_load(
            os.path.join(config_dir, "centroid_data"), device=device)
        graph = saveload.load_from_disk(
            NeighborGraph, os.path.join(config_dir, "graph"), device=device)
        ids_padded = ctx.load_array(table["ids_padded"])
        data = _poison_padding(
            dispatch_load(os.path.join(config_dir, "data"), device=device),
            ids_padded)
        sp = InvertedSearchParameters.from_table(table["search_parameters"])
        bp = (InvertedBuildParameters.from_table(table["build_parameters"])
              if table.get("build_parameters") else None)
        return cls(graph, centroid_data, ctx.load_array(table["centroid_ids"]),
                   data, ids_padded, table["slot"], table["num_points"],
                   table["entry_point"], table["distance"],
                   search_parameters=sp, build_parameters=bp, **kwargs)
