"""Multi-device sharded search and build steps.

PyTorch counterpart of ``scalablevectorsearch_tpu/parallel/sharded.py`` on
the single-controller mesh of :mod:`.mesh`: where the JAX package runs one
``shard_map`` program per device and lets XLA insert the collectives, one
Python process loops over the shards here.  Three decompositions:

* **Query-parallel (dp)** — queries split into contiguous chunks, the index
  on every device of the axis (on k x one card the same tensors, not
  copies): :func:`dp_greedy_search`, and :func:`dp_build_round`, whose
  per-node search and prune run per chunk while the commit, whose reverse
  edges span the batch, runs once on the lead device.
* **Data-sharded flat / IVF (shard)** — dataset rows (IVF: probe units) in
  contiguous blocks; each shard's top-k, concatenated and merged.
* **Sharded-graph Vamana** — graph rows and dataset rows in contiguous
  blocks, behind *shard views* that implement the graph and dataset
  protocols, so the unchanged ``greedy_search`` and ``build_round`` run
  over them.

Collectives.  Each shard computes its partial on its device; the partials
move to the lead device (the axis's first) and are reduced there in shard
order: ``pmin`` is ``torch.minimum`` over +inf-masked keys, ``pmax`` the
maximum over -1-masked adjacency rows, ``psum`` a sum over 0-masked rows
or norms, ``all_gather`` ``torch.cat``.  Each reduction has exactly one
non-neutral contributor, so a sharded result is the single-device one bit
for bit wherever both compute the same keys.

Scoring.  A data view's ``score_keys`` (the hook of ``search.py`` and
``build.py``) runs the single-device scorer it is given on every shard's
own rows, the ids it does not own clamped and their keys masked, then
``pmin``: S times the single-device scoring work, as in the JAX package.
Views take ``greedy_search``'s scored route (``beam_update``).  Their
candidates get ``search._route_keys``: ``score_rows`` over the shard's
decoded rows for f32 / bf16 / LVQ rows (the beam-step kernels' formula,
so a sharded search equals the single-device one on the CPU, where those
kernels run their plain versions), ``gather_score_l2_partial`` over the
shard's table for float16 / int8 / uint8 L2 rows and ``score_rows`` over
decoded SQ rows (what the single-device scored route computes).
"""

from __future__ import annotations

import dataclasses
import os
import types
from typing import Optional

import numpy as np
import torch

from ..core.data import VectorDataset
from ..core.graph import NeighborGraph
from ..core.medioid import compute_medioid
from ..lib import datatypes as dt
from ..ops import distance as dist_ops
from ..ops import topk as topk_ops
from ..index import flat as flat_mod
from ..index.vamana import build as build_mod
from ..index.vamana import search as search_mod
from ..quantization.lvq import LVQDataset
from ..quantization.scalar import SQDataset
from .mesh import Layout, Mesh, row_sharded

# the tensors of each container that hold one entry per row
_ROW_FIELDS = {
    VectorDataset: ("vectors", "norms_sq"),
    LVQDataset: ("codes", "scales", "biases", "norms_sq", "res_codes",
                 "res_scales", "full_norms_sq"),
    SQDataset: ("codes", "norms_sq", "code_sums"),
    NeighborGraph: ("adjacency", "degrees"),
}


def _to(obj, device):
    """A tensor, or a dataclass of tensors (a dataset, graph, sampler), on
    ``device``; ``.to`` copies only to another device."""
    if obj is None:
        return None
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    moved = {f.name: _to(getattr(obj, f.name), device)
             for f in dataclasses.fields(obj)
             if isinstance(getattr(obj, f.name), torch.Tensor)
             or dataclasses.is_dataclass(getattr(obj, f.name))}
    return dataclasses.replace(obj, **moved)


def _rows(obj, lo: int, hi: int, device):
    """Rows [lo, hi) of a dataset or graph, on ``device``, as a container
    of ``hi - lo`` rows."""
    row = _ROW_FIELDS[type(obj)]
    kw = {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
    kw.update({name: kw[name][lo:hi] for name in row})
    kw = {k: v.to(device) if isinstance(v, torch.Tensor) else v
          for k, v in kw.items()}
    kw["n"] = hi - lo
    return type(obj)(**kw)


def _join(parts: list, device, n: int):
    """The one-device container of the parts' rows, in order, on
    ``device``."""
    first = parts[0]
    kw = {f.name: getattr(first, f.name) for f in dataclasses.fields(first)}
    kw.update({name: torch.cat([getattr(p, name).to(device) for p in parts])
               for name in _ROW_FIELDS[type(first)]})
    kw = {k: v.to(device) if isinstance(v, torch.Tensor) else v
          for k, v in kw.items()}
    kw["n"] = n
    return type(first)(**kw)


def _split(obj, layout: Layout) -> list:
    """``obj``'s rows in contiguous blocks, one per device of the layout."""
    devices = layout.devices
    cap = obj.capacity
    if cap % len(devices):
        raise ValueError(f"capacity {cap} not divisible by {len(devices)}")
    rps = cap // len(devices)
    return [_rows(obj, s * rps, (s + 1) * rps, dev)
            for s, dev in enumerate(devices)]


def _blocked(capacity: int, n_shards: int) -> int:
    """Capacity padded as the JAX package pads it: rows per shard a
    multiple of 8."""
    return dt.pad_to(-(-capacity // n_shards), 8) * n_shards


# ---------------------------------------------------------------------------
# Shard views
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _ShardedRows:
    """Rows in contiguous blocks, one part per device of ``layout``."""

    shards: list
    layout: Layout
    n: int

    @property
    def rows_per_shard(self) -> int:
        return self.shards[0].capacity

    @property
    def capacity(self) -> int:
        return self.rows_per_shard * len(self.shards)

    @property
    def device(self) -> torch.device:
        """The lead device: replicated state and reduced partials."""
        return self.layout.devices[0]

    def _owned(self, ids: torch.Tensor):
        """Per shard: (part, its device, local ids, owner mask on the lead
        device)."""
        rps = self.rows_per_shard
        for s, (part, dev) in enumerate(zip(self.shards,
                                            self.layout.devices)):
            lid = ids - s * rps
            yield part, dev, lid, (ids >= 0) & (lid >= 0) & (lid < rps)

    def _reduce(self, ids: torch.Tensor, local, fill, op) -> torch.Tensor:
        """``op`` over the shards of ``local(part, local_ids)``, each part's
        values where it does not own the id replaced by ``fill``."""
        out = None
        for part, dev, lid, mine in self._owned(ids):
            val = local(part, lid.clamp(0, self.rows_per_shard - 1).to(dev))
            val = val.to(self.device)
            mask = mine.reshape(mine.shape + (1,) * (val.ndim - mine.ndim))
            val = torch.where(mask, val, fill)
            out = val if out is None else op(out, val)
        return out

    def _apply(self, ids: torch.Tensor, update) -> list:
        """Each part's ``update(part, local_ids, mine)``, where the ids it
        does not own are -1 (outside every part: the single-device
        containers drop them)."""
        return [update(part, torch.where(mine, lid, -1).to(dev),
                       mine.to(dev))
                for part, dev, lid, mine in self._owned(ids)]

    def gather(self):
        """The one-device container of all rows, on the lead device."""
        return _join(self.shards, self.device, self.n)


@dataclasses.dataclass
class ShardedGraphShard(_ShardedRows):
    """Graph rows in contiguous blocks (one ``NeighborGraph`` per shard):
    the graph protocol of ``greedy_search`` and ``build_round``.  Rows are
    read by ``pmax`` over -1-masked local rows and degrees by ``psum``;
    each shard commits only the rows it owns, and ids at or above the
    global capacity are dropped."""

    max_degree: int = 0

    def neighbors(self, ids: torch.Tensor) -> torch.Tensor:
        return self._reduce(ids, lambda g, lid: g.adjacency[lid], -1,
                            torch.maximum)

    def degrees_of(self, ids: torch.Tensor) -> torch.Tensor:
        return self._reduce(ids, lambda g, lid: g.degrees[lid], 0, torch.add)

    def replace_rows(self, ids, rows, new_degrees) -> "ShardedGraphShard":
        return dataclasses.replace(self, shards=self._apply(
            ids, lambda g, lid, _m: g.replace_rows(
                lid, rows.to(lid.device), new_degrees.to(lid.device))))

    def scatter_edges(self, dst, slot, src, valid) -> "ShardedGraphShard":
        return dataclasses.replace(self, shards=self._apply(
            dst, lambda g, lid, mine: g.scatter_edges(
                lid.clamp_min(0), slot.to(lid.device), src.to(lid.device),
                valid.to(lid.device) & mine)))

    def clear_rows(self, ids: torch.Tensor) -> "ShardedGraphShard":
        return dataclasses.replace(self, shards=self._apply(
            ids.to(self.device), lambda g, lid, _m: g.clear_rows(lid)))

    def with_capacity(self, capacity: int) -> "ShardedGraphShard":
        """Grow to at least ``capacity`` rows; the blocks are laid out
        again (ids are global, so no row's content changes)."""
        if capacity <= self.capacity:
            return self
        return shard_graph(self.gather().with_capacity(capacity),
                           self.layout.mesh, self.layout.axis)


@dataclasses.dataclass
class ShardedDataShard(_ShardedRows):
    """Dataset rows in contiguous blocks (one dataset per shard, of any
    kind): the dataset protocol of ``greedy_search`` and ``build_round``.
    Rows and norms are read by ``psum`` over 0-masked local ones (the
    decode is local), and keys by :meth:`score_keys`."""

    dim: int = 0

    @property
    def padded_dim(self) -> int:
        return self.shards[0].padded_dim

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    def get(self, ids: torch.Tensor) -> torch.Tensor:
        return self._reduce(ids, lambda d, lid: d.get(lid), 0, torch.add)

    def get_f32(self, ids: torch.Tensor) -> torch.Tensor:
        return self._reduce(ids, lambda d, lid: d.get_f32(lid), 0, torch.add)

    def norms_of(self, ids: torch.Tensor) -> torch.Tensor:
        return self._reduce(ids, lambda d, lid: d.norms_of(lid), 0,
                            torch.add)

    def score_keys(self, distance, queries, q_norms, ids, scorer):
        """(B, K) ids -> (B, K) keys: ``scorer(dataset, distance, queries,
        q_norms, ids)`` on each shard's rows, then ``pmin``; +inf for ids
        outside ``[0, n)``."""
        keys = self._reduce(ids, lambda d, lid: scorer(
            d, distance, queries.to(lid.device), q_norms.to(lid.device),
            lid), float("inf"), torch.minimum)
        return torch.where(ids < self.n, keys, float("inf"))

    def scatter_rows(self, slots, rows, new_n: Optional[int] = None
                     ) -> "ShardedDataShard":
        """Write ``rows`` at ``slots``; each shard writes the ones it owns
        (the dynamic index's add path)."""
        slots = torch.as_tensor(slots, device=self.device)
        return dataclasses.replace(
            self, n=self.n if new_n is None else new_n,
            shards=self._apply(slots, lambda d, lid, _m: d.scatter_rows(
                lid, rows)))

    def with_capacity(self, capacity: int) -> "ShardedDataShard":
        """Grow to at least ``capacity`` rows, laid out again in blocks."""
        if capacity <= self.capacity:
            return self
        return shard_any_dataset(self.gather().with_capacity(capacity),
                                 self.layout.mesh, self.layout.axis)


@dataclasses.dataclass
class ShardedLVQShard(ShardedDataShard):
    """LVQ codes and per-row constants in blocks (the mean on every
    device): ``get`` decodes the primary level locally, ``get_full`` both
    levels."""

    def get_full(self, ids: torch.Tensor) -> torch.Tensor:
        return self._reduce(ids, lambda d, lid: d.get_full(lid), 0,
                            torch.add)


@dataclasses.dataclass
class ShardedSQShard(ShardedDataShard):
    """SQ codes in blocks (the global scale and bias on every device),
    decoded locally."""


_VIEWS = {VectorDataset: ShardedDataShard, LVQDataset: ShardedLVQShard,
          SQDataset: ShardedSQShard}


def _shard_rows(data, mesh: Mesh, axis: str):
    n_shards = mesh.shape[axis]
    data = data.with_capacity(_blocked(data.capacity, n_shards))
    layout = row_sharded(mesh, axis)
    return _VIEWS[type(data)](shards=_split(data, layout), layout=layout,
                              n=data.n, dim=data.dim)


def shard_dataset(data: VectorDataset, mesh: Mesh, axis: str = "shard"
                  ) -> ShardedDataShard:
    """Lay a dataset's rows out across a mesh axis (the capacity padded
    first, so that every shard holds a multiple of 8 rows)."""
    if not isinstance(data, VectorDataset):
        raise TypeError(f"shard_dataset takes a VectorDataset, not "
                        f"{type(data).__name__}")
    return _shard_rows(data, mesh, axis)


def shard_lvq(lvq: LVQDataset, mesh: Mesh, axis: str = "shard"
              ) -> ShardedLVQShard:
    """Lay an ``LVQDataset``'s rows across a mesh axis (``with_capacity``
    pads to 32 rows; a capacity that then does not split raises)."""
    if not isinstance(lvq, LVQDataset):
        raise TypeError(f"shard_lvq takes an LVQDataset, not "
                        f"{type(lvq).__name__}")
    return _shard_rows(lvq, mesh, axis)


def shard_sq(sq: SQDataset, mesh: Mesh, axis: str = "shard"
             ) -> ShardedSQShard:
    """Lay an ``SQDataset``'s rows across a mesh axis."""
    if not isinstance(sq, SQDataset):
        raise TypeError(f"shard_sq takes an SQDataset, not "
                        f"{type(sq).__name__}")
    return _shard_rows(sq, mesh, axis)


def shard_any_dataset(data, mesh: Mesh, axis: str = "shard"
                      ) -> ShardedDataShard:
    """The view of any dataset's rows across a mesh axis: ``VectorDataset``
    (any element type) -> :class:`ShardedDataShard`, ``LVQDataset`` ->
    :class:`ShardedLVQShard`, ``SQDataset`` -> :class:`ShardedSQShard`."""
    if type(data) not in _VIEWS:
        raise TypeError(f"no shard view for {type(data).__name__}")
    return _shard_rows(data, mesh, axis)


def shard_graph(graph: NeighborGraph, mesh: Mesh, axis: str = "shard"
                ) -> ShardedGraphShard:
    """Lay a graph's rows out across a mesh axis."""
    graph = graph.with_capacity(_blocked(graph.capacity, mesh.shape[axis]))
    layout = row_sharded(mesh, axis)
    return ShardedGraphShard(shards=_split(graph, layout), layout=layout,
                             n=graph.n, max_degree=graph.max_degree)


def shard_dataset_from_file(path: str, mesh: Mesh, axis: str = "shard", *,
                            dtype=None, block_rows: int = 1 << 18
                            ) -> ShardedDataShard:
    """Stream a ``*vecs`` file straight into the row-sharded layout.

    Rows are read in ``block_rows`` blocks into one per-shard host buffer
    at a time (peak host memory: one shard), which goes to its device; the
    norms are computed there as ``VectorDataset.from_array`` computes them.
    The result is ``shard_dataset(VectorDataset.from_array(read_vecs(path)),
    ...)``, bit for bit.
    """
    from ..core import io as core_io
    n, dim = core_io.probe_vecs_shape(path, dtype)
    if n == 0:
        raise ValueError(f"{path} is empty")
    if len(mesh.shape) != 1:
        raise ValueError("shard_dataset_from_file expects a 1-d mesh")
    layout = row_sharded(mesh, axis)
    d_pad = dt.padded_dim(dim)
    per = _blocked(dt.padded_count(n, torch.float32),
                   mesh.shape[axis]) // mesh.shape[axis]
    parts = []
    for s, dev in enumerate(layout.devices):
        buf = np.zeros((per, d_pad), dtype=np.float32)
        lo, hi = min(s * per, n), min((s + 1) * per, n)
        for start in range(lo, hi, block_rows):
            blk = core_io.read_vecs_rows(
                path, start, min(block_rows, hi - start), dtype)
            buf[start - s * per: start - s * per + blk.shape[0], :dim] = blk
        vectors = torch.from_numpy(buf).to(dev)
        del buf
        norms = torch.where(
            torch.arange(s * per, (s + 1) * per, device=dev) < n,
            vectors.float().square().sum(-1), float("inf"))
        parts.append(VectorDataset(vectors=vectors, norms_sq=norms, n=per,
                                   dim=dim))
    return ShardedDataShard(shards=parts, layout=layout, n=n, dim=dim)


class _SlotRows:
    """The dataset protocol of ``compute_medioid`` over chosen rows of a
    sharded f32 dataset, in slot order, as one device holding them in
    ``capacity`` rows would present them: the mean accumulates in
    ``compute_medioid``'s own tiles, so the medioid is the single-device
    one bit for bit wherever both hold the same capacity.  ``valid`` marks
    the rows the arg-min may choose (default: all)."""

    def __init__(self, view: ShardedDataShard, slots: np.ndarray,
                 capacity: int, valid: Optional[np.ndarray] = None):
        self._view = view
        self.n = len(slots)
        self.capacity = capacity
        self.padded_dim = view.padded_dim
        self.device = view.device
        pos = np.zeros(capacity, dtype=np.int64)
        pos[: self.n] = slots
        ok = np.zeros(capacity, dtype=bool)
        ok[: self.n] = True if valid is None else valid
        self._slots = torch.from_numpy(pos).to(self.device)
        self._valid = torch.from_numpy(ok).to(self.device)

    def get_f32(self, ids: torch.Tensor) -> torch.Tensor:
        return self._view.get_f32(self._slots[ids])

    def tile_keys(self, queries, q_norms, start: int, tile: int, distance):
        slots = self._slots[start:start + tile]
        norms = torch.where(self._valid[start:start + tile],
                            self._view.norms_of(slots), float("inf"))
        return dist_ops.pairwise_keys(distance, queries, self._view.get(slots),
                                      vector_norms_sq=norms,
                                      query_norms_sq=q_norms)


def sharded_medioid(view: ShardedDataShard, slots: np.ndarray,
                    capacity: int, valid: Optional[np.ndarray] = None) -> int:
    """The slot of ``compute_medioid`` over the rows at ``slots`` (see
    :class:`_SlotRows`)."""
    return int(slots[compute_medioid(_SlotRows(view, slots, capacity,
                                               valid))])


# ---------------------------------------------------------------------------
# Data-sharded flat and IVF search
# ---------------------------------------------------------------------------

def sharded_flat_search(mesh: Mesh, data: ShardedDataShard,
                        queries: torch.Tensor, k: int, distance, *,
                        tile: int = 8192, axis: str = "shard"):
    """Exhaustive top-k over a row-sharded dataset (:func:`shard_dataset`):
    each shard runs ``flat_search_kernel`` over its rows (padded to a
    multiple of the tile, as ``FlatIndex`` pads a dataset), rows whose
    global id is past the live count masked, and the per-shard top-k are
    concatenated and merged.  Returns (B, k) keys and global ids on the
    lead device."""
    distance = dist_ops.as_distance(distance)
    if not isinstance(data, ShardedDataShard):
        data = shard_any_dataset(data, mesh, axis)
    local_cap = data.rows_per_shard
    eff_tile = min(dt.pad_to(tile, 128), dt.pad_to(local_cap, 128))
    kk = min(k, local_cap)
    keys_all, ids_all = [], []
    for s, (part, dev) in enumerate(zip(data.shards, data.layout.devices)):
        off = s * local_cap
        part = part.with_capacity(dt.pad_to(local_cap, eff_tile))
        local = torch.arange(part.capacity, device=dev)
        row_mask = (local < local_cap) & (local + off < data.n)
        keys, ids = flat_mod.flat_search_kernel(
            part, queries.to(dev), kk, eff_tile, distance, row_mask=row_mask)
        keys_all.append(keys.to(data.device))
        ids_all.append(torch.where(ids >= 0, ids + off, -1).to(data.device))
    return topk_ops.smallest_k(torch.cat(keys_all, 1), torch.cat(ids_all, 1),
                               k)


def sharded_ivf_search(mesh: Mesh, index, queries: torch.Tensor, k: int, *,
                       n_probes: int, axis: str = "shard", sub: int = 256):
    """IVF search with the probe units (centroid rows; chunked layouts have
    more than clusters) in contiguous blocks over a mesh axis.

    The centroid phase runs once on the lead device; each shard scans the
    probes it owns (``scan_padded_clusters``, on the super-row view of its
    own rows where ``ensure_scan_layout`` allows it), and the per-shard
    top-k are merged.  A shard owns ``ceil(units / S)`` units; the last
    ones own fewer, so nothing is padded.  ``index``: a single-device
    ``IVFIndex``; ``queries``: (B, d_pad) f32.  Returns (B, k) keys and
    original ids on the lead device."""
    from ..index.ivf.index import (_pick_subtile, _resolve_tiles_per_step,
                                   ensure_scan_layout, scan_padded_clusters)
    distance = index.distance
    devices = mesh.axis_devices(axis)
    lead = devices[0]
    slot = index.slot
    eff_sub = _pick_subtile(slot, sub)
    n_units = getattr(index, "num_probe_units", index.num_centroids)
    local_units = -(-n_units // len(devices))
    q = queries.to(lead).float()
    q_norms = q.square().sum(-1)
    ckeys = dist_ops.pairwise_keys(distance, q, index.centroids.to(lead),
                                   vector_norms_sq=index.centroid_norms.to(
                                       lead), query_norms_sq=q_norms)
    _, probes = topk_ops.smallest_k(ckeys, None, min(n_probes, n_units))
    keys_all, ids_all = [], []
    for s, dev in enumerate(devices):
        lo, hi = s * local_units, min((s + 1) * local_units, n_units)
        if hi <= lo:
            continue
        part = types.SimpleNamespace(
            data=_rows(index.data, lo * slot, hi * slot, dev),
            ids_padded=index.ids_padded[lo * slot:hi * slot].to(dev),
            slot=slot, _scan_sub=0, _scan_vecs=None, _scan_ids=None)
        use_scan = ensure_scan_layout(part, eff_sub)
        local = probes - lo
        mine = (probes >= 0) & (local >= 0) & (local < hi - lo)
        keys, ids = scan_padded_clusters(
            part.data, part.ids_padded, q.to(dev), q_norms.to(dev),
            torch.where(mine, local, 0).to(dev), mine.to(dev), keep=k,
            slot=slot, sub=eff_sub, distance=distance,
            scan_vecs=part._scan_vecs if use_scan else None,
            scan_ids=part._scan_ids if use_scan else None,
            tiles_per_step=_resolve_tiles_per_step(
                getattr(index, "scan_tiles_per_step", 0), slot // eff_sub,
                use_scan))
        keys_all.append(keys.to(lead))
        ids_all.append(ids.to(lead))
    return topk_ops.smallest_k(torch.cat(keys_all, 1), torch.cat(ids_all, 1),
                               k)


# ---------------------------------------------------------------------------
# Query-parallel (dp) search and build round
# ---------------------------------------------------------------------------

def _chunks(mesh: Mesh, axis: str, *tensors):
    """(device, chunk of each tensor) for the contiguous chunks of the
    tensors' rows along ``axis``'s devices; empty chunks are skipped."""
    devices = mesh.axis_devices(axis)
    splits = [torch.tensor_split(t, len(devices)) for t in tensors]
    for s, dev in enumerate(devices):
        parts = [sp[s].to(dev) for sp in splits]
        if parts[0].shape[0]:
            yield dev, parts


def dp_greedy_search(mesh: Mesh, graph: NeighborGraph, data,
                     queries: torch.Tensor, entry_ids: torch.Tensor, *,
                     window: int, capacity: int, max_iters: int, distance,
                     axis: str = "dp", sampler=None, n_entries: int = 1,
                     **search_kwargs) -> search_mod.SearchOutput:
    """Greedy search with the query batch split into contiguous chunks
    along ``axis`` and the index on every device of the axis: each chunk
    runs ``greedy_search`` with no collective, and the results are
    concatenated on the lead device (``n_iters`` is the largest chunk's).
    Queries are independent, so the result is one ``greedy_search`` over
    the whole batch, up to launch shapes that change a kernel's rounding.

    ``sampler``: optional ``EntrySampler``; each chunk selects its own
    queries' entries.  ``entry_ids`` (E,) or (B, E).  ``search_kwargs``
    go to ``greedy_search`` (``pool_size``, ``pop_width``, ...)."""
    distance = dist_ops.as_distance(distance)
    lead = mesh.axis_devices(axis)[0]
    per_query = entry_ids.ndim == 2
    outs = []
    for dev, (q, *rest) in _chunks(mesh, axis, queries,
                                   *([entry_ids] if per_query else [])):
        if sampler is not None:
            eids = _to(sampler, dev).select(distance, q, n_entries=n_entries)
        else:
            eids = rest[0] if per_query else entry_ids.to(dev)
        outs.append(search_mod.greedy_search(
            _to(graph, dev), _to(data, dev), q, eids, window=window,
            capacity=capacity, max_iters=max_iters, distance=distance,
            **search_kwargs))

    def cat(name):
        return torch.cat([getattr(o, name).to(lead) for o in outs])

    return search_mod.SearchOutput(
        ids=cat("ids"), keys=cat("keys"),
        n_iters=max(o.n_iters for o in outs), n_pops=cat("n_pops"),
        pool_ids=cat("pool_ids"), pool_keys=cat("pool_keys"))


def dp_build_round(mesh: Mesh, graph: NeighborGraph, data,
                   batch_ids: torch.Tensor, batch_valid: torch.Tensor,
                   entry_ids: torch.Tensor, sampler=None,
                   sample_invalid: Optional[torch.Tensor] = None, *,
                   axis: str = "dp", rev_alpha: float, prune_to: int,
                   **search_kwargs):
    """One Vamana build round with the node batch split along ``axis``:
    ``build.search_and_prune`` per chunk on its device, then
    ``build.commit_rows`` once over the whole batch on the lead device (its
    reverse-edge sort spans the batch).  ``search_kwargs`` are
    ``search_and_prune``'s (``window``, ``capacity``, ``max_iters``,
    ``distance``, ``pool_size``, ``gen_alpha``, ``max_degree``,
    ``prune_chunk``, ...).  Returns ``build_round``'s (graph, dropped),
    equal to it over the whole batch."""
    lead = mesh.axis_devices(axis)[0]
    rows, degs = [], []
    for dev, (ids,) in _chunks(mesh, axis, batch_ids):
        r, d = build_mod.search_and_prune(
            _to(graph, dev), _to(data, dev), ids, entry_ids.to(dev),
            _to(sampler, dev), _to(sample_invalid, dev), **search_kwargs)
        rows.append(r.to(lead))
        degs.append(d.to(lead))
    return build_mod.commit_rows(
        _to(graph, lead), _to(data, lead), batch_ids.to(lead),
        batch_valid.to(lead), torch.cat(rows), torch.cat(degs),
        rev_alpha=rev_alpha, prune_to=prune_to,
        distance=search_kwargs["distance"],
        max_degree=search_kwargs["max_degree"],
        prune_chunk=search_kwargs["prune_chunk"])


# ---------------------------------------------------------------------------
# Sharded-graph Vamana: graph rows and dataset rows behind shard views
# ---------------------------------------------------------------------------

def sharded_greedy_search(mesh: Mesh, graph, data, queries: torch.Tensor,
                          entry_ids: torch.Tensor, *, window: int,
                          capacity: int, max_iters: int, distance,
                          pool_size: int = 0, pop_width: int = 4,
                          axis: str = "shard", sampler=None,
                          n_entries: int = 1) -> search_mod.SearchOutput:
    """Greedy search over a row-sharded graph and dataset (queries and the
    beam on the lead device).  ``graph`` / ``data`` are shard views or
    single-device containers, sharded here (``VectorDataset`` of any
    element type, ``LVQDataset``, ``SQDataset``).  ``sampler``: optional
    ``EntrySampler``, small, kept on the lead device."""
    distance = dist_ops.as_distance(distance)
    if not isinstance(graph, ShardedGraphShard):
        graph = shard_graph(graph, mesh, axis)
    if not isinstance(data, ShardedDataShard):
        data = shard_any_dataset(data, mesh, axis)
    if sampler is not None:
        entry_ids = sampler.select(distance, queries, n_entries=n_entries)
    return search_mod.greedy_search(
        graph, data, queries, entry_ids, window=window, capacity=capacity,
        max_iters=max_iters, distance=distance, pool_size=pool_size,
        pop_width=pop_width)


def sharded_build_graph(mesh: Mesh, data, params, distance, *,
                        axis: str = "shard", batch_size=None,
                        prune_chunk: int = 128, pop_width: int = 4,
                        prune_pool: int = 0, tail_frac: int = 1,
                        first_pass_window=None, entry_point=None,
                        sampled_entries: bool = False,
                        entry_sample_size=None, logger=None):
    """Full Vamana build with graph rows and f32 rows sharded over ``axis``:
    ``build_graph``'s rounds over shard views.  ``data``: a path of a
    ``*vecs`` file (streamed in with :func:`shard_dataset_from_file`), a
    ``VectorDataset`` or an (n, d) array.  The medioid and the entry
    sample are drawn over the sharded rows, as the single-device build
    draws them over its own.  ``prune_pool`` / ``tail_frac`` /
    ``first_pass_window`` are ``build_graph``'s.  Returns
    (``NeighborGraph`` on the lead device, entry point)."""
    distance = dist_ops.as_distance(distance)
    lead = mesh.axis_devices(axis)[0]
    if isinstance(data, (str, os.PathLike)):
        view = shard_dataset_from_file(os.fspath(data), mesh, axis)
        capacity = dt.padded_count(view.n, torch.float32)
    else:
        if not isinstance(data, VectorDataset):
            data = VectorDataset.from_array(data, device=lead)
        capacity = data.capacity
        view = shard_dataset(data, mesh, axis)
    params = params.resolved(distance)
    n = view.n
    entry = entry_point if entry_point is not None else \
        sharded_medioid(view, np.arange(n), capacity)
    graph = shard_graph(NeighborGraph.empty(n, params.graph_max_degree,
                                            device=lead), mesh, axis)
    graph, entry = build_mod.build_graph(
        view, params, distance, entry_point=entry, batch_size=batch_size,
        prune_chunk=prune_chunk, pop_width=pop_width, prune_pool=prune_pool,
        tail_frac=tail_frac, first_pass_window=first_pass_window,
        sampled_entries=sampled_entries, entry_sample_size=entry_sample_size,
        logger=logger, graph=graph)
    out = graph.gather()
    cap = dt.pad_to(n, 8)
    return NeighborGraph(adjacency=out.adjacency[:cap],
                         degrees=out.degrees[:cap], n=n,
                         max_degree=out.max_degree), entry
