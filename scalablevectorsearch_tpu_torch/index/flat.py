"""Brute-force (flat) exhaustive search index.

PyTorch counterpart of ``scalablevectorsearch_tpu/index/flat.py``: each
dataset tile is one distance matmul, and a running (B, k) top-k state is
merged tile by tile.  This is the ground-truth engine that recall checks
are held against.  ``save`` / ``assemble`` write and read the JAX
package's checkpoint (``flat_config.json`` beside the dataset's table).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np
import torch

from ..core.data import VectorDataset
from ..core.query_result import QueryResult
from ..lib import datatypes as dt
from ..lib import saveload
from ..ops import distance as dist_ops
from ..ops import topk as topk_ops


def flat_search_kernel(data, queries: torch.Tensor, k: int,
                       tile: int, distance: dist_ops.DistanceType,
                       row_mask: Optional[torch.Tensor] = None):
    """Streaming exhaustive top-k over dataset tiles.

    Args:
      data: dataset-protocol object (``VectorDataset``, ``SQDataset``,
        ``LVQDataset``) whose capacity is a multiple of ``tile``; SQ and
        LVQ score each tile in the code domain (their ``tile_keys``).
      queries: (B, d_pad) tensor on the dataset's device.
      row_mask: optional (capacity,) bool; False rows are excluded.

    Returns: keys (B, k) ascending, ids (B, k) int32 (-1 for missing).
    """
    capacity = data.capacity
    if capacity % tile:
        raise ValueError("dataset capacity must be a tile multiple")
    b = queries.shape[0]
    device = queries.device
    q_norms = queries.float().square().sum(-1)
    best_keys = torch.full((b, k), float("inf"), device=device)
    best_ids = torch.full((b, k), topk_ops.INVALID_ID, dtype=torch.int32,
                          device=device)
    for start in range(0, capacity, tile):
        keys = data.tile_keys(queries, q_norms, start, tile, distance)
        ids = start + torch.arange(tile, dtype=torch.int32, device=device)
        keys = torch.where((ids < data.n)[None, :], keys, float("inf"))
        if row_mask is not None:
            keys = torch.where(row_mask[start:start + tile][None, :], keys,
                               float("inf"))
        tile_keys, tile_ids = topk_ops.smallest_k(keys, ids, min(k, tile))
        best_keys, best_ids = topk_ops.merge_smallest(
            best_keys, best_ids, tile_keys, tile_ids, k)
    return best_keys, best_ids


@dataclasses.dataclass
class FlatIndex:
    """Exhaustive index over a device dataset (reference: flat.h:159): any
    object with the dataset protocol (``tile_keys``, ``with_capacity``,
    ``n`` / ``dim`` / ``capacity`` / ``padded_dim`` / ``device``)."""

    data: object
    distance: dist_ops.DistanceType
    data_batch_size: int = 32768
    query_batch_size: int = 512

    def __post_init__(self):
        self.distance = dist_ops.as_distance(self.distance)
        if not (hasattr(self.data, "tile_keys")
                and hasattr(self.data, "with_capacity")):
            raise TypeError(f"FlatIndex: {type(self.data).__name__} does not "
                            "implement the dataset protocol (tile_keys, "
                            "with_capacity)")
        tile = min(dt.pad_to(self.data_batch_size, 128),
                   dt.pad_to(self.data.capacity, 128))
        # capacity must be a multiple of the tile for clamp-free slicing
        self.data = self.data.with_capacity(dt.pad_to(self.data.capacity,
                                                      tile))
        self._tile = tile

    @classmethod
    def from_array(cls, x, distance="L2", dtype=None, device="cuda",
                   **kwargs) -> "FlatIndex":
        return cls(VectorDataset.from_array(x, dtype=dtype, device=device),
                   dist_ops.as_distance(distance), **kwargs)

    @property
    def size(self) -> int:
        return self.data.n

    @property
    def dimensions(self) -> int:
        return self.data.dim

    def search(self, queries, k: int, row_mask=None,
               cancel=None) -> QueryResult:
        return self.search_async(queries, k, row_mask=row_mask,
                                 cancel=cancel).result()

    def search_async(self, queries, k: int, row_mask=None, cancel=None):
        """Dispatch every query batch and start the copies back; see
        ``VamanaIndex.search_async``.  Queries stay f32: ground truths must
        not carry the half-width upload rounding of the ANN paths."""
        from ..lib.exceptions import check_cancel
        from .vamana.index import PendingSearch, _BatchPlan
        queries = np.asarray(queries)
        nq, dim = queries.shape
        if dim != self.data.dim:
            raise ValueError(
                f"query dim {dim} != dataset dim {self.data.dim}")
        plan = _BatchPlan.plan(nq, self.query_batch_size)
        device = self.data.device
        mask_dev = None if row_mask is None else \
            torch.as_tensor(row_mask, device=device)
        q_host = torch.from_numpy(dt.pad_matrix(
            queries.astype(np.float32), n_pad=plan.rows * plan.n_batches,
            d_pad=self.data.padded_dim))
        pending = PendingSearch(rows=plan.rows, nq=nq,
                                out_ids=np.empty((nq, k), dtype=np.int64),
                                out_vals=np.empty((nq, k), dtype=np.float32))
        for i in range(plan.n_batches):
            check_cancel(cancel)
            q_i = q_host[i * plan.rows:(i + 1) * plan.rows].to(device)
            keys, ids = flat_search_kernel(self.data, q_i, k, self._tile,
                                           self.distance, row_mask=mask_dev)
            pending.add(i * plan.rows, ids,
                        dist_ops.value_from_key(self.distance, keys))
        return pending.dispatched()

    # -- persistence -----------------------------------------------------------
    SCHEMA = "flat_index"
    VERSION = saveload.Version(0, 0, 1)

    def save(self, config_dir: str, data_dir: Optional[str] = None) -> None:
        data_dir = data_dir or config_dir
        saveload.save_to_disk(self.data, data_dir)
        os.makedirs(config_dir, exist_ok=True)
        table = saveload.save_table(self.SCHEMA, self.VERSION, {
            "distance": self.distance.value,
        })
        with open(os.path.join(config_dir, "flat_config.json"), "w") as f:
            json.dump(table, f, indent=2)

    @classmethod
    def assemble(cls, config_dir: str, data_dir: Optional[str] = None,
                 device="cuda", **kwargs) -> "FlatIndex":
        data_dir = data_dir or config_dir
        with open(os.path.join(config_dir, "flat_config.json")) as f:
            table = json.load(f)
        saveload.check_table(table, cls.SCHEMA, cls.VERSION)
        data = saveload.load_from_disk(VectorDataset, data_dir, device=device)
        return cls(data, dist_ops.as_distance(table["distance"]), **kwargs)


def exhaustive_search(x, queries, k: int, distance="L2",
                      device="cuda") -> QueryResult:
    """One-shot ground-truth computation (benchmark/test helper); ``x`` is
    an (n, d) array or a dataset (``SQDataset``, ``LVQDataset``, which keep
    their own device)."""
    if hasattr(x, "tile_keys"):
        return FlatIndex(x, dist_ops.as_distance(distance)).search(queries, k)
    return FlatIndex.from_array(x, distance=distance,
                                device=device).search(queries, k)
