"""Clustering container: centroids + per-point assignments.

PyTorch counterpart of ``scalablevectorsearch_tpu/index/ivf/clustering.py``
(the reference's ``Clustering``, ``include/svs/index/ivf/clustering.h:85``):
the saveable intermediate between k-means training and index assembly.
Centroids and assignments live on the host as numpy arrays; the checkpoint
table is the JAX package's (``ivf_clustering`` v0.0.1), so a clustering
either package saved loads in the other.  :func:`pack_padded_clusters` is a
copy of the JAX package's numpy function.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ...lib import datatypes as dt
from ...lib import saveload
from .kmeans import train_clustering
from .params import IVFBuildParameters


@dataclasses.dataclass
class Clustering:
    centroids: np.ndarray     # (K, d) float32
    assignments: np.ndarray   # (n,) int32

    SCHEMA = "ivf_clustering"
    VERSION = saveload.Version(0, 0, 1)

    @classmethod
    def build(cls, parameters: IVFBuildParameters, data,
              device="cuda") -> "Clustering":
        """Train k-means over the data on ``device`` (reference
        build_clustering)."""
        x = data.to_numpy() if hasattr(data, "to_numpy") else np.asarray(data)
        centroids, assignments = train_clustering(x, parameters,
                                                  device=device)
        return cls(centroids=centroids, assignments=assignments)

    @property
    def num_centroids(self) -> int:
        return self.centroids.shape[0]

    def cluster_sizes(self) -> np.ndarray:
        return np.bincount(self.assignments, minlength=self.num_centroids)

    def save(self, ctx: saveload.SaveContext) -> dict:
        return saveload.save_table(self.SCHEMA, self.VERSION, {
            "name": "ivf clustering",
            "centroids": ctx.save_array(self.centroids),
            "assignments": ctx.save_array(self.assignments),
            "num_centroids": self.num_centroids,
        })

    @classmethod
    def load(cls, table: dict, ctx: saveload.LoadContext) -> "Clustering":
        saveload.check_table(table, cls.SCHEMA, cls.VERSION)
        return cls(centroids=ctx.load_array(table["centroids"]),
                   assignments=ctx.load_array(table["assignments"]))


def pack_padded_clusters(x: np.ndarray, assignments: np.ndarray, k: int,
                         align: int = 8, slot_cap: int = 0):
    """Pack rows into the uniform padded-cluster layout (the
    DenseClusteredDataset analog, reference ivf/clustering.h:314): probe
    unit p owns rows [p*slot, (p+1)*slot).

    ``slot_cap`` > 0 bounds the per-unit slot size by chunking oversized
    clusters: a cluster of size s becomes ceil(s/slot) probe units that all
    carry its centroid (``owners``), so the layout holds at most
    n + units*slot rows whatever the skew, where the uncapped layout holds
    k * (largest cluster).

    Returns (rows (U*slot, d), ids_padded (U*slot,) int32 with -1 padding,
    slot, owners (U,) int32 mapping probe unit -> original cluster).
    """
    assignments = np.asarray(assignments)
    n = assignments.shape[0]
    sizes = np.bincount(assignments, minlength=k)
    slot = int(dt.pad_to(max(int(sizes.max()), 1), align))
    if slot_cap > 0:
        slot = min(slot, int(dt.pad_to(max(slot_cap, 1), align)))
    order = np.argsort(assignments, kind="stable")
    sorted_assign = assignments[order]
    starts = np.zeros(k, dtype=np.int64)
    np.cumsum(sizes[:-1], out=starts[1:])
    rank = np.arange(n, dtype=np.int64) - starts[sorted_assign]
    chunks_per = np.maximum(-(-sizes // slot), 1)        # >= 1 per cluster
    chunk_base = np.zeros(k, dtype=np.int64)
    np.cumsum(chunks_per[:-1], out=chunk_base[1:])
    unit = chunk_base[sorted_assign] + rank // slot
    u = int(chunks_per.sum())
    pos = unit * slot + rank % slot
    ids_padded = np.full(u * slot, -1, dtype=np.int32)
    ids_padded[pos] = order
    rows = np.zeros((u * slot, x.shape[1]), dtype=x.dtype)
    rows[pos] = x[order]
    owners = np.repeat(np.arange(k, dtype=np.int32), chunks_per)
    return rows, ids_padded, slot, owners
