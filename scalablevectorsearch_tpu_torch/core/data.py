"""Device-resident vector dataset container.

PyTorch counterpart of ``scalablevectorsearch_tpu/core/data.py``: one padded
``(capacity, d_pad)`` tensor plus cached squared norms.  The padding rules
are the JAX package's (``lib.datatypes``), so shapes match across the two
packages; padding rows carry ``+inf`` norms so they lose every L2
comparison made through the norm-algebra distance path.  Row mutations
(``set_rows``, ``scatter_rows``, ``with_capacity``, for the dynamic
indexes) return a new dataset, as in the JAX package.

Checkpoints are the JAX package's: ``save`` / ``load`` and
``save_vectors_host`` write and read the same ``uncompressed_data`` table
and the same ``.npy`` bytes, so either package loads what the other saved.
A bfloat16 blob holds the raw 2-byte words under the ``'<V2'`` descr that
``np.save`` gives an ``ml_dtypes.bfloat16`` array (numpy here has no
bfloat16).
"""

from __future__ import annotations

import dataclasses
import json
import os
import uuid
from typing import Optional

import numpy as np
import torch

from ..lib import datatypes as dt
from ..lib import saveload


@dataclasses.dataclass
class VectorDataset:
    """Padded (capacity, d_pad) tensor + cached squared norms.

    ``vectors.shape[0]`` is the capacity; rows ``n:`` are zero padding.
    ``norms_sq`` is f32 (capacity,) with padding rows set to +inf.
    """

    vectors: torch.Tensor    # (capacity, d_pad)
    norms_sq: torch.Tensor   # (capacity,) float32
    n: int                   # live row count
    dim: int                 # logical feature dim

    # -- construction -------------------------------------------------------
    @classmethod
    def from_array(cls, x, dtype=None, capacity: Optional[int] = None,
                   device="cuda") -> "VectorDataset":
        x = dt.to_torch(x)
        if x.ndim != 2:
            raise ValueError(f"expected (n, dim) array, got shape "
                             f"{tuple(x.shape)}")
        n, dim = x.shape
        if dtype is None and x.dtype == torch.float64:
            dtype = torch.float32      # as JAX stores f64 input (x64 off)
        if dtype is not None:
            x = x.to(dt.torch_dtype(dtype))
        d_pad = dt.padded_dim(dim)
        cap = dt.padded_count(capacity if capacity is not None else n,
                              x.dtype)
        if cap < n:
            raise ValueError(f"capacity {cap} < n {n}")
        vectors = torch.zeros((cap, d_pad), dtype=x.dtype, device=device)
        vectors[:n, :dim] = x.to(device)
        return cls(vectors=vectors, norms_sq=_norms_sq(vectors, n),
                   n=n, dim=dim)

    @property
    def capacity(self) -> int:
        return self.vectors.shape[0]

    @property
    def padded_dim(self) -> int:
        return self.vectors.shape[1]

    @property
    def dtype(self) -> torch.dtype:
        return self.vectors.dtype

    @property
    def device(self) -> torch.device:
        return self.vectors.device

    # -- access --------------------------------------------------------------
    def get(self, ids: torch.Tensor) -> torch.Tensor:
        """Gather rows by id.  Ids are clamped to ``[0, capacity)`` as the
        JAX package's ``mode="clip"`` gather does (-1 reads row 0, where
        torch indexing would read the last row); callers mask the keys of
        invalid ids to +inf."""
        return self.vectors[ids.clamp(0, self.capacity - 1)]

    def get_f32(self, ids: torch.Tensor) -> torch.Tensor:
        return self.get(ids).float()

    def norms_of(self, ids: torch.Tensor) -> torch.Tensor:
        return self.norms_sq[ids.clamp(0, self.capacity - 1)]

    def to_numpy(self) -> np.ndarray:
        return dt.to_numpy(self.vectors[: self.n, : self.dim])

    def tile_keys(self, queries: torch.Tensor, q_norms: torch.Tensor,
                  start: int, tile: int, distance) -> torch.Tensor:
        """Distance keys between all queries and one dataset tile."""
        from ..ops import distance as dist_ops
        return dist_ops.pairwise_keys(
            distance, queries, self.vectors[start:start + tile],
            vector_norms_sq=self.norms_sq[start:start + tile],
            query_norms_sq=q_norms)

    # -- mutation (functional) --------------------------------------------------
    def _as_rows(self, rows) -> torch.Tensor:
        """Rows in this dataset's dtype and device, padded to ``padded_dim``
        columns."""
        rows = dt.to_torch(rows).to(device=self.device, dtype=self.dtype)
        if rows.shape[1] != self.padded_dim:
            rows = torch.nn.functional.pad(
                rows, (0, self.padded_dim - rows.shape[1]))
        return rows

    def set_rows(self, start: int, rows, new_n: Optional[int] = None
                 ) -> "VectorDataset":
        """Write ``rows`` at ``start`` (norms recomputed) into a new dataset.
        A block that would run past the capacity is moved back to end at
        it, as the JAX package's ``dynamic_update_slice`` does."""
        rows = self._as_rows(rows)
        start = max(0, min(start, self.capacity - rows.shape[0]))
        stop = start + rows.shape[0]
        vectors, norms = self.vectors.clone(), self.norms_sq.clone()
        vectors[start:stop] = rows
        norms[start:stop] = rows.float().square().sum(-1)
        return dataclasses.replace(self, vectors=vectors, norms_sq=norms,
                                   n=self.n if new_n is None else new_n)

    def scatter_rows(self, slots: torch.Tensor, rows,
                     new_n: Optional[int] = None) -> "VectorDataset":
        """Write ``rows`` at arbitrary ``slots`` into a new dataset (the
        dynamic index's add path); slots outside ``[0, capacity)`` are
        dropped into a sink row that is sliced off."""
        rows = self._as_rows(rows)
        slots = slots.to(self.device)
        idx = torch.where((slots >= 0) & (slots < self.capacity), slots,
                          self.capacity).long()
        vectors = torch.cat([self.vectors,
                             self.vectors.new_zeros((1, self.padded_dim))])
        vectors[idx] = rows
        norms = torch.cat([self.norms_sq, self.norms_sq.new_zeros(1)])
        norms[idx] = rows.float().square().sum(-1)
        return dataclasses.replace(self, vectors=vectors[:-1],
                                   norms_sq=norms[:-1],
                                   n=self.n if new_n is None else new_n)

    def with_capacity(self, capacity: int) -> "VectorDataset":
        """Grow (pad) the backing tensors to at least ``capacity`` rows."""
        cap = dt.padded_count(capacity, self.dtype)
        if cap <= self.capacity:
            return self
        grow = cap - self.capacity
        vectors = torch.cat([self.vectors, self.vectors.new_zeros(
            (grow, self.padded_dim))])
        norms = torch.cat([self.norms_sq, self.norms_sq.new_full(
            (grow,), float("inf"))])
        return dataclasses.replace(self, vectors=vectors, norms_sq=norms)

    # -- persistence -----------------------------------------------------------
    SCHEMA = "uncompressed_data"
    VERSION = saveload.Version(0, 0, 2)

    def save(self, ctx: saveload.SaveContext) -> dict:
        return _rows_table(ctx, self.vectors[: self.n, : self.dim])

    @classmethod
    def load(cls, table: dict, ctx: saveload.LoadContext, dtype=None,
             capacity: Optional[int] = None, device="cuda"
             ) -> "VectorDataset":
        saveload.check_table(table, cls.SCHEMA, cls.VERSION)
        x = dt.from_host_bits(ctx.load_array(table["binary_file"]),
                              table["eltype"])
        return cls.from_array(x, dtype=dtype or table["eltype"],
                              capacity=capacity, device=device)


def save_vectors_host(directory: str, rows, eltype=None) -> None:
    """Write a :class:`VectorDataset` checkpoint from (n, dim) host rows (a
    numpy array or a CPU tensor), stored as ``eltype`` if given: the format
    of :meth:`VectorDataset.save`, with no dataset on the device."""
    rows = dt.to_torch(rows)
    if eltype is not None:
        rows = rows.to(dt.torch_dtype(eltype))
    table = _rows_table(saveload.SaveContext(directory), rows)
    with open(os.path.join(directory, saveload.CONFIG_FILENAME), "w") as f:
        json.dump(table, f, indent=2)


def _rows_table(ctx: saveload.SaveContext, rows: torch.Tensor) -> dict:
    """Write (n, dim) rows as one blob and return the dataset's table."""
    host = dt.to_host_bits(rows)
    if rows.dtype == torch.bfloat16:
        # np.save would write the raw words under '|V2'; the JAX package's
        # ml_dtypes array gets '<V2', and the blobs must be byte-equal
        blob = uuid.uuid4().hex + ".npy"
        with open(ctx.resolve(blob), "wb") as f:
            np.lib.format.write_array_header_1_0(f, {
                "descr": "<V2", "fortran_order": False,
                "shape": host.shape})
            f.write(host.tobytes())
    else:
        blob = ctx.save_array(host)
    return saveload.save_table(VectorDataset.SCHEMA, VectorDataset.VERSION, {
        "name": "vector dataset",
        "binary_file": blob,
        "dims": int(rows.shape[1]),
        "num_vectors": int(rows.shape[0]),
        "eltype": dt.eltype_name(rows.dtype),
    })


def _norms_sq(vectors: torch.Tensor, n: int) -> torch.Tensor:
    """Row norms in f32 with +inf on padding rows."""
    norms = vectors.float().square().sum(-1)
    norms[n:] = float("inf")
    return norms
