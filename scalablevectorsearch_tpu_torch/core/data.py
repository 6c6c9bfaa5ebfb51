"""Device-resident vector dataset container.

PyTorch counterpart of ``scalablevectorsearch_tpu/core/data.py``: one padded
``(capacity, d_pad)`` tensor plus cached squared norms.  The padding rules
are the JAX package's (``lib.datatypes``), so shapes match across the two
packages; padding rows carry ``+inf`` norms so they lose every L2
comparison made through the norm-algebra distance path.

Save/load of datasets is not part of this package yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..lib import datatypes as dt


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


def _norms_sq(vectors: torch.Tensor, n: int) -> torch.Tensor:
    """Row norms in f32 with +inf on padding rows."""
    norms = vectors.float().square().sum(-1)
    norms[n:] = float("inf")
    return norms
