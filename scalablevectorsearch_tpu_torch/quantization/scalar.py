"""Global scalar quantization (SQ).

PyTorch counterpart of ``scalablevectorsearch_tpu/quantization/scalar.py``:
int8 (or uint8 / int16) codes with one global ``scale`` / ``bias`` pair
fitted to the dataset's min and max, ``x ≈ codes * scale + bias``.  The
quantization is the JAX package's numpy code, copied, so both packages
store identical codes, scale, bias, norms and code sums.

Graph search and build score decoded rows (``get``: dead columns zero);
flat scans score in the code domain (``tile_keys``): with
``x̂ = s·x' + b`` over the ``dim`` live columns and the query quantized
alike,

    <q̂, x̂> = s² <q', x'> + s·b (Σq' + Σx') + dim · b².

The JAX package accumulates 8-bit code products in int32, which is exact.
Here they go through an f32 matmul at full f32 precision (TF32 off), which
is exact while every partial sum stays below 2^24: the contraction runs in
blocks of 256 columns (255² · 256 < 2^24), and the blocks' exact sums add
up in int32, so the result equals the JAX package's at any width.  int16
codes take an f32 matmul, as in the JAX package.

``SQDataset`` follows the dataset protocol of ``core.data.VectorDataset``
(get / get_f32 / norms_sq / norms_of / tile_keys / with_capacity), so the
flat and Vamana indexes take it as they take a ``VectorDataset``.
``save`` / ``load`` write and read the JAX package's ``sq_dataset``
checkpoint (codes ``[:n, :dim]``, eltype, scale, bias).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..lib import datatypes as dt
from ..lib import saveload

_CODE_DTYPES = (np.dtype(np.int8), np.dtype(np.uint8), np.dtype(np.int16))
_EXACT_BLOCK = 256     # columns per exact f32 block of 8-bit code products


@dataclasses.dataclass
class SQDataset:
    """Scalar-quantized dataset: codes + global (scale, bias).

    ``norms_sq`` holds the reconstructed rows' squared norms (f32, +inf on
    padding rows); ``code_sums`` the per-row Σcodes (f32) for the code
    domain's correction terms.  ``scale`` and ``bias`` are f32 values held
    as Python floats.
    """

    codes: torch.Tensor      # (capacity, d_pad) int8 / uint8 / int16
    norms_sq: torch.Tensor   # (capacity,) f32
    code_sums: torch.Tensor  # (capacity,) f32
    scale: float
    bias: float
    n: int
    dim: int

    # -- construction -------------------------------------------------------
    @classmethod
    def compress(cls, x, dtype=torch.int8, capacity: Optional[int] = None,
                 device="cuda") -> "SQDataset":
        """Fit the global min/max and quantize: codes ``round((x - bias) /
        scale)`` clamped to the dtype's range, with ``scale = (max - min) /
        (2^bits - 1)`` and ``bias`` centering the codes in that range."""
        x = np.asarray(x, dtype=np.float32)
        np_dtype = dt.numpy_dtype(dtype)
        if np_dtype not in _CODE_DTYPES:
            raise ValueError(
                f"SQ codes must be int8/uint8/int16, got {np_dtype}")
        info = np.iinfo(np_dtype)
        lo, hi = float(x.min()), float(x.max())
        levels = float(info.max - info.min)
        scale = max((hi - lo) / levels, 1e-12)
        bias = lo - info.min * scale        # code info.min decodes to `lo`
        codes = np.clip(np.rint((x - bias) / scale),
                        info.min, info.max).astype(np_dtype)
        return cls.from_codes(codes, scale, bias, capacity=capacity,
                              device=device)

    @classmethod
    def from_codes(cls, codes, scale: float, bias: float, *,
                   capacity: Optional[int] = None,
                   device="cuda") -> "SQDataset":
        """Assemble a dataset from (n, dim) host codes and the global scale
        and bias: the codes are padded, and the norms and code sums computed
        on the host, as ``compress`` computes them."""
        codes = np.asarray(codes)
        if codes.dtype not in _CODE_DTYPES:
            raise ValueError(
                f"SQ codes must be int8/uint8/int16, got {codes.dtype}")
        n, dim = codes.shape
        d_pad = dt.padded_dim(dim)
        cap = dt.pad_to(capacity if capacity is not None else n, 32)
        if cap < n:
            raise ValueError(f"capacity {cap} < n {n}")
        host = np.zeros((cap, d_pad), dtype=codes.dtype)
        host[:n, :dim] = codes
        # padding columns decode to `bias`, not 0: only the first `dim`
        # columns are live in the norms and sums
        recon = codes.astype(np.float32) * scale + bias
        norms = np.full((cap,), np.inf, dtype=np.float32)
        norms[:n] = (recon ** 2).sum(axis=1)
        sums = np.zeros((cap,), dtype=np.float32)
        sums[:n] = codes.astype(np.float32).sum(axis=1)
        return cls(codes=torch.from_numpy(host).to(device),
                   norms_sq=torch.from_numpy(norms).to(device),
                   code_sums=torch.from_numpy(sums).to(device),
                   scale=float(np.float32(scale)),
                   bias=float(np.float32(bias)), n=n, dim=dim)

    # -- dataset protocol -----------------------------------------------------
    @property
    def capacity(self) -> int:
        return self.codes.shape[0]

    @property
    def padded_dim(self) -> int:
        return self.codes.shape[1]

    @property
    def dtype(self) -> torch.dtype:
        return self.codes.dtype

    @property
    def device(self) -> torch.device:
        return self.codes.device

    def _live(self) -> torch.Tensor:
        return torch.arange(self.padded_dim, device=self.device) < self.dim

    def _decode(self, codes: torch.Tensor) -> torch.Tensor:
        return torch.where(self._live(),
                           codes.to(torch.float32) * self.scale + self.bias,
                           0.0)

    @property
    def vectors(self) -> torch.Tensor:
        """The decoded padded matrix (f32, dead columns zero).  Builds the
        whole decode: for packing neighbourhoods and small datasets; the
        search and build paths decode per gather (:meth:`get`)."""
        return self._decode(self.codes)

    def get(self, ids: torch.Tensor) -> torch.Tensor:
        """Decoded rows (f32) by id, ids clamped to ``[0, capacity)``: what
        graph search and build score against."""
        return self._decode(self.codes[ids.clamp(0, self.capacity - 1)])

    def get_f32(self, ids: torch.Tensor) -> torch.Tensor:
        return self.get(ids)

    def norms_of(self, ids: torch.Tensor) -> torch.Tensor:
        return self.norms_sq[ids.clamp(0, self.capacity - 1)]

    def to_numpy(self) -> np.ndarray:
        """Reconstructed rows (n, dim)."""
        codes = dt.to_numpy(self.codes[: self.n, : self.dim])
        return codes.astype(np.float32) * self.scale + self.bias

    def decompress(self, ids) -> np.ndarray:
        rows = dt.to_numpy(self.codes)[np.asarray(ids)][..., : self.dim]
        return rows.astype(np.float32) * self.scale + self.bias

    def with_capacity(self, capacity: int) -> "SQDataset":
        cap = dt.pad_to(capacity, 32)
        if cap <= self.capacity:
            return self
        g = cap - self.capacity
        return dataclasses.replace(
            self,
            codes=torch.cat([self.codes, self.codes.new_zeros(
                (g, self.padded_dim))]),
            norms_sq=torch.cat([self.norms_sq, self.norms_sq.new_full(
                (g,), float("inf"))]),
            code_sums=torch.cat([self.code_sums,
                                 self.code_sums.new_zeros((g,))]))

    def quantize_queries(self, queries: torch.Tensor) -> torch.Tensor:
        """f32 queries into the code domain; dead columns map to 0."""
        info = np.iinfo(dt.numpy_dtype(self.dtype))
        q = torch.round((queries.float() - self.bias) / self.scale)
        q = q.clamp(info.min, info.max)
        return torch.where(self._live(), q, 0.0).to(self.dtype)

    def tile_keys(self, queries: torch.Tensor, q_norms: torch.Tensor,
                  start: int, tile: int, distance) -> torch.Tensor:
        """Keys between all queries and one tile of rows, in the code
        domain (no decode)."""
        from ..ops import distance as dist_ops
        distance = dist_ops.as_distance(distance)
        xs = self.codes[start:start + tile]
        ns = self.norms_sq[start:start + tile]
        xsums = self.code_sums[start:start + tile]
        qc = self.quantize_queries(queries)
        qf = qc.to(torch.float32)
        qsums = qf.sum(-1)
        dots_i = _code_dots(qf, xs)
        # the scalar products in f32, as the JAX package forms them
        s, b = np.float32(self.scale), np.float32(self.bias)
        ss, sb = float(s * s), float(s * b)
        dbb = float(np.float32(self.dim) * b * b)
        dots = ss * dots_i + sb * (qsums[:, None] + xsums[None, :]) + dbb
        pad = torch.where(torch.isinf(ns), float("inf"), 0.0)[None, :]
        if distance == dist_ops.DistanceType.MIP:
            return -dots + pad
        if distance == dist_ops.DistanceType.L2:
            # the reconstructed query's norm keeps the ranking exact in the
            # code domain
            qrn = ss * qf.square().sum(-1) + (2.0 * sb) * qsums + dbb
            keys = qrn[:, None] - 2.0 * dots + ns[None, :]
            return keys.clamp_min(0.0) + pad
        denom = q_norms[:, None].clamp_min(1e-30).sqrt() * \
            torch.where(torch.isinf(ns), 1.0, ns).sqrt()[None, :]
        return -dots / denom + pad

    def max_abs_error(self) -> float:
        return self.scale / 2.0

    # -- persistence ------------------------------------------------------------
    SCHEMA = "sq_dataset"
    VERSION = saveload.Version(0, 0, 1)

    def save(self, ctx: saveload.SaveContext) -> dict:
        blob = ctx.save_array(self.codes[: self.n, : self.dim].cpu().numpy())
        return saveload.save_table(self.SCHEMA, self.VERSION, {
            "name": "scalar quantized dataset",
            "binary_file": blob,
            "dims": self.dim,
            "num_vectors": self.n,
            "eltype": dt.eltype_name(self.dtype),
            "scale": self.scale,
            "bias": self.bias,
        })

    @classmethod
    def load(cls, table: dict, ctx: saveload.LoadContext, device="cuda",
             **_) -> "SQDataset":
        """Through :meth:`from_codes`, so the capacity is ``pad_to(n, 32)``
        as in the JAX package."""
        saveload.check_table(table, cls.SCHEMA, cls.VERSION)
        eltype = np.dtype(table.get("eltype", "int8"))
        codes = ctx.load_array(table["binary_file"]).astype(eltype)
        return cls.from_codes(codes, table["scale"], table["bias"],
                              device=device)


def _code_dots(qf: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """(B, d) quantized queries (as f32) x (T, d) codes -> (B, T) f32 dot
    products, exact for 8-bit codes (blocks of 256 columns, each an exact
    f32 matmul, summed in int32)."""
    from ..ops.distance import HIGHEST, matmul_precision
    with matmul_precision(HIGHEST):
        if xs.dtype == torch.int16:
            return qf @ xs.to(torch.float32).T
        total = None
        for c0 in range(0, xs.shape[1], _EXACT_BLOCK):
            part = qf[:, c0:c0 + _EXACT_BLOCK] @ \
                xs[:, c0:c0 + _EXACT_BLOCK].to(torch.float32).T
            part = part.to(torch.int32)
            total = part if total is None else total + part
        return total.to(torch.float32)
