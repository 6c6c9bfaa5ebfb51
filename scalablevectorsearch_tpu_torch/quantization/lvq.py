"""LVQ-style per-vector quantization (one- and two-level, 4/8-bit).

PyTorch counterpart of ``scalablevectorsearch_tpu/quantization/lvq.py``.

**Level 1** (``bits`` in {4, 8}): remove the dataset mean, then quantize
each vector with its own (scale, bias) fitted to the row min/max:

    x1 = mean + bias_i + scale_i * c_i

**Level 2** (``residual_bits`` in {0, 4, 8}): the residual x - x1 is
quantized symmetrically with a second per-vector scale:

    x2 = x1 + scale2_i * c2_i

Graph traversal and flat scans use the primary level only; ``full_view()``
exposes the two-level reconstruction for reranking.  4-bit codes are
packed two per byte.  The quantization itself is the JAX package's numpy
code, copied, so both packages store identical codes, scales, biases, mean
and norms.  Flat scans score in the code domain:

    <q, x1> = <q, mean> + bias_i * sum(q) + scale_i * <q, c_i>

with ``<q, c_i>`` a product of bf16-rounded queries and codes accumulated
in f32.

``LVQDataset`` follows the dataset protocol of ``core.data.VectorDataset``
(get / get_f32 / norms_sq / norms_of / tile_keys / with_capacity), so the
flat and Vamana indexes take it as they take a ``VectorDataset``.
``save`` / ``load`` and ``compress_and_save_host`` write and read the JAX
package's ``lvq_dataset`` checkpoint.  Loading goes through
``from_codes``, which recomputes the reconstruction norms on the host in
float64 as ``compress`` does, so a saved dataset loads back bit for bit;
the JAX package recomputes them in f32 on its device (within 1e-6).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..lib import datatypes as dt
from ..lib import saveload


def _pack4(codes: np.ndarray) -> np.ndarray:
    """Pack signed 4-bit values [-8, 7] two per int8 byte (lo, hi)."""
    u = codes.astype(np.int16) & 0xF
    lo, hi = u[:, 0::2], u[:, 1::2]
    return (lo | (hi << 4)).astype(np.uint8).view(np.int8)


def _unpack4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_pack4`: (..., w) int8 -> (..., 2w) int8 in
    [-8, 7]."""
    u = packed.to(torch.int32) & 0xFF
    lo = u & 0xF
    hi = (u >> 4) & 0xF
    lo = lo - 16 * (lo > 7).to(torch.int32)
    hi = hi - 16 * (hi > 7).to(torch.int32)
    out = torch.stack([lo, hi], dim=-1)
    return out.reshape(*packed.shape[:-1],
                       packed.shape[-1] * 2).to(torch.int8)


def _live(d_pad: int, dim: int, device) -> torch.Tensor:
    return (torch.arange(d_pad, device=device) < dim).to(torch.float32)


def affine_decode(codes, scales, biases, mean, *, bits: int, dim: int):
    """The single exact LVQ primary reconstruction
    ``(mean + bias + scale * code) * live``, shared by ``LVQDataset.get``
    and the packed neighbourhoods so that both decode alike.

    ``codes``: (..., w1) stored codes (packed nibbles when bits == 4);
    ``scales`` / ``biases``: (...,) per-vector constants; ``mean``:
    (d_pad,).
    """
    if bits == 4:
        codes = _unpack4(codes)
    live = _live(codes.shape[-1], dim, codes.device)
    return (mean + biases[..., None]
            + scales[..., None] * codes.to(torch.float32)) * live


def _quantize_primary(resid: np.ndarray, bits: int):
    """Per-row min/max fit: returns (codes int8 signed, scales, biases)."""
    levels = (1 << bits) - 1
    half = 1 << (bits - 1)
    lo = resid.min(axis=1)
    hi = resid.max(axis=1)
    scales = np.maximum((hi - lo) / levels, 1e-12)
    biases = lo + half * scales
    codes = np.clip(np.rint((resid - biases[:, None]) / scales[:, None]),
                    -half, half - 1).astype(np.int8)
    return codes, scales.astype(np.float32), biases.astype(np.float32)


def _quantize_residual(resid: np.ndarray, bits: int):
    """Symmetric per-row fit for the second level."""
    half = 1 << (bits - 1)
    scales = np.maximum(np.abs(resid).max(axis=1) / (half - 0.5), 1e-12)
    codes = np.clip(np.rint(resid / scales[:, None]),
                    -half, half - 1).astype(np.int8)
    return codes, scales.astype(np.float32)


@dataclasses.dataclass
class LVQDataset:
    codes: torch.Tensor      # (capacity, w1) int8; w1 = d_pad / (8 // bits)
    scales: torch.Tensor     # (capacity,) f32 level-1 scale
    biases: torch.Tensor     # (capacity,) f32 level-1 bias
    mean: torch.Tensor       # (d_pad,) f32 dataset mean (0 in dead columns)
    norms_sq: torch.Tensor   # (capacity,) f32 level-1 recon norms, +inf pad
    res_codes: torch.Tensor  # (capacity, w2) int8; (capacity, 0) if absent
    res_scales: torch.Tensor  # (capacity,) f32 level-2 scale (1.0 if absent)
    full_norms_sq: torch.Tensor  # (capacity,) f32 two-level recon norms
    n: int
    dim: int
    bits: int                # 4 or 8
    residual_bits: int       # 0, 4 or 8

    # -- construction ---------------------------------------------------------
    @classmethod
    def compress(cls, x, bits: int = 8, residual_bits: int = 0,
                 capacity: Optional[int] = None,
                 device="cuda", mean=None) -> "LVQDataset":
        """Fit mean + per-vector (scale, bias) at ``bits``; optionally add a
        ``residual_bits`` second level.  ``mean``: the (dim,) f32 mean to
        remove instead of ``x``'s own (a block of rows of a larger
        array)."""
        _check_bits(bits, residual_bits)
        x = np.asarray(x, dtype=np.float32)
        mean = x.mean(axis=0) if mean is None else \
            np.asarray(mean, dtype=np.float32)
        codes, scales, biases = _quantize_primary(x - mean, bits)
        res_codes = res_scales = None
        if residual_bits:
            recon1 = mean + biases[:, None] + scales[:, None] * \
                codes.astype(np.float32)
            res_codes, res_scales = _quantize_residual(x - recon1,
                                                       residual_bits)
        return cls.from_codes(codes, scales, biases, mean, bits=bits,
                              residual_bits=residual_bits,
                              res_codes=res_codes, res_scales=res_scales,
                              capacity=capacity, device=device)

    @classmethod
    def from_codes(cls, codes, scales, biases, mean, *, bits: int,
                   residual_bits: int = 0, res_codes=None, res_scales=None,
                   capacity: Optional[int] = None,
                   device="cuda") -> "LVQDataset":
        """Assemble a dataset from unpacked host codes: ``codes`` (n, dim)
        int8, ``scales`` / ``biases`` (n,), ``mean`` (dim,), and for a second
        level ``res_codes`` (n, dim) / ``res_scales`` (n,).  Codes are padded
        (and nibble-packed at 4 bits) as ``compress`` stores them, and the
        reconstruction norms are computed on the host in float64 as
        ``compress`` computes them."""
        _check_bits(bits, residual_bits)
        codes = np.asarray(codes, dtype=np.int8)
        scales = np.asarray(scales, dtype=np.float32)
        biases = np.asarray(biases, dtype=np.float32)
        mean = np.asarray(mean, dtype=np.float32)
        n, dim = codes.shape
        d_pad = dt.padded_dim(dim)
        cap = dt.pad_to(capacity if capacity is not None else n, 32)
        if cap < n:
            raise ValueError(f"capacity {cap} < n {n}")

        def host_codes(c, b):
            out = np.zeros((cap, d_pad // (8 // b)), dtype=np.int8)
            padded = np.zeros((n, d_pad), dtype=np.int8)
            padded[:, :dim] = c
            out[:n] = _pack4(padded) if b == 4 else padded
            return torch.from_numpy(out).to(device)

        recon1 = mean + biases[:, None] + scales[:, None] * \
            codes.astype(np.float32)
        if residual_bits:
            res_scales = np.asarray(res_scales, dtype=np.float32)
            recon2 = recon1 + res_scales[:, None] * \
                np.asarray(res_codes, dtype=np.int8).astype(np.float32)
            res_t = host_codes(np.asarray(res_codes, np.int8), residual_bits)
        else:
            res_scales = np.ones(n, np.float32)
            recon2 = recon1
            res_t = torch.zeros((cap, 0), dtype=torch.int8, device=device)

        mean_pad = np.zeros(d_pad, dtype=np.float32)
        mean_pad[:dim] = mean

        def pad1(a, fill=0.0):
            out = np.full(cap, fill, dtype=np.float32)
            out[:n] = a
            return torch.from_numpy(out).to(device)

        norms = np.full(cap, np.inf, dtype=np.float32)
        norms[:n] = (recon1.astype(np.float64) ** 2).sum(1)
        fnorms = np.full(cap, np.inf, dtype=np.float32)
        fnorms[:n] = (recon2.astype(np.float64) ** 2).sum(1)
        return cls(codes=host_codes(codes, bits), scales=pad1(scales, 1.0),
                   biases=pad1(biases),
                   mean=torch.from_numpy(mean_pad).to(device),
                   norms_sq=torch.from_numpy(norms).to(device),
                   res_codes=res_t, res_scales=pad1(res_scales, 1.0),
                   full_norms_sq=torch.from_numpy(fnorms).to(device),
                   n=n, dim=dim, bits=bits, residual_bits=residual_bits)

    @property
    def kind(self) -> str:
        """The reference's ``StorageKind`` name."""
        if self.residual_bits:
            return f"LVQ{self.bits}x{self.residual_bits}"
        return f"LVQ{self.bits}"

    # -- dataset protocol -----------------------------------------------------
    @property
    def capacity(self) -> int:
        return self.codes.shape[0]

    @property
    def padded_dim(self) -> int:
        return self.codes.shape[1] * (8 // self.bits)

    @property
    def dtype(self) -> torch.dtype:
        return self.codes.dtype

    @property
    def device(self) -> torch.device:
        return self.codes.device

    def _clip(self, ids: torch.Tensor) -> torch.Tensor:
        """Ids clamped to ``[0, capacity)``, as the JAX package's
        ``mode="clip"`` gathers read."""
        return ids.clamp(0, self.capacity - 1)

    def get(self, ids: torch.Tensor) -> torch.Tensor:
        """Decoded rows (f32), primary level only: what graph traversal
        scores against.  :meth:`get_full` adds the second level."""
        ids = self._clip(ids)
        return affine_decode(self.codes[ids], self.scales[ids],
                             self.biases[ids], self.mean, bits=self.bits,
                             dim=self.dim)

    def get_full(self, ids: torch.Tensor) -> torch.Tensor:
        """Two-level reconstruction (== get() when residual_bits == 0)."""
        dec = self.get(ids)
        if not self.residual_bits:
            return dec
        ids = self._clip(ids)
        rows = self.res_codes[ids]
        if self.residual_bits == 4:
            rows = _unpack4(rows)
        live = _live(self.padded_dim, self.dim, rows.device)
        return dec + self.res_scales[ids][..., None] * \
            rows.to(torch.float32) * live

    def get_f32(self, ids: torch.Tensor) -> torch.Tensor:
        return self.get(ids)

    def norms_of(self, ids: torch.Tensor) -> torch.Tensor:
        return self.norms_sq[self._clip(ids)]

    def full_view(self) -> "LVQFullView":
        """Dataset view decoding both levels, for the rerank of two-level
        search and for building over the full reconstruction."""
        return LVQFullView(base=self)

    def to_numpy(self) -> np.ndarray:
        ids = torch.arange(self.n, device=self.device)
        return self.get_full(ids)[:, : self.dim].cpu().numpy()

    def with_capacity(self, capacity: int) -> "LVQDataset":
        cap = dt.pad_to(capacity, 32)
        if cap <= self.capacity:
            return self
        g = cap - self.capacity

        def grow(t, fill=0.0):
            return torch.cat([t, t.new_full((g, *t.shape[1:]), fill)])

        return dataclasses.replace(
            self, codes=grow(self.codes, 0), scales=grow(self.scales, 1.0),
            biases=grow(self.biases), norms_sq=grow(self.norms_sq,
                                                    float("inf")),
            res_codes=grow(self.res_codes, 0),
            res_scales=grow(self.res_scales, 1.0),
            full_norms_sq=grow(self.full_norms_sq, float("inf")))

    def tile_keys(self, queries: torch.Tensor, q_norms: torch.Tensor,
                  start: int, tile: int, distance) -> torch.Tensor:
        """Code-domain distance tile (primary level):
        <q, x1> = <q, mean> + b_i * sum_live(q) + s_i * <q, c_i>."""
        from ..ops import distance as dist_ops
        distance = dist_ops.as_distance(distance)
        xs = self.codes[start:start + tile]
        if self.bits == 4:
            xs = _unpack4(xs)
        ns = self.norms_sq[start:start + tile]
        s = self.scales[start:start + tile]
        b = self.biases[start:start + tile]

        q_live = queries.float() * _live(self.padded_dim, self.dim,
                                         queries.device)
        q_mean = dist_ops.dot_matrix(q_live, self.mean[None, :])[:, 0]
        q_sum = q_live.sum(-1)
        # bf16 x bf16 products (codes are exact in bf16) summed in f32
        dots_c = dist_ops.dot_matrix(q_live.to(torch.bfloat16), xs)
        dots = q_mean[:, None] + b[None, :] * q_sum[:, None] \
            + s[None, :] * dots_c
        inf_mask = torch.where(torch.isinf(ns), float("inf"), 0.0)[None, :]
        if distance == dist_ops.DistanceType.MIP:
            return -dots + inf_mask
        if distance == dist_ops.DistanceType.L2:
            keys = q_norms[:, None] - 2.0 * dots + ns[None, :]
            return keys.clamp_min(0.0) + inf_mask
        denom = q_norms[:, None].clamp_min(1e-30).sqrt() * \
            torch.where(torch.isinf(ns), 1.0, ns).sqrt()[None, :]
        return -dots / denom + inf_mask

    # -- persistence -------------------------------------------------------------
    SCHEMA = "lvq_dataset"
    VERSION = saveload.Version(0, 0, 2)

    def save(self, ctx: saveload.SaveContext) -> dict:
        """v0.0.2: the padded (nibble-packed at 4 bits) code rows."""
        def blob(t):
            return ctx.save_array(t.cpu().numpy())

        table = {
            "name": "lvq dataset",
            "codes": blob(self.codes[: self.n]),
            "scales": blob(self.scales[: self.n]),
            "biases": blob(self.biases[: self.n]),
            "mean": blob(self.mean[: self.dim]),
            "dims": self.dim,
            "num_vectors": self.n,
            "bits": self.bits,
            "residual_bits": self.residual_bits,
        }
        if self.residual_bits:
            table["res_codes"] = blob(self.res_codes[: self.n])
            table["res_scales"] = blob(self.res_scales[: self.n])
        return saveload.save_table(self.SCHEMA, self.VERSION, table)

    @classmethod
    def load(cls, table: dict, ctx: saveload.LoadContext, device="cuda",
             **_) -> "LVQDataset":
        """Reads v0.0.2 (padded, packed rows) and v0.0.1 (unpadded,
        unpacked ``(n, dim)`` rows), for both levels; the capacity is
        ``pad_to(n, 32)`` as in the JAX package."""
        saveload.check_table(table, cls.SCHEMA, cls.VERSION)
        bits = int(table.get("bits", 8))
        residual_bits = int(table.get("residual_bits", 0))
        dim = int(table["dims"])

        def blob(name, dtype=np.float32):
            return ctx.load_array(table[name]).astype(dtype)

        res = {}
        if residual_bits:
            res = dict(res_codes=_stored_codes(blob("res_codes", np.int8),
                                               residual_bits, dim),
                       res_scales=blob("res_scales"))
        return cls.from_codes(
            _stored_codes(blob("codes", np.int8), bits, dim), blob("scales"),
            blob("biases"), blob("mean"), bits=bits,
            residual_bits=residual_bits, device=device, **res)


def _stored_codes(codes: np.ndarray, bits: int, dim: int) -> np.ndarray:
    """(n, dim) unpacked codes from a saved code blob: v0.0.2 rows are
    padded to the lane width and nibble-packed at 4 bits; v0.0.1 rows are
    ``(n, dim)`` as they are.  The layouts are told apart by width, as the
    JAX package tells them apart."""
    if codes.shape[1] == dt.padded_dim(dim) // (8 // bits) and bits == 4:
        codes = _unpack4(torch.from_numpy(codes)).numpy()
    return codes[:, :dim]


def compress_host(x, bits: int = 8, residual_bits: int = 0,
                  block_rows: int = 1 << 20) -> LVQDataset:
    """:meth:`LVQDataset.compress` on the host (``device="cpu"``), in
    blocks of ``block_rows`` rows: every step but the mean is per row, so
    the blocks give the whole array's bits while the host holds one
    block's float64 temporaries at a time."""
    x = np.asarray(x, dtype=np.float32)
    mean = x.mean(axis=0)
    parts = [LVQDataset.compress(x[i:i + block_rows], bits, residual_bits,
                                 device="cpu", mean=mean)
             for i in range(0, max(x.shape[0], 1), block_rows)]
    if len(parts) == 1:
        return parts[0]
    rows = {name: torch.cat([getattr(p, name)[: p.n] for p in parts])
            for name in ("codes", "scales", "biases", "norms_sq",
                         "res_codes", "res_scales", "full_norms_sq")}
    return dataclasses.replace(parts[0], n=x.shape[0],
                               **rows).with_capacity(x.shape[0])


def compress_and_save_host(directory: str, x, bits: int = 8,
                           residual_bits: int = 0) -> None:
    """Compress and write an :class:`LVQDataset` checkpoint on the host,
    with no dataset on the device (:func:`compress_host`): the bytes the
    JAX package's function of this name writes (v0.0.2, the format of
    :meth:`LVQDataset.save`)."""
    saveload.save_to_disk(compress_host(x, bits, residual_bits), directory)


def _check_bits(bits: int, residual_bits: int) -> None:
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if residual_bits not in (0, 4, 8):
        raise ValueError(
            f"residual_bits must be 0, 4, or 8, got {residual_bits}")


@dataclasses.dataclass
class LVQFullView:
    """Two-level reconstruction view of an :class:`LVQDataset`: enough of
    the dataset protocol for reranking and for building (get / norms_sq /
    tile_keys)."""

    base: LVQDataset

    @property
    def n(self) -> int:
        return self.base.n

    @property
    def dim(self) -> int:
        return self.base.dim

    @property
    def capacity(self) -> int:
        return self.base.capacity

    @property
    def padded_dim(self) -> int:
        return self.base.padded_dim

    @property
    def device(self) -> torch.device:
        return self.base.device

    @property
    def norms_sq(self) -> torch.Tensor:
        return self.base.full_norms_sq

    def get(self, ids: torch.Tensor) -> torch.Tensor:
        return self.base.get_full(ids)

    def get_f32(self, ids: torch.Tensor) -> torch.Tensor:
        return self.base.get_full(ids)

    def norms_of(self, ids: torch.Tensor) -> torch.Tensor:
        return self.base.full_norms_sq[self.base._clip(ids)]

    def with_capacity(self, capacity: int) -> "LVQFullView":
        return LVQFullView(base=self.base.with_capacity(capacity))

    def tile_keys(self, queries: torch.Tensor, q_norms: torch.Tensor,
                  start: int, tile: int, distance) -> torch.Tensor:
        """Two-level decode tile + pairwise keys."""
        from ..ops import distance as dist_ops
        ids = start + torch.arange(tile, device=queries.device)
        return dist_ops.pairwise_keys(
            dist_ops.as_distance(distance), queries, self.base.get_full(ids),
            vector_norms_sq=self.norms_of(ids), query_norms_sq=q_norms)
