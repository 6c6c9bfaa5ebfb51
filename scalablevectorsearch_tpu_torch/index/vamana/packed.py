"""Packed neighborhoods: inline neighbor vectors for serving.

PyTorch counterpart of ``scalablevectorsearch_tpu/index/vamana/packed.py``:
``packed[v, j] = vectors[adjacency[v, j]]``, so a search iteration reads the
popped nodes' neighbor rows as m contiguous (R, d) super-rows instead of
m * R scattered rows.  With a lossy packed dtype (bf16 over an f32,
float16, int8 or SQ dataset) the final beam is re-scored against the
dataset's own rows.  LVQ datasets pack
their neighbors' codes with per-neighbor (scale, bias) instead
(:class:`PackedLVQNeighborhoods`): half (LVQ-8) to a quarter (LVQ-4) of
the bf16 packed bytes, decoded exactly, so no re-score is needed.
"""

from __future__ import annotations

import dataclasses

import torch


def pack_neighborhoods(graph, data, dtype=torch.bfloat16,
                       chunk: int = 65536) -> torch.Tensor:
    """Materialize ``packed[v, j, :] = vectors[adjacency[v, j]]``.

    Slots where ``adjacency[v, j] == -1`` hold row 0's vector; consumers mask
    by the adjacency ids, never by the packed contents.  Chunked to bound
    the transient gather output.  ``data.vectors`` is read once: an
    ``SQDataset`` decodes its whole matrix there.
    """
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"packed dtype {dtype}: float32 or bfloat16")
    cap, r = graph.adjacency.shape
    vectors = data.vectors
    out = torch.empty((cap, r, data.padded_dim), dtype=dtype,
                      device=data.device)
    for start in range(0, cap, chunk):
        adj = graph.adjacency[start:start + chunk]
        out[start:start + chunk] = vectors[adj.clamp_min(0)].to(dtype)
    return out


@dataclasses.dataclass
class PackedLVQNeighborhoods:
    """Inline neighbor LVQ codes: the packed layout applied to quantized
    rows, with each neighbor's level-1 constants beside its codes."""

    codes: torch.Tensor    # (capacity, R, w1) int8; w1 = d_pad / (8 // bits)
    scales: torch.Tensor   # (capacity, R) f32 per-neighbor level-1 scale
    biases: torch.Tensor   # (capacity, R) f32
    mean: torch.Tensor     # (d_pad,) f32 dataset mean
    bits: int              # 4 or 8
    dim: int

    @property
    def dtype(self) -> torch.dtype:
        return self.codes.dtype

    def gather(self, popped_flat: torch.Tensor, rows: int):
        """Super-rows of ``popped_flat`` (rows * m,) node ids, as
        ``(codes (rows, m * R, w1), scales (rows, m * R), biases (rows,
        m * R))``; ids are clamped to the capacity."""
        ids = popped_flat.clamp(0, self.codes.shape[0] - 1)
        width = (popped_flat.shape[0] // rows) * self.codes.shape[1]
        return (self.codes[ids].reshape(rows, width, self.codes.shape[2]),
                self.scales[ids].reshape(rows, width),
                self.biases[ids].reshape(rows, width))

    def decode(self, popped_flat: torch.Tensor, rows: int) -> torch.Tensor:
        """Gathered super-rows decoded to (rows, m * R, d_pad) f32 primary
        reconstructions, with the dataset's own ``affine_decode``."""
        from ...quantization.lvq import affine_decode
        codes, scales, biases = self.gather(popped_flat, rows)
        return affine_decode(codes, scales, biases, self.mean,
                             bits=self.bits, dim=self.dim)


def pack_neighborhoods_lvq(graph, lvq, chunk: int = 65536
                           ) -> PackedLVQNeighborhoods:
    """Materialize inline neighbor LVQ codes + per-neighbor constants.

    Slots where ``adjacency[v, j] == -1`` hold row 0's codes; consumers mask
    by the adjacency ids.  Chunked like :func:`pack_neighborhoods`."""
    cap, r = graph.adjacency.shape
    dev = lvq.codes.device
    out_c = torch.empty((cap, r, lvq.codes.shape[1]), dtype=torch.int8,
                        device=dev)
    out_s = torch.empty((cap, r), dtype=torch.float32, device=dev)
    out_b = torch.empty((cap, r), dtype=torch.float32, device=dev)
    for start in range(0, cap, chunk):
        adj = graph.adjacency[start:start + chunk].clamp(0, lvq.capacity - 1)
        out_c[start:start + chunk] = lvq.codes[adj]
        out_s[start:start + chunk] = lvq.scales[adj]
        out_b[start:start + chunk] = lvq.biases[adj]
    return PackedLVQNeighborhoods(codes=out_c, scales=out_s, biases=out_b,
                                  mean=lvq.mean, bits=lvq.bits, dim=lvq.dim)
