"""Packed neighborhoods: inline neighbor vectors for serving.

PyTorch counterpart of ``scalablevectorsearch_tpu/index/vamana/packed.py::
pack_neighborhoods``: ``packed[v, j] = vectors[adjacency[v, j]]``, so a
search iteration reads the popped nodes' neighbor rows as m contiguous
(R, d) super-rows instead of m * R scattered rows.  With a lossy packed
dtype (bf16 over an f32 dataset) the final beam is re-scored against the
exact rows.  LVQ-coded neighborhoods are not part of this package yet.
"""

from __future__ import annotations

import torch


def pack_neighborhoods(graph, data, dtype=torch.bfloat16,
                       chunk: int = 65536) -> torch.Tensor:
    """Materialize ``packed[v, j, :] = vectors[adjacency[v, j]]``.

    Slots where ``adjacency[v, j] == -1`` hold row 0's vector; consumers mask
    by the adjacency ids, never by the packed contents.  Chunked to bound
    the transient gather output.
    """
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"packed dtype {dtype}: float32 or bfloat16")
    cap, r = graph.adjacency.shape
    out = torch.empty((cap, r, data.padded_dim), dtype=dtype,
                      device=data.device)
    for start in range(0, cap, chunk):
        adj = graph.adjacency[start:start + chunk]
        out[start:start + chunk] = data.vectors[adj.clamp_min(0)].to(dtype)
    return out
