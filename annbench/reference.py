"""The plain reference: exact k-nearest-neighbour search under L2.

Plain PyTorch in float64, so that rounding plays no part in what it
answers.  It imports nothing of the program: it works everything out
again from the rows and queries the benchmark drew (``data.py``).  Rows
and queries are float32 tensors on one device; the search runs over
blocks of rows and of queries so that the (queries, rows) key panel stays
small, keeping a running top-k.

``precision="tf32"`` computes the same search one precision below
float32 with TF32 off, as the control of ``correct`` (``control.py``):
the products of TF32 inputs (float32 rounded to TF32's 10 mantissa bits)
summed in float32, the norms in float32, as a TF32 matrix product on the
tensor cores computes them, on the CPU too.
"""

from __future__ import annotations

import torch

QUERY_BLOCK = 2048
ROW_BLOCK = 1 << 17


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to the nearest TF32 value, kept as float32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _operands(x: torch.Tensor, precision: str) -> tuple:
    """(the matrix product's operand, the values the norms are taken of)."""
    if precision == "float64":
        x = x.double()
        return x, x
    if precision == "tf32":
        return tf32(x.float()), x.float()
    raise ValueError(f"unknown precision {precision!r}")


def exact_knn(rows: torch.Tensor, queries: torch.Tensor, k: int,
              precision: str = "float64") -> tuple:
    """The exact top-``k`` of every query: ``(ids (nq, k) int64, squared
    L2 distances (nq, k))``, nearest first, the distances in float64 (in
    float32 at ``precision="tf32"``)."""
    nq = queries.shape[0]
    dtype = torch.float64 if precision == "float64" else torch.float32
    ids_out = torch.empty((nq, k), dtype=torch.int64, device=rows.device)
    dist_out = torch.empty((nq, k), dtype=dtype, device=rows.device)
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")     # no TF32 of its own
    try:
        for q0 in range(0, nq, QUERY_BLOCK):
            _knn_block(rows, queries[q0:q0 + QUERY_BLOCK], k, precision,
                       ids_out[q0:q0 + QUERY_BLOCK],
                       dist_out[q0:q0 + QUERY_BLOCK])
    finally:
        torch.set_float32_matmul_precision(before)
    return ids_out, dist_out


def _knn_block(rows, queries, k, precision, ids_out, dist_out) -> None:
    q, q_values = _operands(queries, precision)
    q2 = q_values.square().sum(1, keepdim=True)
    best_d = torch.full((q.shape[0], 0), float("inf"), dtype=q2.dtype,
                        device=rows.device)
    best_i = torch.empty((q.shape[0], 0), dtype=torch.int64,
                         device=rows.device)
    for r0 in range(0, rows.shape[0], ROW_BLOCK):
        x, x_values = _operands(rows[r0:r0 + ROW_BLOCK], precision)
        d = (q2 - 2.0 * (q @ x.T)
             + x_values.square().sum(1)[None, :]).clamp_min_(0)
        top_d, top_i = torch.topk(d, min(k, d.shape[1]), dim=1,
                                  largest=False)
        best_d = torch.cat([best_d, top_d], 1)
        best_i = torch.cat([best_i, top_i + r0], 1)
        if best_d.shape[1] > k:
            best_d, pick = torch.topk(best_d, k, dim=1, largest=False)
            best_i = torch.gather(best_i, 1, pick)
    order = torch.argsort(best_d, dim=1, stable=True)
    dist_out.copy_(torch.gather(best_d, 1, order))
    ids_out.copy_(torch.gather(best_i, 1, order))


def pair_distances(rows: torch.Tensor, queries: torch.Tensor,
                   ids: torch.Tensor) -> torch.Tensor:
    """Squared L2 distance in float64 between each query (nq, d) and each
    of its rows ``ids`` (nq, m), from the differences themselves."""
    diff = rows[ids].double() - queries.double()[:, None, :]
    return diff.square().sum(-1)
