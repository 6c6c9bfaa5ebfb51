"""Candidate scoring over rows: ``score_rows`` and ``gather_score_l2_partial``.

Counterparts of ``scalablevectorsearch_tpu/ops/pallas/gather_distance.py``.
Both wrappers dispatch on the tensors' device: CPU tensors run the plain
PyTorch versions, CUDA tensors launch the hand-written kernels of
``csrc/gather_distance.cu`` (built with ``nvcc`` for ``sm_90a`` on first
use) or raise.  ``score_rows.launches`` and
``gather_score_l2_partial.launches`` count kernel launches.

- :func:`score_rows`: ``(<q, x>, ||x||^2)`` over pre-gathered (B, K, d) f32
  rows, the two reductions every metric's key needs
  (:func:`~..distance.keys_from_parts` turns them into keys).
- :func:`gather_score_l2_partial`: ``||x||^2 - 2 <q, x>`` over rows read by
  id from an (N, d) table of f32, float16, bfloat16, int8 or uint8
  (converted to f32 as ``get_f32`` converts them); the (B, K, d) block is
  never written.  ``||q||^2 + partial``, clamped at 0, is the L2 key
  (:func:`~..distance.keys_from_l2_partial`).  Ids should arrive clamped
  to ``[0, N)``, as the JAX kernel requires; both versions clamp them
  again, so no id reads outside the table.

Products and sums are f32; the kernel sums in another order than the plain
version, so real-valued results agree to rounding, exact-valued ones
exactly.
"""

from __future__ import annotations

import ctypes

import torch

from .beam_step import _launched, _stream

MAX_DIM = 8192          # keeps the query's shared memory under 48 KB
# table element type -> the kernel's type code
_TABLE_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2,
                 torch.int8: 3, torch.uint8: 4}


def score_rows_plain(rows: torch.Tensor, queries: torch.Tensor):
    """(B, K, d) rows, (B, d) queries -> ((B, K) dots, (B, K) x2), f32
    products and sums (the arithmetic of beam_step's plain scoring)."""
    rf = rows.float()
    qf = queries.float()
    return (rf * qf[:, None, :]).sum(-1), rf.square().sum(-1)


def gather_score_l2_partial_plain(table: torch.Tensor, ids: torch.Tensor,
                                  queries: torch.Tensor) -> torch.Tensor:
    """(N, d) table, (B, K) ids, (B, d) queries -> (B, K) ``x2 - 2 dots``."""
    rows = table[ids.clamp(0, table.shape[0] - 1)]
    dots, x2 = score_rows_plain(rows, queries)
    return x2 - 2.0 * dots


_PTR, _I32 = ctypes.c_void_p, ctypes.c_int
# argument types of the library's C entry points (csrc/gather_distance.cu)
_ARGTYPES = {
    "svt_score_rows": (_PTR,) * 4 + (_I32,) * 4 + (_PTR,),
    "svt_gather_score_l2_partial": (_PTR, _I32, _PTR, _I32, _PTR, _PTR)
    + (_I32,) * 4 + (_PTR,),
}


def _kernel_entry(name: str):
    from . import _build
    return _build.entry_point("gather_distance", name, _ARGTYPES[name])


def _on_cuda(op: str, tensors: dict) -> bool:
    """Checks shared by both wrappers; True for CUDA tensors, False for CPU
    tensors, raises otherwise."""
    device = next(iter(tensors.values())).device
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{op}: {name} on {t.device}, expected {device}")
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"{op}: no kernel for device {device}")
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{op}: {name} must be contiguous")
    return True


def _vec16(t: torch.Tensor, d: int) -> int:
    """16-byte loads: rows of whole 16-byte chunks on an aligned base."""
    per = 16 // t.element_size()
    return int(d % per == 0 and t.data_ptr() % 16 == 0)


def score_rows_args(rows, queries, out) -> tuple:
    """The C arguments of ``svt_score_rows`` for checked CUDA tensors and
    the preallocated (dots, x2) ``out`` (also used to time the raw
    kernel)."""
    b, k, d = rows.shape
    return (rows.data_ptr(), queries.data_ptr(), out[0].data_ptr(),
            out[1].data_ptr(), b, k, d, _vec16(rows, d), _stream(rows))


def gather_score_l2_partial_args(table, ids, queries, out) -> tuple:
    """The C arguments of ``svt_gather_score_l2_partial``, as
    :func:`score_rows_args`."""
    n, d = table.shape
    b, k = ids.shape
    return (table.data_ptr(), _TABLE_DTYPES[table.dtype], ids.data_ptr(), n,
            queries.data_ptr(), out.data_ptr(), b, k, d, _vec16(table, d),
            _stream(table))


def score_rows(rows: torch.Tensor, queries: torch.Tensor):
    """(dots, x2) of pre-gathered rows against their queries.

    Args:
      rows: (B, K, d) f32 rows.
      queries: (B, d) f32.

    Returns: ((B, K) f32 ``<q, x>``, (B, K) f32 ``||x||^2``).
    """
    if rows.ndim != 3 or queries.ndim != 2 \
            or tuple(queries.shape) != (rows.shape[0], rows.shape[2]):
        raise ValueError(f"score_rows: rows {tuple(rows.shape)} and queries "
                         f"{tuple(queries.shape)}: expected (B, K, d), (B, d)")
    if not _on_cuda("score_rows", {"rows": rows, "queries": queries}):
        return score_rows_plain(rows, queries)
    if rows.dtype != torch.float32 or queries.dtype != torch.float32:
        raise TypeError(f"score_rows: rows {rows.dtype} and queries "
                        f"{queries.dtype} must be float32")
    b, k, d = rows.shape
    if not (k >= 1 and 1 <= d <= MAX_DIM):
        raise ValueError(f"score_rows: K={k} >= 1 and d={d} in "
                         f"[1, {MAX_DIM}] required")
    dots = torch.empty((b, k), dtype=torch.float32, device=rows.device)
    x2 = torch.empty_like(dots)
    err = _kernel_entry("svt_score_rows")(*score_rows_args(rows, queries,
                                                           (dots, x2)))
    _launched("score_rows", err)
    score_rows.launches += 1
    return dots, x2


score_rows.launches = 0


def gather_score_l2_partial(table: torch.Tensor, ids: torch.Tensor,
                            queries: torch.Tensor) -> torch.Tensor:
    """Partial L2 keys of table rows gathered by id.

    Args:
      table: (N, d) rows, f32 / float16 / bfloat16 / int8 / uint8.
      ids: (B, K) int32 row ids in ``[0, N)`` (clamped again here).
      queries: (B, d) f32.

    Returns: (B, K) f32 ``||x||^2 - 2 <q, x>``.
    """
    if table.ndim != 2 or ids.ndim != 2 or queries.ndim != 2 \
            or queries.shape[0] != ids.shape[0] \
            or queries.shape[1] != table.shape[1]:
        raise ValueError(f"gather_score_l2_partial: table "
                         f"{tuple(table.shape)}, ids {tuple(ids.shape)}, "
                         f"queries {tuple(queries.shape)}: expected (N, d), "
                         "(B, K), (B, d)")
    if table.shape[0] < 1:
        raise ValueError("gather_score_l2_partial: empty table")
    if not _on_cuda("gather_score_l2_partial",
                    {"table": table, "ids": ids, "queries": queries}):
        return gather_score_l2_partial_plain(table, ids, queries)
    if table.dtype not in _TABLE_DTYPES or ids.dtype != torch.int32 \
            or queries.dtype != torch.float32:
        raise TypeError(f"gather_score_l2_partial: table {table.dtype} must "
                        "be float32/float16/bfloat16/int8/uint8, ids int32, "
                        f"queries float32 (got {ids.dtype}, {queries.dtype})")
    n, d = table.shape
    b, k = ids.shape
    if not (k >= 1 and 1 <= d <= MAX_DIM and n < 2 ** 31):
        raise ValueError(f"gather_score_l2_partial: K={k} >= 1, d={d} in "
                         f"[1, {MAX_DIM}] and N={n} < 2^31 required")
    out = torch.empty((b, k), dtype=torch.float32, device=table.device)
    err = _kernel_entry("svt_gather_score_l2_partial")(
        *gather_score_l2_partial_args(table, ids, queries, out))
    _launched("gather_score_l2_partial", err)
    gather_score_l2_partial.launches += 1
    return out


gather_score_l2_partial.launches = 0
