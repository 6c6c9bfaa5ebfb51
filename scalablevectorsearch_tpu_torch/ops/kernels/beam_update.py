"""Merge already-scored candidates into the beam and pop the next m nodes.

Counterpart of ``scalablevectorsearch_tpu/ops/pallas/beam_update.py::
beam_update``.  :func:`beam_update` dispatches on the tensors' device: CPU
tensors run :func:`beam_update_plain`, CUDA tensors launch the kernel
``svt_beam_update`` of ``csrc/beam_step.cu`` (the beam-step template with a
row loader that takes the keys as given and scores nothing) or raise.
``beam_update.launches`` counts kernel launches.

It is :func:`~.beam_step.beam_step` without the scoring, so the dedup, the
beam mask, the merge, the pop and the tie order (candidates by (key, id),
beam before candidate on equal keys) are beam_step's.  Two things follow
the JAX kernel instead:
- a candidate is valid when its id is >= 0 **and** its key is finite;
- the pool outputs are (B, C + K) and hold only the candidates that enter
  the merge: a candidate repeated within the iteration or already in the
  beam is dropped (+inf / -1), where beam_step's (B, K) pool keeps
  in-beam candidates.  The JAX kernel leaves the survivors in arbitrary
  columns; here they sit in the first K columns in id order, and the last
  C columns are always empty.
"""

from __future__ import annotations

import torch

from .beam_step import (MAX_WIDTH, _kernel_entry, _launched,
                        _merge_and_pop, _on_cuda, _outputs, _stream)


def beam_update_plain(beam_keys: torch.Tensor, beam_packed: torch.Tensor,
                      cand_keys: torch.Tensor, cand_ids: torch.Tensor, *,
                      window: int, m: int):
    """Plain PyTorch version of the kernel (any device).

    Returns ``(keys (B, C), packed (B, C), popped (B, m), pool_keys
    (B, C + K), pool_ids (B, C + K))``."""
    return _merge_and_pop(beam_keys, beam_packed, cand_keys, cand_ids,
                          window=window, m=m, merge_pool=True)


def _check(beam_keys, beam_packed, cand_keys, cand_ids, window: int, m: int):
    """Shapes, types and limits (both devices: the plain version keeps the
    kernel's contract)."""
    device = beam_keys.device
    for name, t in (("beam_packed", beam_packed), ("cand_keys", cand_keys),
                    ("cand_ids", cand_ids)):
        if t.device != device:
            raise ValueError(f"beam_update: {name} on {t.device}, beam_keys "
                             f"on {device}")
    if beam_keys.ndim != 2 or cand_keys.ndim != 2:
        raise ValueError("beam_update: expected beam (B, C) and candidates "
                         "(B, K)")
    b, c = beam_keys.shape
    k = cand_keys.shape[1]
    if tuple(beam_packed.shape) != (b, c) or tuple(cand_ids.shape) != (b, k) \
            or cand_keys.shape[0] != b:
        raise ValueError(
            f"beam_update: inconsistent shapes beam {tuple(beam_keys.shape)}, "
            f"packed {tuple(beam_packed.shape)}, keys "
            f"{tuple(cand_keys.shape)}, ids {tuple(cand_ids.shape)}")
    if beam_keys.dtype != torch.float32 or cand_keys.dtype != torch.float32 \
            or beam_packed.dtype != torch.int32 \
            or cand_ids.dtype != torch.int32:
        raise TypeError("beam_update: keys f32, beam_packed and cand_ids "
                        "int32 required")
    if not (1 <= c <= MAX_WIDTH and 1 <= k <= MAX_WIDTH):
        raise ValueError(f"beam_update: C={c}, K={k} must lie in "
                         f"[1, {MAX_WIDTH}]")
    if window < 1 or m < 1:
        raise ValueError(f"beam_update: window={window}, m={m}")


def beam_update_args(beam_keys, beam_packed, cand_keys, cand_ids, out, *,
                     window: int, m: int) -> tuple:
    """The C arguments of ``svt_beam_update`` for checked CUDA tensors and
    the five preallocated outputs ``out``, pool (B, C + K) (also used to
    time the raw kernel)."""
    b, c = beam_keys.shape
    return (beam_keys.data_ptr(), beam_packed.data_ptr(), cand_keys.data_ptr(),
            cand_ids.data_ptr(), *(t.data_ptr() for t in out), b, c,
            cand_keys.shape[1], window, m, _stream(beam_keys))


def beam_update(beam_keys: torch.Tensor, beam_packed: torch.Tensor,
                cand_keys: torch.Tensor, cand_ids: torch.Tensor, *,
                window: int, m: int):
    """Fold scored candidates into the beam; pop the next m.

    Args:
      beam_keys: (B, C) f32 sorted ascending, +inf = empty slot.
      beam_packed: (B, C) int32, ``id | visited << 30``.
      cand_keys: (B, K) f32 candidate keys, +inf = invalid.
      cand_ids: (B, K) int32 candidate ids below 2^30, -1 = invalid (an
        id at or above 2^30 traps in the kernel).
      window: pop horizon; m: pop width.

    Returns: as :func:`beam_update_plain`.
    """
    _check(beam_keys, beam_packed, cand_keys, cand_ids, window, m)
    if not _on_cuda("beam_update", beam_keys):
        return beam_update_plain(beam_keys, beam_packed, cand_keys, cand_ids,
                                 window=window, m=m)
    for name, t in (("beam_keys", beam_keys), ("beam_packed", beam_packed),
                    ("cand_keys", cand_keys), ("cand_ids", cand_ids)):
        if not t.is_contiguous():
            raise ValueError(f"beam_update: {name} must be contiguous")
    out = _outputs(beam_keys, beam_keys.shape[1] + cand_keys.shape[1], m)
    err = _kernel_entry("svt_beam_update")(*beam_update_args(
        beam_keys, beam_packed, cand_keys, cand_ids, out, window=window, m=m))
    _launched("beam_update", err)
    beam_update.launches += 1
    return out


beam_update.launches = 0
