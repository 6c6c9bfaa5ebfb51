"""One lockstep beam-search iteration: score + dedup + merge + pop.

Counterpart of ``scalablevectorsearch_tpu/ops/pallas/beam_step.py::
beam_step``.  :func:`beam_step` dispatches on the tensors' device: CPU
tensors run :func:`beam_step_plain`, CUDA tensors launch the hand-written
kernel in ``csrc/beam_step.cu`` (built with ``nvcc`` for ``sm_90a`` on first
use) or raise.  ``beam_step.launches`` counts kernel launches.

Contract (shared with the JAX package): a beam is (B, C) f32 keys sorted
ascending, +inf marking empty slots, beside int32 ``packed = id | visited
<< 30``; a candidate id of -1 is invalid.

Tie order: the JAX kernel's bitonic network leaves equal keys wherever the
network puts them.  Here both versions follow one total order — candidates
by (key, id), and on equal keys the beam entry before the candidate — so
the kernel and :func:`beam_step_plain` agree exactly whenever their keys
do; against the JAX package, tied keys compare as (key, id) multisets.
"""

from __future__ import annotations

import ctypes
import functools

import torch

L2, MIP, COSINE = 0, 1, 2
VIS_BIT = 1 << 30
ID_MASK = VIS_BIT - 1
_INT_BIG = 2 ** 31 - 1
MAX_WIDTH = 1024          # largest beam capacity C and candidate count K
MAX_DIM = 8192            # keeps the kernel's shared memory under 227 KB
_VALUE_DTYPES = (torch.float32, torch.bfloat16)


def _score(vecs: torch.Tensor, queries: torch.Tensor, metric: int
           ) -> torch.Tensor:
    """(B, K, d) rows + (B, d) queries -> (B, K) f32 keys, products and
    sums in f32 (the JAX kernel's ``_score_block``)."""
    vf = vecs.float()
    qf = queries.float()
    dots = (vf * qf[:, None, :]).sum(-1)
    if metric == MIP:
        return -dots
    x2 = vf.square().sum(-1)
    qn = qf.square().sum(-1)[:, None]
    if metric == L2:
        return (qn - 2.0 * dots + x2).clamp_min(0.0)
    denom = qn.clamp_min(1e-30).sqrt() * x2.clamp_min(1e-30).sqrt()
    return -dots / denom


def beam_step_plain(beam_keys: torch.Tensor, beam_packed: torch.Tensor,
                    vecs: torch.Tensor, cand_ids: torch.Tensor,
                    queries: torch.Tensor, *, metric: int, window: int,
                    m: int):
    """Plain PyTorch version of the kernel (any device).

    Follows ``_beam_step_body`` of the JAX package with stable sorts in
    place of its bitonic networks.  Returns ``(keys (B, C), packed (B, C),
    popped (B, m), pool_keys (B, K), pool_ids (B, K))``; the pool holds the
    scored candidates in id order with repeats within the iteration masked
    to +inf (candidates already in the beam stay, for build-mode pool
    tracking).
    """
    b, c = beam_keys.shape
    inf = float("inf")
    valid = cand_ids >= 0
    keys = torch.where(valid, _score(vecs, queries, metric), inf)

    # within-iteration dedup in id order (invalid ids last)
    sortid = torch.where(valid, cand_ids, _INT_BIG)
    sortid, order = torch.sort(sortid, dim=1, stable=True)
    keys = torch.gather(keys, 1, order)
    ids = torch.gather(cand_ids, 1, order)
    dup = torch.zeros_like(valid)
    dup[:, 1:] = (sortid[:, 1:] == sortid[:, :-1]) & (sortid[:, 1:] != _INT_BIG)
    keys = torch.where(dup, inf, keys)
    pool_keys, pool_ids = keys, ids

    # candidates already in the beam
    beam_ids = torch.where(torch.isfinite(beam_keys), beam_packed & ID_MASK, -1)
    in_beam = (beam_ids[:, :, None] == ids[:, None, :]).any(1)
    keys = torch.where(in_beam, inf, keys)

    # candidates by (key, id), then a stable merge behind equal beam keys
    keys, order = torch.sort(keys, dim=1, stable=True)
    ids = torch.gather(ids, 1, order)
    merged_keys, order = torch.sort(torch.cat([beam_keys, keys], 1), dim=1,
                                    stable=True)
    merged_packed = torch.gather(torch.cat([beam_packed, ids], 1), 1, order)
    new_keys = merged_keys[:, :c].contiguous()
    new_packed = merged_packed[:, :c]

    # pop the first m unvisited finite slots inside the window
    in_window = torch.arange(c, device=beam_keys.device) < window
    unvis = torch.isfinite(new_keys) & ((new_packed >> 30) == 0) & in_window
    rank = torch.cumsum(unvis.to(torch.int32), 1) - 1
    hit = unvis & (rank < m)
    # column m is the sink for the slots that are not popped
    popped = torch.full((b, m + 1), -1, dtype=torch.int32,
                        device=beam_keys.device)
    popped.scatter_(1, torch.where(hit, rank, m).long(),
                    torch.where(hit, new_packed & ID_MASK, -1))
    new_packed = torch.where(hit, new_packed | VIS_BIT, new_packed)
    return (new_keys, new_packed.contiguous(), popped[:, :m].contiguous(),
            pool_keys.contiguous(), pool_ids.contiguous())


def _check(beam_keys, beam_packed, vecs, cand_ids, queries, metric, window,
           m):
    device = beam_keys.device
    for name, t in (("beam_packed", beam_packed), ("vecs", vecs),
                    ("cand_ids", cand_ids), ("queries", queries)):
        if t.device != device:
            raise ValueError(f"beam_step: {name} on {t.device}, beam_keys "
                             f"on {device}")
    b, c = beam_keys.shape
    if vecs.ndim != 3 or cand_ids.ndim != 2 or queries.ndim != 2:
        raise ValueError("beam_step: expected vecs (B, K, d), cand_ids "
                         "(B, K), queries (B, d)")
    k, d = vecs.shape[1], vecs.shape[2]
    if (beam_packed.shape != (b, c) or tuple(cand_ids.shape) != (b, k)
            or tuple(queries.shape) != (b, d) or vecs.shape[0] != b):
        raise ValueError(
            f"beam_step: inconsistent shapes beam {tuple(beam_keys.shape)}, "
            f"packed {tuple(beam_packed.shape)}, vecs {tuple(vecs.shape)}, "
            f"ids {tuple(cand_ids.shape)}, queries {tuple(queries.shape)}")
    if beam_keys.dtype != torch.float32 or beam_packed.dtype != torch.int32 \
            or cand_ids.dtype != torch.int32:
        raise TypeError("beam_step: beam_keys f32, beam_packed and cand_ids "
                        "int32 required")
    if vecs.dtype not in _VALUE_DTYPES or queries.dtype not in _VALUE_DTYPES:
        raise TypeError(f"beam_step: vecs {vecs.dtype} / queries "
                        f"{queries.dtype} must be float32 or bfloat16")
    for name, t in (("beam_keys", beam_keys), ("beam_packed", beam_packed),
                    ("vecs", vecs), ("cand_ids", cand_ids),
                    ("queries", queries)):
        if not t.is_contiguous():
            raise ValueError(f"beam_step: {name} must be contiguous")
    if not (1 <= c <= MAX_WIDTH and 1 <= k <= MAX_WIDTH and 1 <= d <= MAX_DIM):
        raise ValueError(f"beam_step: C={c}, K={k} must lie in "
                         f"[1, {MAX_WIDTH}] and d={d} in [1, {MAX_DIM}]")
    if metric not in (L2, MIP, COSINE) or window < 1 or m < 1:
        raise ValueError(f"beam_step: metric={metric}, window={window}, "
                         f"m={m}")


@functools.lru_cache(maxsize=None)
def _kernel_entry():
    """The built library's C entry point, with its argument types."""
    from . import _build
    fn = _build.load_library("beam_step").svt_beam_step
    ptr = ctypes.c_void_p
    fn.argtypes = [ptr, ptr, ptr, ctypes.c_int, ptr, ptr, ctypes.c_int,
                   ptr, ptr, ptr, ptr, ptr] + [ctypes.c_int] * 8 + [ptr]
    fn.restype = ctypes.c_int
    return fn


def beam_step(beam_keys: torch.Tensor, beam_packed: torch.Tensor,
              vecs: torch.Tensor, cand_ids: torch.Tensor,
              queries: torch.Tensor, *, metric: int, window: int, m: int):
    """Score gathered candidate rows and fold them into the beam; pop next m.

    Args:
      beam_keys: (B, C) f32 sorted ascending, +inf = empty slot.
      beam_packed: (B, C) int32, ``id | visited << 30``.
      vecs: (B, K, d) gathered candidate rows (f32 or bf16).
      cand_ids: (B, K) int32 candidate ids below 2^30, -1 = invalid.
      queries: (B, d) query block (f32 or bf16).
      metric: 0=L2, 1=MIP, 2=cosine.
      window: pop horizon; m: pop width.

    Returns: as :func:`beam_step_plain`.
    """
    if beam_keys.device.type == "cpu":
        return beam_step_plain(beam_keys, beam_packed, vecs, cand_ids,
                               queries, metric=metric, window=window, m=m)
    if beam_keys.device.type != "cuda":
        raise ValueError(f"beam_step: no kernel for device "
                         f"{beam_keys.device}")
    _check(beam_keys, beam_packed, vecs, cand_ids, queries, metric, window, m)
    # ids at or above 2^30 would collide with the visited bit; checked on
    # the device without a host round trip (a failure raises at the next
    # synchronisation)
    torch._assert_async((cand_ids < VIS_BIT).all())
    b, c = beam_keys.shape
    k, d = vecs.shape[1], vecs.shape[2]
    dev = beam_keys.device
    out_keys = torch.empty((b, c), dtype=torch.float32, device=dev)
    out_packed = torch.empty((b, c), dtype=torch.int32, device=dev)
    popped = torch.empty((b, m), dtype=torch.int32, device=dev)
    pool_keys = torch.empty((b, k), dtype=torch.float32, device=dev)
    pool_ids = torch.empty((b, k), dtype=torch.int32, device=dev)
    vec4 = d % 4 == 0 and vecs.data_ptr() % (4 * vecs.element_size()) == 0
    err = _kernel_entry()(beam_keys.data_ptr(), beam_packed.data_ptr(), vecs.data_ptr(),
             int(vecs.dtype == torch.bfloat16), cand_ids.data_ptr(),
             queries.data_ptr(), int(queries.dtype == torch.bfloat16),
             out_keys.data_ptr(), out_packed.data_ptr(), popped.data_ptr(),
             pool_keys.data_ptr(), pool_ids.data_ptr(), b, c, k, d, metric,
             window, m, int(vec4), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"beam_step kernel launch failed: CUDA error "
                           f"{err}")
    beam_step.launches += 1
    return out_keys, out_packed, popped, pool_keys, pool_ids


beam_step.launches = 0
