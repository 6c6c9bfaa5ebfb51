"""One lockstep beam-search iteration: score + dedup + merge + pop.

Counterpart of ``scalablevectorsearch_tpu/ops/pallas/beam_step.py::
beam_step``.  :func:`beam_step` dispatches on the tensors' device: CPU
tensors run :func:`beam_step_plain`, CUDA tensors launch the hand-written
kernel in ``csrc/beam_step.cu`` (built with ``nvcc`` for ``sm_90a`` on first
use) or raise.  ``beam_step.launches`` counts kernel launches.
:func:`beam_step_lvq` (the JAX package's ``beam_step_lvq``) is the same
step over int8 LVQ-8 code rows that the kernel decodes in registers; it
dispatches alike, runs :func:`beam_step_lvq_plain` on the CPU, and counts
its launches in ``beam_step_lvq.launches``.

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

import torch

L2, MIP, COSINE = 0, 1, 2
VIS_BIT = 1 << 30
ID_MASK = VIS_BIT - 1
_INT_BIG = 2 ** 31 - 1
MAX_WIDTH = 1024          # largest beam capacity C and candidate count K
MAX_DIM = 8192            # keeps the kernel's shared memory under 227 KB
_VALUE_DTYPES = (torch.float32, torch.bfloat16)


def _score(vecs: torch.Tensor, queries: torch.Tensor, metric: int,
           decode=None) -> torch.Tensor:
    """(B, K, d) rows + (B, d) queries -> (B, K) f32 keys, products and
    sums in f32 (the JAX kernel's ``_score_block``).

    ``decode``: optional LVQ-8 ``(scales, biases, mean, n_dead)``; ``vecs``
    then holds int8 codes, decoded as ``mean + bias + scale * code``.  The
    ``n_dead`` zero-padded trailing lanes decode to exactly ``bias``, so
    their ``n_dead * bias**2`` is subtracted from the squared norm (the
    queries are zero there, so the dots need no correction)."""
    qf = queries.float()
    if decode is None:
        vf = vecs.float()
        dead_x2 = 0.0
    else:
        scales, biases, mean, n_dead = decode
        vf = (mean.reshape(1, 1, -1) + biases[:, :, None]
              + scales[:, :, None] * vecs.float())
        dead_x2 = float(n_dead) * biases * biases
    dots = (vf * qf[:, None, :]).sum(-1)
    if metric == MIP:
        return -dots
    x2 = vf.square().sum(-1) - dead_x2
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
    keys = _score(vecs, queries, metric)
    return _merge_and_pop(beam_keys, beam_packed, keys, cand_ids,
                          window=window, m=m)


def beam_step_lvq_plain(beam_keys: torch.Tensor, beam_packed: torch.Tensor,
                        codes: torch.Tensor, scales: torch.Tensor,
                        biases: torch.Tensor, mean: torch.Tensor,
                        cand_ids: torch.Tensor, queries: torch.Tensor, *,
                        metric: int, window: int, m: int, n_dead: int):
    """Plain PyTorch version of the LVQ-8 kernel (any device): the rows are
    decoded as the JAX package's ``_score_block(decode=...)`` decodes them,
    then dedup, merge and pop run as in :func:`beam_step_plain`."""
    keys = _score(codes, queries, metric,
                  decode=(scales, biases, mean, n_dead))
    return _merge_and_pop(beam_keys, beam_packed, keys, cand_ids,
                          window=window, m=m)


def _merge_and_pop(beam_keys, beam_packed, keys, cand_ids, *, window: int,
                   m: int, merge_pool: bool = False):
    """Everything after scoring: dedup, beam-membership mask, merge, pop.

    ``merge_pool=False`` (beam_step): a candidate is valid when its id is
    >= 0, and the (B, K) pool holds every scored candidate in id order with
    repeats masked.  ``merge_pool=True`` (beam_update): a candidate is
    valid when its id is >= 0 and its key finite, and the (B, C + K) pool
    holds only the candidates that enter the merge (in id order, in the
    first K columns), +inf / -1 elsewhere."""
    b, c = beam_keys.shape
    inf = float("inf")
    valid = cand_ids >= 0
    if merge_pool:
        valid = valid & torch.isfinite(keys)
    keys = torch.where(valid, keys, inf)

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
    if merge_pool:
        pool_keys = torch.cat([keys, keys.new_full((b, c), inf)], 1)
        pool_ids = torch.cat([torch.where(torch.isfinite(keys), ids, -1),
                              ids.new_full((b, c), -1)], 1)

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


def _check(op, beam_keys, beam_packed, rows, cand_ids, queries, metric,
           window, m, **extra):
    """Checks both kernels share; ``rows`` is the (B, K, d) row block and
    ``extra`` the kernel's other tensor arguments (device and contiguity
    checked here, shapes and types by the caller)."""
    device = beam_keys.device
    tensors = {"beam_keys": beam_keys, "beam_packed": beam_packed,
               "rows": rows, "cand_ids": cand_ids, "queries": queries,
               **extra}
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{op}: {name} on {t.device}, beam_keys on "
                             f"{device}")
    b, c = beam_keys.shape
    if rows.ndim != 3 or cand_ids.ndim != 2 or queries.ndim != 2:
        raise ValueError(f"{op}: expected rows (B, K, d), cand_ids (B, K), "
                         "queries (B, d)")
    k, d = rows.shape[1], rows.shape[2]
    if (beam_packed.shape != (b, c) or tuple(cand_ids.shape) != (b, k)
            or tuple(queries.shape) != (b, d) or rows.shape[0] != b):
        raise ValueError(
            f"{op}: inconsistent shapes beam {tuple(beam_keys.shape)}, "
            f"packed {tuple(beam_packed.shape)}, rows {tuple(rows.shape)}, "
            f"ids {tuple(cand_ids.shape)}, queries {tuple(queries.shape)}")
    if beam_keys.dtype != torch.float32 or beam_packed.dtype != torch.int32 \
            or cand_ids.dtype != torch.int32:
        raise TypeError(f"{op}: beam_keys f32, beam_packed and cand_ids "
                        "int32 required")
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{op}: {name} must be contiguous")
    if not (1 <= c <= MAX_WIDTH and 1 <= k <= MAX_WIDTH and 1 <= d <= MAX_DIM):
        raise ValueError(f"{op}: C={c}, K={k} must lie in [1, {MAX_WIDTH}] "
                         f"and d={d} in [1, {MAX_DIM}]")
    if metric not in (L2, MIP, COSINE) or window < 1 or m < 1:
        raise ValueError(f"{op}: metric={metric}, window={window}, m={m}")


def _outputs(beam_keys, pool_width: int, m: int):
    """The five output tensors, allocated on the beam's device; the pool
    is (B, pool_width)."""
    b, c = beam_keys.shape
    dev = beam_keys.device
    return (torch.empty((b, c), dtype=torch.float32, device=dev),
            torch.empty((b, c), dtype=torch.int32, device=dev),
            torch.empty((b, m), dtype=torch.int32, device=dev),
            torch.empty((b, pool_width), dtype=torch.float32, device=dev),
            torch.empty((b, pool_width), dtype=torch.int32, device=dev))


_PTR, _I32 = ctypes.c_void_p, ctypes.c_int
# argument types of the library's C entry points (csrc/beam_step.cu;
# svt_beam_update is wrapped in beam_update.py)
_ARGTYPES = {
    "svt_beam_step": (_PTR, _PTR, _PTR, _I32, _PTR, _PTR, _I32)
    + (_PTR,) * 5 + (_I32,) * 8 + (_PTR,),
    "svt_beam_step_lvq": (_PTR,) * 13 + (_I32,) * 9 + (_PTR,),
    "svt_beam_update": (_PTR,) * 9 + (_I32,) * 5 + (_PTR,),
}


def _kernel_entry(name: str):
    """A C entry point of the built library, with its argument types."""
    from . import _build
    return _build.entry_point("beam_step", name, _ARGTYPES[name])


def _on_cuda(op: str, beam_keys: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU tensors; raises otherwise."""
    if beam_keys.device.type == "cpu":
        return False
    if beam_keys.device.type != "cuda":
        raise ValueError(f"{op}: no kernel for device {beam_keys.device}")
    return True


def _launched(op: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{op} kernel launch failed: CUDA error {err}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def beam_step_args(beam_keys, beam_packed, vecs, cand_ids, queries, out, *,
                   metric: int, window: int, m: int) -> tuple:
    """The C arguments of ``svt_beam_step`` for checked CUDA tensors and
    the five preallocated outputs ``out`` (also used to time the raw
    kernel)."""
    b, c = beam_keys.shape
    k, d = vecs.shape[1], vecs.shape[2]
    vec4 = d % 4 == 0 and vecs.data_ptr() % (4 * vecs.element_size()) == 0
    return (beam_keys.data_ptr(), beam_packed.data_ptr(), vecs.data_ptr(),
            int(vecs.dtype == torch.bfloat16), cand_ids.data_ptr(),
            queries.data_ptr(), int(queries.dtype == torch.bfloat16),
            *(t.data_ptr() for t in out), b, c, k, d, metric, window, m,
            int(vec4), _stream(beam_keys))


def beam_step_lvq_args(beam_keys, beam_packed, codes, scales, biases, mean,
                       cand_ids, queries, out, *, metric: int, window: int,
                       m: int, n_dead: int) -> tuple:
    """The C arguments of ``svt_beam_step_lvq``, as :func:`beam_step_args`."""
    b, c = beam_keys.shape
    k, d = codes.shape[1], codes.shape[2]
    vec16 = d % 16 == 0 and codes.data_ptr() % 16 == 0
    return (beam_keys.data_ptr(), beam_packed.data_ptr(), codes.data_ptr(),
            scales.data_ptr(), biases.data_ptr(), mean.data_ptr(),
            cand_ids.data_ptr(), queries.data_ptr(),
            *(t.data_ptr() for t in out), b, c, k, d, metric, window, m,
            n_dead, int(vec16), _stream(beam_keys))


def beam_step(beam_keys: torch.Tensor, beam_packed: torch.Tensor,
              vecs: torch.Tensor, cand_ids: torch.Tensor,
              queries: torch.Tensor, *, metric: int, window: int, m: int):
    """Score gathered candidate rows and fold them into the beam; pop next m.

    Args:
      beam_keys: (B, C) f32 sorted ascending, +inf = empty slot.
      beam_packed: (B, C) int32, ``id | visited << 30``.
      vecs: (B, K, d) gathered candidate rows (f32 or bf16).
      cand_ids: (B, K) int32 candidate ids below 2^30, -1 = invalid.  An
        id at or above 2^30 would collide with the visited bit: the kernel
        traps, and the next synchronisation raises.
      queries: (B, d) query block (f32 or bf16).
      metric: 0=L2, 1=MIP, 2=cosine.
      window: pop horizon; m: pop width.

    Returns: as :func:`beam_step_plain`.
    """
    if not _on_cuda("beam_step", beam_keys):
        return beam_step_plain(beam_keys, beam_packed, vecs, cand_ids,
                               queries, metric=metric, window=window, m=m)
    _check("beam_step", beam_keys, beam_packed, vecs, cand_ids, queries,
           metric, window, m)
    if vecs.dtype not in _VALUE_DTYPES or queries.dtype not in _VALUE_DTYPES:
        raise TypeError(f"beam_step: vecs {vecs.dtype} / queries "
                        f"{queries.dtype} must be float32 or bfloat16")
    out = _outputs(beam_keys, vecs.shape[1], m)
    err = _kernel_entry("svt_beam_step")(*beam_step_args(
        beam_keys, beam_packed, vecs, cand_ids, queries, out, metric=metric,
        window=window, m=m))
    _launched("beam_step", err)
    beam_step.launches += 1
    return out


beam_step.launches = 0


def beam_step_lvq(beam_keys: torch.Tensor, beam_packed: torch.Tensor,
                  codes: torch.Tensor, scales: torch.Tensor,
                  biases: torch.Tensor, mean: torch.Tensor,
                  cand_ids: torch.Tensor, queries: torch.Tensor, *,
                  metric: int, window: int, m: int, n_dead: int):
    """:func:`beam_step` over LVQ-8 code rows, decoded inside the kernel.

    Counterpart of the JAX package's ``beam_step_lvq``.

    Args beyond :func:`beam_step`:
      codes: (B, K, d_pad) int8 gathered primary code rows.
      scales / biases: (B, K) f32 per-candidate level-1 constants.
      mean: (d_pad,) or (1, d_pad) f32 dataset mean (zero in dead lanes).
      queries: (B, d_pad) f32, zero in dead lanes.
      n_dead: count of zero-padded trailing lanes (d_pad - dim), each
        decoding to ``bias``; corrected in the squared-norm term.

    Returns: as :func:`beam_step_plain`.
    """
    if not _on_cuda("beam_step_lvq", beam_keys):
        return beam_step_lvq_plain(beam_keys, beam_packed, codes, scales,
                                   biases, mean, cand_ids, queries,
                                   metric=metric, window=window, m=m,
                                   n_dead=n_dead)
    _check("beam_step_lvq", beam_keys, beam_packed, codes, cand_ids, queries,
           metric, window, m, scales=scales, biases=biases, mean=mean)
    b, k, d = codes.shape
    if codes.dtype != torch.int8 or queries.dtype != torch.float32:
        raise TypeError(f"beam_step_lvq: codes {codes.dtype} must be int8 "
                        f"and queries {queries.dtype} float32")
    for name, t in (("scales", scales), ("biases", biases)):
        if t.dtype != torch.float32 or tuple(t.shape) != (b, k):
            raise TypeError(f"beam_step_lvq: {name} must be ({b}, {k}) "
                            f"float32, got {tuple(t.shape)} {t.dtype}")
    if mean.dtype != torch.float32 or mean.numel() != d \
            or mean.ndim not in (1, 2):
        raise TypeError(f"beam_step_lvq: mean must be ({d},) or (1, {d}) "
                        f"float32, got {tuple(mean.shape)} {mean.dtype}")
    if not 0 <= n_dead < d:
        raise ValueError(f"beam_step_lvq: n_dead={n_dead} outside [0, {d})")
    out = _outputs(beam_keys, k, m)
    err = _kernel_entry("svt_beam_step_lvq")(*beam_step_lvq_args(
        beam_keys, beam_packed, codes, scales, biases, mean, cand_ids,
        queries, out, metric=metric, window=window, m=m, n_dead=n_dead))
    _launched("beam_step_lvq", err)
    beam_step_lvq.launches += 1
    return out


beam_step_lvq.launches = 0
