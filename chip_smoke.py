"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

Run from the repository root on a machine with an NVIDIA H100 (or another
sm_90a card) and the CUDA toolkit:

    python3 chip_smoke.py

Phases, one line of detail each (any failure exits non-zero):
  1. device: the card, its power limit, the fp32 matmul flags (TF32 off);
  2. build: nvcc builds csrc/beam_step.cu for sm_90a from the checkout;
  3. kernels: beam_step's CUDA kernel against its plain PyTorch version on
     the card, 3 metrics x {f32, bf16} rows at the serving and the build
     shape, plus median times of both;
  4. main path: a 100k x 128 clustered dataset (seed 42), Vamana build
     (R=32, window 100, pool 300, prune_to 28, alpha 1.1, sampled
     entries), exhaustive ground truth, bf16 packed serving of 5000
     queries, window sweep to recall@10 >= 0.9, QPS over 5 repetitions;
     the kernel's launch count must grow during build and during serving;
  5. golden gate: the L2, MIP and cosine rows of
     data/golden/vamana_reference.json within +-0.05 recall (cosine
     +-0.10, see GOLDEN_TOL).
The line before the last is the kernels' JSON summary; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "data", "golden", "vamana_reference.json")
SERVING_SHAPE = (2048, 16, 128, 128, 12, 4)   # B, C, K, d, window, m
BUILD_SHAPE = (2500, 100, 128, 128, 100, 4)
WINDOWS = (11, 12, 13, 14, 16, 20, 24, 32, 48, 64, 96, 128)
# Recall tolerance per golden row.  The cosine row of the reference is
# sensitive to the build schedule: on the CPU, where the port reproduces the
# golden bit for bit, changing only the build batch size (200-300 instead
# of 250) moves it by up to 0.097 in the JAX package itself, so it is held
# to that measured spread; L2 and MIP are stable and keep +-0.05.
GOLDEN_TOL = {"L2": 0.05, "MIP": 0.05, "Cosine": 0.10}
TIMING_REPS = 20


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is False); this check runs only on the GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    log(f"device: {device['kind']} x{device['count']} torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    log(smi)
    log(f"fp32 matmul: matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32} precision="
        f"{torch.get_float32_matmul_precision()}")
    return device


def phase_build() -> float:
    from scalablevectorsearch_tpu_torch.ops.kernels import _build
    t0 = time.perf_counter()
    path = _build.build("beam_step")
    seconds = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in path.with_suffix(".log").read_text()
             .splitlines() if "registers" in ln or "smem" in ln]
    log(f"build: beam_step.cu -> {path.name} in {seconds:.2f} s; "
        + " | ".join(ptxas))
    return seconds


def make_case(rng, shape, grid, query_dtype=torch.float32):
    """Beam-step inputs on the card, built as tests/test_pallas.py builds
    them: a sorted beam with visited and empty slots, 20% invalid candidate
    ids, rows gathered from one table.  ``grid`` puts the table and the
    queries on multiples of 1/32 small enough that they are exact in bf16
    and every f32 dot product is exact in any summation order, so the
    kernel and the plain version must agree bit for bit."""
    B, C, K, d, _window, _m = shape
    n_ids = max(400, 2 * C)
    beam_ids = (rng.integers(0, n_ids, size=(B, 1))
                + np.arange(C)[None, :]) % n_ids       # C distinct per row
    beam_keys = np.sort(rng.normal(size=(B, C)).astype(np.float32) ** 2, 1)
    vis = (rng.random((B, C)) < 0.5).astype(np.int32)
    n_empty = rng.integers(0, C // 3 + 1, size=B)
    beam_keys[np.arange(C)[None, :] >= (C - n_empty)[:, None]] = np.inf
    beam_packed = np.where(np.isfinite(beam_keys), beam_ids | (vis << 30),
                           -1).astype(np.int32)
    cand_ids = rng.integers(0, n_ids, size=(B, K)).astype(np.int32)
    cand_ids[rng.random((B, K)) < 0.2] = -1
    table = rng.normal(size=(n_ids, d)).astype(np.float32)
    queries = rng.normal(size=(B, d)).astype(np.float32)
    if grid:
        # |value| <= kmax/32 keeps every L2 key below 2^24 / 1024
        kmax = min(127, int(np.sqrt(2.0 ** 22 / d)))
        table = np.clip(np.rint(table * 32), -kmax, kmax) / np.float32(32)
        queries = np.clip(np.rint(queries * 32), -kmax, kmax) / np.float32(32)
    vecs = table[np.maximum(cand_ids, 0)]
    out = [torch.from_numpy(np.ascontiguousarray(x)).cuda()
           for x in (beam_keys, beam_packed, vecs, cand_ids, queries)]
    out[4] = out[4].to(query_dtype)
    return out


def median_ms(fn, reps: int = TIMING_REPS) -> float:
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_kernels() -> dict:
    """beam_step kernel vs beam_step_plain on the card.  Grid inputs: all
    five outputs identical.  Real-valued inputs: keys within rtol/atol 1e-5
    (f32 rows) or 1e-3 (bf16 rows), the pool ids identical, and the beam
    ids and pops identical except where two keys are within rounding of
    each other (reported; at most 0.1% of rows)."""
    from scalablevectorsearch_tpu_torch.ops.kernels import beam_step as bs
    rng = np.random.default_rng(0)
    max_err, timings, failures, swapped, rows = 0.0, {}, [], 0, 0
    for label, shape in (("serving", SERVING_SHAPE), ("build", BUILD_SHAPE)):
        _B, _C, _K, _d, window, m = shape
        for vdt in (torch.float32, torch.bfloat16):
            tol = 1e-5 if vdt == torch.float32 else 1e-3
            for metric in (0, 1, 2):
                kw = dict(metric=metric, window=window, m=m)
                grid = make_case(rng, shape, grid=True)
                grid[2] = grid[2].to(vdt)
                got = bs.beam_step(*grid, **kw)
                want = bs.beam_step_plain(*grid, **kw)
                torch.cuda.synchronize()
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    failures.append(f"{label}/{vdt}/m{metric} grid mismatch")
                real = make_case(rng, shape, grid=False)
                real[2] = real[2].to(vdt)
                got = bs.beam_step(*real, **kw)
                want = bs.beam_step_plain(*real, **kw)
                gk, gp, gpop, gpk, gpi = got
                wk, wp, wpop, wpk, wpi = want
                fin = torch.isfinite(wk)
                if not torch.equal(fin, torch.isfinite(gk)):
                    failures.append(f"{label}/{vdt}/m{metric} inf slots")
                err = (gk[fin] - wk[fin]).abs()
                max_err = max(max_err, float(err.max()))
                if not torch.allclose(gk, wk, rtol=tol, atol=tol) or \
                        not torch.allclose(gpk, wpk, rtol=tol, atol=tol) \
                        or not torch.equal(gpi, wpi):
                    failures.append(f"{label}/{vdt}/m{metric} real keys/pool")
                rows_off = ((gp != wp) & fin).any(1) | (gpop != wpop).any(1)
                swapped += int(rows_off.sum())
                rows += rows_off.numel()
                if float(rows_off.float().mean()) > 1e-3:
                    failures.append(f"{label}/{vdt}/m{metric} real ids "
                                    f"{int(rows_off.sum())} rows")
            args = make_case(rng, shape, grid=False)
            args[2] = args[2].to(vdt)
            kw = dict(metric=0, window=window, m=m)
            ms = median_ms(lambda: bs.beam_step(*args, **kw))
            plain_ms = median_ms(lambda: bs.beam_step_plain(*args, **kw))
            timings[f"{label}_{'bf16' if vdt == torch.bfloat16 else 'f32'}"] \
                = {"ms": ms, "plain_ms": plain_ms}
            log(f"kernels: beam_step {label} B,C,K,d={shape[:4]} "
                f"{vdt} L2: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
                f"(median of {TIMING_REPS})")
    if failures:
        raise AssertionError("beam_step kernel vs plain: "
                             + "; ".join(failures))
    log(f"kernels: beam_step matches plain: 2 shapes x 2 dtypes x 3 "
        f"metrics; grid inputs identical, real inputs max_abs_err "
        f"{max_err:.3g}, near-tie rows with other ids or pops {swapped} of "
        f"{rows}")
    return {"max_abs_err": max_err, "timings": timings}


def phase_main_path() -> dict:
    import scalablevectorsearch_tpu_torch as svt
    from scalablevectorsearch_tpu_torch.index.vamana import search as smod
    from scalablevectorsearch_tpu_torch.index.vamana.index import (
        dequantize_queries, prepare_query_upload)
    from scalablevectorsearch_tpu_torch.ops.kernels.beam_step import (
        beam_step)
    data, queries = svt.generate_test_dataset(100_000, 5000, 128, seed=42)
    params = svt.VamanaBuildParameters(
        alpha=1.1, graph_max_degree=32, window_size=100,
        max_candidate_pool_size=300, prune_to=28)
    beam_step.launches = 0
    t0 = time.perf_counter()
    index = svt.Vamana.build(params, data, "l2", sampled_entries=True)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_launches = beam_step.launches
    log(f"main path: build 100000x128 in {build_s:.2f} s, mean degree "
        f"{index.index.graph.mean_degree():.3f}, beam_step launches "
        f"{build_launches}")
    t0 = time.perf_counter()
    gt = svt.exhaustive_search(data, queries, 10)
    gt_s = time.perf_counter() - t0
    index.enable_packed_serving()
    sweep, window, recall = [], None, 0.0
    for w in WINDOWS:
        index.search_window_size = w
        recall = svt.k_recall_at_n(gt, index.search(queries, 10))
        sweep.append(f"{w}:{recall:.4f}")
        if recall >= 0.9:
            window = w
            break
    log(f"main path: ground truth {gt_s:.2f} s; recall@10 sweep "
        + " ".join(sweep))
    if window is None:
        raise AssertionError("no window reached recall@10 >= 0.9")
    before = beam_step.launches
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        res = index.search_async(queries, 10).result()
        times.append(time.perf_counter() - t0)
    serve_launches = beam_step.launches - before
    total_launches = beam_step.launches
    qps = len(queries) / statistics.median(times)
    if svt.k_recall_at_n(gt, res) < 0.9:
        raise AssertionError("timed searches lost recall")
    # expansions per query: one direct pass of the serving search
    ix = index.index
    q_up, scale = prepare_query_upload(np.pad(
        queries, ((0, 0), (0, ix.data.padded_dim - 128))))
    q = dequantize_queries(q_up.cuda(), None if scale is None else
                           scale.cuda())
    out = smod.greedy_search(
        ix.graph, ix.data, q, ix._entry_sampler.select(ix.distance, q),
        window=window, capacity=max(window, 10),
        max_iters=smod.default_max_iters(window), distance=ix.distance,
        packed=ix._packed, tail_frac=ix.tail_frac)
    pops = float(out.n_pops.float().mean())
    log(f"main path: window {window} recall@10 {recall:.4f}; search_async "
        f"x5 median {statistics.median(times) * 1e3:.2f} ms -> {qps:.1f} "
        f"QPS; mean pops/query {pops:.2f}; beam_step launches serving "
        f"{serve_launches}")
    if build_launches == 0 or serve_launches == 0:
        raise AssertionError("beam_step kernel not launched on the main "
                             "path (build %d, serving %d)"
                             % (build_launches, serve_launches))
    return {"launches": total_launches}


def phase_golden() -> None:
    import scalablevectorsearch_tpu_torch as svt
    with open(GOLDEN) as f:
        golden = json.load(f)
    spec, k = golden["dataset"], golden["num_neighbors"]
    data, queries = svt.generate_test_dataset(
        spec["n"], spec["n_queries"], spec["dim"], seed=spec["seed"])
    bad = []
    for entry in golden["expected"]:
        bp = svt.VamanaBuildParameters(**{
            key: val for key, val in entry["build_parameters"].items()
            if key in ("alpha", "graph_max_degree", "window_size",
                       "max_candidate_pool_size", "prune_to")})
        t0 = time.perf_counter()
        index = svt.VamanaIndex.build(bp, data, entry["distance"])
        build_s = time.perf_counter() - t0
        gt = svt.exhaustive_search(data, queries, k, entry["distance"])
        got = {}
        for window, want in entry["recalls"].items():
            index.search_window_size = int(window)
            got[window] = svt.k_recall_at_n(gt, index.search(queries, k))
            if abs(got[window] - want) > GOLDEN_TOL[entry["distance"]]:
                bad.append(f"{entry['distance']} w{window} "
                           f"{got[window]:.4f} vs {want}")
        log(f"golden: {entry['distance']} build {build_s:.2f} s, recall "
            + " ".join(f"w{w}:{r:.4f}(ref {entry['recalls'][w]})"
                       for w, r in got.items()))
    if bad:
        raise AssertionError("golden recall outside tolerance: "
                             + "; ".join(bad))


def main() -> int:
    device = phase_device()
    build_s = phase_build()
    kern = phase_kernels()
    main_path = phase_main_path()
    phase_golden()
    serving = kern["timings"]["serving_bf16"]
    print(json.dumps({"kernels": [{
        "name": "beam_step", "route": "cuda",
        "source": "scalablevectorsearch_tpu_torch/csrc/beam_step.cu",
        "replaces": "scalablevectorsearch_tpu/ops/pallas/beam_step.py:261",
        "launches": main_path["launches"],
        "max_abs_err": kern["max_abs_err"],
        "ms": serving["ms"], "plain_ms": serving["plain_ms"],
        "build_s": build_s, "ms_by_shape": kern["timings"]}]}))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
