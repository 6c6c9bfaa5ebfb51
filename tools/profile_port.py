"""Where the PyTorch/CUDA port spends its time on the GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 tools/profile_port.py

Builds the 100k x 128 index of ``chip_smoke.py``'s main path (seed 42,
R=32, window 100, pool 300, prune_to 28, alpha 1.1, sampled entries), then
profiles with ``torch.profiler``:
  - one ``search`` of 5000 queries (k=10) for each serving route: f32 data
    with bf16 packed rows at window 11, LVQ-8 packed and unpacked, and
    LVQ8x8 packed with its rerank, at window 20; float16 rows unpacked (the
    scored route) at window 11 and SQ-int8 rows unpacked at window 12;
  - one build round (B 2500, window 100, pool 300, pass-2 alpha) over the
    f32 rows, over LVQ-8 codes and over SQ-int8 codes (the scored route);
  - LeanVec (PCA to 64 dimensions, built with the same parameters): one
    reranked ``search`` of 5000 queries at window 11 (the fetch of 30
    makes it 30); the batch iterator over the main index: a first page of
    10 at window 20 (B 8), and a page of 64 at capacity 1088 (the wide
    route, after 15 pages of 64);
  - the dynamic index over the f32 graph and rows: one add round (B 125,
    as ``add_points`` runs 5,000 rows), one consolidation batch (1024
    vertices after 10,000 soft deletes) and the medioid of the VALID rows
    that ``compact`` and an entry-point delete recompute;
  - IVF at ``chip_smoke.py``'s configuration (948 centroids over the 100k
    rows, query batches of 2500): one ``search`` of 5000 queries at the
    first n_probes with recall@10 >= 0.9, the k-means++ seeding (948
    picks) and one ``kmeans_training`` minibatch epoch (10 steps of
    10,000 rows); the inverted index at its defaults: one ``search`` of
    5000 queries at the first setting of chip_smoke's sweep with
    recall@10 >= 0.9.
Calibration is a sequence of the searches above and has no row.
For each it prints the wall time with the profiler on, the device busy
time (the sum of the device-side events' times: kernels and copies), the
device's idle share, the share of the beam-step kernels (beam_step,
beam_step_lvq, beam_update: one template) and of the scoring kernels
(score_rows, gather_score_l2_partial), for each of those five kernels its
launch count and mean device ms per launch, and the largest device items.
It exits non-zero without a CUDA device.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

TOP = 8
# row loader of a beam_step_kernel instance -> the port's kernel
LOADERS = (("DenseRows", "beam_step"), ("LvqRows", "beam_step_lvq"),
           ("KeyRows", "beam_update"))
# gather_score_l2_partial's fast kernel (not PyTorch's vectorized_gather_kernel)
FAST_GATHER = "namespace)::gather_kernel<"


def kernel_of(key: str):
    """Which of the five kernels a profiler entry is, or None."""
    if "beam_step_kernel" in key:
        return next((name for loader, name in LOADERS if loader in key),
                    None)
    if "score_kernel<" in key:                  # score_kernel<T, kGather>
        return "gather_score_l2_partial" if "true>" in key else "score_rows"
    if FAST_GATHER in key:                      # its fast path
        return "gather_score_l2_partial"
    return None


def device_time(event) -> float:
    """Self device time of one key_averages() entry, in microseconds."""
    return getattr(event, "self_device_time_total", None) or \
        getattr(event, "self_cuda_time_total", 0.0)


def profiled(label: str, fn) -> None:
    fn()                                   # warm up (allocations, caches)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side entries only (kernels, copies, sets): the CPU ops that
    # launched them carry the same time again
    items = [(e.key, device_time(e) / 1e3, e.count)
             for e in prof.key_averages()
             if e.device_type != DeviceType.CPU and device_time(e) > 0]
    busy = sum(t for _, t, _ in items)
    if busy <= 0:
        raise RuntimeError(f"{label}: the profiler saw no device time")
    beam = sum(t for key, t, _ in items if "beam_step_kernel" in key)
    scoring = sum(t for key, t, _ in items
                  if "score_kernel" in key or FAST_GATHER in key)
    print(f"{label}: wall {wall_ms:.2f} ms (profiler on), device busy "
          f"{busy:.2f} ms, idle {1 - busy / wall_ms:.1%}, beam-step kernels "
          f"{beam:.3f} ms = {beam / busy:.1%} of busy, scoring kernels "
          f"{scoring:.3f} ms = {scoring / busy:.1%}", flush=True)
    per_kernel = {}
    for key, t, count in items:
        name = kernel_of(key)
        if name:
            total, n = per_kernel.get(name, (0.0, 0))
            per_kernel[name] = (total + t, n + count)
    for name, (total, n) in sorted(per_kernel.items()):
        print(f"  kernel {name}: {n} launches, {total / n:.4f} ms device "
              f"time per launch", flush=True)
    for key, t, count in sorted(items, key=lambda x: -x[1])[:TOP]:
        print(f"  {t:8.3f} ms {t / busy:6.1%} x{count:<5d} {key[:90]}",
              flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("profile_port: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    import scalablevectorsearch_tpu_torch as svt
    from scalablevectorsearch_tpu_torch.index.vamana import build as bmod
    from scalablevectorsearch_tpu_torch.index.vamana import search as smod
    from scalablevectorsearch_tpu_torch.index.vamana.entry import (
        build_sampler)
    from scalablevectorsearch_tpu_torch.index.vamana.index import VamanaIndex

    data, queries = svt.generate_test_dataset(100_000, 5000, 128, seed=42)
    params = svt.VamanaBuildParameters(
        alpha=1.1, graph_max_degree=32, window_size=100,
        max_candidate_pool_size=300, prune_to=28)
    t0 = time.perf_counter()
    index = svt.VamanaIndex.build(params, data, "l2", sampled_entries=True)
    torch.cuda.synchronize()
    print(f"build {time.perf_counter() - t0:.2f} s", flush=True)

    index.enable_packed_serving()
    index.search_window_size = 11
    profiled("serving f32 data, bf16 packed, window 11",
             lambda: index.search(queries, 10))
    index.disable_packed_serving()

    for label, bits, res, packed in (("LVQ-8 packed", 8, 0, True),
                                     ("LVQ-8 unpacked", 8, 0, False),
                                     ("LVQ8x8 packed + rerank", 8, 8, True)):
        lvq = VamanaIndex(index.graph, svt.LVQDataset.compress(
            data, bits=bits, residual_bits=res), index.entry_point, "l2")
        lvq.enable_entry_sampler()
        if packed:
            lvq.enable_packed_serving()
        lvq.search_window_size = 20
        profiled(f"serving {label}, window 20",
                 lambda: lvq.search(queries, 10))
        del lvq

    sq8 = svt.SQDataset.compress(data)
    for label, ds, window in (
            ("float16 unpacked", svt.VectorDataset.from_array(
                data, dtype=torch.float16), 11),
            ("SQ-int8 unpacked", sq8, 12)):
        scored = VamanaIndex(index.graph, ds, index.entry_point, "l2")
        scored.enable_entry_sampler()
        scored.search_window_size = window
        profiled(f"serving {label} (scored route), window {window}",
                 lambda: scored.search(queries, 10))
        del scored

    b, window = 2500, params.window_size
    ids = torch.arange(b, dtype=torch.int32, device="cuda")
    valid = torch.ones(b, dtype=torch.bool, device="cuda")
    entry = torch.tensor([index.entry_point], dtype=torch.int32,
                         device="cuda")
    for label, ds in (("f32 rows", index.data),
                      ("LVQ-8 codes", svt.LVQDataset.compress(data, bits=8)),
                      ("SQ-int8 codes (scored route)", sq8)):
        sampler = build_sampler(ds, None, seed=0)
        profiled(f"build round B {b} over {label}", lambda: bmod.build_round(
            index.graph, ds, ids, valid, entry, sampler, None,
            window=window, capacity=window,
            max_iters=smod.default_max_iters(window), distance=svt.L2,
            pool_size=params.max_candidate_pool_size, gen_alpha=params.alpha,
            rev_alpha=params.alpha, prune_to=params.prune_to,
            max_degree=params.graph_max_degree, prune_chunk=256,
            pop_width=4, tail_frac=4))
    profile_leanvec_iterator(index, data, queries, params)
    profile_dynamic(index, params.resolved("l2"))
    del index
    profile_ivf_inverted(data, queries)
    return 0


def profile_leanvec_iterator(index, data, queries, params) -> None:
    """A LeanVec search, and iterator pages over ``index``."""
    import scalablevectorsearch_tpu_torch as svt
    t0 = time.perf_counter()
    lv = svt.LeanVecVamana.build(params, data, "l2", target_dim=64,
                                 sampled_entries=True)
    torch.cuda.synchronize()
    print(f"LeanVec PCA 64 train + build {time.perf_counter() - t0:.2f} s",
          flush=True)
    lv.search_window_size = 11
    profiled("serving LeanVec PCA 64 (LVQ-8 primary, rerank of 30 over the "
             "LVQ-8 secondary), window 11", lambda: lv.search(queries, 10))
    del lv
    index.search_window_size = 20
    profiled("iterator first page of 10, window 20 (B 8)",
             lambda: svt.BatchIterator(index, queries[0], 10).next())
    it = svt.BatchIterator(index, queries[1], 64,
                           schedule=svt.DefaultSchedule(64, 64))
    for _ in range(15):
        it.next()
    profiled("iterator page of 64 at capacity 1088 / 1152 (wide route)",
             it.next)


def profile_dynamic(index, params, device="cuda") -> None:
    """The dynamic index's own steps over ``index``'s graph and rows."""
    import numpy as np
    from scalablevectorsearch_tpu_torch.index.vamana import dynamic as dmod
    n = index.data.n
    dyn = dmod.MutableVamanaIndex.from_state(
        index.data, index.graph, np.full(n, dmod.SLOT_VALID, np.int8),
        np.arange(n), index.entry_point, "l2", params)
    slots = np.arange(125)
    profiled("dynamic add round B 125 (one of add_points 5000's 40)",
             lambda: dyn._build_over(slots, batch_size=125))
    dyn.delete_points(np.arange(0, n, 10))          # 10,000 at 100k
    valid = torch.from_numpy(dyn.status == dmod.SLOT_VALID).to(device)
    affected = dmod._affected_by_deleted(dyn.graph.adjacency,
                                         dyn.deleted_mask, valid)
    ids = torch.nonzero(affected).flatten()[:1024].int()
    ok = torch.ones(ids.shape[0], dtype=torch.bool, device=device)
    r = params.graph_max_degree
    print(f"dynamic: {int(affected.sum())} vertices affected by "
          f"{int(dyn.deleted_mask.sum())} deleted", flush=True)
    profiled("dynamic consolidate batch (1024 vertices)",
             lambda: dmod.consolidate_round(
                 dyn.graph, dyn.data, ids, ok, dyn.deleted_mask,
                 prune_to=params.prune_to, alpha=float(params.alpha),
                 distance=dyn.distance, max_degree=r, prune_chunk=128,
                 pool_cap=min(r * (r + 1), 4 * r)))
    profiled("dynamic medioid of the VALID rows (compact)",
             dyn._reset_entry_point)


def profile_ivf_inverted(data, queries) -> None:
    """IVF and the inverted index over the main data (see the module
    docstring); the winning settings come from chip_smoke's sweeps."""
    import numpy as np
    import chip_smoke as cs
    import scalablevectorsearch_tpu_torch as svt
    from scalablevectorsearch_tpu_torch.index.ivf import kmeans
    gt = svt.exhaustive_search(data, queries, 10)
    bp = cs.ivf_params(len(data))
    ivf = svt.IVF.build(bp, data, "l2", query_batch_size=cs.IVF_BATCH)
    probes, _ = cs.probe_sweep(ivf.index, queries, gt.ids, "profile: ivf")
    sp = svt.IVFSearchParameters(n_probes=probes)
    profiled(f"IVF search, n_probes {probes} ({bp.num_centroids} centroids, "
             f"slot {ivf.index.slot}, batches of {cs.IVF_BATCH})",
             lambda: ivf.index.search(queries, 10, sp))
    del ivf
    x = torch.from_numpy(data).cuda()
    k = bp.num_centroids
    profiled(f"k-means++ seeding, {k} picks over {len(data)} rows",
             lambda: kmeans._kmeanspp_init(x, bp.seed, k))
    seeds = kmeans._kmeanspp_init(x, bp.seed, k)
    order = torch.from_numpy(np.random.default_rng(0).permutation(
        len(data))).cuda()
    mb = bp.resolved(len(data)).minibatch_size

    def epoch():
        c, n = seeds, torch.zeros(k, device="cuda")
        for start in range(0, len(data), mb):
            c, n, _ = kmeans._minibatch_step(x[order[start:start + mb]], c,
                                             n, k)
    profiled(f"kmeans_training minibatch epoch ({len(data) // mb} steps of "
             f"{mb}, {k} centroids)", epoch)
    t0 = time.perf_counter()
    inv = svt.Inverted.build(svt.InvertedBuildParameters(), data, "l2")
    torch.cuda.synchronize()
    print(f"inverted build {time.perf_counter() - t0:.2f} s", flush=True)
    for max_probes, eps in cs.INVERTED_SETTINGS:
        isp = svt.InvertedSearchParameters(refinement_epsilon=eps,
                                           max_probes=max_probes)
        if svt.k_recall_at_n(gt, inv.index.search(queries, 10, isp)) >= 0.9:
            profiled(f"inverted search, max_probes {max_probes} epsilon "
                     f"{eps} (slot {inv.index.slot})",
                     lambda: inv.index.search(queries, 10, isp))
            return
    raise RuntimeError("profile: no inverted setting reached recall 0.9")


if __name__ == "__main__":
    sys.exit(main())
