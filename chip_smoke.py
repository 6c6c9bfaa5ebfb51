"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

Run from the repository root on a machine with an NVIDIA H100 (or another
sm_90a card) and the CUDA toolkit:

    python3 chip_smoke.py

Phases, one line of detail each (any failure exits non-zero):
  1. device: the card, its power limit, the fp32 matmul flags (TF32 off);
  2. build: nvcc builds csrc/beam_step.cu (beam_step, beam_step_lvq,
     beam_update) and csrc/gather_distance.cu (score_rows,
     gather_score_l2_partial) for sm_90a from the checkout, one nvcc per
     source, both started together; ptxas registers per kernel instance;
     SASS instruction counts of gather_distance's kernel instances;
  3. kernels: beam_step's CUDA kernel against its plain PyTorch version on
     the card, 3 metrics x {f32, bf16} rows at the serving, the build and
     the tail (B 418) shape, plus times (below); untimed, the shapes of
     later paths: the dynamic path's, the iterator's first and deepest
     page (B 8, C 21 and 1024), calibration's widest search and compacted
     tail at pop width 8 (K 256: C 512 at B 1000, C 16 at B 250);
  4. kernels, LVQ: beam_step_lvq against beam_step_lvq_plain, 3 metrics x
     the three shapes (n_dead 28 when serving, 0 at the build shape),
     exact and real inputs, and against beam_step over the decoded rows;
     times and the bound; untimed, LeanVec's shapes (64 live lanes of 128,
     n_dead 64: serving B 2048 and tail B 418 at C 30, the build's B 2500
     at C 100), real-input rows off the plain version's proven near-ties;
  5. kernels, scored: beam_update against beam_update_plain at the three
     shapes (tied and real keys: identical outputs);
     score_rows against its plain version at (2048, 128, 128) f32;
     gather_score_l2_partial against its plain version from a 100k x 128
     table in f32, float16 and int8, ids with repeats, at (2048, 128),
     and in float16 at the tail's (418, 128);
     times, bounds, plain times, and torch.bmm (the dot half of
     score_rows) as score_rows' library call.
     A kernel's time ``ms`` is device time: RAW_LAUNCHES calls of its C
     entry point back to back between two CUDA events (outputs
     preallocated, inputs rotated over copies that together exceed twice
     the L2 cache), median of RAW_WINDOWS windows, with the host's issue
     time per launch and torch.profiler's device time beside it;
     ``call_ms`` is one call of the Python wrapper as the search loop pays
     it;
  6. main path: a 100k x 128 clustered dataset (seed 42), Vamana build
     (R=32, window 100, pool 300, prune_to 28, alpha 1.1, sampled
     entries), exhaustive ground truth, bf16 packed serving of 5000
     queries, window sweep to recall@10 >= 0.9, QPS over 5 repetitions;
     the kernel's launch count must grow during build and during serving;
  7. persistence: the main index saved and assembled onto the card three
     ways (save / assemble, save_stream / assemble_stream, save_host /
     assemble), each copy's graph, dataset, sampler and parameters equal
     to the live index's and its bf16 packed search identical in ids and
     distances (beam_step launching); the JAX package's legacy v0.0.1 LVQ
     checkpoints (data/legacy) loaded on the card, decoding within 1e-5 of
     a fresh compress; seconds and bytes of every round trip;
  8. host rerank: recall@10 and QPS of the main index at its window with
     float16 uploads, int8 uploads, and int8 uploads re-ranked exactly on
     the host (enable_host_rerank), which must not lose recall to int8
     alone;
  9. LVQ path, over the main path's graph: LVQ-8 packed serving (window
     sweep to recall@10 >= 0.9, QPS), LVQ-8 unpacked and two-level LVQ8x8
     packed (rerank) at that window; then an LVQ-8 build at 100k x 128
     with the main path's parameters and its sweep; beam_step_lvq's launch
     count must grow in every one of them; compress_and_save_host equal to
     LVQDataset.compress bit for bit, and the LVQ8x8 dataset and the LVQ-8
     index saved, assembled and served identically;
  10. scored path, over the main path's data: a float16 VectorDataset on the
     main path's graph, unpacked (window sweep to recall@10 >= 0.9, QPS,
     recall within 0.01 of the f32 index at that window;
     gather_score_l2_partial and beam_update launch); an SQ-int8 build at
     100k x 128 with the main path's parameters (seconds, mean degree,
     beam_update and score_rows launches) and its unpacked serving (window
     sweep against the exact search over the decoded rows, since one
     global scale caps SQ-int8's recall against the f32 truth; that recall
     and its cap are printed beside it); one
     wide search (capacity 1280, window 1280, k 10, 1000 queries, f32
     rows: gather_score_l2_partial launches, beam_update does not; recall
     at least the f32 index's at window 128); the float16 dataset and the
     SQ-int8 index saved, assembled and served identically;
  11. dynamic path, over the main path's data: a DynamicVamana built over
     80,000 rows (ReferenceDataset seed 0) in storage for 84,000 with the
     main path's parameters, bf16 packed serving and sampled entries; four
     cycles of 5,000 adds (the first grows the storage in place) and 5,000
     deletes, consolidate after cycles 2 and 4 (affected vertices counted),
     compact at the end; after the build and every step the window sweep
     to recall@10 >= 0.9 against the exact search over the live set, with
     every search launching beam_step and returning only live ids, and QPS
     at that window (host clock, noisy); seconds, launches and peak device
     memory of every step; after cycle 3's delete a save / assemble round
     trip with the deleted slots pending (identical ids and distances);
     DynamicFlat through the same mutations, recall@10 >= 0.999 with every
     miss a tie of the 10th distance;
  12. iterator: BatchIterator over the main index, 32 queries x 10 pages
     of 10 from the main path's serving window (pages disjoint and nearest-first, first-page
     recall@10 >= 0.9, the ten pages covering >= 0.95 of the exact
     top-100, restart repeating the first page, beam_step launching on
     every page); one query paged in pages of 64 past capacity 1024 into
     the wide route (no repeats; its pages launch gather_score_l2_partial
     and no beam_step); the dynamic index after deleting the 128 live rows
     nearest a query: no deleted or unknown id ever yielded, no page empty;
     then beam_step against its plain version at every shape, row type,
     query type and metric the phase gave it (recorded as it ran);
  13. calibrate: calibrate_full on the main index to recall@10 0.9 with
     1000 calibration queries; the winner set on the index and its recall
     on the other 4000 queries >= 0.89; again with the int8 upload axis
     (where int8 wins, the index uploads int8 queries); an unreachable
     target returns the best effort; trials, winner, recall and QPS (host
     clock, noisy); then beam_step against its plain version at every
     shape the phase gave it, as in 12;
  14. LeanVec over the main path's data: PCA and OOD (a query training set
     of 10,000 in-distribution queries that are not the test queries) to
     64 dimensions, LVQ-8 primary and secondary; LeanVecVamana built with
     the main path's parameters and sampled entries (beam_step_lvq at
     n_dead 64); the primary search alone swept to recall@10 >= 0.9
     against the exact search over the decoded primary with the projected
     queries; the reranked search's f32-truth recall and QPS at every
     window from the fetch (k * 3 = 30) up; the projection's ceiling, the
     exact projected top-30 (and top-100) reranked, reported; PCA's share
     of the variance and of query-to-neighbour distances; the rerank of 256
     queries held to a float64 host rerank of the fetched ids; a save /
     assemble round trip searched identically; every search and the build
     launching beam_step_lvq;
  15. golden gate: the L2, MIP and cosine rows of
     data/golden/vamana_reference.json within +-0.05 recall (GOLDEN_TOL),
     the bf16, SQ-int8, LVQ-8 and LVQ8x8 rows of
     data/golden/torch_kinds_reference.json (written by
     tools/make_torch_kinds_golden.py with the JAX package) within +-0.01
     (GOLDEN_KINDS_TOL), the IVF rows of data/golden/ivf_reference.json
     (L2 / MIP / cosine at n_probes 1, 4, 16, 32) within +-0.05, but for
     the four rows GOLDEN_IVF_BY_SEED_MEAN names, which depend on the
     k-means++ draws and are gated as the mean over the 32 seeds of
     data/golden/torch_ivf_seed_mean_reference.json (the JAX package's
     mean; tools/make_torch_ivf_seed_mean_golden.py) within +-0.05, and
     the inverted rows of data/golden/inverted_reference.json (epsilons
     0, 0.25, 1 at max_probes 32) within +-0.03; the Vamana, IVF and
     inverted rows are the ones phase 18's golden generators wrote;
  16. IVF over the main path's data (after 14, before 15): bench.py's
     configuration (3 sqrt(n) = 948 centroids, minibatch k-means, 10
     iterations, every row trained on, f32 rows, query batches of 2500);
     training seconds and a second training with the same seed (identical
     centroids and assignments); slot and padding factor; the probe sweep
     over (1 .. 128) to recall@10 >= 0.9 and QPS there; a full probe
     (misses only ties of the 10th distance, 256 queries' distances
     against float64 on the host); the row-gather scan route
     (SVT_IVF_SCAN_LAYOUT=0) giving the super-row route's ids but at
     near-ties proven on the host; a
     hierarchical training and its sweep; LVQ-8 postings with the rerank
     at k_reorder 3, swept; save / assemble_from_file (identical search)
     and save_packed_layout_host (bf16 rows, recall reported);
     IVFBatchIterator, 32 queries x 10 pages of 10 (disjoint, none short,
     restart repeats page one, top-100 coverage reported); DynamicIVF over
     80,000 rows (ReferenceDataset seed 0): two cycles of 5,000 adds and
     5,000 deletes and a compact, the probe sweep against the exact search
     over the live set after every step (no deleted or unknown id),
     seconds and probe units per step.  No kernel of the repo is on this
     path: the posting scan is PyTorch code;
  17. inverted index over the main path's data (after 16): the defaults
     (10,000 centroids, the default Vamana primary, epsilon 0.05, 8
     replicas); the build split into primary graph, closure assignment and
     packing, slot, padding, mean replicas and the layout's bytes; the
     sweep over max_probes 16, 32 x epsilon 0, 0.25, 1, 2 to recall@10 >=
     0.9 and QPS there; 256 queries' distances against float64 on the
     host; a save / assemble round trip searched identically; beam_step
     launching in the build and every search, then held to its plain
     version at every call the phase made, as in 12.
  18. tools (after 17, before 15), over the benchmark runner
     (scalablevectorsearch_tpu_torch.benchmark), the reference-layout
     interop, the upgrader and the native vecs loader: the runner's
     vamana_search over the saved main index (the main path's data,
     packed serving, the saved sampler config; at the main path's window
     the main path's recall to the digit); the reference layout
     (svs_config.toml + .svs) written from the main index and loaded onto
     the card (UUIDs match their blobs; adjacency, rows and entry point
     identical; served as the main path serves it, identical ids and
     distances); copies of the three data/legacy checkpoints upgraded
     and assembled onto the card (all current, LVQ decoding within 1e-5
     of a fresh compress); the 1M x 128 job data as .fvecs read by the
     native loader and by NumPy (identical; both rates); vamana_dynamic
     (two cycles, recall@10 >= 0.9 after each at the job's window),
     vamana_iterator (recall >= 0.95) and inverted_search (>= 0.9 at some
     epsilon) at 20,000 x 128 (data/jobs/ivf_10m.json through the CLI is
     in 21); the three golden generators at the settings of their
     reference files; then beam_step against its plain version at every
     call the phase made, as in 12;
  19. parallel (after 18, before 15), the multi-device package over
     logical shards of the card (meshes of 1, 2 and 8 x cuda:0): 1M x 128
     rows (seed 42) written as .fvecs and streamed into 8 shards
     (shard_dataset_from_file), identical to the host-staged layout, and
     1000 queries' sharded top-10 equal to the single-device flat search
     but ties of the 10th distance; the main data's IVF index (948
     centroids) with its probe units over 8 shards at n_probes 3, equal to
     the single-device search (f32 uploads) up to proven near-ties, recall
     reported; dp_greedy_search of the 5000 queries in 8 chunks at the
     main window over f32 rows (beam_step) and LVQ-8 codes (beam_step_lvq)
     against one greedy_search (ids identical or proven near-ties; keys
     identical or their largest relative difference reported);
     sharded_greedy_search over the main graph with f32, float16, LVQ-8
     and SQ-int8 rows at 1, 2 and 8 shards, equal bit for bit across shard
     counts, float16 and SQ bit for bit to the single-device search, f32
     and LVQ-8 up to proven near-ties, recall@10 within 0.005;
     sharded_build_graph over the main data's first 20,000 rows (main
     parameters, sampled entries) at 2 shards and, streamed from .fvecs,
     at 8: identical graphs, recall@10 and mean degree within 0.01 of the
     single-device build; ShardedMutableVamanaIndex.from_single_chip of a
     20,000-row MutableVamanaIndex at 8 shards through 1,000 adds, 1,000
     deletes, consolidate and compact mirrored on the single-device index
     (after every step ids equal up to proven near-ties, recall@10 >= 0.9
     at window 100; the same external entry point after compact;
     to_single_chip round trip identical); seconds per step and shard
     count, launches, peak device memory; then every kernel against its
     plain version at every call the phase made (step_shapes,
     scored_shapes);
  20. examples (after 19, before 15): the port's six examples
     (scalablevectorsearch_tpu_torch/examples) through their run(device=
     "cuda") at the JAX examples' own sizes (10k-50k rows, uncut), their
     own asserts holding, every printed recall held to data/golden/
     torch_examples_reference.json (the JAX examples' printed numbers,
     written by tools/make_torch_examples_golden.py) within EXAMPLES_TOL,
     the dynamic rows within EXAMPLES_DYNAMIC_TOL and IVF at 2 probes
     within EXAMPLES_FEW_PROBES_TOL; the calibrated window printed beside
     JAX's, its recall >= 0.95; QPS and latency of the serving example
     (host clock); then MultiMutableVamanaIndex over the main data's
     first 20,000 rows, two vectors per label, through 1,000 adds, 250
     deleted labels, consolidate and compact (label recall@10 >= 0.9
     against the exact label ranking after every step, no deleted label,
     no label twice, beam_step launching; a save / assemble round trip
     searched identically); svt.Flat over the main rows (misses only ties
     of the 10th distance; round trip identical); BatchIterator with
     LinearSchedule over the main index, 32 queries x 5 pages; seconds per
     example and part, peak device memory; then every kernel against its
     plain version at every call the phase made.
  21. scale_10m (after 20, before 15): data/jobs/ivf_10m.json unchanged
     (10M x 96, hierarchical, K 8192) through the CLI in a child process
     (the JAX runner's keys, recall@10 >= 0.9 at some n_probes; build
     seconds, recall, QPS, p50 / p99 per n_probes; the layout the child
     logs, its sampled peak device memory); a 10M x 96 f32 table (padded
     to 128 columns) made on the card from a seeded generator, and its
     float16 copy, each served by greedy_search (B 2000, windows 12 and
     48) over a random 32-regular graph: the route's kernels (beam_step;
     gather_score_l2_partial and beam_update) on real gathers; then, over
     that table and over the main path's 100k table, PyTorch's row gather
     of the search loop, beam_step on the gathered rows (C 12 and 48, K
     128) and gather_score_l2_partial (f32 and float16) held to their
     plain versions (keys rtol 1e-5, atol 1e-5 of the norms' scale; ids
     identical but proven near-ties, at most 0.1% of rows) and timed as
     kernel_ms times, beside their bounds over the bytes read (128
     columns) and the live bytes (96).
Each path (6-14, 16-21) starts with every launch count at 0 and reads them at
its end.  The line before the last is the JSON summary of the five
kernels (beam_step, beam_step_lvq, beam_update, score_rows,
gather_score_l2_partial; each kernel's launches are the sum over the
paths, ``launches_by_path`` beside it); the last line is
``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --kernels-only
    python3 chip_smoke.py --kernels-only --other-gather PATH.cu

run phases 1-5 alone and print every kernel's times by shape.  The second
form also builds PATH.cu, another version of csrc/gather_distance.cu (the
parent commit's, say, copied into a gitignored directory), and times its
score_rows and gather_score_l2_partial in turns with this checkout's on
the same inputs (other, this, this, other).  Phase 2 prints the SASS
instruction counts of both gather_distance libraries (cuobjdump).

    python3 chip_smoke.py --parallel-only

runs phases 1, 2, 6 and 19 alone: the main path, then the parallel phase.

    python3 chip_smoke.py --examples-only

runs phases 1, 2, 6 and 20 alone: the main path, then the examples.

    python3 chip_smoke.py --scale-10m-only

runs phases 1, 2, 6 and 21 alone: the main path, then the 10M phase.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "data", "golden", "vamana_reference.json")
GOLDEN_KINDS = os.path.join(HERE, "data", "golden",
                            "torch_kinds_reference.json")
SERVING_SHAPE = (2048, 16, 128, 128, 12, 4)   # B, C, K, d, window, m
BUILD_SHAPE = (2500, 100, 128, 128, 100, 4)
# the serving search's compacted tail: a 1672-query batch's last quarter
TAIL_SHAPE = (418, 16, 128, 128, 12, 4)
STEP_SHAPES = (("serving", SERVING_SHAPE), ("build", BUILD_SHAPE),
               ("tail", TAIL_SHAPE))
# shapes only later paths give beam_step, checked against the plain
# version but not timed: the dynamic path's searches widen the beam to
# max(window, 2k) = 20 slots (a batch of 2048 and the compacted tail), and
# each add_points round runs 125 rows at the build window; the iterator
# pages one query (B 8) at capacity window + batch, up to 1024 before the
# wide route; calibration searches 1000 queries at pop width 8 (K 256) up
# to its window bound of 512, and at the compacted tail of a quarter; the
# inverted index searches its 10,000 centroids (R 32) at window 32 in
# batches of 1672, and builds them in rounds of 250 at pop width 1
UNTIMED_STEP_SHAPES = (("dynamic serving", (2048, 20, 128, 128, 11, 4)),
                       ("dynamic tail", (418, 20, 128, 128, 11, 4)),
                       ("dynamic add", (125, 100, 128, 128, 100, 4)),
                       ("iterator first page", (8, 21, 128, 128, 11, 4)),
                       ("iterator deep page", (8, 1024, 128, 128, 960, 4)),
                       ("calibrate widest", (1000, 512, 256, 128, 512, 8)),
                       ("calibrate tail", (250, 16, 256, 128, 10, 8)),
                       ("inverted serving", (1672, 32, 128, 128, 32, 4)),
                       ("inverted build", (250, 200, 32, 128, 200, 1)))
WINDOWS = (11, 12, 13, 14, 16, 20, 24, 32, 48, 64, 96, 128)
# Recall tolerance per golden row.  The cosine row moves by up to 0.097 in
# the JAX package itself when only the build batch size changes, but the
# port's build on the card reproduces the reference's cosine row to the
# digit (0.3730 / 0.4796 / 0.5642 / 0.6656 in every run since the beam-step
# redesign), so all three rows are held to +-0.05.
GOLDEN_TOL = {"L2": 0.05, "MIP": 0.05, "Cosine": 0.05}
# The card reproduces the four kinds' rows within 0.0016, and a bf16 row
# computed in f32 would pass +-0.05 at three of its windows: +-0.01.
GOLDEN_KINDS_TOL = 0.01
# IVF rows (data/golden/ivf_reference.json): the port's k-means++ draws
# differ from the JAX package's by design, so +-0.05; the inverted rows
# (inverted_reference.json) draw only numpy generators: +-0.03, the JAX
# package's own tolerance.
GOLDEN_IVF = os.path.join(HERE, "data", "golden", "ivf_reference.json")
GOLDEN_INVERTED = os.path.join(HERE, "data", "golden",
                               "inverted_reference.json")
GOLDEN_IVF_TOL, GOLDEN_INVERTED_TOL = 0.05, 0.03
# IVF rows that leave +-0.05 of the reference under some k-means++ draw
# (L2 and cosine at 1 probe, MIP at 1 and 4 probes): one training of the
# port cannot reproduce one training of the JAX package, so these rows are
# gated as means over the seeds of GOLDEN_IVF_SEED_MEAN (the JAX package's
# means over the same seeds; tools/make_torch_ivf_seed_mean_golden.py,
# spread: tools/ivf_golden_spread.py), within GOLDEN_IVF_TOL.
GOLDEN_IVF_BY_SEED_MEAN = {("L2", "1"), ("MIP", "1"), ("MIP", "4"),
                           ("Cosine", "1")}
GOLDEN_IVF_SEED_MEAN = os.path.join(HERE, "data", "golden",
                                    "torch_ivf_seed_mean_reference.json")
TIMING_REPS = 20
RAW_LAUNCHES = 50              # raw launches per timing window
RAW_WINDOWS = 5
L2_BYTES = 50_000_000          # H100 L2 cache
SLEEP_CYCLES = 4_000_000       # ~2 ms: longer than queueing one window
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 peak
F32_FLOPS_PER_S = 67e12        # H100 SXM fp32 peak outside the tensor cores
LVQ_DEAD = {"serving": 28, "build": 0, "tail": 28}   # n_dead per shape
# LeanVec's primary: 64 projected columns in 128 lanes.  Its searches fetch
# k * 3 = 30 candidates, so window and capacity are at least 30; its build
# runs the main path's rounds.  Checked against the plain version, untimed.
LEANVEC_DIM = 64
LEANVEC_CHECK_SHAPES = (("leanvec serving", (2048, 30, 128, 128, 30, 4)),
                        ("leanvec tail", (418, 30, 128, 128, 30, 4)),
                        ("leanvec build", (2500, 100, 128, 128, 100, 4)))
ITER_QUERIES, ITER_PAGES = 32, 10
SCORE_SHAPE = (2048, 128, 128)          # B, K, d of the scoring kernels
TABLE_ROWS = 100_000
WIDE_CAPACITY = 1280
# dynamic phase: initial rows, their storage (the first add grows it), and
# the rows added and deleted in each of its four cycles
DYN_ROWS, DYN_CAPACITY, DYN_BATCH = 80_000, 84_000, 5000
SOURCES = ("beam_step", "gather_distance")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is False); this check runs only on the GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    smi = card_line()
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


def ptxas_report(text: str) -> list:
    """One entry per kernel instance (its mangled name carries the row
    loader, DenseRows<...> or LvqRows, and the query type): what ptxas said
    about registers, spills and shared memory."""
    out, name = [], None
    for ln in text.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
        elif name and ("registers" in ln or "spill" in ln):
            out.append(f"{name}: {ln.split(':', 1)[-1].strip()}")
    return out


def build_other(source: str):
    """nvcc of another version of csrc/gather_distance.cu (``source``, e.g.
    the parent commit's) with the package's flags into its ``_build/``;
    returns the library path.  Its C entry points keep their names and
    signatures, so the same argument builders serve both."""
    import hashlib
    from pathlib import Path
    from scalablevectorsearch_tpu_torch.ops.kernels import _build
    src = Path(source).resolve()
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = _build.BUILD_DIR / f"libother_gather_distance_{digest}.so"
    _build.BUILD_DIR.mkdir(exist_ok=True)
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                           str(out), str(src)], capture_output=True,
                          text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    return out


# SASS opcodes counted per kernel instance by sass_report
SASS_OPS = ("LDG", "STG", "SHFL", "I2F", "HADD2.F32", "PRMT", "IDP", "LOP3",
            "FFMA", "FADD", "FMUL", "IMAD", "LDS")


def sass_report(lib) -> list:
    """Instruction counts per kernel instance of ``lib`` from ``cuobjdump
    -sass`` (an opcode counts under the first SASS_OPS entry it starts
    with), or one line saying why there are none."""
    from scalablevectorsearch_tpu_torch.ops.kernels import _build
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    proc = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=False)
    if proc.returncode != 0:
        return [f"cuobjdump failed: {proc.stderr.strip()[:200]}"]
    funcs, name = {}, None
    for ln in proc.stdout.splitlines():
        if "Function :" in ln:
            name = ln.split("Function :", 1)[1].strip()
            funcs[name] = {}
        elif name and ln.strip().startswith("/*") and "*/" in ln:
            body = ln.split("*/", 1)[1].strip()
            if not body or body.startswith("/*"):
                continue
            words = body.split()
            op = words[1] if words[0].startswith("@") else words[0]
            op = op.rstrip(";")
            counts = funcs[name]
            counts["total"] = counts.get("total", 0) + 1
            for key in SASS_OPS:
                if op.startswith(key):
                    counts[key] = counts.get(key, 0) + 1
                    break
    filt = os.path.join(os.path.dirname(tool), "cu++filt")
    out = []
    for mangled, counts in funcs.items():
        shown = mangled
        if os.path.exists(filt):
            shown = subprocess.run([filt, mangled], capture_output=True,
                                   text=True, check=False).stdout.strip() \
                or mangled
        out.append(f"{shown}: " + " ".join(
            f"{k} {counts.get(k, 0)}" for k in ("total",) + SASS_OPS))
    return out


def phase_build(other_gather: str | None = None) -> tuple:
    """Both sources at once (and ``other_gather``, another version of
    csrc/gather_distance.cu, beside them), one nvcc each; returns the wall
    seconds and the other library's path (None without one)."""
    from scalablevectorsearch_tpu_torch.ops.kernels import _build
    jobs = {f"{name}.cu": functools.partial(_build.build, name)
            for name in SOURCES}
    other = f"{other_gather} (other gather_distance.cu)"
    if other_gather:
        jobs[other] = functools.partial(build_other, other_gather)
    t0 = time.perf_counter()

    def one(build):
        start = time.perf_counter()
        return build(), time.perf_counter() - start

    with ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(one, jobs.values())))
    seconds = time.perf_counter() - t0
    for label, (path, own_s) in built.items():
        log(f"build: {label} -> {path.name} in {own_s:.2f} s")
        for line in ptxas_report(path.with_suffix(".log").read_text()):
            log(f"build: ptxas {line}")
        if "gather_distance" in label:
            for line in sass_report(path):
                log(f"build: sass {line}")
    log(f"build: {len(jobs)} libraries in {seconds:.2f} s")
    return seconds, (built[other][0] if other_gather else None)


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
    out = [torch.from_numpy(np.ascontiguousarray(x)).cuda()
           for x in (beam_keys, beam_packed, table, cand_ids, queries)]
    out[2] = out[2][out[3].clamp_min(0).long()]    # (B, K, d) rows
    out[4] = out[4].to(query_dtype)
    return out


def median_ms(fn, reps: int = TIMING_REPS) -> float:
    """One CUDA event pair around one call of ``fn``, median of ``reps``:
    the time a caller pays for one call of a Python wrapper, the wrapper's
    host work included (``call_ms``)."""
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


def input_sets(args: list) -> list:
    """``args`` and enough device copies of it that the sets together
    exceed twice the L2 cache, so that no launch finds its inputs there."""
    n = max(2, -(-2 * L2_BYTES // nbytes(*args)))
    return [args] + [[t.clone() for t in args] for _ in range(n - 1)]


def time_raw(entry, args: list, make_out, make_raw, other=None) -> dict:
    """:func:`kernel_ms` over :func:`input_sets` of ``args``:
    ``make_out(set)`` preallocates a set's outputs, ``make_raw(set, out)``
    gives the entry point's C arguments.  With ``other`` (the same entry
    point of another build of the source), the two run in turns on the
    same inputs: other, this, this, other; ``ms`` is this one's mean,
    ``other_ms`` the other's, ``turns_ms`` the four in order."""
    sets = input_sets(args)
    outs = [make_out(a) for a in sets]
    raw = [make_raw(a, o) for a, o in zip(sets, outs)]
    if other is None:
        return kernel_ms(entry, raw)
    turns = [kernel_ms(fn, raw) for fn in (other, entry, entry, other)]
    t = dict(turns[1])
    t["turns_ms"] = [x["ms"] for x in turns]
    t["ms"] = (turns[1]["ms"] + turns[2]["ms"]) / 2
    t["other_ms"] = (turns[0]["ms"] + turns[3]["ms"]) / 2
    return t


def kernel_ms(entry, raw_args: list) -> dict:
    """Device time of one kernel: ``entry`` (a C entry point of a built
    library) is called with each tuple of ``raw_args`` in turn (raw
    pointers and ints; outputs preallocated), RAW_LAUNCHES times back to
    back between two CUDA events; ``ms`` is the elapsed time over the
    count, the median of RAW_WINDOWS such windows.  A sleep kernel ahead
    of the start event holds the device while the host queues the window's
    launches, so ``ms`` is device time even where the host issues more
    slowly than the kernel runs.  ``issue_ms`` is the host's time to issue
    one raw launch; ``host_bound`` says it is not well below ``ms`` (a
    caller launching one at a time would keep the device waiting).
    ``profiler_ms``: the mean device time per launch that torch.profiler
    reports for the same launches (a cross-check)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    n = len(raw_args)
    err = 0
    for a in raw_args:                        # warm up
        err |= entry(*a)
    torch.cuda.synchronize()
    windows, issue = [], []
    for _ in range(RAW_WINDOWS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        t0 = time.perf_counter()
        for i in range(RAW_LAUNCHES):
            err |= entry(*raw_args[i % n])
        issue.append((time.perf_counter() - t0) * 1e3 / RAW_LAUNCHES)
        end.record()
        end.synchronize()
        windows.append(start.elapsed_time(end) / RAW_LAUNCHES)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(RAW_LAUNCHES):
            err |= entry(*raw_args[i % n])
        torch.cuda.synchronize()
    if err:
        raise RuntimeError(f"kernel launch failed: CUDA error {err}")
    dev = [(getattr(e, "self_device_time_total", 0.0)
            or getattr(e, "self_cuda_time_total", 0.0), e.count)
           for e in prof.key_averages() if e.device_type != DeviceType.CPU]
    dev = [(t, c) for t, c in dev if t > 0]
    top = max(dev, default=(0.0, 1))
    ms, issue_ms = statistics.median(windows), statistics.median(issue)
    return {"ms": ms, "issue_ms": issue_ms,
            "profiler_ms": top[0] / 1e3 / max(top[1], 1),
            "host_bound": issue_ms > 0.5 * ms, "input_sets": n}


def describe(t: dict) -> str:
    """The timing fields of one kernel case, for the log."""
    other = "" if "other_ms" not in t else (
        f"; other source {t['other_ms']:.4f} ms (turns other, this, this, "
        f"other: {', '.join(f'{x:.4f}' for x in t['turns_ms'])})")
    return (f"device {t['ms']:.4f} ms/launch (profiler "
            f"{t['profiler_ms']:.4f}, host issue {t['issue_ms']:.4f}"
            f"{' HOST-BOUND' if t['host_bound'] else ''}, "
            f"{t['input_sets']} input sets), wrapper call {t['call_ms']:.4f}"
            f" ms, plain {t['plain_ms']:.4f} ms; bound {t['bound_ms']:.4f} "
            f"ms by {t['bound_by']} ({t['bytes']} bytes, {t['flops']} "
            f"flops) = {t['bound_ms'] / t['ms']:.1%} of it" + other)


def make_lvq_case(rng, shape, n_dead: int, grid: bool):
    """beam_step_lvq inputs on the card: the beam and candidate ids of
    :func:`make_case`, int8 code rows with per-id scale and bias, a mean,
    and queries, zero in the ``n_dead`` trailing lanes.  ``grid``: codes in
    [-16, 15], scales 2^-4 or 2^-5, biases, mean and queries on the 1/32
    grid within [-1, 1], so every decoded value, product and sum is exact
    in f32 and the kernel must match the plain version bit for bit.
    Otherwise the codes, scales, biases and mean are those of
    ``LVQDataset.compress`` over a normal table of ``d - n_dead`` columns
    (real LVQ-8 data), and the queries are normal."""
    from scalablevectorsearch_tpu_torch.quantization.lvq import LVQDataset
    B, C, K, d, _window, _m = shape
    beam_keys, beam_packed, _vecs, cand_ids, _q = make_case(
        rng, (B, C, K, 4, 1, 1), grid=False)
    n_ids = max(400, 2 * C)          # make_case's id range
    live = d - n_dead

    def on_grid(x):
        return np.clip(np.rint(x * 8), -32, 32) / np.float32(32)

    if grid:
        codes = rng.integers(-16, 16, size=(n_ids, d))
        scales = 2.0 ** -rng.integers(4, 6, size=n_ids)
        biases = on_grid(rng.normal(size=n_ids))
        mean = on_grid(rng.normal(size=d))
        queries = on_grid(rng.normal(size=(B, d)))
    else:
        lvq = LVQDataset.compress(rng.normal(size=(n_ids, live)), bits=8,
                                  device="cpu")
        if lvq.padded_dim != d:
            raise ValueError(f"{live} live columns pad to {lvq.padded_dim}, "
                             f"not {d}")
        codes, scales, biases, mean = (t[:n_ids].numpy() for t in (
            lvq.codes, lvq.scales, lvq.biases, lvq.mean))
        mean = mean.copy()
        queries = rng.normal(size=(B, d))
    codes[:, live:] = 0
    mean[live:] = 0
    queries[:, live:] = 0
    cl = cand_ids.clamp_min(0).cpu().numpy()
    rows = [torch.from_numpy(np.ascontiguousarray(x)).cuda() for x in (
        codes.astype(np.int8)[cl], scales.astype(np.float32)[cl],
        biases.astype(np.float32)[cl], mean.astype(np.float32)[None, :],
        queries.astype(np.float32))]
    return [beam_keys, beam_packed, *rows[:4], cand_ids, rows[4]]


def step_bound(args, m: int, flops_per_value: int, live=None) -> dict:
    """Least time for one beam step on these inputs: every input read once
    and the five outputs written once, over the HBM peak, against the f32
    operations on the row block over the f32 peak.  The rows of invalid
    candidates (id -1) do not count: no output depends on them.  With
    ``live``, only the first ``live`` columns of the rows and the queries
    count: the bytes that carry data where the rest is padding."""
    beam_keys, rows, cand_ids, queries = args[0], args[2], args[-2], args[-1]
    b, c = beam_keys.shape
    k = rows.shape[1]
    dead_rows = int((cand_ids < 0).sum())
    row_values = rows.shape[2]
    live = row_values if live is None else live
    padding = (row_values - live) * ((b * k - dead_rows) * rows.element_size()
                                     + b * queries.element_size())
    return bound_of(nbytes(*args) + b * (c * 8 + m * 4 + k * 8)
                    - dead_rows * row_values * rows.element_size() - padding,
                    flops_per_value * (b * k - dead_rows) * live)


def unexplained_rows(args, got, want, rows_off, window: int,
                     tol: float) -> list:
    """Rows of ``rows_off`` where the kernel's beam or pops differ from the
    plain version's by more than near-ties.  A row is explained when every
    id of the kernel's beam carries, at its slot, the plain version's key
    for that id (from the input beam or the plain pool) within ``tol``, no
    id repeats, and the kernel's pops are unvisited ids of its beam inside
    the window whose plain keys equal the plain pops' keys within
    ``tol``."""
    from scalablevectorsearch_tpu_torch.ops.kernels.beam_step import ID_MASK
    beam_keys, beam_packed = args[0], args[1]
    gk, gp, gpop = got[:3]
    wpop, wpk, wpi = want[2:]
    bad = []
    for r in torch.nonzero(rows_off).flatten().tolist():
        key_of = {int(i): k for i, k in zip(wpi[r].tolist(), wpk[r].tolist())
                  if i >= 0 and np.isfinite(k)}
        old_vis = {}
        for k, p in zip(beam_keys[r].tolist(), beam_packed[r].tolist()):
            if np.isfinite(k):
                key_of[p & ID_MASK] = k
                old_vis[p & ID_MASK] = p >> 30
        slots = [(k, p & ID_MASK, p >> 30) for k, p in
                 zip(gk[r].tolist(), gp[r].tolist()) if np.isfinite(k)]
        ids = [i for _k, i, _v in slots]
        ok = len(set(ids)) == len(ids) and all(
            i in key_of and abs(key_of[i] - k) <= tol * (1 + abs(k))
            for k, i, _v in slots)
        popped = [i for i in gpop[r].tolist() if i >= 0]
        in_window = {i: v for (_k, i, v) in slots[:window]}
        ok = ok and all(in_window.get(i) == 1 and old_vis.get(i, 0) == 0
                        for i in popped)
        want_pops = sorted(key_of.get(i, np.inf)
                           for i in wpop[r].tolist() if i >= 0)
        got_pops = sorted(key_of.get(i, np.inf) for i in popped)
        ok = ok and len(got_pops) == len(want_pops) and all(
            abs(a - b) <= tol * (1 + abs(b))
            for a, b in zip(got_pops, want_pops))
        if not ok:
            bad.append(r)
    return bad


def check_step(rng, label: str, shape, vdt, metric: int,
               failures: list, qdt=torch.float32) -> tuple:
    """One beam_step case against beam_step_plain at ``shape`` (B, C, K,
    d, window, m) with ``vdt`` rows and ``qdt`` queries.  Grid inputs: all
    five outputs identical.  Real-valued inputs: keys within rtol/atol 1e-5
    (f32 rows and queries) or 1e-3 (bf16), the pool ids identical, and the
    beam ids and pops identical except at near-ties that
    ``unexplained_rows`` proves.  Appends what fails to ``failures``;
    returns (max_abs_err, rows off the plain ids or pops, rows)."""
    from scalablevectorsearch_tpu_torch.ops.kernels import beam_step as bs
    window, m = shape[4:]
    exact = vdt == torch.float32 and qdt == torch.float32
    tol = 1e-5 if exact else 1e-3
    kw = dict(metric=metric, window=window, m=m)
    name = f"{label}/{vdt}/{qdt}/m{metric}"
    grid = make_case(rng, shape, grid=True, query_dtype=qdt)
    grid[2] = grid[2].to(vdt)
    got = bs.beam_step(*grid, **kw)
    want = bs.beam_step_plain(*grid, **kw)
    torch.cuda.synchronize()
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        failures.append(f"{name} grid mismatch")
    real = make_case(rng, shape, grid=False, query_dtype=qdt)
    real[2] = real[2].to(vdt)
    got = bs.beam_step(*real, **kw)
    want = bs.beam_step_plain(*real, **kw)
    return compare_step(name, real, got, want, window, tol, failures)


def compare_step(name: str, real: list, got, want, window: int, tol: float,
                 failures: list, atol=None) -> tuple:
    """beam_step's outputs ``got`` against the plain version's ``want`` on
    real-valued inputs ``real``: keys within rtol ``tol`` and atol
    ``atol`` (``tol`` by default), the pool ids identical, the beam ids
    and pops identical except at near-ties that ``unexplained_rows``
    proves.  Appends what fails to ``failures``; returns (max_abs_err,
    rows off the plain ids or pops, rows)."""
    atol = tol if atol is None else atol
    gk, gp, gpop, gpk, gpi = got
    wk, wp, wpop, wpk, wpi = want
    fin = torch.isfinite(wk)
    if not torch.equal(fin, torch.isfinite(gk)):
        failures.append(f"{name} inf slots")
    err = float((gk[fin] - wk[fin]).abs().max()) if bool(fin.any()) else 0.0
    if not torch.allclose(gk, wk, rtol=tol, atol=atol) or \
            not torch.allclose(gpk, wpk, rtol=tol, atol=atol) \
            or not torch.equal(gpi, wpi):
        failures.append(f"{name} real keys/pool")
    rows_off = ((gp != wp) & fin).any(1) | (gpop != wpop).any(1)
    bad = unexplained_rows(real, got, want, rows_off, window, tol)
    if bad:
        failures.append(f"{name} real ids: rows {bad[:5]} differ beyond "
                        f"near-ties")
    return err, int(rows_off.sum()), rows_off.numel()


def phase_kernels() -> dict:
    """beam_step kernel vs beam_step_plain on the card (:func:`check_step`),
    at STEP_SHAPES (timed) and UNTIMED_STEP_SHAPES (checked only), f32 and
    bf16 rows, three metrics.  At most 0.1% of the rows of each timed case,
    and of the untimed shapes' cases together, may be near-ties with other
    ids or pops (reported)."""
    from scalablevectorsearch_tpu_torch.ops.kernels import beam_step as bs
    rng = np.random.default_rng(0)
    max_err, timings, failures = 0.0, {}, []
    swapped, rows = [0, 0], [0, 0]     # near-tie rows: [untimed, timed]
    for label, shape in STEP_SHAPES + UNTIMED_STEP_SHAPES:
        window, m = shape[4:]
        timed = (label, shape) in STEP_SHAPES
        for vdt in (torch.float32, torch.bfloat16):
            for metric in (0, 1, 2):
                err, off, n = check_step(rng, label, shape, vdt, metric,
                                         failures)
                max_err = max(max_err, err)
                swapped[timed] += off
                rows[timed] += n
                if timed and off > 1e-3 * n:
                    failures.append(f"{label}/{vdt}/m{metric} real ids "
                                    f"{off} rows")
            if not timed:
                continue
            args = make_case(rng, shape, grid=False)
            args[2] = args[2].to(vdt)
            kw = dict(metric=0, window=window, m=m)
            t = time_raw(
                bs._kernel_entry("svt_beam_step"), args,
                lambda a: bs._outputs(a[0], a[2].shape[1], m),
                lambda a, o: bs.beam_step_args(*a, o, **kw))
            t["call_ms"] = median_ms(lambda: bs.beam_step(*args, **kw))
            t["plain_ms"] = median_ms(lambda: bs.beam_step_plain(*args, **kw))
            # per value: a multiply-add for the dot and one for the norm
            t.update(step_bound(args, m, 4))
            timings[f"{label}_{'bf16' if vdt == torch.bfloat16 else 'f32'}"] \
                = t
            log(f"kernels: beam_step {label} B,C,K,d={shape[:4]} {vdt} L2: "
                + describe(t))
    if swapped[False] > 1e-3 * rows[False]:
        failures.append(f"untimed shapes: {swapped[False]} near-tie rows of "
                        f"{rows[False]}")
    if failures:
        raise AssertionError("beam_step kernel vs plain: "
                             + "; ".join(failures))
    log(f"kernels: beam_step matches plain: "
        f"{len(STEP_SHAPES) + len(UNTIMED_STEP_SHAPES)} shapes (3 timed) x "
        f"2 dtypes x 3 metrics; grid inputs identical, real inputs "
        f"max_abs_err {max_err:.3g}, near-tie rows with other ids or pops "
        f"{swapped[True]} of {rows[True]} at the timed shapes, "
        f"{swapped[False]} of {rows[False]} at the untimed ones")
    return {"max_abs_err": max_err, "timings": timings}


@contextlib.contextmanager
def step_shapes():
    """Inside the block, record every distinct call ``greedy_search``
    makes of beam_step, as ((B, C, K, d, window, m), row type, query type,
    metric), and of beam_step_lvq, as ((B, C, K, d, window, m), "lvq",
    n_dead, metric); yields the set.  The calls themselves are
    unchanged."""
    from scalablevectorsearch_tpu_torch.index.vamana import search as smod
    seen, step, step_lvq = set(), smod.beam_step, smod.beam_step_lvq

    def recording(beam_keys, beam_packed, vecs, cand_ids, queries, *,
                  metric, window, m):
        seen.add(((*beam_keys.shape, *vecs.shape[1:], window, m),
                  vecs.dtype, queries.dtype, metric))
        return step(beam_keys, beam_packed, vecs, cand_ids, queries,
                    metric=metric, window=window, m=m)

    def recording_lvq(beam_keys, beam_packed, codes, *args, metric, window,
                      m, n_dead):
        seen.add(((*beam_keys.shape, *codes.shape[1:], window, m), "lvq",
                  n_dead, metric))
        return step_lvq(beam_keys, beam_packed, codes, *args, metric=metric,
                        window=window, m=m, n_dead=n_dead)

    smod.beam_step, smod.beam_step_lvq = recording, recording_lvq
    try:
        yield seen
    finally:
        smod.beam_step, smod.beam_step_lvq = step, step_lvq


def check_step_shapes(path: str, seen: set) -> None:
    """The kernels against their plain versions (:func:`check_step`,
    :func:`check_lvq_step`) at every call that ``path`` made
    (:func:`step_shapes`): its shape, row and query types or n_dead, and
    metric; near-tie rows at most 0.1% of all.  Run after the path has
    read its launch counts."""
    rng = np.random.default_rng(1)
    failures, max_err, off, rows = [], 0.0, 0, 0
    t0 = time.perf_counter()
    for shape, kind, arg, metric in sorted(seen, key=str):
        if kind == "lvq":
            err, o, n, _real, _got = check_lvq_step(
                rng, f"{path} {shape}", shape, arg, metric, failures)
        else:
            err, o, n = check_step(rng, f"{path} {shape}", shape, kind,
                                   metric, failures, arg)
        max_err, off, rows = max(max_err, err), off + o, rows + n
    if off > 1e-3 * rows:
        failures.append(f"{off} near-tie rows of {rows}")
    if not seen or failures:
        raise AssertionError(f"{path}: kernels vs plain at the path's "
                             f"shapes: {'; '.join(failures) or 'none seen'}")
    widths = sorted({s[0][1] for s in seen})
    log(f"{path}: kernels match plain at the path's {len(seen)} calls "
        f"(B {sorted({s[0][0] for s in seen})}, C {widths[0]}-{widths[-1]}, "
        f"K {sorted({s[0][2] for s in seen})}, m "
        f"{sorted({s[0][5] for s in seen})}, rows "
        f"{sorted({str(s[1]) for s in seen})}, queries or n_dead "
        f"{sorted({str(s[2]) for s in seen})}); grid inputs identical, real "
        f"inputs max_abs_err {max_err:.3g}, near-tie rows {off} of {rows}; "
        f"{time.perf_counter() - t0:.1f} s")


def check_lvq_step(rng, label: str, shape, n_dead: int, metric: int,
                   failures: list) -> tuple:
    """One beam_step_lvq case against beam_step_lvq_plain at ``shape``
    with ``n_dead`` zero lanes.  Exact inputs: all five outputs identical.
    Real inputs: keys within rtol/atol 1e-5, pool ids identical, beam ids
    and pops identical except near-ties that ``unexplained_rows`` proves.
    Appends what fails to ``failures``; returns (max_abs_err, rows off the
    plain ids or pops, rows, the real inputs, the kernel's outputs on
    them)."""
    from scalablevectorsearch_tpu_torch.ops.kernels import beam_step as bs
    window, m = shape[4:]
    kw = dict(metric=metric, window=window, m=m, n_dead=n_dead)
    tag = f"{label}/m{metric}/dead{n_dead}"
    grid = make_lvq_case(rng, shape, n_dead, grid=True)
    got = bs.beam_step_lvq(*grid, **kw)
    want = bs.beam_step_lvq_plain(*grid, **kw)
    torch.cuda.synchronize()
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        failures.append(f"{tag} exact inputs differ")
    real = make_lvq_case(rng, shape, n_dead, grid=False)
    got = bs.beam_step_lvq(*real, **kw)
    want = bs.beam_step_lvq_plain(*real, **kw)
    gk, gp, gpop, gpk, gpi = got
    wk, wp, wpop, wpk, wpi = want
    fin = torch.isfinite(wk)
    if not torch.equal(fin, torch.isfinite(gk)):
        failures.append(f"{tag} inf slots")
    err = float((gk[fin] - wk[fin]).abs().max()) if bool(fin.any()) else 0.0
    if not torch.allclose(gk, wk, rtol=1e-5, atol=1e-5) or \
            not torch.allclose(gpk, wpk, rtol=1e-5, atol=1e-5) or \
            not torch.equal(gpi, wpi):
        failures.append(f"{tag} real keys/pool")
    off = ((gp != wp) & fin).any(1) | (gpop != wpop).any(1)
    bad = unexplained_rows(real, got, want, off, window, 1e-5)
    if bad:
        failures.append(f"{tag} real ids: rows {bad[:5]} differ beyond "
                        "near-ties")
    return err, int(off.sum()), off.numel(), real, got


def phase_kernels_lvq() -> dict:
    """beam_step_lvq kernel vs beam_step_lvq_plain on the card
    (:func:`check_lvq_step`; near-tie rows at most 0.1% of each case's,
    reported).  Also against beam_step over the
    decoded rows (dead lanes zero, as the JAX package's decoded path): keys
    within rtol/atol 1e-4, ids identical except near-ties."""
    from scalablevectorsearch_tpu_torch.ops.kernels import beam_step as bs
    from scalablevectorsearch_tpu_torch.quantization.lvq import affine_decode
    rng = np.random.default_rng(1)
    max_err, timings, failures = 0.0, {}, []
    swapped = swapped_dec = rows = 0
    for label, shape in STEP_SHAPES:
        _B, _C, _K, d, window, m = shape
        n_dead = LVQ_DEAD[label]
        for metric in (0, 1, 2):
            tag = f"lvq {label}/m{metric}/dead{n_dead}"
            err, off, n, real, got = check_lvq_step(
                rng, f"lvq {label}", shape, n_dead, metric, failures)
            max_err = max(max_err, err)
            swapped += off
            rows += n
            if off > 1e-3 * n:
                failures.append(f"{tag} real ids {off} rows")
            gk, gp, gpop, gpk, gpi = got
            fin = torch.isfinite(gk)
            # the same step over the decoded f32 rows
            bk, bp, codes, sc, bi, mean, cids, q = real
            dec = affine_decode(codes, sc, bi, mean[0], bits=8,
                                dim=d - n_dead)
            dk, dp, dpop, dpk, dpi = bs.beam_step(
                bk, bp, dec, cids, q, metric=metric, window=window, m=m)
            if not torch.allclose(gk, dk, rtol=1e-4, atol=1e-4) or \
                    not torch.allclose(gpk, dpk, rtol=1e-4, atol=1e-4) or \
                    not torch.equal(gpi, dpi):
                failures.append(f"{tag} vs beam_step on decoded rows")
            off = ((gp != dp) & fin).any(1) | (gpop != dpop).any(1)
            swapped_dec += int(off.sum())
            if float(off.float().mean()) > 1e-3:
                failures.append(f"{tag} vs decoded: ids {int(off.sum())} "
                                "rows")
        args = make_lvq_case(rng, shape, n_dead, grid=False)
        kw = dict(metric=0, window=window, m=m, n_dead=n_dead)
        t = time_raw(
            bs._kernel_entry("svt_beam_step_lvq"), args,
            lambda a: bs._outputs(a[0], a[2].shape[1], m),
            lambda a, o: bs.beam_step_lvq_args(*a, o, **kw))
        t["call_ms"] = median_ms(lambda: bs.beam_step_lvq(*args, **kw))
        t["plain_ms"] = median_ms(lambda: bs.beam_step_lvq_plain(*args, **kw))
        # per value: decode (add, multiply, add) + the two multiply-adds
        t.update(step_bound(args, m, 7))
        timings[label] = t
        log(f"kernels: beam_step_lvq {label} B,C,K,d={shape[:4]} n_dead "
            f"{n_dead} L2: " + describe(t))
    # LeanVec's shapes, untimed: every real-input row off the plain
    # version's a proven near-tie, at most 0.1% of their rows together
    n_dead = 128 - LEANVEC_DIM
    lv_swapped = lv_rows = 0
    for label, shape in LEANVEC_CHECK_SHAPES:
        for metric in (0, 1, 2):
            err, off, n, _real, _got = check_lvq_step(
                rng, label, shape, n_dead, metric, failures)
            max_err = max(max_err, err)
            lv_swapped += off
            lv_rows += n
    if lv_swapped > 1e-3 * lv_rows:
        failures.append(f"leanvec shapes: {lv_swapped} near-tie rows of "
                        f"{lv_rows}")
    if failures:
        raise AssertionError("beam_step_lvq kernel: " + "; ".join(failures))
    log(f"kernels: beam_step_lvq matches plain: 3 shapes x 3 metrics; exact "
        f"inputs identical, real inputs max_abs_err {max_err:.3g}, near-tie "
        f"rows with other ids or pops {swapped} of {rows}; vs beam_step on "
        f"decoded rows {swapped_dec} of {rows}; LeanVec's shapes (n_dead "
        f"{n_dead}) x 3 metrics: exact inputs identical, near-tie rows "
        f"{lv_swapped} of {lv_rows}")
    return {"max_abs_err": max_err, "timings": timings}


def phase_main_path() -> dict:
    import scalablevectorsearch_tpu_torch as svt
    from scalablevectorsearch_tpu_torch.index.vamana import search as smod
    from scalablevectorsearch_tpu_torch.index.vamana.index import (
        dequantize_queries, prepare_query_upload)
    from scalablevectorsearch_tpu_torch.ops.kernels.beam_step import (
        beam_step)
    data, queries = svt.generate_test_dataset(100_000, 5000, 128, seed=42)
    params = main_path_params()
    zero_counts()
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
    log(f"main path: ground truth {time.perf_counter() - t0:.2f} s")
    index.enable_packed_serving()
    window, recall = sweep(index, queries, gt, "main path")
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
    return {"launches": total_launches, "index": index, "data": data,
            "queries": queries, "gt": gt, "window": window, "recall": recall}


def main_path_params():
    import scalablevectorsearch_tpu_torch as svt
    return svt.VamanaBuildParameters(
        alpha=1.1, graph_max_degree=32, window_size=100,
        max_candidate_pool_size=300, prune_to=28)


def launch_check(kernel, label: str, then=None):
    """A :func:`sweep` ``check``: fails unless ``kernel`` launched in each
    search since the previous one; ``then(result)``, where given, runs
    after."""
    before = kernel.launches

    def check(res, w):
        nonlocal before
        if kernel.launches == before:
            raise AssertionError(f"{label}: {kernel.__name__} not launched "
                                 f"in the search at window {w}")
        before = kernel.launches
        if then is not None:
            then(res)

    return check


def sweep(index, queries, gt, label: str, check=None):
    """First window of WINDOWS with recall@10 >= 0.9; fails if none.
    ``check(result, window)``, where given, runs on every search's result
    first."""
    import scalablevectorsearch_tpu_torch as svt
    steps = []
    for w in WINDOWS:
        index.search_window_size = w
        res = index.search(queries, 10)
        if check is not None:
            check(res, w)
        recall = svt.k_recall_at_n(gt, res)
        steps.append(f"{w}:{recall:.4f}")
        if recall >= 0.9:
            log(f"{label}: recall@10 sweep " + " ".join(steps))
            return w, recall
    raise AssertionError(f"{label}: no window reached recall@10 >= 0.9 "
                         f"({' '.join(steps)})")


def timed_serving(index, queries, gt, label: str, f32_recall: float,
                  kernels=None, path: str = "lvq path") -> dict:
    """recall@10 and QPS (median of 5 search_async calls) at the index's
    window, and the launches of those calls of each of ``kernels`` (the
    wrappers; beam_step_lvq by default), each of which must be > 0."""
    import scalablevectorsearch_tpu_torch as svt
    from scalablevectorsearch_tpu_torch.ops.kernels.beam_step import (
        beam_step_lvq)
    kernels = kernels or (beam_step_lvq,)
    before = [k.launches for k in kernels]
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        res = index.search_async(queries, 10).result()
        times.append(time.perf_counter() - t0)
    launches = {k.__name__: k.launches - b for k, b in zip(kernels, before)}
    recall = svt.k_recall_at_n(gt, res)
    qps = len(queries) / statistics.median(times)
    log(f"{path}: {label} window {index.search_window_size} recall@10 "
        f"{recall:.4f} (f32 index at this window {f32_recall:.4f}); "
        f"search_async x5 median {statistics.median(times) * 1e3:.2f} ms "
        f"-> {qps:.1f} QPS; launches {launches}")
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"{label}: {name} not launched")
    return {"recall": recall, "qps": qps, "launches": launches}


def sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def tree_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(root, name))
               for root, _dirs, files in os.walk(path) for name in files)


def round_trip(label: str, save, load, path: str = "persistence"):
    """``save(directory)`` then ``load(directory)`` in a fresh temporary
    directory; logs the seconds of each and the checkpoint's bytes and
    returns what ``load`` gave."""
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        save(tmp)
        save_s = time.perf_counter() - t0
        size = tree_bytes(tmp)
        t0 = time.perf_counter()
        out = load(tmp)
        sync()
        load_s = time.perf_counter() - t0
    log(f"{path}: {label}: save {save_s:.3f} s, assemble {load_s:.3f} s, "
        f"{size} bytes")
    return out


def same_tensors(label: str, got, want) -> None:
    """Every tensor field of two dataclasses (a dataset, a graph, a
    sampler) equal and on the same device."""
    for field in dataclasses.fields(want):
        a, b = getattr(got, field.name), getattr(want, field.name)
        if isinstance(b, torch.Tensor):
            if a.device != b.device or not torch.equal(a, b):
                raise AssertionError(f"{label}: {field.name} differs after "
                                     f"the round trip")
        elif a != b:
            raise AssertionError(f"{label}: {field.name} {a} != {b}")


def same_index(label: str, got, want) -> None:
    """An assembled VamanaIndex against the live one: graph, dataset,
    sampler (config and sample), entry point and search parameters."""
    same_tensors(label + " graph", got.graph, want.graph)
    same_tensors(label + " data", got.data, want.data)
    same_tensors(label + " sampler", got._entry_sampler, want._entry_sampler)
    if (got._entry_cfg, got.entry_point, got.search_parameters) != \
            (want._entry_cfg, want.entry_point, want.search_parameters):
        raise AssertionError(f"{label}: sampler config, entry point or "
                             f"search parameters differ")


def same_search(label: str, live, loaded, queries, kernels,
                path: str = "persistence") -> dict:
    """The live index's search and the assembled one's at the same window:
    identical ids and distances; each of ``kernels`` must launch in the
    assembled index's search."""
    want = live.search(queries, 10)
    before = [k.launches for k in kernels]
    got = loaded.search(queries, 10)
    launches = {k.__name__: k.launches - b for k, b in zip(kernels, before)}
    max_diff = float(np.max(np.abs(got.distances - want.distances)))
    log(f"{path}: {label}: window {loaded.search_window_size}, ids "
        f"identical {np.array_equal(got.ids, want.ids)}, distances max abs "
        f"diff {max_diff:.3g}; launches {launches}")
    if not np.array_equal(got.ids, want.ids) or max_diff:
        raise AssertionError(f"{label}: the assembled index searches "
                             f"otherwise than the live one")
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"{label}: {name} not launched")
    return launches


def phase_persistence(main_path: dict) -> dict:
    """The main index saved and assembled three ways (directory, stream,
    save_host), each copy checked against the live index on the card and
    served with bf16 packed rows; the legacy JAX checkpoints loaded on the
    card.  Every count starts at 0 here."""
    import io
    import scalablevectorsearch_tpu_torch as svt
    from scalablevectorsearch_tpu_torch.ops.kernels.beam_step import (
        beam_step)
    index = main_path["index"]
    live, data, queries = index.index, main_path["data"], main_path["queries"]
    device = live.data.device
    zero_counts()

    def stream_save(tmp):
        with open(os.path.join(tmp, "index.svt"), "wb") as f:
            index.save_stream(f)

    def stream_load(tmp):
        with open(os.path.join(tmp, "index.svt"), "rb") as f:
            buf = io.BytesIO(f.read())
        return svt.Vamana.assemble_stream(buf, device=device)

    def assemble(tmp):
        return svt.Vamana.assemble(tmp, device=device)

    routes = (("save / assemble", index.save, assemble),
              ("save_stream / assemble_stream", stream_save, stream_load),
              ("save_host / assemble",
               lambda tmp: live.save_host(tmp, data), assemble))
    out = {}
    for label, save, load in routes:
        loaded = round_trip(label, save, load)
        same_index(label, loaded.index, live)
        loaded.enable_packed_serving()
        out[label] = same_search(label, index, loaded, queries, (beam_step,))
        del loaded
        torch.cuda.empty_cache()
    rng = np.random.default_rng(7)
    fixture = rng.normal(size=(48, 20)).astype(np.float32)
    for name, bits, res in (("lvq8_v001", 8, 0), ("lvq4x8_v001", 4, 8)):
        got = svt.dispatch_load(os.path.join(HERE, "data", "legacy", name),
                                device=device)
        err = float(np.max(np.abs(got.to_numpy() - svt.LVQDataset.compress(
            fixture, bits=bits, residual_bits=res,
            device=device).to_numpy())))
        log(f"persistence: legacy JAX checkpoint {name} ({got.kind}) on "
            f"{got.codes.device}: decode max abs err {err:.3g} against a "
            f"fresh compress")
        if got.codes.device != device or err > 1e-5:
            raise AssertionError(f"legacy checkpoint {name}: {err}")
    out["launches"] = beam_step.launches
    log(f"persistence: launches beam_step {beam_step.launches}")
    return out


def hits_per_query(gt, res, k: int = 10) -> np.ndarray:
    return np.array([len(set(g) & set(r)) for g, r in
                     zip(gt.ids[:, :k].tolist(), res.ids[:, :k].tolist())])


def phase_host_rerank(main_path: dict) -> dict:
    """Recall@10 and QPS (median of 5 search_async calls) of the main index
    at its window with (a) float16 uploads, (b) int8 uploads
    (``query_upload_dtype = "int8"``), (c) int8 uploads with the exact
    host rerank of the fetched beam.  (c) must not lose recall to (b):
    per query, (c) may hold fewer true neighbours than (b) only where a
    dropped one ties (c)'s 10th distance.  The rerank ranks by the JAX
    package's f32 norm algebra ||q||^2 - 2<q,x> + ||x||^2, whose rounding
    is a few ulps of ||q||^2 + ||x||^2, so a tie is a float64 distance
    within 8 f32 epsilons of that sum of (c)'s 10th.  Counts start at 0
    here; beam_step must launch."""
    import scalablevectorsearch_tpu_torch as svt
    from scalablevectorsearch_tpu_torch.ops.kernels.beam_step import (
        beam_step)
    index = main_path["index"]
    live = index.index
    data, queries, gt = (main_path[key] for key in ("data", "queries", "gt"))
    beam_step.launches = 0
    out = {}

    def timed(label):
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            res = index.search_async(queries, 10).result()
            times.append(time.perf_counter() - t0)
        qps = len(queries) / statistics.median(times)
        out[label] = {"recall": svt.k_recall_at_n(gt, res), "qps": qps}
        log(f"host rerank: ({label}) window {index.search_window_size} "
            f"recall@10 {out[label]['recall']:.4f}; search_async x5 median "
            f"{statistics.median(times) * 1e3:.2f} ms -> {qps:.1f} QPS")
        return res

    try:
        timed("a: float16 upload")
        live.query_upload_dtype = "int8"
        res_b = timed("b: int8 upload")
        index.enable_host_rerank(data)
        res_c = timed("c: int8 upload + host rerank")
    finally:
        index.disable_host_rerank()
        live.query_upload_dtype = None
    hb, hc = hits_per_query(gt, res_b), hits_per_query(gt, res_c)
    worse = np.flatnonzero(hc < hb)
    for i in worse:
        dropped = set(res_b.ids[i, :10]) & set(gt.ids[i, :10]) \
            - set(res_c.ids[i, :10])
        kth = float(res_c.distances[i, 9])
        q = queries[i].astype(np.float64)
        for d in dropped:
            x = data[d].astype(np.float64)
            dist = float(((q - x) ** 2).sum())
            tie = 8 * np.finfo(np.float32).eps * float(q @ q + x @ x)
            if abs(dist - kth) > tie:
                raise AssertionError(
                    f"host rerank dropped neighbour {d} of query {i} at "
                    f"distance {dist}, not a tie of the 10th {kth} "
                    f"(rounding {tie:.3g})")
    log(f"host rerank: queries with fewer true neighbours under (c) than "
        f"(b): {len(worse)} (ties of the 10th distance within f32 "
        f"rounding); with more: {int((hc > hb).sum())}; "
        f"beam_step launches {beam_step.launches}")
    if out["c: int8 upload + host rerank"]["recall"] < \
            out["b: int8 upload"]["recall"]:
        raise AssertionError(f"host rerank lost recall: {out}")
    if beam_step.launches == 0:
        raise AssertionError("host rerank phase: beam_step not launched")
    return out


def phase_lvq_path(main_path: dict) -> dict:
    """LVQ serving over the main path's graph (as bench.py's _lvq8_phase
    serves it) and an LVQ-8 build; every count starts at 0 here."""
    import scalablevectorsearch_tpu_torch as svt
    from scalablevectorsearch_tpu_torch.index.vamana.index import (
        VamanaIndex)
    from scalablevectorsearch_tpu_torch.lib.saveload import save_to_disk
    from scalablevectorsearch_tpu_torch.ops.kernels.beam_step import (
        beam_step, beam_step_lvq)
    from scalablevectorsearch_tpu_torch.quantization.lvq import (
        compress_and_save_host)
    index = main_path["index"].index
    data, queries, gt = (main_path[key] for key in ("data", "queries", "gt"))
    index.disable_packed_serving()          # drop the bf16 packed rows
    torch.cuda.empty_cache()
    zero_counts()

    def over_graph(lvq):
        idx = VamanaIndex(index.graph, lvq, index.entry_point,
                          index.distance,
                          query_batch_size=index.query_batch_size)
        idx.enable_entry_sampler()
        idx.pop_width = index.pop_width
        return idx

    def f32_recall(window):
        index.search_window_size = window
        return svt.k_recall_at_n(gt, index.search(queries, 10))

    t0 = time.perf_counter()
    lvq8 = svt.LVQDataset.compress(data, bits=8)
    torch.cuda.synchronize()
    compress_s = time.perf_counter() - t0
    idx = over_graph(lvq8)
    t0 = time.perf_counter()
    idx.enable_packed_serving()
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    packed_mb = sum(t.numel() * t.element_size() for t in (
        idx._packed.codes, idx._packed.scales, idx._packed.biases)) / 1e6
    log(f"lvq path: LVQ-8 compress {compress_s:.2f} s, pack {pack_s:.2f} s "
        f"({packed_mb:.1f} MB of packed codes and constants)")
    window, _ = sweep(idx, queries, gt, "lvq path: LVQ-8 packed")
    out = {"window": window, "f32_recall": f32_recall(window)}
    idx.search_window_size = window
    out["packed"] = timed_serving(idx, queries, gt, "LVQ-8 packed",
                                  out["f32_recall"])
    idx.disable_packed_serving()
    out["unpacked"] = timed_serving(idx, queries, gt, "LVQ-8 unpacked",
                                    out["f32_recall"])
    host = round_trip(
        "LVQ-8 compress_and_save_host / dispatch_load",
        lambda tmp: compress_and_save_host(tmp, data, bits=8),
        lambda tmp: svt.dispatch_load(tmp, device=lvq8.device))
    same_tensors("LVQ-8 compress_and_save_host", host, lvq8)
    del idx, lvq8, host
    lvq88 = svt.LVQDataset.compress(data, bits=8, residual_bits=8)
    idx = over_graph(lvq88)
    idx.enable_packed_serving()
    idx.search_window_size = window
    out["lvq8x8"] = timed_serving(idx, queries, gt,
                                  "LVQ8x8 packed + rerank",
                                  out["f32_recall"])
    loaded = round_trip(
        "LVQ8x8 dataset save / dispatch_load",
        lambda tmp: save_to_disk(lvq88, tmp),
        lambda tmp: svt.dispatch_load(tmp, device=lvq88.device))
    same_tensors("LVQ8x8 dataset", loaded, lvq88)
    copy = over_graph(loaded)
    copy.enable_packed_serving()
    copy.search_window_size = window
    same_search("LVQ8x8 packed + rerank", idx, copy, queries,
                (beam_step_lvq,), path="lvq path")
    del idx, lvq88, copy, loaded
    torch.cuda.empty_cache()

    before = beam_step_lvq.launches
    t0 = time.perf_counter()
    built = svt.Vamana.build(main_path_params(),
                             svt.LVQDataset.compress(data, bits=8), "l2",
                             sampled_entries=True)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_launches = beam_step_lvq.launches - before
    log(f"lvq path: LVQ-8 build 100000x128 in {build_s:.2f} s, mean degree "
        f"{built.index.graph.mean_degree():.3f}, beam_step_lvq launches "
        f"{build_launches}")
    if build_launches == 0:
        raise AssertionError("LVQ-8 build: beam_step_lvq not launched")
    built.enable_packed_serving()
    out["build"] = {"seconds": build_s, "launches": build_launches}
    out["build"]["window"], out["build"]["recall"] = sweep(
        built, queries, gt, "lvq path: LVQ-8 build, packed serving")
    loaded = round_trip(
        "LVQ-8 index save / assemble", built.save,
        lambda tmp: svt.Vamana.assemble(tmp, device=built.index.data.device))
    same_index("LVQ-8 index", loaded.index, built.index)
    loaded.enable_packed_serving()
    same_search("LVQ-8 index, packed", built, loaded, queries,
                (beam_step_lvq,), path="lvq path")
    del loaded
    out["launches"] = read_counts()
    log(f"lvq path: launches beam_step_lvq {beam_step_lvq.launches}, "
        f"beam_step {beam_step.launches}")
    return out


def golden_dataset(kind: str, data: np.ndarray):
    """The dataset of a golden row's ``dataset_kind`` (f32 rows where the
    row names none), on the card."""
    import scalablevectorsearch_tpu_torch as svt
    if kind == "f32":
        return data
    if kind == "bf16":
        return svt.VectorDataset.from_array(data, dtype=torch.bfloat16)
    if kind == "sq_int8":
        return svt.SQDataset.compress(data)
    if kind == "lvq8":
        return svt.LVQDataset.compress(data, bits=8)
    if kind == "lvq8x8":
        return svt.LVQDataset.compress(data, bits=8, residual_bits=8)
    raise ValueError(f"unknown golden dataset kind {kind!r}")


def phase_golden(generated: dict) -> None:
    """The golden gate.  The rows of GOLDEN (f32 rows, three distances),
    GOLDEN_IVF and GOLDEN_INVERTED come from the runner's generators in
    :func:`phase_tools` (``generated``: path -> distance -> recalls) and
    are held to their files within GOLDEN_TOL, GOLDEN_IVF_TOL (but for the
    rows of GOLDEN_IVF_BY_SEED_MEAN, gated as seed means by
    :func:`golden_ivf_seed_mean`) and GOLDEN_INVERTED_TOL; the rows of
    GOLDEN_KINDS (four dataset kinds, L2) are built and searched here, on
    the card, within GOLDEN_KINDS_TOL."""
    import scalablevectorsearch_tpu_torch as svt
    bad = []
    for path in (GOLDEN, GOLDEN_IVF, GOLDEN_INVERTED):
        with open(path) as f:
            golden = json.load(f)
        for entry in golden["expected"]:
            distance = entry["distance"]
            got = generated[path][distance]
            tol = {GOLDEN: GOLDEN_TOL[distance], GOLDEN_IVF: GOLDEN_IVF_TOL,
                   GOLDEN_INVERTED: GOLDEN_INVERTED_TOL}[path]
            seed_mean = [key for key in got if path == GOLDEN_IVF
                         and (distance, key) in GOLDEN_IVF_BY_SEED_MEAN]
            for key, want in entry["recalls"].items():
                if abs(got[key] - want) > tol and key not in seed_mean:
                    bad.append(f"{os.path.basename(path)} {distance} {key} "
                               f"{got[key]:.4f} vs {want}")
            log(f"golden: {os.path.basename(path)} {distance} recall "
                + " ".join(f"{key}:{r:.4f}(ref {entry['recalls'][key]})"
                           for key, r in got.items())
                + (f"; gated as seed means: {seed_mean}" if seed_mean
                   else ""))
    with open(GOLDEN_KINDS) as f:
        golden = json.load(f)
    spec, k = golden["dataset"], golden["num_neighbors"]
    data, queries = svt.generate_test_dataset(
        spec["n"], spec["n_queries"], spec["dim"], seed=spec["seed"])
    truth = svt.exhaustive_search(data, queries, k, "L2")
    for entry in golden["expected"]:
        kind = entry["dataset_kind"]
        bp = svt.VamanaBuildParameters(**{
            key: val for key, val in entry["build_parameters"].items()
            if key in ("alpha", "graph_max_degree", "window_size",
                       "max_candidate_pool_size", "prune_to")})
        before = read_counts()
        t0 = time.perf_counter()
        index = svt.VamanaIndex.build(bp, golden_dataset(kind, data),
                                      entry["distance"])
        build_s = time.perf_counter() - t0
        got = {}
        for window, want in entry["recalls"].items():
            index.search_window_size = int(window)
            got[window] = svt.k_recall_at_n(truth, index.search(queries, k))
            if abs(got[window] - want) > GOLDEN_KINDS_TOL:
                bad.append(f"{entry['distance']} {kind} w{window} "
                           f"{got[window]:.4f} vs {want}")
        launched = {name: n for name, n in launched_since(before).items()
                    if n}
        log(f"golden: {entry['distance']} {kind} build {build_s:.2f} s, "
            "recall " + " ".join(f"w{w}:{r:.4f}(ref {entry['recalls'][w]})"
                                 for w, r in got.items())
            + f"; launches {launched}")
    golden_ivf_seed_mean(bad)
    if bad:
        raise AssertionError("golden recall outside tolerance: "
                             + "; ".join(bad))


def golden_ivf_seed_mean(bad: list) -> None:
    """The rows of GOLDEN_IVF_BY_SEED_MEAN as means over the seeds of
    GOLDEN_IVF_SEED_MEAN (the JAX package's rows averaged over those
    values of ``IVFBuildParameters.seed``): the runner's
    ivf_test_generator at each seed, and the port's mean within
    GOLDEN_IVF_TOL of the reference's; rows outside go to ``bad``."""
    from scalablevectorsearch_tpu_torch.benchmark import run_job
    with open(GOLDEN_IVF_SEED_MEAN) as f:
        ref = json.load(f)
    rows = {(e["distance"], p): [] for e in ref["expected"]
            for p in e["recalls"]}
    t0 = time.perf_counter()
    for seed in ref["seeds"]:
        res = run_job({
            "executable": "ivf_test_generator", "synthetic": ref["dataset"],
            "num_neighbors": ref["num_neighbors"],
            "distances": [e["distance"] for e in ref["expected"]],
            "build_parameters": {**ref["expected"][0]["build_parameters"],
                                 "num_iterations": 10, "seed": seed},
            "n_probes": [int(p) for p in ref["expected"][0]["recalls"]]})
        for e in res["expected"]:
            for p, r in e["recalls"].items():
                rows[(e["distance"], p)].append(r)
    cells = []
    for entry in ref["expected"]:
        for p, want in entry["recalls"].items():
            key = (entry["distance"], p)
            got = float(np.mean(rows[key]))
            gated = key in GOLDEN_IVF_BY_SEED_MEAN
            cells.append(f"{entry['distance']} {p}: {got:.4f} (ref {want}, "
                         f"sd {float(np.std(rows[key], ddof=1)):.4f} / "
                         f"{entry['recalls_std'][p]}){' gated' * gated}")
            if gated and abs(got - want) > GOLDEN_IVF_TOL:
                bad.append(f"IVF seed mean {entry['distance']} {p} "
                           f"{got:.4f} vs {want}")
    log(f"golden: IVF means over {len(ref['seeds'])} seeds in "
        f"{time.perf_counter() - t0:.1f} s (port sd / reference sd): "
        + "; ".join(cells))


def bound_of(bytes_moved: int, flops: int) -> dict:
    """The least time for ``bytes_moved`` bytes and ``flops`` f32
    operations: the larger of bytes over the HBM peak and operations over
    the f32 peak."""
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS_PER_S * 1e3
    return {"bytes": bytes_moved, "flops": flops,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def make_update_case(rng, shape, grid: bool):
    """beam_update inputs on the card: make_case's beam (keys rounded to a
    1/4 grid when ``grid``) and candidate ids, candidate keys a function of
    (row, id) in the beam's range (on the same grid when ``grid``, so that
    different ids tie), 3% of the valid ids with +inf keys."""
    B, C, K, _d, _window, _m = shape
    beam_keys, beam_packed, _vecs, cand_ids, _q = make_case(
        rng, (B, C, K, 4, 1, 1), grid=False)
    n_ids = max(400, 2 * C)          # make_case's id range
    table = rng.normal(size=(B, n_ids)).astype(np.float32) ** 2
    if grid:
        table = np.round(table * 4) / np.float32(4)
        beam_keys = torch.round(beam_keys * 4) / 4
    cl = cand_ids.clamp_min(0).cpu().numpy()
    keys = np.take_along_axis(table, cl, 1)
    keys[rng.random(keys.shape) < 0.03] = np.inf
    return [beam_keys, beam_packed, torch.from_numpy(keys).cuda(), cand_ids]


def grid_values(rng, shape, d: int):
    """Normal values on the 1/32 grid, small enough that every f32 dot
    product and squared norm of d of them is exact in any order."""
    kmax = min(127, int(np.sqrt(2.0 ** 22 / d)))
    return np.clip(np.rint(rng.normal(size=shape) * 32), -kmax,
                   kmax).astype(np.float32) / np.float32(32)


def other_entries(lib) -> dict:
    """The C entry points of another build of csrc/gather_distance.cu
    (:func:`build_other`), argument types set as the wrapper sets them;
    empty without one."""
    import ctypes
    from scalablevectorsearch_tpu_torch.ops.kernels import (
        gather_distance as gd)
    if lib is None:
        return {}
    handle = ctypes.CDLL(str(lib))
    out = {}
    for name, argtypes in gd._ARGTYPES.items():
        fn = getattr(handle, name)
        fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
        out[name] = fn
    return out


def phase_kernels_scored(other_lib=None) -> dict:
    """The scored route's kernels against their plain versions on the card.
    beam_update: tied (grid) and real keys, all five outputs identical (the
    keys are inputs, so nothing is rounded).  score_rows and
    gather_score_l2_partial: exact (grid) inputs identical; real inputs
    within rtol 1e-5 (atol 1e-5 of the values' scale): the sums run in
    another order.  Median times, plain times, bounds, and torch.bmm for
    the dot half of score_rows.  ``other_lib``: another build of
    csrc/gather_distance.cu, timed in turns with this one (time_raw)."""
    from scalablevectorsearch_tpu_torch.ops.kernels import beam_step as bs
    from scalablevectorsearch_tpu_torch.ops.kernels import beam_update as bu
    from scalablevectorsearch_tpu_torch.ops.kernels import (
        gather_distance as gd)
    rng = np.random.default_rng(3)
    failures, out = [], {}
    other = other_entries(other_lib)

    timings = {}
    for label, shape in STEP_SHAPES:
        B, C, K, _d, window, m = shape
        kw = dict(window=window, m=m)
        for grid in (True, False):
            args = make_update_case(rng, shape, grid)
            got = bu.beam_update(*args, **kw)
            want = bu.beam_update_plain(*args, **kw)
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                failures.append(f"beam_update {label} grid={grid} differs")
        t = time_raw(
            bs._kernel_entry("svt_beam_update"), args,
            lambda a: bs._outputs(a[0], C + K, m),
            lambda a, o: bu.beam_update_args(*a, o, **kw))
        t["call_ms"] = median_ms(lambda: bu.beam_update(*args, **kw))
        t["plain_ms"] = median_ms(lambda: bu.beam_update_plain(*args, **kw))
        t.update(bound_of(nbytes(*args) + B * (C * 8 + m * 4 + (C + K) * 8),
                          0))
        timings[label] = t
        log(f"kernels: beam_update {label} B,C,K={shape[:3]}: "
            + describe(t))
    out["beam_update"] = {"max_abs_err": 0.0, "timings": timings}

    B, K, d = SCORE_SHAPE
    max_err = 0.0
    for grid in (True, False):
        if grid:
            rows = grid_values(rng, (B, K, d), d)
            q = grid_values(rng, (B, d), d)
        else:
            rows = rng.normal(size=(B, K, d)).astype(np.float32)
            q = rng.normal(size=(B, d)).astype(np.float32)
        rows, q = torch.from_numpy(rows).cuda(), torch.from_numpy(q).cuda()
        got = gd.score_rows(rows, q)
        want = gd.score_rows_plain(rows, q)
        torch.cuda.synchronize()
        for name, g, w in zip(("dots", "x2"), got, want):
            if grid and not torch.equal(g, w):
                failures.append(f"score_rows grid {name} differs")
            err = float((g - w).abs().max())
            max_err = max(max_err, err)
            if not torch.allclose(g, w, rtol=1e-5,
                                  atol=1e-5 * float(w.abs().max())):
                failures.append(f"score_rows grid={grid} {name}: {err:.3g}")
    t = time_raw(gd._kernel_entry("svt_score_rows"), [rows, q],
                 lambda a: (torch.empty((B, K), device="cuda"),
                            torch.empty((B, K), device="cuda")),
                 lambda a, o: gd.score_rows_args(*a, o),
                 other.get("svt_score_rows"))
    t["call_ms"] = median_ms(lambda: gd.score_rows(rows, q))
    t["plain_ms"] = median_ms(lambda: gd.score_rows_plain(rows, q))
    bmm_sets = input_sets([rows, q])
    bmm_ms = median_ms(lambda: [torch.bmm(r, qq[:, :, None])
                                for r, qq in bmm_sets]) / len(bmm_sets)
    # per value: a multiply-add for the dot and one for the norm
    t.update(bound_of(nbytes(rows, q) + 2 * B * K * 4, 4 * rows.numel()))
    out["score_rows"] = {"max_abs_err": max_err, "library_ms": bmm_ms,
                         "timings": {"f32": t}}
    log(f"kernels: score_rows B,K,d={SCORE_SHAPE} f32: " + describe(t)
        + f"; torch.bmm (dots only) {bmm_ms:.4f} ms per call over "
        f"{len(bmm_sets)} input sets; real inputs max_abs_err {max_err:.3g}")

    max_err, timings = 0.0, {}
    # ids at the serving shape and at the tail's (B 418), repeats within
    # a row; the tail is timed over float16 rows, the main path's type
    id_sets = {}
    for suffix, n_q in (("", B), ("_tail", TAIL_SHAPE[0])):
        ids = rng.integers(0, TABLE_ROWS, size=(n_q, K)).astype(np.int32)
        ids[::2, K // 2:] = ids[::2, :K // 2]
        id_sets[suffix] = torch.from_numpy(ids).cuda()
    for grid in (True, False):
        if grid:
            base = grid_values(rng, (TABLE_ROWS, d), d)
            q_all = torch.from_numpy(grid_values(rng, (B, d), d)).cuda()
        else:
            base = rng.normal(size=(TABLE_ROWS, d)).astype(np.float32)
            q_all = torch.from_numpy(rng.normal(size=(B, d)).astype(
                np.float32)).cuda()
        base = torch.from_numpy(base).cuda()
        tables = {"f32": base, "float16": base.half(),
                  "int8": (base * 32).round().clamp(-127, 127).to(torch.int8)}
        for (name, table), (suffix, ids) in itertools.product(
                tables.items(), id_sets.items()):
            if suffix and name != "float16":
                continue
            n_q = ids.shape[0]
            q = q_all[:n_q]
            got = gd.gather_score_l2_partial(table, ids, q)
            want = gd.gather_score_l2_partial_plain(table, ids, q)
            torch.cuda.synchronize()
            if grid and not torch.equal(got, want):
                failures.append(f"gather_score_l2_partial {name}{suffix} "
                                "grid differs")
            err = float((got - want).abs().max())
            if not grid:
                max_err = max(max_err, err)
            if not torch.allclose(got, want, rtol=1e-5,
                                  atol=1e-5 * float(want.abs().max())):
                failures.append(f"gather_score_l2_partial {name}{suffix} "
                                f"grid={grid}: {err:.3g}")
            if grid:
                continue
            t = time_raw(
                gd._kernel_entry("svt_gather_score_l2_partial"),
                [table, ids, q],
                lambda a: torch.empty(a[1].shape, device="cuda"),
                lambda a, o: gd.gather_score_l2_partial_args(*a, o),
                other.get("svt_gather_score_l2_partial"))
            t["call_ms"] = median_ms(
                lambda: gd.gather_score_l2_partial(table, ids, q))
            t["plain_ms"] = median_ms(
                lambda: gd.gather_score_l2_partial_plain(table, ids, q))
            # the rows this run's ids need (each distinct row once), the
            # ids, the queries and the output
            n_unique = int(torch.unique(ids).numel())
            row_bytes = d * table.element_size()
            t.update(bound_of(n_unique * row_bytes + nbytes(ids, q)
                              + n_q * K * 4, 4 * n_q * K * d))
            timings[name + suffix] = t
            log(f"kernels: gather_score_l2_partial {name} table "
                f"{TABLE_ROWS}x{d}, ids ({n_q}, {K}) ({n_unique} distinct): "
                + describe(t))
    out["gather_score_l2_partial"] = {"max_abs_err": max_err,
                                      "timings": timings}
    if failures:
        raise AssertionError("scored kernels vs plain: "
                             + "; ".join(failures))
    log(f"kernels: beam_update, score_rows, gather_score_l2_partial match "
        f"their plain versions; partial max_abs_err {max_err:.3g}")
    return out


def phase_scored_path(main_path: dict) -> dict:
    """The scored route over the main path's data and graph, an SQ-int8
    build, and one wide search; every count starts at 0 here."""
    import scalablevectorsearch_tpu_torch as svt
    from scalablevectorsearch_tpu_torch.core.query_result import QueryResult
    from scalablevectorsearch_tpu_torch.index.vamana.index import (
        VamanaIndex)
    from scalablevectorsearch_tpu_torch.lib.saveload import save_to_disk
    from scalablevectorsearch_tpu_torch.ops.kernels.beam_update import (
        beam_update)
    from scalablevectorsearch_tpu_torch.ops.kernels.gather_distance import (
        gather_score_l2_partial, score_rows)
    index = main_path["index"].index
    data, queries, gt = (main_path[key] for key in ("data", "queries", "gt"))
    zero_counts()
    torch.cuda.empty_cache()
    out = {}

    def f32_recall(window, q=queries, truth=gt):
        index.search_window_size = window
        return svt.k_recall_at_n(truth, index.search(q, 10))

    # 1. float16 rows on the main graph, unpacked
    f16 = VamanaIndex(index.graph, svt.VectorDataset.from_array(
        data, dtype=torch.float16), index.entry_point, index.distance,
        query_batch_size=index.query_batch_size)
    f16.enable_entry_sampler()
    f16.pop_width = index.pop_width
    window, _ = sweep(f16, queries, gt, "scored path: float16")
    f16.search_window_size = window
    ref = f32_recall(window)
    out["float16"] = timed_serving(
        f16, queries, gt, "float16 unpacked", ref,
        kernels=(gather_score_l2_partial, beam_update), path="scored path")
    out["float16"]["window"] = window
    if abs(out["float16"]["recall"] - ref) > 0.01:
        raise AssertionError(f"float16 recall {out['float16']['recall']} "
                             f"vs f32 {ref} at window {window}")
    loaded = round_trip(
        "float16 dataset save / dispatch_load",
        lambda tmp: save_to_disk(f16.data, tmp),
        lambda tmp: svt.dispatch_load(tmp, device=f16.data.device))
    same_tensors("float16 dataset", loaded, f16.data)
    copy = VamanaIndex(index.graph, loaded, index.entry_point,
                       index.distance, query_batch_size=index.query_batch_size)
    copy.enable_entry_sampler()
    copy.pop_width = index.pop_width
    copy.search_window_size = window
    same_search("float16 unpacked", f16, copy, queries,
                (gather_score_l2_partial, beam_update), path="scored path")
    del f16, copy, loaded

    # 2. an SQ-int8 build and its unpacked serving.  One global scale
    # caps SQ-int8's recall against the f32 ground truth below 0.9 here
    # (the exact search over the decoded rows reaches `ceiling`), so the
    # graph search is held to that exact search's answers, and its recall
    # against the f32 truth is reported beside it.
    sq = svt.SQDataset.compress(data)
    sq_gt = svt.exhaustive_search(sq.to_numpy(), queries, 10)
    ceiling = svt.k_recall_at_n(gt, sq_gt)
    log(f"scored path: SQ-int8 scale {sq.scale:.6g}: exact search over the "
        f"decoded rows has recall@10 {ceiling:.4f} against the f32 truth")
    before = read_counts()
    t0 = time.perf_counter()
    built = svt.Vamana.build(main_path_params(), sq, "l2",
                             sampled_entries=True)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    launches = launched_since(before)
    log(f"scored path: SQ-int8 build {data.shape[0]}x{data.shape[1]} in "
        f"{build_s:.2f} s, mean "
        f"degree {built.index.graph.mean_degree():.3f}, launches {launches}")
    if not (launches["beam_update"] and launches["score_rows"]):
        raise AssertionError("SQ-int8 build: beam_update or score_rows not "
                             "launched")
    window, _ = sweep(built, queries, sq_gt,
                      "scored path: SQ-int8 build, against the decoded rows")
    built.search_window_size = window
    out["sq8"] = timed_serving(
        built.index, queries, sq_gt, "SQ-int8 unpacked", f32_recall(window),
        kernels=(score_rows, beam_update), path="scored path")
    vs_f32 = svt.k_recall_at_n(gt, built.search(queries, 10))
    log(f"scored path: SQ-int8 at window {window}: recall@10 against the "
        f"f32 truth {vs_f32:.4f} (ceiling {ceiling:.4f})")
    out["sq8"].update(window=window, build_s=build_s,
                      build_launches=launches, vs_f32=vs_f32,
                      ceiling=ceiling,
                      mean_degree=built.index.graph.mean_degree())
    loaded = round_trip(
        "SQ-int8 index save / assemble", built.save,
        lambda tmp: svt.Vamana.assemble(tmp, device=built.index.data.device))
    same_index("SQ-int8 index", loaded.index, built.index)
    same_search("SQ-int8 unpacked", built, loaded, queries,
                (score_rows, beam_update), path="scored path")
    del built, sq, loaded
    torch.cuda.empty_cache()

    # 3. one wide search: capacity 1280 over the f32 rows
    nq = 1000
    sub_gt = QueryResult(ids=gt.ids[:nq], distances=gt.distances[:nq])
    ref = f32_recall(128, queries[:nq], sub_gt)
    before = read_counts()
    index.search_window_size = WIDE_CAPACITY
    t0 = time.perf_counter()
    res = index.search(queries[:nq], 10)
    wide_s = time.perf_counter() - t0
    launches = launched_since(before)
    recall = svt.k_recall_at_n(sub_gt, res)
    log(f"scored path: wide search capacity {WIDE_CAPACITY} window "
        f"{WIDE_CAPACITY}, {nq} queries in {wide_s:.2f} s, recall@10 "
        f"{recall:.4f} (f32 index at window 128: {ref:.4f}); launches "
        f"{launches}")
    if launches["gather_score_l2_partial"] == 0 or launches["beam_update"] \
            or launches["beam_step"]:
        raise AssertionError(f"wide search took another route: {launches}")
    if recall < ref:
        raise AssertionError(f"wide search recall {recall} < {ref}")
    out["wide"] = {"recall": recall, "seconds": wide_s, "ref": ref}
    out["launches"] = read_counts()
    log(f"scored path: launches {out['launches']}")
    return out


def phase_dynamic(main_path: dict) -> dict:
    """The dynamic index at the main path's scale on the card: an 80k build
    in storage for 84k, bf16 packed serving and sampled entries, four
    cycles of 5,000 adds (the first grows the storage) and 5,000 deletes,
    consolidation after cycles 2 and 4, a compact; after every step the
    window sweep against the exact search over the live set (no deleted or
    unknown id) and QPS there (host clock, noisy); a save / assemble round
    trip with deleted slots pending; DynamicFlat through the same
    mutations, exact at the end.  Counts start at 0 here; beam_step must
    launch in the build, every add and every search.  Returns the phase's
    beam_step launches, the index and its ReferenceDataset."""
    import scalablevectorsearch_tpu_torch as svt
    from scalablevectorsearch_tpu_torch.index.vamana.dynamic import (
        SLOT_DELETED, SLOT_VALID, _affected_by_deleted)
    from scalablevectorsearch_tpu_torch.ops.kernels.beam_step import (
        beam_step, beam_step_lvq)
    data, queries = main_path["data"], main_path["queries"]
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    ref = svt.ReferenceDataset(data, seed=0)
    pts, ids = ref.new_batch(DYN_ROWS)
    t0 = time.perf_counter()
    dv = svt.DynamicVamana.build(main_path_params(), pts, ids, "l2",
                                 capacity=DYN_CAPACITY)
    sync()
    build_s = time.perf_counter() - t0
    index = dv.index
    log(f"dynamic: build {DYN_ROWS}x{data.shape[1]} in {build_s:.2f} s "
        f"(capacity {index.data.capacity}), mean degree "
        f"{index.graph.mean_degree():.3f}, beam_step launches "
        f"{beam_step.launches}")
    if beam_step.launches == 0:
        raise AssertionError("dynamic: beam_step not launched in the build")
    flat = svt.DynamicFlat.build(pts, ids, "l2")
    dv.enable_packed_serving()
    dv.enable_entry_sampler()

    def searched(label) -> None:
        """The sweep over the live set, every search launching beam_step
        and returning live ids only; then QPS at the window reached."""
        sweep(dv, queries, ref.groundtruth(queries, 10), f"dynamic: {label}",
              launch_check(beam_step, f"dynamic: {label}", ref.check_ids))
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            ref.check_ids(dv.search_async(queries, 10).result())
            times.append(time.perf_counter() - t0)
        log(f"dynamic: {label}: size {dv.size}, window "
            f"{dv.search_window_size}: "
            f"{len(queries) / statistics.median(times):.1f} QPS (host clock, "
            f"noisy)")

    def step(label, fn) -> int:
        """Run one mutation (seconds, beam_step launches, peak device
        memory), then the sweep over the live set; returns the launches."""
        torch.cuda.reset_peak_memory_stats()
        before = beam_step.launches
        t0 = time.perf_counter()
        fn()
        sync()
        launches = beam_step.launches - before
        log(f"dynamic: {label} in {time.perf_counter() - t0:.3f} s (capacity "
            f"{index.data.capacity}, high-water {index.data.n}), beam_step "
            f"launches {launches}, peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        searched(label)
        return launches

    def assemble(tmp):
        out = svt.DynamicVamana.assemble(tmp, device=index.data.device)
        out.enable_packed_serving()
        out.search_window_size = dv.search_window_size
        return out

    searched("build")
    for cycle in range(1, 5):
        pts, ids = ref.new_batch(DYN_BATCH)
        if step(f"cycle {cycle} add_points {DYN_BATCH}",
                lambda: dv.add_points(pts, ids)) == 0:
            raise AssertionError(f"dynamic: cycle {cycle}: add_points "
                                 f"launched no beam_step")
        flat.add_points(pts, ids)
        dead = ref.delete_batch(DYN_BATCH)
        step(f"cycle {cycle} delete_points {DYN_BATCH}",
             lambda: dv.delete_points(dead))
        flat.delete_points(dead)
        if cycle == 3:
            pending = int((index.status == SLOT_DELETED).sum())
            loaded = round_trip(f"round trip with {pending} deleted slots "
                                f"pending", dv.save, assemble, path="dynamic")
            if loaded.index._sampler_cfg != index._sampler_cfg or \
                    not np.array_equal(loaded.index.status[:index.data.n],
                                       index.status[:index.data.n]):
                raise AssertionError("dynamic: the assembled copy's state "
                                     "differs")
            same_search("round trip", dv, loaded, queries, (beam_step,),
                        path="dynamic")
        if cycle in (2, 4):
            valid = torch.from_numpy(index.status == SLOT_VALID).to(
                index.data.device)
            affected = int(_affected_by_deleted(
                index.graph.adjacency, index.deleted_mask, valid).sum())
            log(f"dynamic: cycle {cycle}: {affected} vertices affected by "
                f"{int(index.deleted_mask.sum())} deleted slots")
            step(f"cycle {cycle} consolidate", dv.consolidate)
    step("compact", dv.compact)
    flat.compact()
    if index.data.n != len(ref.live) or dv.size != len(ref.live):
        raise AssertionError("dynamic: compact left empty slots")
    dynamic_flat_check(flat, queries, ref)
    log(f"dynamic: launches beam_step {beam_step.launches}, beam_step_lvq "
        f"{beam_step_lvq.launches}")
    return {"launches": beam_step.launches, "index": dv, "ref": ref}


def dynamic_flat_check(flat, queries, ref, sample: int = 256) -> None:
    """DynamicFlat after the same mutations: recall@10 >= 0.999 against
    the exact search over the live set, and every miss a tie of the 10th
    distance (:func:`misses_are_ties`); for the first ``sample`` queries,
    every returned distance equal to the float64 distance of its row on
    the host (:func:`host_distances`)."""
    import scalablevectorsearch_tpu_torch as svt
    res = flat.search(queries, 10)
    ref.check_ids(res)
    gt = ref.groundtruth(queries, 10)
    recall = svt.k_recall_at_n(gt, res)

    def rows_of(ids):
        return ref.pool[[ref.live[int(e)] for e in ids]]

    host_distances(res, queries, rows_of, "dynamic flat", sample)
    misses_are_ties(res, gt, queries, rows_of, "dynamic flat")
    log(f"dynamic: DynamicFlat over the {flat.size} live rows: recall@10 "
        f"{recall:.6f}; distances of {min(sample, len(queries))} queries "
        f"equal the host's float64 ones within f32 rounding")
    if recall < 0.999:
        raise AssertionError(f"dynamic flat recall {recall} < 0.999")


def counted_kernels() -> tuple:
    """The wrappers of the five kernels, each with its launch count."""
    from scalablevectorsearch_tpu_torch.ops.kernels.beam_step import (
        beam_step, beam_step_lvq)
    from scalablevectorsearch_tpu_torch.ops.kernels.beam_update import (
        beam_update)
    from scalablevectorsearch_tpu_torch.ops.kernels.gather_distance import (
        gather_score_l2_partial, score_rows)
    return (beam_step, beam_step_lvq, beam_update, score_rows,
            gather_score_l2_partial)


def zero_counts() -> None:
    for kernel in counted_kernels():
        kernel.launches = 0


def read_counts() -> dict:
    return {kernel.__name__: kernel.launches for kernel in counted_kernels()}


def launched_since(before: dict) -> dict:
    return {name: count - before[name]
            for name, count in read_counts().items()}


def phase_iterator(main_path: dict, dynamic: dict) -> dict:
    """BatchIterator on the card: 32 queries x 10 pages of 10 over the main
    index from its serving window (the default schedule); one query in pages of 64
    past capacity 1024 into the wide route; the dynamic index after a soft
    delete of the 128 live rows nearest query 0.  Counts start at 0 here;
    every page launches beam_step but the wide ones, which launch
    gather_score_l2_partial and no beam_step."""
    import scalablevectorsearch_tpu_torch as svt
    from scalablevectorsearch_tpu_torch.index.vamana.dynamic import (
        SLOT_VALID)
    index = main_path["index"].index
    data, queries, gt = (main_path[key] for key in ("data", "queries", "gt"))
    zero_counts()

    def page(it, label):
        """One page; fails unless beam_step launched and the page is
        nearest-first without repeats."""
        before = read_counts()
        res = it.next()
        if launched_since(before)["beam_step"] == 0:
            raise AssertionError(f"iterator: {label}: beam_step not "
                                 f"launched")
        ids = res.ids[0][res.ids[0] >= 0]
        if np.any(np.diff(res.distances[0][res.ids[0] >= 0]) < 0) or \
                len(np.unique(ids)) != ids.size:
            raise AssertionError(f"iterator: {label}: not nearest-first or "
                                 f"repeats an id")
        return res

    nq = ITER_QUERIES
    gt100 = svt.exhaustive_search(data, queries[:nq], 100).ids
    # page from the serving window of the main path's sweep, as a user of
    # the served index would (later phases move the index's window)
    index.search_window_size = main_path["window"]
    first = cover = 0
    t0 = time.perf_counter()
    for qi in range(nq):
        it = svt.BatchIterator(index, queries[qi], batch_size=10)
        pages = [page(it, f"query {qi} page {p}") for p in range(ITER_PAGES)]
        ids = np.concatenate([p.ids[0] for p in pages])
        if np.any(ids < 0) or len(np.unique(ids)) != ids.size:
            raise AssertionError(f"iterator: query {qi}: pages overlap or "
                                 f"run short")
        first += len(set(pages[0].ids[0].tolist())
                     & set(gt.ids[qi, :10].tolist()))
        cover += len(set(ids.tolist()) & set(gt100[qi].tolist()))
        it.restart()
        if not np.array_equal(page(it, f"query {qi} restart").ids,
                              pages[0].ids):
            raise AssertionError(f"iterator: query {qi}: restart gives "
                                 f"another first page")
    main_s = time.perf_counter() - t0
    first, cover = first / (10 * nq), cover / (100 * nq)
    log(f"iterator: main index, {nq} queries x {ITER_PAGES} pages of 10 from "
        f"window {main_path['window']} (+ a restart each) in {main_s:.2f} s: "
        f"first-page recall@10 {first:.4f}, the {ITER_PAGES} pages cover "
        f"{cover:.4f} of the exact top-100; launches {read_counts()}")
    if first < 0.9 or cover < 0.95:
        raise AssertionError(f"iterator: first-page recall {first} or "
                             f"coverage {cover} too low")

    # one query past capacity 1024: pages of 64 from window 64
    schedule = svt.DefaultSchedule(64, 64)
    it = svt.BatchIterator(index, queries[nq], batch_size=64,
                           schedule=schedule)
    got, wide = [], 0
    t0 = time.perf_counter()
    while wide < 2:
        window, capacity = schedule.for_iteration(it.batch_number)
        before = read_counts()
        res = it.next()
        launched = launched_since(before)
        if capacity > 1024:
            wide += 1
            if launched["beam_step"] or not \
                    launched["gather_score_l2_partial"]:
                raise AssertionError(f"iterator: the page at capacity "
                                     f"{capacity} took another route: "
                                     f"{launched}")
        elif not launched["beam_step"]:
            raise AssertionError(f"iterator: page at capacity {capacity}: "
                                 f"beam_step not launched")
        live = res.ids[0] >= 0
        if np.any(np.diff(res.distances[0][live]) < 0):
            raise AssertionError(f"iterator: page at capacity {capacity} "
                                 f"is not nearest-first")
        got.append(res.ids[0][live])
    ids = np.concatenate(got)
    exact = svt.exhaustive_search(data, queries[nq:nq + 1], ids.size).ids[0]
    overlap = len(set(ids.tolist()) & set(exact.tolist())) / ids.size
    log(f"iterator: one query, {len(got)} pages of 64 up to window {window} "
        f"capacity {capacity} ({wide} on the wide route) in "
        f"{time.perf_counter() - t0:.2f} s: {ids.size} ids yielded "
        f"({len(np.unique(ids))} distinct; pages short of 64 once the "
        f"reachable rows run out: {sum(g.size < 64 for g in got)}), "
        f"{overlap:.4f} of them in the exact top-{ids.size}; done "
        f"{it.done()}")
    if len(np.unique(ids)) != ids.size:
        raise AssertionError("iterator: deep pages repeat an id")

    # the dynamic index after a soft delete of query 0's 128 nearest rows
    dv, ref = dynamic["index"], dynamic["ref"]
    dyn = dv.index
    doomed = ref.groundtruth(queries[:1], 128)[0]
    dv.delete_points(doomed)
    dead = set(doomed.tolist())
    live_total, partial = 0, 0
    for qi in range(8):
        it = svt.BatchIterator(dyn, queries[qi], batch_size=10)
        for p in range(5):
            res = page(it, f"dynamic query {qi} page {p}")
            slots = res.ids[0][res.ids[0] >= 0]
            ext = dyn.translator.to_external(slots)
            if slots.size == 0 or np.any(slots >= dyn.data.n) or \
                    np.any(dyn.status[slots] != SLOT_VALID) or \
                    dead & set(ext.tolist()) or \
                    any(int(e) not in ref.live for e in ext):
                raise AssertionError(f"iterator: dynamic query {qi} page "
                                     f"{p} yields slots {slots}")
            live_total += slots.size
            partial += slots.size < 10
        if it.done():
            raise AssertionError(f"iterator: dynamic query {qi} exhausted")
    log(f"iterator: dynamic index ({dv.size} live, 128 deleted near query "
        f"0): 8 queries x 5 pages yield {live_total} live ids, {partial} "
        f"pages short of 10, no deleted or unknown id")
    counts = read_counts()
    log(f"iterator: launches {counts}")
    return counts


def phase_calibrate(main_path: dict) -> dict:
    """calibrate_full on the main index: target recall@10 0.9 with 1000
    calibration queries, the winner's recall on the other 4000 >= 0.89;
    the same with the int8 upload axis; an unreachable target.  Which
    feasible configuration wins is decided by host-clock QPS, which is
    noise on this card, so only recall is checked.  Counts start at 0
    here; beam_step must launch."""
    import scalablevectorsearch_tpu_torch as svt
    from scalablevectorsearch_tpu_torch.index.vamana import index as index_mod
    from scalablevectorsearch_tpu_torch.index.vamana.calibrate import (
        calibrate_full)
    index = main_path["index"].index
    queries, gt = main_path["queries"], main_path["gt"].ids
    n_cal = 1000
    zero_counts()
    dtypes, search = [], index.search

    def spy(*args, **kwargs):
        dtypes.append(index.query_upload_dtype)
        return search(*args, **kwargs)

    def run(label, target, params):
        dtypes.clear()
        t0 = time.perf_counter()
        res = calibrate_full(index, queries[:n_cal], gt[:n_cal], 10, target,
                             params)
        seconds = time.perf_counter() - t0
        state = (index.search_parameters, index.pop_width, index.tail_frac,
                 index._packed is not None, index.query_upload_dtype)
        if state != (res.search_parameters, res.pop_width, res.tail_frac,
                     res.packed, res.query_upload_dtype):
            raise AssertionError(f"calibrate: {label}: the winner is not "
                                 f"set on the index")
        held = svt.k_recall_at_n(gt[n_cal:], index.search(queries[n_cal:],
                                                          10))
        cfg = res.search_parameters.buffer_config
        log(f"calibrate: {label}: {res.trials} trials in {seconds:.2f} s; "
            f"winner window {cfg.search_window_size} capacity "
            f"{cfg.search_buffer_capacity} pop_width {res.pop_width} "
            f"tail_frac {res.tail_frac} packed {res.packed} upload "
            f"{res.query_upload_dtype}; recall@10 {res.recall:.4f} on the "
            f"{n_cal} calibration queries, {held:.4f} on the other "
            f"{len(queries) - n_cal}; {res.qps:.1f} QPS (host clock, "
            f"noisy); searched under uploads {sorted(set(map(str, dtypes)))}")
        return res, held

    index.search = spy
    try:
        res, held = run("target 0.9", 0.9, None)
        if res.recall < 0.9 or held < 0.89:
            raise AssertionError(f"calibrate: recall {res.recall}, held-out "
                                 f"{held}")
        res, held = run("target 0.9, int8 axis", 0.9,
                        svt.CalibrationParameters(try_int8_uploads=True))
        if held < 0.89 or set(dtypes) != {None, "int8"}:
            raise AssertionError(f"calibrate: int8 axis: held-out {held}, "
                                 f"uploads searched {set(dtypes)}")
        uploads, prepare = [], index_mod.prepare_query_upload

        def record(q_host, override=None):
            out = prepare(q_host, override)
            uploads.append(out[0].dtype)
            return out

        index_mod.prepare_query_upload = record
        try:
            search(queries[n_cal:], 10)
        finally:
            index_mod.prepare_query_upload = prepare
        want = torch.int8 if res.query_upload_dtype == "int8" else \
            torch.float16
        log(f"calibrate: int8 axis winner {res.query_upload_dtype}: the "
            f"index's search uploads {uploads}")
        if uploads != [want]:
            raise AssertionError(f"calibrate: the index uploads {uploads}, "
                                 f"not {want}")
        res, _ = run("unreachable target 1.01", 1.01,
                     svt.CalibrationParameters(search_window_upper=64))
        if res.search_parameters.buffer_config.search_window_size != 64 or \
                res.qps != 0.0:
            raise AssertionError("calibrate: unreachable target did not "
                                 "return the best effort at window 64")
    finally:
        del index.search
        index.query_upload_dtype = None
    counts = read_counts()
    log(f"calibrate: launches {counts}")
    if counts["beam_step"] == 0:
        raise AssertionError("calibrate: beam_step not launched")
    return counts


def leanvec_rerank_check(lv, queries, k: int = 10) -> int:
    """The reranked search of ``queries`` against float64 on the host: the
    fetched k * rerank_multiplier ids re-scored with the secondary's
    decoded rows and the f32 queries.  Every returned id must be fetched,
    its distance the host's within 8 f32 epsilons of ||q||^2 + ||x||^2
    (the norm algebra's rounding), and the returned distances the host's
    k smallest within that rounding (ids may differ only at ties).
    Returns the queries whose ids differ from the host's order."""
    got = lv.search(queries, k)
    fetch = k * lv.rerank_multiplier
    fetched = lv.index.search(lv.leanvec.project_queries(queries), fetch).ids
    sec = lv.leanvec.secondary
    flat = torch.from_numpy(np.maximum(fetched, 0).reshape(-1)).to(
        sec.device)
    rows = sec.get(flat)[:, : sec.dim].cpu().numpy().astype(np.float64)
    rows = rows.reshape(len(queries), fetch, sec.dim)
    q = queries.astype(np.float64)
    dist = ((rows - q[:, None, :]) ** 2).sum(-1)
    dist[fetched < 0] = np.inf
    tol = 8 * np.finfo(np.float32).eps * ((rows ** 2).sum(-1)
                                          + (q ** 2).sum(-1)[:, None])
    differ = 0
    for i in range(len(queries)):
        pos = [np.flatnonzero(fetched[i] == g) for g in got.ids[i]]
        if any(p.size == 0 for p in pos):
            raise AssertionError(f"leanvec: query {i} returns ids it did "
                                 f"not fetch")
        pos = np.array([p[0] for p in pos])
        host = np.sort(dist[i])[:k]
        if np.any(np.abs(got.distances[i] - dist[i][pos]) > tol[i][pos]) or \
                np.any(np.abs(got.distances[i] - host) > tol[i][pos]):
            raise AssertionError(f"leanvec: query {i}: distances "
                                 f"{got.distances[i]}, host {host}")
        differ += not np.array_equal(
            got.ids[i], fetched[i][np.argsort(dist[i], kind="stable")[:k]])
    return differ


def phase_leanvec(main_path: dict) -> dict:
    """LeanVec over the main path's data, PCA and OOD (phase 14).  Counts
    start at 0 here; the builds and every search launch beam_step_lvq."""
    import scalablevectorsearch_tpu_torch as svt
    from scalablevectorsearch_tpu_torch.ops.kernels.beam_step import (
        beam_step_lvq)
    data, queries, gt = (main_path[key] for key in ("data", "queries", "gt"))
    zero_counts()
    # the OOD query training set: 10,000 more queries of the main path's
    # clusters (its generator and seed, 42, with more queries), none of
    # them a test query
    _, more = svt.generate_test_dataset(data.shape[0], len(queries) + 10_000,
                                        data.shape[1], seed=42)
    train_q = more[len(queries):]
    if {r.tobytes() for r in train_q} & {r.tobytes() for r in queries}:
        raise AssertionError("leanvec: a training query is a test query")
    out = {}

    for mode, train in (("PCA", None), ("OOD", train_q)):
        t0 = time.perf_counter()
        lvd = svt.LeanVecDataset.train(data, LEANVEC_DIM, queries=train)
        sync()
        train_s = time.perf_counter() - t0
        before = beam_step_lvq.launches
        t0 = time.perf_counter()
        lv = svt.LeanVecVamana.build(main_path_params(), lvd, "l2",
                                     sampled_entries=True)
        sync()
        build_s = time.perf_counter() - t0
        build_launches = beam_step_lvq.launches - before
        size = {level: nbytes(ds.codes[: ds.n], ds.scales[: ds.n],
                              ds.biases[: ds.n])
                for level, ds in (("primary", lvd.primary),
                                  ("secondary", lvd.secondary))}
        log(f"leanvec: {mode} train {data.shape[0]}x{data.shape[1]} -> "
            f"{lvd.reduced_dim} in {train_s:.2f} s; build in {build_s:.2f} "
            f"s, mean degree {lv.index.graph.mean_degree():.3f}, "
            f"beam_step_lvq launches {build_launches}; codes, scales and "
            f"biases {size} bytes, graph "
            f"{nbytes(lv.index.graph.adjacency)} bytes")
        if build_launches == 0:
            raise AssertionError(f"leanvec: {mode} build: beam_step_lvq not "
                                 f"launched")
        if train is None:
            # PCA's map is orthonormal: the share of the centered data's
            # variance, and of the squared distances from 256 queries to
            # their exact ten nearest, that its dimensions keep
            cen = data - lvd.mean
            var = float(((cen @ lvd.projection) ** 2).sum()
                        / (cen ** 2).sum())
            diff = queries[:256, None, :] - data[gt.ids[:256]]
            near = float(((diff @ lvd.projection) ** 2).sum()
                         / (diff ** 2).sum())
            log(f"leanvec: PCA's {lvd.reduced_dim} of {data.shape[1]} "
                f"dimensions keep {var:.4f} of the data's variance and "
                f"{near:.4f} of the squared distance from a query to its "
                f"exact ten nearest")
        pq = lvd.project_queries(queries)
        primary_gt = svt.exhaustive_search(lvd.primary, pq, 10)
        window, primary = sweep(lv.index, pq, primary_gt,
                                f"leanvec: {mode} primary search against the "
                                f"exact search over the decoded primary",
                                launch_check(beam_step_lvq, f"leanvec: {mode} "
                                             f"primary search"))
        check = launch_check(beam_step_lvq, f"leanvec: {mode} reranked search")
        # windows below the fetch of k * rerank_multiplier search at the
        # fetch's width, so the sweep starts there
        fetch = 10 * lv.rerank_multiplier
        steps = []
        for w in (fetch,) + tuple(w for w in WINDOWS if w > fetch):
            lv.search_window_size = w
            t0 = time.perf_counter()
            res = lv.search(queries, 10)
            seconds = time.perf_counter() - t0
            check(res, w)
            steps.append((w, svt.k_recall_at_n(gt, res),
                          len(queries) / seconds))
        log(f"leanvec: {mode} search (fetch {fetch}, rerank over the "
            f"secondary): window:recall@10 against the f32 truth/QPS (host "
            f"clock, noisy) "
            + " ".join(f"{w}:{r:.4f}/{q:.0f}" for w, r, q in steps))
        # the projection's ceiling: the exact top-c of the projected search
        # (the decoded primary), reranked as the search reranks
        ceiling = {c: svt.k_recall_at_n(gt, lv.rerank(
            queries, svt.exhaustive_search(lvd.primary, pq, c).ids, 10))
            for c in (fetch, 100)}
        log(f"leanvec: {mode} exact projected top-c reranked, f32-truth "
            f"recall@10: " + " ".join(f"c {c}: {r:.4f}"
                                      for c, r in ceiling.items()))
        lv.search_window_size = window
        differ = leanvec_rerank_check(lv, queries[:256])
        log(f"leanvec: {mode} rerank at window {window}: 256 queries equal "
            f"the float64 host rerank of the fetched ids within f32 "
            f"rounding; {differ} with tied ids in another order")
        loaded = round_trip(
            f"{mode} LeanVec index save / assemble", lv.save,
            lambda tmp: svt.LeanVecVamana.assemble(
                tmp, device=lvd.primary.device), path="leanvec")
        loaded.search_window_size = window
        same_search(f"{mode} LeanVec", lv, loaded, queries, (beam_step_lvq,),
                    path="leanvec")
        out[mode] = {"window": window, "primary_recall": primary,
                     "ceiling": ceiling[fetch],
                     "build_s": build_s, "build_launches": build_launches}
        del lv, lvd, loaded
        torch.cuda.empty_cache()
    counts = read_counts()
    log(f"leanvec: launches {counts}; f32-truth recall@10 of the exact "
        f"projected top-30 reranked: PCA {out['PCA']['ceiling']:.4f}, OOD "
        f"{out['OOD']['ceiling']:.4f}")
    out["launches"] = counts
    return out


IVF_PROBES = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128)
IVF_BATCH = 2500               # bench.py's IVF query batch
INVERTED_SETTINGS = tuple((probes, eps) for probes in (16, 32)
                          for eps in (0.0, 0.25, 1.0, 2.0))


def ivf_params(n: int, hierarchical: bool = False):
    """bench.py's IVF configuration: 3 sqrt(n) centroids, 10 iterations,
    every row trained on."""
    import scalablevectorsearch_tpu_torch as svt
    return svt.IVFBuildParameters(num_centroids=int(np.sqrt(n) * 3),
                                  num_iterations=10, training_fraction=1.0,
                                  is_hierarchical=hierarchical)


def probe_sweep(index, queries, gt, label: str, check=None,
                k_reorder: int = 1):
    """First n_probes of IVF_PROBES with recall@10 >= 0.9 against ``gt``
    (ids); fails if none.  ``check(result)`` runs on every result."""
    import scalablevectorsearch_tpu_torch as svt
    steps = []
    for probes in IVF_PROBES:
        res = index.search(queries, 10, svt.IVFSearchParameters(
            n_probes=probes, k_reorder=k_reorder))
        if check is not None:
            check(res)
        recall = svt.k_recall_at_n(gt, res)
        steps.append(f"{probes}:{recall:.4f}")
        if recall >= 0.9:
            log(f"{label}: recall@10 probe sweep " + " ".join(steps))
            return probes, recall
        if probes >= index.num_probe_units:
            break
    raise AssertionError(f"{label}: no n_probes reached recall@10 >= 0.9 "
                         f"({' '.join(steps)})")


def median_qps(search, nq: int) -> float:
    """Queries per second of the median of 5 ``search()`` calls (host
    clock, noisy)."""
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        search()
        times.append(time.perf_counter() - t0)
    return nq / statistics.median(times)


def host_distances(res, queries, rows_of, label: str, sample: int = 256
                   ) -> None:
    """The first ``sample`` queries' returned distances against float64 L2
    distances of their rows on the host (``rows_of(ids)`` -> rows); the
    norm algebra's rounding is a few ulps of ||q||^2 + ||x||^2, so 8 f32
    epsilons of that sum are allowed."""
    eps = 8 * np.finfo(np.float32).eps
    for qi in range(min(sample, len(queries))):
        ids = res.ids[qi][res.ids[qi] >= 0]
        x = rows_of(ids).astype(np.float64)
        q = queries[qi].astype(np.float64)
        want = ((x - q) ** 2).sum(1)
        tol = eps * ((x ** 2).sum(1) + q @ q)
        if np.any(np.abs(res.distances[qi][: ids.size] - want) > tol):
            raise AssertionError(f"{label}: query {qi} returns distances "
                                 f"{res.distances[qi]}, the host gives "
                                 f"{want}")


def misses_are_ties(res, gt_ids, queries, rows_of, label: str) -> int:
    """Every id of the exact top-10 that ``res`` misses lies at the 10th
    returned distance (float64 on the host, within 8 f32 epsilons of
    ||q||^2 + ||x||^2); returns the count of such tied misses."""
    eps = 8 * np.finfo(np.float32).eps
    ties = 0
    for qi in np.nonzero((np.sort(gt_ids, 1)
                          != np.sort(res.ids, 1)).any(1))[0]:
        q = queries[qi].astype(np.float64)
        missed = rows_of(np.setdiff1d(gt_ids[qi], res.ids[qi]))
        tenth = rows_of(res.ids[qi, 9:10]).astype(np.float64)
        d_missed = ((missed.astype(np.float64) - q) ** 2).sum(1)
        d_tenth = float(((tenth - q) ** 2).sum())
        tol = eps * (float((tenth ** 2).sum()) + q @ q)
        if np.any(np.abs(d_missed - d_tenth) > tol):
            raise AssertionError(f"{label}: query {qi} misses rows at "
                                 f"{d_missed}, not ties of the 10th "
                                 f"{d_tenth}")
        ties += missed.shape[0]
    return ties


def ties_only(got, want, queries, rows_of, label: str) -> int:
    """Rows where ``got`` and ``want`` (searches with f32 uploads) return
    other ids must hold the same float64 L2 distances on the host, sorted,
    within 8 f32 epsilons of ||q||^2 + ||x||^2: near-ties whose order the
    rounding decides.  Returns the count of such rows."""
    eps = 8 * np.finfo(np.float32).eps
    rows = np.nonzero((got.ids != want.ids).any(1))[0]
    for qi in rows:
        q = queries[qi].astype(np.float64)
        dists = []
        for ids in (got.ids[qi], want.ids[qi]):
            x = rows_of(ids[ids >= 0]).astype(np.float64)
            dists.append((np.sort(((x - q) ** 2).sum(1)),
                          eps * ((x ** 2).sum(1).max() + q @ q)))
        (a, tol), (b, _) = dists
        if a.shape != b.shape or np.any(np.abs(a - b) > tol):
            raise AssertionError(f"{label}: query {qi} returns {a}, the "
                                 f"other search {b}: not ties")
    return rows.size


def phase_ivf(main_path: dict) -> dict:
    """IVF on the card over the main path's data, queries and exact ground
    truth (bench.py's configuration, no cut): training seconds and a
    second training with the same seed (identical centroids and
    assignments); the layout's slot and padding; the probe sweep to
    recall@10 >= 0.9 and QPS there; a full probe against the exhaustive
    search (only ties of the 10th distance missed; 256 queries' distances
    against float64 on the host); the row-gather scan route against the
    super-row one (identical ids but at near-ties, each proven on the
    host); a hierarchical training and its sweep;
    LVQ-8 postings with the k_reorder 3 rerank, swept; save /
    assemble_from_file (identical search) and save_packed_layout_host
    (bf16 rows; recall reported); IVFBatchIterator; DynamicIVF over 80,000
    rows through two cycles of 5,000 adds and 5,000 deletes and a compact,
    swept after every step.  No kernel of the repo is on this path (the
    posting scan is PyTorch code, as it is XLA code in the JAX package);
    the counts stay 0 and are returned."""
    import scalablevectorsearch_tpu_torch as svt
    from scalablevectorsearch_tpu_torch.index.ivf.index import (
        save_packed_layout_host)
    data, queries, gt = (main_path[key] for key in ("data", "queries", "gt"))
    n = data.shape[0]
    zero_counts()
    bp = ivf_params(n)
    t0 = time.perf_counter()
    clustering = svt.Clustering.build(bp, data)
    train_s = time.perf_counter() - t0
    again = svt.Clustering.build(bp, data)
    same = np.array_equal(again.centroids, clustering.centroids) and \
        np.array_equal(again.assignments, clustering.assignments)
    sizes = clustering.cluster_sizes()
    log(f"ivf: train {bp.num_centroids} centroids (minibatch, 10 "
        f"iterations, all {n} rows) in {train_s:.2f} s; a second training "
        f"with the seed gives identical centroids and assignments: {same}; "
        f"cluster sizes {sizes.min()}-{sizes.max()} (empty "
        f"{int((sizes == 0).sum())})")
    if not same:
        raise AssertionError("ivf: two trainings with one seed differ")
    t0 = time.perf_counter()
    ivf = svt.IVF.assemble_from_clustering(clustering, data, "l2",
                                           query_batch_size=IVF_BATCH)
    sync()
    index = ivf.index
    total = index.ids_padded.shape[0]
    log(f"ivf: assemble in {time.perf_counter() - t0:.2f} s: slot "
        f"{index.slot}, {index.num_probe_units} probe units, padding factor "
        f"{total / n:.3f} ({total} rows, "
        f"{index.data.vectors.numel() * index.data.vectors.element_size()} "
        f"bytes on the card)")
    gt_ids = gt.ids
    probes, recall = probe_sweep(index, queries, gt_ids, "ivf")
    ivf.n_probes = probes
    qps = median_qps(lambda: ivf.search_async(queries, 10).result(),
                     len(queries))
    log(f"ivf: n_probes {probes} recall@10 {recall:.4f}; search_async x5 "
        f"median -> {qps:.1f} QPS (host clock, noisy)")

    # exactness checks upload f32 queries (the default float16 upload
    # rounds each distance by ~1e-5 relative)
    index.query_upload_dtype = "float32"
    t0 = time.perf_counter()
    full = index.search(queries, 10, svt.IVFSearchParameters(
        n_probes=index.num_probe_units))
    full_s = time.perf_counter() - t0
    index.query_upload_dtype = None
    ties = misses_are_ties(full, gt_ids, queries, lambda ids: data[ids],
                           "ivf full probe")
    host_distances(full, queries, lambda ids: data[ids], "ivf full probe")
    log(f"ivf: full probe ({index.num_probe_units} units, f32 query "
        f"uploads) in {full_s:.2f} s: recall@10 {svt.k_recall_at_n(gt, full):.6f}, {ties} misses, "
        f"each a tie of the 10th distance; 256 queries' distances equal the "
        f"host's float64 ones within f32 rounding")

    # the two scan routes round the norm algebra in other orders (norms
    # recomputed from the gathered super-rows or read from the cache; the
    # contraction over slot or sub rows), so ids may differ at near-ties
    sp = svt.IVFSearchParameters(n_probes=probes)
    default = index.search(queries, 10, sp)
    index.query_upload_dtype = "float32"
    f32 = index.search(queries, 10, sp)
    os.environ["SVT_IVF_SCAN_LAYOUT"] = "0"
    try:
        index._scan_vecs = index._scan_ids = None
        index._scan_sub = 0
        rows_route = index.search(queries, 10, sp)
        routed = index._scan_vecs is None
    finally:
        del os.environ["SVT_IVF_SCAN_LAYOUT"]
        index.query_upload_dtype = None
    if not routed:
        raise AssertionError("ivf: SVT_IVF_SCAN_LAYOUT=0 kept the super-row "
                             "route")
    ties = ties_only(rows_route, f32, queries, lambda ids: data[ids],
                     "ivf scan routes")
    log(f"ivf: row-gather route (SVT_IVF_SCAN_LAYOUT=0) against the "
        f"super-row route at n_probes {probes} (f32 uploads): {ties} of "
        f"{len(queries)} rows order near-ties otherwise, each proven on the "
        f"host; distances max abs diff "
        f"{float(np.max(np.abs(rows_route.distances - f32.distances))):.3g}")

    t0 = time.perf_counter()
    hier = svt.IVF.build(ivf_params(n, hierarchical=True), data, "l2",
                         query_batch_size=IVF_BATCH)
    sync()
    log(f"ivf: hierarchical training + assemble in "
        f"{time.perf_counter() - t0:.2f} s (slot {hier.index.slot})")
    probe_sweep(hier.index, queries, gt_ids, "ivf hierarchical")
    del hier

    lvq = svt.IVF.assemble_from_clustering(
        clustering, data, "l2", dataset_cls=svt.LVQDataset, rerank=True,
        query_batch_size=IVF_BATCH)
    lvq_probes, _ = probe_sweep(lvq.index, queries, gt_ids,
                                "ivf LVQ-8 postings, rerank k_reorder 3",
                                k_reorder=3)
    del lvq

    def assemble(tmp):
        return svt.IVF.assemble_from_file(tmp, query_batch_size=IVF_BATCH)

    loaded = round_trip("save / assemble_from_file", ivf.save, assemble,
                        path="ivf")
    got = loaded.index.search(queries, 10, sp)
    if not (np.array_equal(got.ids, default.ids)
            and np.array_equal(got.distances, default.distances)):
        raise AssertionError("ivf: the assembled index searches otherwise")
    del loaded

    def host_packed(tmp):
        save_packed_layout_host(tmp, clustering, data, "l2")

    bf16 = round_trip("save_packed_layout_host (bf16 rows) / "
                      "assemble_from_file", host_packed, assemble,
                      path="ivf").index
    if bf16.data.dtype != torch.bfloat16:
        raise AssertionError("ivf: the host-packed copy is not bf16")
    log(f"ivf: round trip searched identically; the bf16 copy's recall@10 "
        f"at n_probes {probes}: "
        f"{svt.k_recall_at_n(gt, bf16.search(queries, 10, sp)):.4f}")
    del bf16
    phase_ivf_iterator(index, data, queries)
    phase_dynamic_ivf(data, queries)
    counts = read_counts()
    log(f"ivf: kernel launches {counts} (LVQ postings took n_probes "
        f"{lvq_probes})")
    return {name: count for name, count in counts.items() if count}


def phase_ivf_iterator(index, data, queries) -> None:
    """IVFBatchIterator: ITER_QUERIES queries x ITER_PAGES pages of 10;
    pages disjoint, no -1 before exhaustion, restart repeats page one;
    the exact top-100's coverage reported."""
    import scalablevectorsearch_tpu_torch as svt
    nq = ITER_QUERIES
    gt100 = svt.exhaustive_search(data, queries[:nq], 100).ids
    cover = 0
    t0 = time.perf_counter()
    for qi in range(nq):
        it = svt.IVFBatchIterator(index, queries[qi], batch_size=10)
        pages = [it.next() for _ in range(ITER_PAGES)]
        ids = np.concatenate([p.ids[0] for p in pages])
        if np.any(ids < 0) or len(np.unique(ids)) != ids.size or it.done():
            raise AssertionError(f"ivf iterator: query {qi}: pages overlap "
                                 f"or run short")
        cover += len(set(ids.tolist()) & set(gt100[qi].tolist()))
        it.restart()
        if not np.array_equal(it.next().ids, pages[0].ids):
            raise AssertionError(f"ivf iterator: query {qi}: restart gives "
                                 f"another first page")
    log(f"ivf iterator: {nq} queries x {ITER_PAGES} pages of 10 (+ a "
        f"restart each) in {time.perf_counter() - t0:.2f} s: pages disjoint, "
        f"none short; the ten pages cover {cover / (100 * nq):.4f} of the "
        f"exact top-100")


def phase_dynamic_ivf(data, queries) -> None:
    """DynamicIVF over DYN_ROWS rows (ReferenceDataset seed 0, as the
    dynamic path): two cycles of DYN_BATCH adds and deletes, then compact;
    after every step the probe sweep to recall@10 >= 0.9 against the exact
    search over the live set, with no deleted or unknown id."""
    import scalablevectorsearch_tpu_torch as svt
    ref = svt.ReferenceDataset(data, seed=0)
    pts, ids = ref.new_batch(DYN_ROWS)
    t0 = time.perf_counter()
    div = svt.DynamicIVF.build(ivf_params(DYN_ROWS), pts, ids, "l2",
                               query_batch_size=IVF_BATCH)
    sync()
    index = div.index
    log(f"dynamic ivf: build {DYN_ROWS} rows, {index.num_centroids} "
        f"centroids, in {time.perf_counter() - t0:.2f} s (slot {index.slot})")

    def step(label, fn) -> None:
        units = index.num_probe_units
        t0 = time.perf_counter()
        fn()
        sync()
        secs = time.perf_counter() - t0
        probes, recall = probe_sweep(
            index, queries, ref.groundtruth(queries, 10),
            f"dynamic ivf: {label}", check=ref.check_ids)
        log(f"dynamic ivf: {label} in {secs:.3f} s; probe units {units} -> "
            f"{index.num_probe_units}, size {div.size}; n_probes {probes} "
            f"recall@10 {recall:.4f}")

    step("build", lambda: None)
    for cycle in (1, 2):
        pts, ids = ref.new_batch(DYN_BATCH)
        step(f"cycle {cycle} add_points {DYN_BATCH}",
             lambda: div.add_points(pts, ids))
        dead = ref.delete_batch(DYN_BATCH)
        step(f"cycle {cycle} delete_points {DYN_BATCH}",
             lambda: div.delete_points(dead))
    step("compact", div.compact)
    if div.size != len(ref.live):
        raise AssertionError("dynamic ivf: size differs from the live set")


def phase_inverted(main_path: dict) -> dict:
    """The inverted index at its defaults (10% of the rows as centroids,
    the default Vamana primary, closure epsilon 0.05 and 8 replicas) over
    the main path's data: the build split into the primary graph, closure
    assignment and packing; slot, padding, replicas and the layout's bytes;
    the sweep over max_probes 16, 32 x refinement_epsilon 0, 0.25, 1, 2
    to recall@10 >= 0.9 and QPS there; 256 queries' distances against
    float64 on the host; a save / assemble round trip searched
    identically.  beam_step must launch in the build and in every search.
    Returns the phase's launches."""
    import scalablevectorsearch_tpu_torch as svt
    from scalablevectorsearch_tpu_torch.lib.timing import Timer
    from scalablevectorsearch_tpu_torch.ops.kernels.beam_step import (
        beam_step)
    data, queries, gt = (main_path[key] for key in ("data", "queries", "gt"))
    n = data.shape[0]
    zero_counts()
    timer = Timer()
    t0 = time.perf_counter()
    inv = svt.Inverted.build(svt.InvertedBuildParameters(), data, "l2",
                             timer=timer)
    sync()
    build_s = time.perf_counter() - t0
    index = inv.index
    split = {name: node.total_s for name, node in
             timer.root.children.items()}
    ids_padded = index.ids_padded.cpu().numpy()
    total = ids_padded.shape[0]
    live = int((ids_padded >= 0).sum())
    build_launches = beam_step.launches
    log(f"inverted: build {n} rows, {index.num_centroids} centroids in "
        f"{build_s:.2f} s (" + ", ".join(f"{k} {v:.2f} s"
                                         for k, v in split.items())
        + f"), beam_step launches {build_launches}; slot {index.slot}, "
        f"padding factor {total / n:.3f} ({total} rows), mean replicas per "
        f"point {live / n:.3f}, layout "
        f"{index.data.vectors.numel() * index.data.vectors.element_size()} "
        f"bytes on the card")
    if build_launches == 0:
        raise AssertionError("inverted: beam_step not launched in the build")
    steps, win = [], None
    for probes, eps in INVERTED_SETTINGS:
        sp = svt.InvertedSearchParameters(refinement_epsilon=eps,
                                          max_probes=probes)
        before = beam_step.launches
        res = index.search(queries, 10, sp)
        if beam_step.launches == before:
            raise AssertionError(f"inverted: beam_step not launched in the "
                                 f"search at {probes}, {eps}")
        recall = svt.k_recall_at_n(gt, res)
        steps.append(f"{probes}/{eps}:{recall:.4f}")
        if recall >= 0.9:
            win = sp, recall, res
            break
    log("inverted: recall@10 sweep (max_probes/epsilon) " + " ".join(steps))
    if win is None:
        raise AssertionError("inverted: no setting reached recall@10 >= 0.9")
    sp, recall, res = win
    inv.search_parameters = sp
    qps = median_qps(lambda: inv.search_async(queries, 10).result(),
                     len(queries))
    index.query_upload_dtype = "float32"     # see phase_ivf's full probe
    host_distances(index.search(queries, 10, sp), queries,
                   lambda ids: data[ids], "inverted")
    index.query_upload_dtype = None
    log(f"inverted: max_probes {sp.max_probes} epsilon "
        f"{sp.refinement_epsilon} recall@10 {recall:.4f}; search_async x5 "
        f"median -> {qps:.1f} QPS (host clock, noisy); 256 queries' "
        f"distances (f32 uploads) equal the host's float64 ones within f32 "
        f"rounding")
    loaded = round_trip("save / assemble", inv.save, svt.Inverted.assemble,
                        path="inverted")
    got = loaded.search(queries, 10)
    if not (np.array_equal(got.ids, res.ids)
            and np.array_equal(got.distances, res.distances)):
        raise AssertionError("inverted: the assembled index searches "
                             "otherwise")
    log(f"inverted: the assembled copy searches identically; beam_step "
        f"launches {beam_step.launches}")
    return {"beam_step": beam_step.launches}


# ---------------------------------------------------------------------------
# Tools and interop: the benchmark runner and its CLI, the reference-layout
# interop, the checkpoint upgrader and the native vecs loader
# ---------------------------------------------------------------------------

# keys of the JAX runner's ivf_search result (scalablevectorsearch_tpu/
# benchmark/runner.py:221-248), which the port's CLI output must have
IVF_SEARCH_KEYS = {"build_time_s", "configs", "executable", "wall_time_s"}
IVF_CONFIG_KEYS = {"n_probes", "recall", "qps", "mean_latency_us", "latency"}
LATENCY_KEYS = {"p50_us", "p95_us", "p99_us", "batch_queries", "n_samples"}
# the smaller Vamana jobs: full width, 20,000 rows (depth cut for the run's
# time); the dynamic job's serving window
TOOLS_ROWS, TOOLS_QUERIES, TOOLS_WINDOW = 20_000, 1000, 100
LEGACY_FIXTURES = (("lvq8_v001", 8, 0), ("lvq4x8_v001", 4, 8),
                   ("vamana_params_v001", None, None))


def tools_runner_main_index(main_path: dict, tmp: str) -> None:
    """The runner's vamana_search over the saved main index: the main
    path's data (the synthetic spec regenerates it), packed serving, the
    sampler config the index was saved with, windows from the main path's
    up; at the main path's window the recall must be the main path's to
    the digit."""
    from scalablevectorsearch_tpu_torch.benchmark import run_job
    from scalablevectorsearch_tpu_torch.ops.kernels.beam_step import (
        beam_step)
    index_dir = os.path.join(tmp, "main_index")
    main_path["index"].save(index_dir)
    with open(os.path.join(index_dir, "vamana_config.json")) as f:
        saved_sampler = json.load(f).get("entry_sampler")
    window = main_path["window"]
    job = {"executable": "vamana_search",
           "synthetic": {"n": 100_000, "n_queries": 5000, "dim": 128,
                         "seed": 42},
           "index_dir": index_dir, "packed_serving": True,
           "search_window_sizes": [w for w in WINDOWS if w >= window][:3]}
    if not saved_sampler:
        job["entry_sampler"] = True
    before = beam_step.launches
    res = run_job(job, main_path["index"].index.data.device)
    launches = beam_step.launches - before
    for c in res["configs"]:
        log(f"tools: runner vamana_search over the saved main index: window "
            f"{c['search_window_size']} recall@10 {c['recall']} "
            f"{c['qps']} QPS (host clock), p50 {c['latency']['p50_us']} us "
            f"p99 {c['latency']['p99_us']} us over "
            f"{c['latency']['n_samples']} batches of "
            f"{c['latency']['batch_queries']}")
    want = round(main_path["recall"], 5)
    got = res["configs"][0]["recall"]
    log(f"tools: runner at the main path's window {window}: recall {got}, "
        f"the main path's {want}; sampler saved {saved_sampler}; beam_step "
        f"launches {launches}; {res['wall_time_s']} s")
    if got != want or launches == 0:
        raise AssertionError(f"runner over the main index: recall {got} vs "
                             f"the main path's {want}, {launches} launches")


def ivf_cli_job(name: str, tmp: str) -> dict:
    """data/jobs/<name>.json, unchanged, through the port's CLI in a child
    process on the card: the JAX runner's keys, recall@10 >= 0.9 at some
    n_probes.  The child logs the IVF layout (SVS_LOG_LEVEL=info): the
    probe units exceed K where the auto skew cap chunked large clusters.
    Device memory in use on the card is sampled every 0.2 s while the
    child runs; its peak less what was in use before is the child's.
    Returns the result, the layout's log line and the peaks."""
    import resource
    import threading
    job_file = os.path.join(HERE, "data", "jobs", f"{name}.json")
    with open(job_file) as f:
        spec = json.load(f)
    n, dim = spec["synthetic"]["n"], spec["synthetic"]["dim"]
    rows = n * dim * 4
    # the layout holds max(4 n, 5M) rows at most before the auto cap
    # (2x the mean posting) applies: index/ivf/index.py::_pack_layout_host
    bound = max(4 * n, 5_000_000) * 128 * 4
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    log(f"{name}: {n} x {dim} f32 rows {rows} bytes; the padded layout at "
        f"most {bound} bytes; {free} of {total} bytes free on the card")
    out = os.path.join(tmp, f"{name}_result.json")
    lowest, done = [free], threading.Event()

    def sample():
        while not done.wait(0.2):
            lowest[0] = min(lowest[0], torch.cuda.mem_get_info()[0])

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "scalablevectorsearch_tpu_torch.benchmark",
             job_file, "-o", out], cwd=HERE, capture_output=True, text=True,
            timeout=900, check=False,
            env={**os.environ, "SVS_LOG_LEVEL": "info"})
    finally:
        done.set()
        sampler.join()
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"{name} CLI rc {proc.returncode}:\n"
                             f"{proc.stderr[-4000:]}")
    with open(out) as f:
        (res,) = json.load(f)
    layout = [line.split("] ")[-1] for line in proc.stderr.splitlines()
              if "ivf assemble:" in line]
    bad_keys = set(res) ^ IVF_SEARCH_KEYS
    for c in res["configs"]:
        bad_keys |= (set(c) ^ IVF_CONFIG_KEYS) | (set(c["latency"])
                                                  ^ LATENCY_KEYS)
        log(f"{name} n_probes {c['n_probes']}: recall@10 {c['recall']}, "
            f"{c['qps']} QPS (host clock), p50 {c['latency']['p50_us']} us "
            f"p99 {c['latency']['p99_us']} us "
            f"({c['latency']['n_samples']} batches of "
            f"{c['latency']['batch_queries']})")
    best = max(c["recall"] for c in res["configs"])
    peak = free - lowest[0]
    host = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss * 1024
    log(f"{name} through the CLI: build {res['build_time_s']} s, job "
        f"{res['wall_time_s']} s, process {wall:.1f} s; best recall@10 "
        f"{best}; {layout}; peak device memory of the child {peak} bytes "
        f"(sampled), peak host memory of a child {host} bytes "
        f"({card_line()})")
    if bad_keys:
        raise AssertionError(f"{name} output keys differ from the JAX "
                             f"runner's: {sorted(bad_keys)}")
    if best < 0.9:
        raise AssertionError(f"{name}: no n_probes reached recall@10 0.9")
    return {"result": res, "layout": layout, "peak_device_bytes": peak,
            "peak_host_bytes": host, "process_s": wall}


def tools_small_jobs(device) -> None:
    """vamana_dynamic, vamana_iterator and inverted_search in-process at
    TOOLS_ROWS x 128 with the main path's build parameters."""
    from scalablevectorsearch_tpu_torch.benchmark import run_job
    bp = dataclasses.asdict(main_path_params())
    spec = {"synthetic": {"n": TOOLS_ROWS, "n_queries": TOOLS_QUERIES,
                          "dim": 128, "seed": 42}}
    dyn = run_job({"executable": "vamana_dynamic", **spec,
                   "build_parameters": bp, "num_cycles": 2,
                   "cycle_fraction": 0.1,
                   "search_window_size": TOOLS_WINDOW}, device)
    for c in dyn["cycles"]:
        log(f"tools: vamana_dynamic cycle {c['cycle']}: delete "
            f"{c['delete_s']} s, add {c['add_s']} s, consolidate "
            f"{c['consolidate_s']} s, compact {c['compact_s']} s, size "
            f"{c['size']}, recall@10 {c['recall']} at window {TOOLS_WINDOW}")
    log(f"tools: vamana_dynamic build {dyn['build_time_s']} s, "
        f"{dyn['qps']} QPS (host clock), job {dyn['wall_time_s']} s")
    if min(c["recall"] for c in dyn["cycles"]) < 0.9:
        raise AssertionError("vamana_dynamic: recall@10 < 0.9 after a cycle")
    it = run_job({"executable": "vamana_iterator", **spec,
                  "build_parameters": bp, "num_neighbors": 10,
                  "num_batches": 5, "max_iterator_queries": 32}, device)
    log(f"tools: vamana_iterator {it['queries']} queries x "
        f"{it['batches_per_query']} pages of {it['batch_size']}: recall "
        f"{it['recall']}, {it['batches_per_s']} pages/s (host clock), job "
        f"{it['wall_time_s']} s")
    if it["recall"] < 0.95:
        raise AssertionError(f"vamana_iterator recall {it['recall']} < 0.95")
    inv = run_job({"executable": "inverted_search", **spec,
                   "max_probes": 32, "refinement_epsilons": [0.25, 1.0, 2.0]},
                  device)
    log(f"tools: inverted_search {inv['num_centroids']} centroids, build "
        f"{inv['build_time_s']} s; max_probes 32, recall@10 by epsilon "
        + " ".join(f"{c['refinement_epsilon']}:{c['recall']}"
                   for c in inv["configs"]))
    if max(c["recall"] for c in inv["configs"]) < 0.9:
        raise AssertionError("inverted_search: no epsilon reached 0.9")


def tools_golden_generators(tmp: str, device) -> dict:
    """The three golden generators at the settings of their reference
    files, one job per reference row as the JAX package's tests run them,
    each writing to a temporary file; returns path -> (row -> recalls) for
    :func:`phase_golden` to gate."""
    from scalablevectorsearch_tpu_torch.benchmark import run_job
    generated = {}
    for path, executable in ((GOLDEN, "vamana_test_generator"),
                             (GOLDEN_IVF, "ivf_test_generator"),
                             (GOLDEN_INVERTED, "inverted_test_generator")):
        with open(path) as f:
            golden = json.load(f)
        rows = {}
        for entry in golden["expected"]:
            job = {"executable": executable, "synthetic": golden["dataset"],
                   "num_neighbors": golden["num_neighbors"],
                   "distances": [entry["distance"]],
                   "output_file": os.path.join(tmp, "golden.json")}
            if executable == "vamana_test_generator":
                job["build_parameters"] = {
                    key: val for key, val in entry["build_parameters"].items()
                    if key in ("alpha", "graph_max_degree", "window_size",
                               "max_candidate_pool_size", "prune_to")}
                job["search_window_sizes"] = [int(w) for w in
                                              entry["recalls"]]
            elif executable == "ivf_test_generator":
                bp = entry["build_parameters"]
                job["build_parameters"] = {
                    "num_centroids": bp["num_centroids"],
                    "is_hierarchical": bp["is_hierarchical"],
                    "num_iterations": 10}
                job["n_probes"] = [int(p) for p in entry["recalls"]]
            else:
                job["max_probes"] = golden["max_probes"]
                job["refinement_epsilons"] = [float(e) for e in
                                              entry["recalls"]]
            res = run_job(job, device)
            with open(job["output_file"]) as f:
                written = json.load(f)
            if written["expected"] != res["expected"]:
                raise AssertionError(f"{executable}: the written file "
                                     f"differs from the result")
            (row,) = res["expected"]
            rows[entry["distance"]] = row["recalls"]
            log(f"tools: {executable} {entry['distance']} "
                f"{res['wall_time_s']} s: " + " ".join(
                    f"{key}:{val}" for key, val in row["recalls"].items()))
        generated[path] = rows
    return generated


def tools_interop(main_path: dict, tmp: str) -> None:
    """The main index written in the reference layout and loaded onto the
    card: each config's UUID is its blob's, adjacency, rows and entry
    point identical; served as the main path serves it (its sampler
    config, packed rows, its window): identical ids and distances."""
    import tomllib
    import warnings
    from scalablevectorsearch_tpu_torch.core import io as tio
    from scalablevectorsearch_tpu_torch.ops.kernels.beam_step import (
        beam_step)
    from scalablevectorsearch_tpu_torch.utils import svs_interop
    live = main_path["index"].index
    dirs = [os.path.join(tmp, "reference", name)
            for name in ("config", "graph", "data")]
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        svs_interop.save_reference_vamana(live, *dirs)
    save_s = time.perf_counter() - t0
    if not any("entry sampler" in str(w.message) for w in caught):
        raise AssertionError("interop: no warning for the sampler export")
    for directory, blob in zip(dirs[1:], ("graph.svs", "data.svs")):
        with open(os.path.join(directory, "svs_config.toml"), "rb") as f:
            uuid = tomllib.load(f)["object"]["uuid"]
        if tio.read_svs_uuid(os.path.join(directory, blob)) != uuid:
            raise AssertionError(f"interop: {blob} header UUID is not its "
                                 f"config's")
    t0 = time.perf_counter()
    loaded = svs_interop.load_reference_vamana(*dirs, "l2",
                                               device=live.data.device)
    sync()
    load_s = time.perf_counter() - t0
    if not (np.array_equal(loaded.graph.to_numpy(), live.graph.to_numpy())
            and np.array_equal(loaded.data.to_numpy(), live.data.to_numpy())
            and loaded.entry_point == live.entry_point
            and loaded.data.vectors.device == live.data.vectors.device):
        raise AssertionError("interop: adjacency, rows, entry point or "
                             "device differ")
    loaded.enable_entry_sampler(**live._entry_cfg)
    loaded.enable_packed_serving()
    loaded.search_window_size = live.search_window_size
    log(f"tools: interop: the reference layout written in {save_s:.2f} s "
        f"({tree_bytes(os.path.join(tmp, 'reference'))} bytes), loaded onto "
        f"{loaded.data.vectors.device} in {load_s:.2f} s; UUIDs match their "
        f"blobs; adjacency, rows and entry point identical")
    same_search("reference-layout round trip", main_path["index"], loaded,
                main_path["queries"], (beam_step,), path="tools")


def tools_upgrader(tmp: str, device) -> None:
    """Copies of the data/legacy checkpoints upgraded and assembled onto
    the card: every component current, the LVQ copies decoding within
    1e-5 of a fresh compress of the fixture data."""
    import shutil
    import scalablevectorsearch_tpu_torch as svt
    from scalablevectorsearch_tpu_torch.utils import upgrader
    fixture = np.random.default_rng(7).normal(size=(48, 20)).astype(
        np.float32)
    for name, bits, res in LEGACY_FIXTURES:
        ck = os.path.join(tmp, "legacy", name)
        shutil.copytree(os.path.join(HERE, "data", "legacy", name), ck)
        actions = upgrader.upgrade(ck, backup=False)
        report = upgrader.inspect(ck)
        if not actions or any(e["status"] != "up-to-date" for e in report):
            raise AssertionError(f"upgrader {name}: {actions} {report}")
        if bits is None:
            with open(os.path.join(ck, "svs_config.json")) as f:
                table = json.load(f)
            svt.VamanaBuildParameters.from_table(table["build_parameters"])
            detail = f"entry_sampler {table['entry_sampler']}"
        else:
            got = svt.dispatch_load(ck, device=device)
            err = float(np.max(np.abs(got.to_numpy() - svt.LVQDataset.compress(
                fixture, bits=bits, residual_bits=res,
                device=device).to_numpy())))
            if got.codes.device != device or err > 1e-5:
                raise AssertionError(f"upgraded {name}: {err}")
            detail = (f"{got.kind} on {got.codes.device}, decode max abs "
                      f"err {err:.3g} against a fresh compress")
        log(f"tools: upgrader {name}: " + ", ".join(
            f"{a['file']} -> {a['to']}" for a in actions)
            + f"; inspect all up-to-date; {detail}")


def tools_native(tmp: str) -> None:
    """The 1M x 128 job data written as .fvecs and read back by the native
    loader and by NumPy: identical; both rates."""
    import scalablevectorsearch_tpu_torch as svt
    from scalablevectorsearch_tpu_torch.core import io as tio
    from scalablevectorsearch_tpu_torch.lib import native
    t0 = time.perf_counter()
    ok = native.available()
    build_s = time.perf_counter() - t0
    if not ok:
        raise AssertionError("native vecs loader did not build")
    with open(os.path.join(HERE, "data", "jobs", "ivf_1m.json")) as f:
        spec = json.load(f)["synthetic"]
    data, _queries = svt.generate_test_dataset(
        spec["n"], spec["n_queries"], spec["dim"], seed=spec["seed"])
    path = os.path.join(tmp, "ivf_1m.fvecs")
    tio.write_vecs(path, data)
    size = os.path.getsize(path)
    rates = {}
    for label, read in (("native", lambda: tio.read_vecs(path)),
                        ("numpy", lambda: tio._read_vecs_numpy(
                            path, np.dtype(np.float32)))):
        t0 = time.perf_counter()
        got = read()
        rates[label] = size / (time.perf_counter() - t0) / 1e9
        if not np.array_equal(got, data):
            raise AssertionError(f"{label} read differs from the data")
        del got
    os.remove(path)
    log(f"tools: native loader ({native.library_path().name}, ready in "
        f"{build_s:.1f} s): {size} bytes of .fvecs read identically, native "
        f"{rates['native']:.2f} GB/s, numpy {rates['numpy']:.2f} GB/s "
        f"(host, file in the page cache; {card_line()})")


def phase_tools(main_path: dict) -> dict:
    """The runner over the saved main index, the smaller Vamana jobs, the
    golden generators, the reference-layout round trip, the upgrader and
    the native loader.
    Every count starts at 0 here.  Returns the phase's launches and the
    generated golden rows."""
    from scalablevectorsearch_tpu_torch.index.vamana import search as smod
    from scalablevectorsearch_tpu_torch.index.vamana.params import (
        VamanaSearchParameters)
    # the main path's serving state, which calibration changed
    live = main_path["index"].index
    live.search_parameters = VamanaSearchParameters().with_window(
        main_path["window"])
    live.pop_width, live.tail_frac = smod.SERVING_POP_WIDTH, 4
    live.query_upload_dtype = None
    if live._packed is None:
        live.enable_packed_serving()
    zero_counts()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tools_runner_main_index(main_path, tmp)
        tools_interop(main_path, tmp)
        tools_upgrader(tmp, live.data.device)
        tools_native(tmp)
        tools_small_jobs(live.data.device)
        generated = tools_golden_generators(tmp, live.data.device)
    launches = {name: n for name, n in read_counts().items() if n}
    log(f"tools: {time.perf_counter() - t0:.1f} s; launches {launches}")
    if not launches.get("beam_step"):
        raise AssertionError("tools: beam_step not launched")
    return {"launches": launches, "golden": generated}


# parallel phase: logical shards of one card (k x cuda:0).  The 20,000-row
# build and dynamic index are a depth cut of the main path's 100k rows (as
# the tools phase's 20k jobs are); the sharded flat search streams 1M rows.
PAR_FLAT_ROWS, PAR_FLAT_QUERIES = 1_000_000, 1000
PAR_ROWS, PAR_QUERIES, PAR_DYN_BATCH = 20_000, 1000, 1000


@contextlib.contextmanager
def scored_shapes():
    """Inside the block, record every distinct call ``greedy_search`` makes
    of beam_update ((B, C, K, window, m)), score_rows ((B, K, d)) and
    gather_score_l2_partial ((N, d, table type, B, K)); yields the three
    sets.  The calls themselves are unchanged."""
    from scalablevectorsearch_tpu_torch.index.vamana import search as smod
    seen = {"beam_update": set(), "score_rows": set(),
            "gather_score_l2_partial": set()}
    update, rows_fn, gather = (smod.beam_update, smod.score_rows,
                               smod.gather_score_l2_partial)

    def rec_update(beam_keys, beam_packed, cand_keys, cand_ids, *, window, m):
        seen["beam_update"].add((*beam_keys.shape, cand_keys.shape[1],
                                 window, m))
        return update(beam_keys, beam_packed, cand_keys, cand_ids,
                      window=window, m=m)

    def rec_rows(rows, queries):
        seen["score_rows"].add(tuple(rows.shape))
        return rows_fn(rows, queries)

    def rec_gather(table, ids, queries):
        seen["gather_score_l2_partial"].add(
            (*table.shape, table.dtype, *ids.shape))
        return gather(table, ids, queries)

    smod.beam_update, smod.score_rows, smod.gather_score_l2_partial = (
        rec_update, rec_rows, rec_gather)
    try:
        yield seen
    finally:
        smod.beam_update, smod.score_rows, smod.gather_score_l2_partial = (
            update, rows_fn, gather)


def check_scored_shapes(path: str, seen: dict,
                        expect=("beam_update", "score_rows",
                                "gather_score_l2_partial")) -> None:
    """beam_update, score_rows and gather_score_l2_partial against their
    plain versions at every call ``path`` made (:func:`scored_shapes`),
    each kernel of ``expect`` called at least once:
    beam_update on tied (grid) and real keys, identical outputs; the
    scoring kernels on exact (grid) inputs identical, on real inputs within
    rtol 1e-5 (atol 1e-5 of the values' scale).  Run after the path has
    read its launch counts."""
    from scalablevectorsearch_tpu_torch.ops.kernels import beam_update as bu
    from scalablevectorsearch_tpu_torch.ops.kernels import (
        gather_distance as gd)
    rng = np.random.default_rng(4)
    gen = torch.Generator(device="cuda").manual_seed(4)
    failures, max_err = [], 0.0
    t0 = time.perf_counter()

    def values(shape, d, grid):
        x = torch.randn(shape, device="cuda", generator=gen)
        if grid:
            kmax = min(127, int(np.sqrt(2.0 ** 22 / d)))
            x = torch.round(x * 32).clamp(-kmax, kmax) / 32
        return x

    def close(label, got, want, grid):
        nonlocal max_err
        if grid and not torch.equal(got, want):
            failures.append(f"{label} grid differs")
        err = float((got - want).abs().max())
        max_err = max(max_err, 0.0 if grid else err)
        if not torch.allclose(got, want, rtol=1e-5,
                              atol=1e-5 * float(want.abs().max())):
            failures.append(f"{label} grid={grid}: {err:.3g}")

    for b, c, k, window, m in sorted(seen["beam_update"]):
        for grid in (True, False):
            args = make_update_case(rng, (b, c, k, 4, window, m), grid)
            got = bu.beam_update(*args, window=window, m=m)
            want = bu.beam_update_plain(*args, window=window, m=m)
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                failures.append(f"beam_update {(b, c, k, window, m)} "
                                f"grid={grid} differs")
    for b, k, d in sorted(seen["score_rows"]):
        for grid in (True, False):
            rows, q = values((b, k, d), d, grid), values((b, d), d, grid)
            for name, g, w in zip(("dots", "x2"), gd.score_rows(rows, q),
                                  gd.score_rows_plain(rows, q)):
                close(f"score_rows {(b, k, d)} {name}", g, w, grid)
    for n, d, dtype, b, k in sorted(seen["gather_score_l2_partial"],
                                    key=str):
        for grid in (True, False):
            table = values((n, d), d, grid).to(dtype)
            q = values((b, d), d, grid)
            ids = torch.randint(0, n, (b, k), device="cuda",
                                dtype=torch.int32, generator=gen)
            close(f"gather_score_l2_partial {(n, d, dtype, b, k)}",
                  gd.gather_score_l2_partial(table, ids, q),
                  gd.gather_score_l2_partial_plain(table, ids, q), grid)
    counts = {name: len(s) for name, s in seen.items()}
    if not all(counts[name] for name in expect) or failures:
        raise AssertionError(f"{path}: scored kernels vs plain at the path's "
                             f"shapes {counts}: {'; '.join(failures)}")
    log(f"{path}: beam_update, score_rows and gather_score_l2_partial match "
        f"their plain versions at the path's calls {counts} (B "
        f"{sorted({s[0] for s in seen['score_rows']})}); real inputs "
        f"max_abs_err {max_err:.3g}; {time.perf_counter() - t0:.1f} s")


def search_result(out, k: int = 10):
    """A greedy search's first k ids as a result for the tie checks."""
    return types.SimpleNamespace(ids=out.ids[:, :k].cpu().numpy())


def same_or_ties(label: str, got, want, queries, rows_of) -> str:
    """Two greedy searches' outputs: ids identical, or the rows whose first
    10 ids differ proven near-ties on the host (:func:`ties_only`); keys
    identical or their largest relative difference."""
    if torch.equal(got.ids, want.ids):
        ids = "ids identical"
    else:
        rows = ties_only(search_result(got), search_result(want), queries,
                         rows_of, label)
        ids = f"ids equal but {rows} rows of proven near-ties"
    if torch.equal(got.keys, want.keys):
        return ids + ", keys identical"
    fin = torch.isfinite(want.keys) & (got.ids == want.ids)
    rel = ((got.keys - want.keys).abs() / want.keys.abs().clamp_min(1e-30))
    return ids + f", keys of equal ids within {float(rel[fin].max()):.3g} " \
        "relative"


def parallel_flat(mesh, card: str) -> None:
    """1M x 128 rows streamed into 8 shards from .fvecs, held to the
    host-staged layout; 1000 queries' sharded top-10 held to the port's
    single-device flat search."""
    import scalablevectorsearch_tpu_torch as svt
    from scalablevectorsearch_tpu_torch.core import io as tio
    from scalablevectorsearch_tpu_torch.parallel import sharded
    data, queries = svt.generate_test_dataset(
        PAR_FLAT_ROWS, PAR_FLAT_QUERIES, 128, seed=42)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "flat.fvecs")
        tio.write_vecs(path, data)
        t0 = time.perf_counter()
        streamed = sharded.shard_dataset_from_file(path, mesh)
        sync()
        load_s = time.perf_counter() - t0
    staged = sharded.shard_dataset(svt.VectorDataset.from_array(data), mesh)
    if (streamed.n, streamed.capacity) != (staged.n, staged.capacity) or \
            not all(torch.equal(a.vectors, b.vectors)
                    and torch.equal(a.norms_sq, b.norms_sq)
                    for a, b in zip(streamed.shards, staged.shards)):
        raise AssertionError("parallel: streamed 1M rows differ from the "
                             "host-staged layout")
    del staged
    q = torch.from_numpy(queries).cuda()
    t0 = time.perf_counter()
    _keys, ids = sharded.sharded_flat_search(mesh, streamed, q, 10, "l2")
    sync()
    flat_s = time.perf_counter() - t0
    want = svt.exhaustive_search(data, queries, 10)
    got = types.SimpleNamespace(ids=ids.cpu().numpy())
    ties = misses_are_ties(got, want.ids, queries, lambda i: data[i],
                           "parallel flat")
    del streamed
    log(f"parallel: flat {PAR_FLAT_ROWS}x128 streamed into 8 shards in "
        f"{load_s:.2f} s (identical to the host-staged layout); "
        f"{PAR_FLAT_QUERIES} queries top-10 in {flat_s:.3f} s, ids equal "
        f"to the single-device flat search but {ties} ties of the 10th "
        f"distance ({card})")


def parallel_ivf(main_path: dict, mesh, card: str) -> None:
    """The main data's IVF index at phase_ivf's settings, its probe units
    over 8 shards, n_probes 3: the single-device search's ids (f32
    uploads) up to proven near-ties; recall@10."""
    import scalablevectorsearch_tpu_torch as svt
    from scalablevectorsearch_tpu_torch.parallel import sharded
    data, queries, gt = (main_path[key] for key in ("data", "queries", "gt"))
    t0 = time.perf_counter()
    index = svt.IVF.build(ivf_params(data.shape[0]), data, "l2").index
    sync()
    build_s = time.perf_counter() - t0
    index.query_upload_dtype = "float32"
    want = index.search(queries, 10, svt.IVFSearchParameters(n_probes=3))
    t0 = time.perf_counter()
    _keys, ids = sharded.sharded_ivf_search(
        mesh, index, torch.from_numpy(queries).cuda(), 10, n_probes=3)
    sync()
    search_s = time.perf_counter() - t0
    got = types.SimpleNamespace(ids=ids.cpu().numpy())
    rows = ties_only(got, want, queries, lambda i: data[i], "parallel ivf")
    log(f"parallel: ivf {index.num_probe_units} probe units over 8 shards "
        f"(built in {build_s:.1f} s), n_probes 3: {len(queries)} queries in "
        f"{search_s:.3f} s, recall@10 {svt.k_recall_at_n(gt, got):.4f} "
        f"(single device {svt.k_recall_at_n(gt, want):.4f}); ids equal but "
        f"{rows} rows of proven near-ties ({card})")


def parallel_searches(main_path: dict, meshes: dict, dp_mesh, card: str
                      ) -> None:
    """dp_greedy_search at 8 chunks over f32 rows (beam_step) and LVQ-8
    (beam_step_lvq) against one greedy_search; sharded_greedy_search over
    f32, float16, LVQ-8 and SQ-int8 views at 1, 2 and 8 shards (equal bit
    for bit), against the single-device search (float16, SQ: bit for bit;
    f32, LVQ-8: up to proven near-ties) and its recall (within 0.005)."""
    import scalablevectorsearch_tpu_torch as svt
    from scalablevectorsearch_tpu_torch.index.vamana import search as smod
    from scalablevectorsearch_tpu_torch.parallel import sharded
    ix = main_path["index"].index
    data, queries, gt = (main_path[key] for key in ("data", "queries", "gt"))
    window = main_path["window"]
    q = torch.from_numpy(queries).cuda()
    entries = ix._entry_sampler.select(ix.distance, q)
    kw = dict(window=window, capacity=max(window, 10),
              max_iters=smod.default_max_iters(window), distance=ix.distance)
    lvq = svt.LVQDataset.compress(data, bits=8)
    kinds = {"f32": ix.data, "lvq8": lvq,
             "float16": svt.VectorDataset.from_array(data,
                                                     dtype=torch.float16),
             "sq8": svt.SQDataset.compress(data)}

    def rows_of(ds):
        if ds is lvq:
            return lambda i: lvq.get(torch.as_tensor(i).cuda())[:, :128] \
                .cpu().numpy()
        return lambda i: data[i]

    for kind in ("f32", "lvq8"):
        ds = kinds[kind]
        want = smod.greedy_search(ix.graph, ds, q, entries, **kw)
        t0 = time.perf_counter()
        got = sharded.dp_greedy_search(dp_mesh, ix.graph, ds, q, entries,
                                       **kw)
        sync()
        dp_s = time.perf_counter() - t0
        verdict = same_or_ties(f"parallel dp {kind}", got, want, queries,
                               rows_of(ds))
        log(f"parallel: dp_greedy_search {kind} {len(queries)} queries in 8 "
            f"chunks at window {window}: {dp_s:.3f} s; ids and keys against "
            f"one greedy_search: {verdict} ({card})")
    for kind, ds in kinds.items():
        want = smod.greedy_search(ix.graph, ds, q, entries, **kw)
        outs, secs = {}, {}
        for s, mesh in meshes.items():
            graph = sharded.shard_graph(ix.graph, mesh)
            view = sharded.shard_any_dataset(ds, mesh)
            t0 = time.perf_counter()
            outs[s] = sharded.sharded_greedy_search(mesh, graph, view, q,
                                                    entries, **kw)
            sync()
            secs[s] = round(time.perf_counter() - t0, 3)
            del graph, view
        for s in (2, 8):
            if not (torch.equal(outs[s].ids, outs[1].ids)
                    and torch.equal(outs[s].keys, outs[1].keys)):
                raise AssertionError(f"parallel: sharded {kind} at {s} "
                                     "shards differs from 1 shard")
        if kind in ("float16", "sq8"):
            if not (torch.equal(outs[8].ids, want.ids)
                    and torch.equal(outs[8].keys, want.keys)):
                raise AssertionError(f"parallel: sharded {kind} differs from "
                                     "the single-device search")
            verdict = "identical"
        else:
            verdict = same_or_ties(f"parallel sharded {kind}", outs[8], want,
                                   queries, rows_of(ds))
        r_sh = svt.k_recall_at_n(gt, search_result(outs[8]))
        r_one = svt.k_recall_at_n(gt, search_result(want))
        log(f"parallel: sharded_greedy_search {kind} at window {window}, "
            f"seconds by shard count {secs}: 8 = 2 = 1 shard bit for bit; "
            f"against one device {verdict}; recall@10 {r_sh:.4f} (one "
            f"device {r_one:.4f}) ({card})")
        if abs(r_sh - r_one) > 0.005:
            raise AssertionError(f"parallel: sharded {kind} recall {r_sh} vs "
                                 f"{r_one}")
        del outs, want


def parallel_build(main_path: dict, meshes: dict, card: str) -> None:
    """sharded_build_graph over the main data's first PAR_ROWS rows with the
    main path's parameters and sampled entries: 2 shards from the host
    rows, 8 streamed from .fvecs, identical graphs; recall@10 and mean
    degree within 0.01 of the single-device build's."""
    import scalablevectorsearch_tpu_torch as svt
    from scalablevectorsearch_tpu_torch.core import io as tio
    from scalablevectorsearch_tpu_torch.index.vamana import build as bmod
    from scalablevectorsearch_tpu_torch.index.vamana import search as smod
    from scalablevectorsearch_tpu_torch.parallel import sharded
    rows = main_path["data"][:PAR_ROWS]
    queries = main_path["queries"][:PAR_QUERIES]
    params = main_path_params()
    ds = svt.VectorDataset.from_array(rows)
    graphs, secs = {}, {}
    t0 = time.perf_counter()
    graphs["one device"] = bmod.build_graph(ds, params, "l2",
                                            sampled_entries=True)
    sync()
    secs["one device"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    graphs["2 shards"] = sharded.sharded_build_graph(
        meshes[2], rows, params, "l2", sampled_entries=True)
    sync()
    secs["2 shards"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "rows.fvecs")
        tio.write_vecs(path, rows)
        t0 = time.perf_counter()
        graphs["8 shards streamed"] = sharded.sharded_build_graph(
            meshes[8], path, params, "l2", sampled_entries=True)
        sync()
        secs["8 shards streamed"] = time.perf_counter() - t0
    (g2, e2), (g8, e8) = graphs["2 shards"], graphs["8 shards streamed"]
    if e2 != e8 or not torch.equal(g2.adjacency, g8.adjacency) \
            or not torch.equal(g2.degrees, g8.degrees):
        raise AssertionError("parallel: the 2-shard and the streamed "
                             "8-shard builds differ")
    gt = svt.exhaustive_search(rows, queries, 10)
    q = torch.from_numpy(queries).cuda()
    window = main_path["window"]
    stats = {}
    for label, (g, e) in graphs.items():
        out = smod.greedy_search(
            g, ds, q, torch.tensor([e], dtype=torch.int32, device="cuda"),
            window=window, capacity=max(window, 10),
            max_iters=smod.default_max_iters(window), distance="l2")
        stats[label] = (svt.k_recall_at_n(gt, search_result(out)),
                        g.mean_degree())
    log(f"parallel: sharded_build_graph {PAR_ROWS}x128 (main parameters, "
        f"sampled entries), seconds "
        + ", ".join(f"{k} {v:.1f}" for k, v in secs.items())
        + "; the 2-shard and streamed 8-shard graphs identical; (recall@10 "
        f"at window {window}, mean degree) "
        + ", ".join(f"{k} ({r:.4f}, {d:.3f})" for k, (r, d) in stats.items())
        + f" ({card})")
    r1, d1 = stats["one device"]
    if abs(stats["2 shards"][0] - r1) > 0.01 or \
            abs(stats["2 shards"][1] - d1) > 0.01:
        raise AssertionError(f"parallel: sharded build {stats}")


def parallel_dynamic(main_path: dict, mesh, card: str) -> None:
    """ShardedMutableVamanaIndex.from_single_chip of a PAR_ROWS-row
    MutableVamanaIndex at 8 shards, one cycle of adds, deletes,
    consolidate and compact mirrored on the single-device index: after
    every step the searches' ids equal up to proven near-ties (f32
    uploads) and recall@10 >= 0.9 at the job's window; after compact the
    same external entry point; to_single_chip round trips identically."""
    import scalablevectorsearch_tpu_torch as svt
    from scalablevectorsearch_tpu_torch.parallel.dynamic import (
        ShardedMutableVamanaIndex)
    total = PAR_ROWS + PAR_DYN_BATCH
    rows = main_path["data"][:total]
    queries = main_path["queries"][:PAR_QUERIES]
    rng = np.random.default_rng(5)
    t0 = time.perf_counter()
    sc = svt.MutableVamanaIndex(main_path_params(), rows[:PAR_ROWS],
                                np.arange(PAR_ROWS), "l2")
    sync()
    build_s = time.perf_counter() - t0
    sh = ShardedMutableVamanaIndex.from_single_chip(sc, mesh)
    for index in (sc, sh):
        index.search_window_size = TOOLS_WINDOW
        index.query_upload_dtype = "float32"
    secs = {"build (one device)": build_s}

    def check(step):
        live = sc.all_ids()
        gt = svt.exhaustive_search(rows[live], queries, 10)
        want, got = sc.search(queries, 10), sh.search(queries, 10)
        ties = ties_only(got, want, queries, lambda i: rows[i],
                         f"parallel dynamic {step}")
        recall = svt.k_recall_at_n(live[gt.ids], got.ids)
        log(f"parallel: dynamic {step}: size {sh.size}, recall@10 "
            f"{recall:.4f} at window {TOOLS_WINDOW}, ids equal to the "
            f"single-device index's but {ties} rows of proven near-ties")
        if recall < 0.9:
            raise AssertionError(f"parallel dynamic {step}: recall {recall}")

    def both(step, fn):
        for label, index in (("one device", sc), ("8 shards", sh)):
            t0 = time.perf_counter()
            fn(index)
            sync()
            secs[f"{step} ({label})"] = time.perf_counter() - t0
        check(step)

    check("from_single_chip")
    both("add", lambda ix: ix.add_points(rows[PAR_ROWS:],
                                         np.arange(PAR_ROWS, total)))
    doomed = rng.choice(total, size=PAR_DYN_BATCH, replace=False)
    both("delete", lambda ix: ix.delete_points(doomed))
    both("consolidate", lambda ix: ix.consolidate())
    both("compact", lambda ix: ix.compact())
    entry = (int(sc.translator.to_external([sc.entry_point])[0]),
             int(sh.translator.to_external([sh.entry_point])[0]))
    if entry[0] != entry[1]:
        raise AssertionError(f"parallel dynamic: entry points {entry}")
    back = ShardedMutableVamanaIndex.from_single_chip(sh.to_single_chip(),
                                                      mesh)
    if not (np.array_equal(back.status, sh.status)
            and back.entry_point == sh.entry_point
            and np.array_equal(back.all_ids(), sh.all_ids())
            and torch.equal(back.graph.gather().adjacency,
                            sh.graph.gather().adjacency)
            and torch.equal(back.data.gather().vectors,
                            sh.data.gather().vectors)):
        raise AssertionError("parallel dynamic: to_single_chip round trip "
                             "differs")
    log(f"parallel: dynamic {PAR_ROWS}x128 at 8 shards, seconds "
        + ", ".join(f"{k} {v:.2f}" for k, v in secs.items())
        + f"; entry point after compact external id {entry[0]} on both; "
        f"to_single_chip round trip identical ({card})")


def phase_parallel(main_path: dict) -> dict:
    """The multi-device package over logical shards of the card (k x
    cuda:0): the sharded flat and IVF searches, dp_greedy_search,
    sharded_greedy_search over four row types, sharded_build_graph and the
    sharded dynamic index.  Every count starts at 0 here; then every
    kernel is held to its plain version at each call the phase made.
    Returns the phase's launches."""
    from scalablevectorsearch_tpu_torch.parallel import mesh as mesh_mod
    card = card_line()
    meshes = {s: mesh_mod.make_mesh(s, "shard", devices=["cuda:0"] * s)
              for s in (1, 2, 8)}
    dp_mesh = mesh_mod.make_mesh(8, "dp", devices=["cuda:0"] * 8)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    with step_shapes() as steps, scored_shapes() as scored:
        for name, run in (
                ("flat", lambda: parallel_flat(meshes[8], card)),
                ("ivf", lambda: parallel_ivf(main_path, meshes[8], card)),
                ("searches", lambda: parallel_searches(main_path, meshes,
                                                       dp_mesh, card)),
                ("build", lambda: parallel_build(main_path, meshes, card)),
                ("dynamic", lambda: parallel_dynamic(main_path, meshes[8],
                                                     card))):
            t1 = time.perf_counter()
            run()
            log(f"parallel: {name} {time.perf_counter() - t1:.1f} s")
    launches = {name: n for name, n in read_counts().items() if n}
    log(f"parallel: {time.perf_counter() - t0:.1f} s; launches {launches}; "
        f"peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB ({card})")
    missing = [k.__name__ for k in counted_kernels()
               if not launches.get(k.__name__)]
    if missing:
        raise AssertionError(f"parallel: kernels not launched: {missing}")
    check_step_shapes("parallel", steps)
    check_scored_shapes("parallel", scored)
    return launches


EXAMPLES = ("vamana", "compression", "dynamic", "ivf", "serving",
            "multichip")
GOLDEN_EXAMPLES = os.path.join(HERE, "data", "golden",
                               "torch_examples_reference.json")
# the examples' recall rows against the JAX examples' (GOLDEN_EXAMPLES):
# +-0.01 as the kinds gate; the dynamic rows +-0.02 (consolidate moves
# recall by points, ROADMAP queue 3); IVF at 2 probes +-0.05 (its recall
# there follows the k-means++ draws, which differ by design)
EXAMPLES_TOL, EXAMPLES_DYNAMIC_TOL, EXAMPLES_FEW_PROBES_TOL = 0.01, 0.02, 0.05
MULTI_ROWS, MULTI_ADD, MULTI_DELETE = 20_000, 1000, 250   # rows, labels
LINEAR_QUERIES, LINEAR_PAGES = 32, 5


def example_rows(name: str, out: dict, want: dict) -> list:
    """(row, port's value, JAX example's value, tolerance) of one example's
    gated numbers; a tolerance of 0 asks for equality."""
    if name == "vamana":
        return [(f"window {w}", out["recall"][w], r, EXAMPLES_TOL)
                for w, r in want["recall"].items()]
    if name == "compression":
        return [(key, out[key], want[key], EXAMPLES_TOL)
                for key in ("float32", "sq_int8", "lvq8", "leanvec")]
    if name == "dynamic":
        return [("initial size", out["initial_size"], want["initial_size"],
                 0), ("size after add+delete", out["size_after_add_delete"],
                      want["size_after_add_delete"], 0),
                ("recall", out["recall"], want["recall"],
                 EXAMPLES_DYNAMIC_TOL)]
    if name == "ivf":
        return [("clusters", out["clusters"], want["clusters"], 0)] + [
            (f"n_probes {p}", out["recall"][p], r,
             EXAMPLES_FEW_PROBES_TOL if p == "2" else EXAMPLES_TOL)
            for p, r in want["recall"].items()] + [
            ("LVQ postings + rerank", out["lvq_rerank"], want["lvq_rerank"],
             EXAMPLES_TOL)]
    if name == "serving":
        return [("recall", out["recall"], want["recall"], EXAMPLES_TOL)]
    if name == "multichip":
        return [(key, out[key], want[key], EXAMPLES_TOL)
                for key in ("flat", "ivf", "dp_vamana", "sharded_lvq8")] + [
            ("sharded_dynamic", out["sharded_dynamic"],
             want["sharded_dynamic"], EXAMPLES_DYNAMIC_TOL)]
    raise ValueError(name)


def examples_run(name: str, want: dict, card: str) -> list:
    """One example's ``run(device="cuda")`` at the JAX example's sizes; its
    own asserts hold inside; its numbers beside the JAX example's.  Returns
    the rows outside their tolerance."""
    import importlib
    module = importlib.import_module(
        f"scalablevectorsearch_tpu_torch.examples.example_{name}")
    torch.cuda.reset_peak_memory_stats()
    before = read_counts()
    t0 = time.perf_counter()
    out = module.run(device="cuda")
    sync()
    secs = time.perf_counter() - t0
    launched = {k: n for k, n in launched_since(before).items() if n}
    rows = example_rows(name, out, want)
    # differences at the recalls' own resolution (hits / (10 queries)):
    # a difference equal to the tolerance is within it
    bad = [f"{name} {row} {got} vs {ref} (+-{tol})"
           for row, got, ref, tol in rows if round(abs(got - ref), 6) > tol]
    extra = ""
    if name == "vamana":
        extra = (f"; calibrated window {out['calibrated_window']} (JAX "
                 f"{want['calibrated_window']}), its recall@10 "
                 f"{out['calibrated_recall']:.4f}")
        if out["calibrated_recall"] < 0.95:
            bad.append(f"vamana calibrated recall {out['calibrated_recall']}")
    elif name == "dynamic" and out["deleted_surfaced"]:
        bad.append("dynamic: a deleted id surfaced after compact")
    elif name == "ivf":
        extra = f"; largest cluster {out['max_size']} (JAX {want['max_size']})"
    elif name == "serving":
        extra = (f"; blocking {out['qps_blocking']:.0f} QPS, pipelined "
                 f"{out['qps_pipelined']:.0f} QPS (identical ids); batch "
                 f"latency "
                 f"({out['batch_queries']} queries) p50 {out['p50_ms']:.1f} "
                 f"ms, p95 {out['p95_ms']:.1f} ms (host clock)")
    elif name == "multichip":
        extra = f"; mesh {out['devices']} devices ({out['mesh']})"
    log(f"examples: {name} {secs:.1f} s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB: "
        + ", ".join(f"{row} {got:.4f} (JAX {ref}, +-{tol})" if tol else
                    f"{row} {got} (JAX {ref})" for row, got, ref, tol in rows)
        + extra + f"; launches {launched} ({card})")
    return bad


def first_labels(labels: np.ndarray, k: int) -> np.ndarray:
    """Each row's first ``k`` distinct labels, in order."""
    out = np.full((labels.shape[0], k), -1, dtype=np.int64)
    for r, row in enumerate(labels):
        _, first = np.unique(row, return_index=True)
        picked = row[np.sort(first)][:k]
        out[r, :picked.size] = picked
    return out


def examples_multi_vector(main_path: dict, card: str) -> None:
    """MultiMutableVamanaIndex over the main data's first MULTI_ROWS rows,
    two vectors per label, the main path's build parameters, window
    TOOLS_WINDOW: add MULTI_ADD rows (half as many labels), delete
    MULTI_DELETE labels, consolidate, compact.  After the build and every
    step: label recall@10 >= 0.9 against the exact label ranking over the
    live vectors, no deleted label, no label twice in a row, beam_step
    launching.  Then a save / assemble round trip with the same labels and
    an identical search."""
    import scalablevectorsearch_tpu_torch as svt
    from scalablevectorsearch_tpu_torch.ops.kernels.beam_step import (
        beam_step)
    total = MULTI_ROWS + MULTI_ADD
    rows = main_path["data"][:total]
    labels = np.arange(total, dtype=np.int64) // 2
    queries = main_path["queries"][:PAR_QUERIES]
    live = np.arange(total) < MULTI_ROWS
    gone = np.empty(0, dtype=np.int64)
    rng = np.random.default_rng(12)
    secs = {}
    t0 = time.perf_counter()
    index = svt.MultiMutableVamanaIndex(main_path_params(), rows[:MULTI_ROWS],
                                        labels[:MULTI_ROWS], "l2")
    sync()
    secs["build"] = time.perf_counter() - t0
    index.search_window_size = TOOLS_WINDOW

    def check(step):
        vids = np.nonzero(live)[0]
        exact = svt.exhaustive_search(rows[vids], queries, 20).ids
        want = first_labels(labels[vids][exact], 10)
        before = beam_step.launches
        res = index.search(queries, 10)
        launched = beam_step.launches - before
        got = res.ids
        recall = float(np.mean([len(set(g) & set(w)) / 10
                                for g, w in zip(got.tolist(),
                                                want.tolist())]))
        twice = sum(np.unique(g[g >= 0]).size != (g >= 0).sum() for g in got)
        dead = int(np.isin(got, gone).sum())
        log(f"examples: multi-vector {step}: {index.size} labels, "
            f"{index.num_vectors} vectors, label recall@10 {recall:.4f} at "
            f"window {TOOLS_WINDOW}; deleted labels returned {dead}, rows "
            f"with a label twice {twice}; beam_step launches {launched}")
        if recall < 0.9 or dead or twice or not launched:
            raise AssertionError(f"examples: multi-vector {step}: recall "
                                 f"{recall}, deleted {dead}, twice {twice}, "
                                 f"launches {launched}")

    def step(name, fn):
        t1 = time.perf_counter()
        fn()
        sync()
        secs[name] = time.perf_counter() - t1
        check(name)

    check("build")
    live[MULTI_ROWS:] = True
    step("add", lambda: index.add_points(rows[MULTI_ROWS:],
                                         labels[MULTI_ROWS:]))
    gone = rng.choice(np.unique(labels), size=MULTI_DELETE, replace=False)
    live &= ~np.isin(labels, gone)
    step("delete", lambda: index.delete_points(gone))
    step("consolidate", index.consolidate)
    step("compact", index.compact)
    with tempfile.TemporaryDirectory() as tmp:
        t1 = time.perf_counter()
        index.save(tmp)
        loaded = svt.MultiMutableVamanaIndex.assemble(tmp)
        secs["round trip"] = time.perf_counter() - t1
        loaded.search_window_size = TOOLS_WINDOW
        a, b = index.search(queries, 10), loaded.search(queries, 10)
        if not (np.array_equal(index.all_labels(), loaded.all_labels())
                and np.array_equal(a.ids, b.ids)
                and np.array_equal(a.distances, b.distances)):
            raise AssertionError("examples: multi-vector round trip differs")
    log("examples: multi-vector seconds " + ", ".join(
        f"{k} {v:.2f}" for k, v in secs.items()) + "; round trip: the same "
        f"labels, identical ids and distances ({card})")


def examples_flat(main_path: dict, card: str) -> None:
    """svt.Flat over the main rows: the main queries' top-10 equal to
    exhaustive_search's up to ties of the 10th distance, 256 queries'
    distances against float64 on the host; a save / assemble round trip
    searched identically."""
    import scalablevectorsearch_tpu_torch as svt
    data, queries, gt = (main_path[key] for key in ("data", "queries", "gt"))
    t0 = time.perf_counter()
    flat = svt.Flat.build(data, "l2")
    res = flat.search(queries, 10)
    search_s = time.perf_counter() - t0
    ties = misses_are_ties(res, gt.ids, queries, lambda i: data[i],
                           "examples flat")
    host_distances(res, queries, lambda i: data[i], "examples flat")
    with tempfile.TemporaryDirectory() as tmp:
        flat.save(tmp)
        loaded = svt.Flat.assemble(tmp)
        again = loaded.search(queries, 10)
        if not (np.array_equal(res.ids, again.ids)
                and np.array_equal(res.distances, again.distances)):
            raise AssertionError("examples: Flat round trip differs")
    log(f"examples: Flat {flat.size} x {flat.dimensions}, build and "
        f"{len(queries)} queries in {search_s:.3f} s: recall@10 "
        f"{svt.k_recall_at_n(gt, res):.4f}, misses all ties of the 10th "
        f"distance ({ties}); round trip identical ({card})")


def examples_linear_schedule(main_path: dict, card: str) -> None:
    """BatchIterator with LinearSchedule(main window, 10) over the main
    index: LINEAR_QUERIES queries x LINEAR_PAGES pages of 10, disjoint and
    nearest-first, beam_step launching on every page; coverage of the
    exact top-50 reported."""
    import scalablevectorsearch_tpu_torch as svt
    index = main_path["index"].index
    data, queries = main_path["data"], main_path["queries"]
    schedule = svt.LinearSchedule(main_path["window"], 10)
    exact = svt.exhaustive_search(data, queries[:LINEAR_QUERIES],
                                  10 * LINEAR_PAGES).ids
    cover = 0
    t0 = time.perf_counter()
    for qi in range(LINEAR_QUERIES):
        it = svt.BatchIterator(index, queries[qi], batch_size=10,
                               schedule=schedule)
        got = []
        for p in range(LINEAR_PAGES):
            before = read_counts()
            res = it.next()
            ids = res.ids[0][res.ids[0] >= 0]
            if not launched_since(before)["beam_step"] or \
                    np.any(np.diff(res.distances[0][res.ids[0] >= 0]) < 0):
                raise AssertionError(f"examples: linear schedule query {qi} "
                                     f"page {p}: no beam_step launch or not "
                                     f"nearest-first")
            got.append(ids)
        ids = np.concatenate(got)
        if ids.size != 10 * LINEAR_PAGES or np.unique(ids).size != ids.size:
            raise AssertionError(f"examples: linear schedule query {qi}: "
                                 f"pages overlap or run short")
        cover += len(set(ids.tolist()) & set(exact[qi].tolist()))
    log(f"examples: BatchIterator with LinearSchedule("
        f"{main_path['window']}, 10), {LINEAR_QUERIES} queries x "
        f"{LINEAR_PAGES} pages of 10 in {time.perf_counter() - t0:.2f} s: "
        f"disjoint, nearest-first, beam_step on every page; the pages cover "
        f"{cover / (10 * LINEAR_PAGES * LINEAR_QUERIES):.4f} of the exact "
        f"top-{10 * LINEAR_PAGES} ({card})")


def phase_examples(main_path: dict) -> dict:
    """The port's six examples at the JAX examples' sizes on the card, held
    to GOLDEN_EXAMPLES; then the entry points no other phase drives: the
    multi-vector index, Flat and BatchIterator with LinearSchedule.  Every
    count starts at 0 here; every kernel call of the phase is then held to
    its plain version.  Returns the phase's launches."""
    card = card_line()
    with open(GOLDEN_EXAMPLES) as f:
        golden = json.load(f)["examples"]
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    peak, bad = 0, []
    t0 = time.perf_counter()
    with step_shapes() as steps, scored_shapes() as scored:
        for name in EXAMPLES:
            bad += examples_run(name, golden[name], card)
            peak = max(peak, torch.cuda.max_memory_allocated())
        for name, run in (
                ("multi-vector", lambda: examples_multi_vector(main_path,
                                                               card)),
                ("flat", lambda: examples_flat(main_path, card)),
                ("linear schedule",
                 lambda: examples_linear_schedule(main_path, card))):
            t1 = time.perf_counter()
            run()
            log(f"examples: {name} {time.perf_counter() - t1:.1f} s")
            peak = max(peak, torch.cuda.max_memory_allocated())
    launches = {name: n for name, n in read_counts().items() if n}
    log(f"examples: {time.perf_counter() - t0:.1f} s; launches {launches}; "
        f"peak device memory {peak / 2 ** 30:.2f} GiB ({card})")
    if bad:
        raise AssertionError("examples outside tolerance: " + "; ".join(bad))
    missing = [name for name in ("beam_step", "beam_step_lvq", "beam_update",
                                 "score_rows") if not launches.get(name)]
    if missing:
        raise AssertionError(f"examples: kernels not launched: {missing}")
    check_step_shapes("examples", steps)
    check_scored_shapes("examples", scored, ("beam_update", "score_rows"))
    return launches


# scale_10m phase (21): data/jobs/ivf_10m.json through the CLI, then the
# serving step over a 10M x 96 f32 table (padded to 128 columns) at the 10M
# serving shapes: B 2000 queries, beams of C 12 and 48, K = pop 4 x R 32
# candidates; each timing beside the same over the main path's 100k table
SCALE_ROWS, SCALE_DIM, SCALE_SEED = 10_000_000, 96, 13
SCALE_B, SCALE_K, SCALE_M, SCALE_R = 2000, 128, 4, 32
SCALE_WINDOWS = (12, 48)
SCALE_ID_SETS = 3              # id sets rotated by the timings


def scale_case(gen, table, n_rows: int, live: int, c: int) -> list:
    """beam_step inputs over ``table`` (rows < ``n_rows``, ``live`` of its
    columns non-zero): C distinct beam ids per query with their true L2
    keys, sorted, half visited and up to a third of the slots empty; K
    candidate ids over all the rows, 20% invalid, gathered as the search
    loop gathers them; queries are table rows plus noise, zero in the dead
    lanes."""
    from scalablevectorsearch_tpu_torch.ops.kernels import beam_step as bs
    b, k, dev = SCALE_B, SCALE_K, "cuda"
    beam_ids = (torch.randint(0, n_rows - c, (b, 1), generator=gen,
                              device=dev)
                + torch.arange(c, device=dev)).to(torch.int32)
    queries = table[torch.randint(0, n_rows, (b,), generator=gen,
                                  device=dev)].clone()
    queries[:, :live] += 0.3 * torch.randn((b, live), generator=gen,
                                           device=dev)
    keys = bs._score(table[beam_ids.long()], queries, 0)
    keys, order = torch.sort(keys, 1)
    beam_ids = torch.gather(beam_ids, 1, order)
    vis = (torch.rand((b, c), generator=gen, device=dev) < 0.5).to(
        torch.int32)
    n_empty = torch.randint(0, c // 3 + 1, (b, 1), generator=gen, device=dev)
    empty = torch.arange(c, device=dev)[None, :] >= c - n_empty
    keys = torch.where(empty, float("inf"), keys)
    packed = torch.where(empty, -1, beam_ids | (vis << 30)).to(torch.int32)
    cand = torch.randint(0, n_rows, (b, k), generator=gen, device=dev).to(
        torch.int32)
    cand[torch.rand((b, k), generator=gen, device=dev) < 0.2] = -1
    rows = table[cand.clamp_min(0).long()]
    return [keys.contiguous(), packed, rows, cand, queries.contiguous()]


def scale_timings(label: str, gen, table, n_rows: int, live: int,
                  failures: list, card: str) -> dict:
    """Over one table: PyTorch's row gather of the search loop, beam_step
    on the gathered rows at each of SCALE_WINDOWS and
    gather_score_l2_partial over the table in f32 and float16, each held
    to its plain version and timed by :func:`kernel_ms`'s method (the
    gather through the same windows, its kernels in place of a C entry
    point); bounds over the bytes read and over the live bytes."""
    from scalablevectorsearch_tpu_torch.ops.kernels import beam_step as bs
    from scalablevectorsearch_tpu_torch.ops.kernels import (
        gather_distance as gd)
    out = {}
    d = table.shape[1]
    es = table.element_size()
    id_sets = [torch.randint(0, n_rows, (SCALE_B, SCALE_K), generator=gen,
                             device="cuda", dtype=torch.int32)
               for _ in range(SCALE_ID_SETS)]
    n_unique = int(torch.unique(id_sets[0]).numel())
    rows = SCALE_B * SCALE_K
    t = kernel_ms(lambda tab, ids: (tab[ids], 0)[1],
                  [[table, ids] for ids in id_sets])
    t["bounds"] = {
        f"read {d}": bound_of(n_unique * d * es + rows * (d * es + 4), 0),
        f"live {live}": bound_of(n_unique * live * es
                                 + rows * (live * es + 4), 0)}
    out["gather"] = t
    log(f"scale_10m: {label} row gather (B, K) = ({SCALE_B}, {SCALE_K}) "
        f"f32 rows of {d}: device {t['ms']:.4f} ms (profiler "
        f"{t['profiler_ms']:.4f}); bound {t['bounds']} ({card})")
    for window in SCALE_WINDOWS:
        kw = dict(metric=0, window=window, m=SCALE_M)
        args = scale_case(gen, table, n_rows, live, window)
        got = bs.beam_step(*args, **kw)
        want = bs.beam_step_plain(*args, **kw)
        torch.cuda.synchronize()
        # L2 keys are ||q||^2 - 2<q, x> + ||x||^2: their rounding follows
        # the norms, not the key (the main rows' norms are ~1e4), so atol
        # is 1e-5 of the norms' scale, as the scoring kernels are held
        norms = float(args[4].square().sum(-1).max()
                      + args[2].square().sum(-1).max())
        err, off, n = compare_step(f"scale_10m {label} C {window}", args,
                                   got, want, window, 1e-5, failures,
                                   atol=1e-5 * norms)
        if off > 1e-3 * n:
            failures.append(f"scale_10m {label} C {window}: {off} near-tie "
                            f"rows of {n}")
        t = time_raw(bs._kernel_entry("svt_beam_step"), args,
                     lambda a: bs._outputs(a[0], a[2].shape[1], SCALE_M),
                     lambda a, o: bs.beam_step_args(*a, o, **kw))
        t["plain_ms"] = median_ms(lambda: bs.beam_step_plain(*args, **kw))
        t["max_abs_err"], t["near_tie_rows"] = err, off
        t["bounds"] = {f"read {d}": step_bound(args, SCALE_M, 4),
                       f"live {live}": step_bound(args, SCALE_M, 4, live)}
        out[f"beam_step_c{window}"] = t
        log(f"scale_10m: {label} beam_step B,C,K,d={SCALE_B},{window},"
            f"{SCALE_K},{d} f32 L2: device {t['ms']:.4f} ms (profiler "
            f"{t['profiler_ms']:.4f}), plain {t['plain_ms']:.4f} ms; "
            f"max_abs_err {err:.3g}, {off} near-tie rows of {n}; bound "
            f"{t['bounds']} ({card})")
    q_all = torch.zeros((SCALE_B, d), device="cuda")
    q_all[:, :live] = torch.randn((SCALE_B, live), generator=gen,
                                  device="cuda")
    for name, tab in (("f32", table), ("float16", table.half())):
        ids = id_sets[0].clone()
        ids[::2, SCALE_K // 2:] = ids[::2, :SCALE_K // 2]   # repeats
        got = gd.gather_score_l2_partial(tab, ids, q_all)
        want = gd.gather_score_l2_partial_plain(tab, ids, q_all)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=1e-5,
                              atol=1e-5 * float(want.abs().max())):
            failures.append(f"scale_10m {label} gather_score_l2_partial "
                            f"{name}: {err:.3g}")
        sets = [[tab, i, q_all] for i in id_sets]
        outs = [torch.empty((SCALE_B, SCALE_K), device="cuda")
                for _ in sets]
        t = kernel_ms(gd._kernel_entry("svt_gather_score_l2_partial"),
                      [gd.gather_score_l2_partial_args(*a, o)
                       for a, o in zip(sets, outs)])
        t["plain_ms"] = median_ms(
            lambda: gd.gather_score_l2_partial_plain(tab, id_sets[0],
                                                     q_all))
        t["max_abs_err"] = err
        tes = tab.element_size()
        t["bounds"] = {
            f"read {d}": bound_of(n_unique * d * tes + rows * 8
                                  + SCALE_B * d * 4, 4 * rows * d),
            f"live {live}": bound_of(n_unique * live * tes + rows * 8
                                     + SCALE_B * live * 4, 4 * rows * live)}
        out[f"gather_score_l2_partial_{name}"] = t
        log(f"scale_10m: {label} gather_score_l2_partial {name} table, ids "
            f"({SCALE_B}, {SCALE_K}) ({n_unique} distinct): device "
            f"{t['ms']:.4f} ms (profiler {t['profiler_ms']:.4f}), plain "
            f"{t['plain_ms']:.4f} ms; max_abs_err {err:.3g}; bound "
            f"{t['bounds']} ({card})")
        del tab
    return out


def scale_search(data, gen, label: str, window: int) -> None:
    """One greedy_search over ``data`` as the serving loop runs it (B
    SCALE_B, pop 4, tail fraction 4) on a random R-regular graph over its
    rows: the route's kernels on the 10M table's real gathers."""
    from scalablevectorsearch_tpu_torch.core.graph import NeighborGraph
    from scalablevectorsearch_tpu_torch.index.vamana import search as smod
    from scalablevectorsearch_tpu_torch.ops import distance as dist_ops
    n = data.n
    graph = NeighborGraph(
        adjacency=torch.randint(0, n, (data.capacity, SCALE_R),
                                generator=gen, device="cuda",
                                dtype=torch.int32),
        degrees=torch.full((data.capacity,), SCALE_R, dtype=torch.int32,
                           device="cuda"), n=n, max_degree=SCALE_R)
    q = data.get_f32(torch.randint(0, n, (SCALE_B,), generator=gen,
                                   device="cuda"))
    entries = torch.randint(0, n, (SCALE_B, 1), generator=gen,
                            device="cuda", dtype=torch.int32)
    before = read_counts()
    t0 = time.perf_counter()
    out = smod.greedy_search(graph, data, q, entries, window=window,
                             capacity=window,
                             max_iters=smod.default_max_iters(window),
                             distance=dist_ops.DistanceType.L2,
                             tail_frac=4)
    torch.cuda.synchronize()
    launched = {k: v for k, v in launched_since(before).items() if v}
    log(f"scale_10m: greedy_search over the 10M {label} table at window "
        f"{window}, B {SCALE_B}: {time.perf_counter() - t0:.3f} s; "
        f"launches {launched}")
    if not bool((out.ids[:, 0] >= 0).all()):
        raise AssertionError(f"scale_10m {label} search: empty beams")


def phase_scale_10m(main_path: dict) -> dict:
    """data/jobs/ivf_10m.json through the CLI (:func:`ivf_cli_job`), then
    the serving step over a 10M-row table made on the card from a seeded
    generator: a greedy_search over its f32 rows (beam_step) and over its
    float16 copy (gather_score_l2_partial, beam_update), whose launches are
    the phase's; then the kernels held to their plain versions and timed
    at the 10M serving shapes over it and over the main path's 100k
    table.  Every count starts at 0 here.  Returns the phase's launches."""
    from scalablevectorsearch_tpu_torch.core.data import VectorDataset
    card = card_line()
    zero_counts()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        cli = ivf_cli_job("ivf_10m", tmp)
    t1 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(SCALE_SEED)
    base = torch.randn((SCALE_ROWS, SCALE_DIM), generator=gen, device="cuda")
    f32 = VectorDataset.from_array(base, device="cuda")
    f16 = VectorDataset.from_array(base, dtype=torch.float16, device="cuda")
    del base
    for window in SCALE_WINDOWS:
        scale_search(f32, gen, "f32", window)
        scale_search(f16, gen, "float16", window)
    del f16
    launches = {name: n for name, n in read_counts().items() if n}
    t2 = time.perf_counter()
    failures = []
    main_rows = main_path["index"].index.data.vectors
    timings = {
        "10M": scale_timings("10M", gen, f32.vectors, SCALE_ROWS,
                             SCALE_DIM, failures, card),
        "100k": scale_timings("100k", gen, main_rows,
                              main_path["index"].index.data.n,
                              main_rows.shape[1], failures, card)}
    peak = torch.cuda.max_memory_allocated()
    del f32
    torch.cuda.empty_cache()
    log(f"scale_10m: {time.perf_counter() - t0:.1f} s (CLI {t1 - t0:.1f}, "
        f"searches {t2 - t1:.1f}, kernels {time.perf_counter() - t2:.1f}); "
        f"launches {launches}; peak device memory {peak / 2 ** 30:.2f} GiB "
        f"outside the child ({card})")
    log(json.dumps({"scale_10m": {"cli": {k: v for k, v in cli.items()
                                          if k != "result"},
                                  "timings": timings}}))
    if failures:
        raise AssertionError("scale_10m kernels vs plain: "
                             + "; ".join(failures))
    missing = [name for name in ("beam_step", "beam_update",
                                 "gather_score_l2_partial")
               if not launches.get(name)]
    if missing:
        raise AssertionError(f"scale_10m: kernels not launched: {missing}")
    return launches


def kernel_entry(name: str, replaces: str, by_path: dict, kern: dict,
                 shape: str, build_s: float,
                 source: str = "beam_step.cu") -> dict:
    """One kernel's entry of the summary line: its launches summed over
    the paths (``by_path``: path -> launches); times and bound at the main
    path's shape ``shape`` (``ms``: device time per raw launch;
    ``call_ms``: one call of the Python wrapper, its host work included);
    every shape's numbers under ``ms_by_shape``.  ``library_ms`` is one
    PyTorch call computing the same function, where there is one (none
    scores, dedups, merges and pops)."""
    t = kern["timings"][shape]
    return {"name": name, "route": "cuda",
            "source": f"scalablevectorsearch_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": kern["max_abs_err"], "ms": t["ms"],
            "call_ms": t["call_ms"], "issue_ms": t["issue_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": kern.get("library_ms"), "build_s": build_s,
            "ms_by_shape": kern["timings"]}


def main(argv: list) -> int:
    kernels_only = argv[:1] == ["--kernels-only"]
    other_gather = None
    if kernels_only and argv[1:2] == ["--other-gather"] and len(argv) == 3:
        other_gather = argv[2]
    elif argv and argv not in (["--kernels-only"], ["--parallel-only"],
                               ["--examples-only"], ["--scale-10m-only"]):
        raise SystemExit(f"chip_smoke: unknown arguments {argv}")
    device = phase_device()
    build_s, other_lib = phase_build(other_gather)
    if argv == ["--parallel-only"]:
        # the main path and the parallel phase only, for work on the
        # multi-device package
        log(json.dumps({"parallel": phase_parallel(phase_main_path())}))
        print(json.dumps({"ok": True, "device": device}))
        return 0
    if argv == ["--examples-only"]:
        # the main path and the examples phase only, for work on the
        # examples
        log(json.dumps({"examples": phase_examples(phase_main_path())}))
        print(json.dumps({"ok": True, "device": device}))
        return 0
    if argv == ["--scale-10m-only"]:
        # the main path and the 10M phase only, for work on the 10M scale
        log(json.dumps({"scale_10m": phase_scale_10m(phase_main_path())}))
        print(json.dumps({"ok": True, "device": device}))
        return 0
    kern = phase_kernels()
    kern_lvq = phase_kernels_lvq()
    kern_scored = phase_kernels_scored(other_lib)
    if kernels_only:
        # phases 1-5 only: the kernels' checks and times, for comparing two
        # versions of the sources in one run on one card
        log(json.dumps({"kernels_only": {
            "beam_step": kern["timings"], "beam_step_lvq": kern_lvq["timings"],
            **{name: k["timings"] for name, k in kern_scored.items()}}}))
        print(json.dumps({"ok": True, "device": device}))
        return 0
    t0 = time.perf_counter()
    main_path = phase_main_path()
    phase_persistence(main_path)
    phase_host_rerank(main_path)
    lvq_path = phase_lvq_path(main_path)
    scored = phase_scored_path(main_path)["launches"]
    dynamic = phase_dynamic(main_path)
    # launches per path of each kernel; the persistence, host rerank and
    # golden phases check their own
    by_path = {"main": {"beam_step": main_path["launches"]},
               "lvq": lvq_path["launches"],
               "scored": scored,
               "dynamic": {"beam_step": dynamic["launches"]}}
    with step_shapes() as seen:
        by_path["iterator"] = phase_iterator(main_path, dynamic)
    del dynamic
    check_step_shapes("iterator", seen)
    with step_shapes() as seen:
        by_path["calibrate"] = phase_calibrate(main_path)
    check_step_shapes("calibrate", seen)
    with step_shapes() as seen:
        by_path["leanvec"] = phase_leanvec(main_path)["launches"]
    check_step_shapes("leanvec", seen)
    by_path["ivf"] = phase_ivf(main_path)
    with step_shapes() as seen:
        by_path["inverted"] = phase_inverted(main_path)
    check_step_shapes("inverted", seen)
    with step_shapes() as seen:
        tools = phase_tools(main_path)
    by_path["tools"] = tools["launches"]
    check_step_shapes("tools", seen)
    by_path["parallel"] = phase_parallel(main_path)
    by_path["examples"] = phase_examples(main_path)
    by_path["scale_10m"] = phase_scale_10m(main_path)
    del main_path                       # frees the 100k index
    phase_golden(tools["golden"])
    log(f"paths: {time.perf_counter() - t0:.1f} s from the main path's "
        f"build to the end of the golden gate")
    pallas = "scalablevectorsearch_tpu/ops/pallas/"

    def launches(name):
        return {path: counts[name] for path, counts in by_path.items()
                if counts.get(name)}

    print(json.dumps({"kernels": [
        kernel_entry("beam_step", pallas + "beam_step.py:261",
                     launches("beam_step"), kern, "serving_bf16", build_s),
        kernel_entry("beam_step_lvq", pallas + "beam_step.py:327",
                     launches("beam_step_lvq"), kern_lvq, "serving", build_s),
        kernel_entry("beam_update", pallas + "beam_update.py:179",
                     launches("beam_update"), kern_scored["beam_update"],
                     "serving", build_s),
        kernel_entry("score_rows", pallas + "gather_distance.py:41",
                     launches("score_rows"), kern_scored["score_rows"], "f32",
                     build_s, source="gather_distance.cu"),
        kernel_entry("gather_score_l2_partial",
                     pallas + "gather_distance.py:131",
                     launches("gather_score_l2_partial"),
                     kern_scored["gather_score_l2_partial"], "float16",
                     build_s, source="gather_distance.cu")]}))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
