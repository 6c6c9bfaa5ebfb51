"""The Deep-10M run on the card: bench.py's 10M configuration (``_scale_10m``
with ``_scale_10m_lvq`` and ``_scale_10m_ivf``) and the cache that
``tools/rebuild_10m_cache.py`` makes, in one resumable command:

    python -m scalablevectorsearch_tpu_torch.benchmark.scale_10m \\
        [--dir .bench10m] [--step STEP ...] [--device cuda]

The data is ``generate_test_dataset(10_000_000, 2000, 96, seed=13)``
(rows padded to 128 columns on the device), L2, k = 10.  The steps, in
order; each writes its artifact into the cache directory and is skipped
when that artifact exists, so a rerun goes on where the last one stopped:

- ``data``: the rows and queries; ``queries.npy``.  A later step that
  needs the rows draws them again from the seed (one draw per process).
- ``gt``: the exact top-10 on the device (``index/flat.py``); ``gt.npy``.
- ``build``: Vamana at alpha 1.1, R 32, window 100, pool 300, ``prune_to``
  28, sampled entries (bench.py's build), then ``save`` into ``index/``.
  The rounds run in segments of ``SEGMENT_ROUNDS``; after each, the
  graph and the next round go into ``build_state/``, and a rerun resumes
  from there, giving the uninterrupted build's graph.
- ``f32``: ``index/`` assembled and served unpacked over ``WINDOWS``
  (``beam_step``); packed rows (R x 128 bf16 per row, 82 GB here) do not
  fit on the card.
- ``lvq8x8``: two-level LVQ 8x8 codes written on the host (``lvq8x8/``),
  served over the saved graph (``beam_step_lvq`` at 32 dead lanes, then
  the two-level rerank) at ``LVQ_WINDOWS``.
- ``int8``: the f32 index with int8 query uploads, no host rerank, one
  batch for the whole query set, as bench.py's ``int8`` line serves it.
- ``ivf``: K = max(64, min(16384, 3 sqrt(n))) k-means, 10 iterations,
  training fraction min(1, 200000 / n), bf16 postings written on the host
  (``ivf/``), then the n_probes sweep of bench.py.

Each step prints one JSON line (and keeps it as ``<step>.json``): its
numbers, the peak device memory, the process's peak host memory so far,
and the card's ``nvidia-smi`` name and power limit.  Searches report
recall@10 at every window (or n_probes) and QPS at the first that
reaches 0.9: the median of 5 ``search_async(...).result()`` calls.
``--deadline-s`` stops the build after the segment that passes it and
reports its rounds per second and projected total instead.

The cache keeps its configuration (rows, queries, dimensions, seed) in
``config.json``; a run of another configuration over it is refused.
:func:`run` takes the sizes (``n``, ``n_queries``) and the build's
``prune_chunk`` (default ``build_graph``'s) as keyword arguments, for the
tests and for trials; the command line runs the 10M configuration only.
"""

from __future__ import annotations

import argparse
import gc
import inspect
import json
import os
import resource
import shutil
import statistics
import sys
import time
from typing import Optional

import numpy as np
import torch

N, N_QUERIES, DIM, K, SEED = 10_000_000, 2000, 96, 10, 13
STEPS = ("data", "gt", "build", "f32", "lvq8x8", "int8", "ivf")
WINDOWS = (12, 14, 16, 20, 24, 32, 48)
LVQ_WINDOWS = (12, 14, 16, 20, 24, 32)
INT8_WINDOWS = (12, 14, 16, 17, 20, 24, 32, 48)   # 17: the JAX int8 line's
IVF_PROBES = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128)
SEGMENT_ROUNDS = 500
RECALL_TARGET = 0.9


def build_parameters():
    from ..index.vamana.params import VamanaBuildParameters
    return VamanaBuildParameters(alpha=1.1, graph_max_degree=32,
                                 window_size=100,
                                 max_candidate_pool_size=300, prune_to=28)


def ivf_build_parameters(n: int):
    from ..index.ivf.params import IVFBuildParameters
    return IVFBuildParameters(
        num_centroids=max(64, min(16384, int(np.sqrt(n) * 3))),
        num_iterations=10, training_fraction=min(1.0, 200_000 / n),
        is_hierarchical=False).resolved(n)


class Run:
    """One invocation over a cache directory: the sizes, the device, and
    what its steps share in this process (the rows, the f32 index).
    ``prune_chunk``: the build's rows per prune chunk (default
    ``build_graph``'s)."""

    def __init__(self, directory: str, device="cuda",
                 n: Optional[int] = None, n_queries: Optional[int] = None,
                 segment_rounds: int = SEGMENT_ROUNDS,
                 prune_chunk: Optional[int] = None,
                 deadline: Optional[float] = None, log=None):
        from ..examples import on_device
        from ..index.vamana.build import build_graph
        self.dir = os.path.abspath(directory)
        self.device = on_device(device)
        self.n = N if n is None else n
        self.n_queries = N_QUERIES if n_queries is None else n_queries
        self.segment_rounds = segment_rounds
        self.prune_chunk = inspect.signature(build_graph).parameters[
            "prune_chunk"].default if prune_chunk is None else prune_chunk
        self.deadline = deadline
        self.log = log or (lambda msg: print(msg, file=sys.stderr,
                                             flush=True))
        self._rows = None
        self._index = None
        os.makedirs(self.dir, exist_ok=True)
        path = self.path("config.json")
        if os.path.exists(path):
            with open(path) as f:
                self.check("config.json", json.load(f))
        else:
            with open(path + ".tmp", "w") as f:
                json.dump(self.config(), f)
            os.replace(path + ".tmp", path)

    def config(self) -> dict:
        return {"n": self.n, "n_queries": self.n_queries, "dim": DIM,
                "seed": SEED}

    def check(self, what: str, found: dict) -> None:
        """Refuse an artifact of another configuration than this run's."""
        want = self.config()
        got = {key: found.get(key) for key in want}
        if got != want:
            raise RuntimeError(f"scale_10m: {what} in {self.dir} is of "
                               f"{got}, this run of {want}; give another "
                               f"directory")

    def path(self, *parts: str) -> str:
        return os.path.join(self.dir, *parts)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def rows(self) -> tuple:
        """(rows, queries) from the seed, drawn once per process."""
        if self._rows is None:
            from ..core.io import generate_test_dataset
            self._rows = generate_test_dataset(self.n, self.n_queries, DIM,
                                               seed=SEED)
        return self._rows

    def queries(self) -> np.ndarray:
        return np.load(self.path("queries.npy"))

    def gt(self) -> np.ndarray:
        return np.load(self.path("gt.npy"))

    def index(self):
        """The f32 index, assembled from ``index/`` once per process;
        ``assemble_s`` says what that took."""
        if self._index is None:
            from ..index.vamana.index import VamanaIndex
            t0 = time.perf_counter()
            self._index = VamanaIndex.assemble(self.path("index"),
                                               device=self.device)
            self.sync()
            self.assemble_s = time.perf_counter() - t0
        return self._index

    def drop_index(self) -> None:
        self._index = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Measurement helpers
# ---------------------------------------------------------------------------

def recall_at_10(gt: np.ndarray, res) -> float:
    from ..core.recall import k_recall_at_n
    return float(k_recall_at_n(gt, res, K))


def median_qps(search_async, queries, k: int = K) -> float:
    """Queries per second of the median of 5 ``search_async(q, k)
    .result()`` calls (host clock)."""
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        search_async(queries, k).result()
        times.append(time.perf_counter() - t0)
    return len(queries) / statistics.median(times)


def window_sweep(index, queries, gt, windows) -> dict:
    """recall@10 at every window, and QPS at the first with recall >= 0.9
    (None where none reaches it)."""
    recall = {}
    for w in windows:
        index.search_window_size = w
        recall[w] = recall_at_10(gt, index.search(queries, K))
    first = next((w for w in windows if recall[w] >= RECALL_TARGET), None)
    qps = None
    if first is not None:
        index.search_window_size = first
        qps = median_qps(index.search_async, queries)
    return {"recall": {str(w): r for w, r in recall.items()},
            "first_window": first, "qps": qps}


def launches_of(kernel, fn):
    before = kernel.launches
    out = fn()
    return out, kernel.launches - before


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------

def step_data(run: Run) -> dict:
    t0 = time.perf_counter()
    rows, queries = run.rows()
    seconds = time.perf_counter() - t0
    np.save(run.path("queries.npy"), queries)
    return {"seconds": seconds, "rows": list(rows.shape),
            "queries": list(queries.shape), "rows_bytes": rows.nbytes}


def step_gt(run: Run) -> dict:
    from ..index.flat import exhaustive_search
    rows, queries = run.rows()
    t0 = time.perf_counter()
    gt = exhaustive_search(rows, queries, K, device=run.device)
    run.sync()
    seconds = time.perf_counter() - t0
    np.save(run.path("gt.npy"), gt.ids)
    return {"seconds": seconds}


def _load_state(run: Run, n: int, r: int):
    """(graph, entry, next_round, seconds) of a build cut short, or None;
    a state of another configuration or prune chunk is refused."""
    from ..core.graph import NeighborGraph
    path = run.path("build_state", "state.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        state = json.load(f)
    run.check("build_state", state)
    if state.get("prune_chunk") != run.prune_chunk:
        raise RuntimeError(f"scale_10m: build_state in {run.dir} was pruned "
                           f"in chunks of {state.get('prune_chunk')}, this "
                           f"run's are {run.prune_chunk}")
    arrays = {name: np.load(run.path("build_state", state[name]))
              for name in ("adjacency", "degrees")}
    graph = NeighborGraph(
        adjacency=torch.from_numpy(arrays["adjacency"]).to(run.device),
        degrees=torch.from_numpy(arrays["degrees"]).to(run.device),
        n=n, max_degree=r)
    return graph, state["entry"], state["next_round"], state["seconds"]


def _save_state(run: Run, graph, entry: int, next_round: int,
                seconds: float) -> None:
    """The graph after ``next_round`` rounds, written under names of that
    round; ``state.json``, replaced last, names them."""
    directory = run.path("build_state")
    os.makedirs(directory, exist_ok=True)
    state = {**run.config(), "prune_chunk": run.prune_chunk,
             "entry": int(entry), "next_round": next_round,
             "seconds": seconds}
    for name in ("adjacency", "degrees"):
        state[name] = f"{name}_{next_round}.npy"
        np.save(os.path.join(directory, state[name]),
                getattr(graph, name).cpu().numpy())
    tmp = os.path.join(directory, "state.json.tmp")
    with open(tmp, "w") as f:
        json.dump(state, f)
    os.replace(tmp, os.path.join(directory, "state.json"))
    for name in os.listdir(directory):
        if name.endswith(".npy") and name not in (state["adjacency"],
                                                  state["degrees"]):
            os.remove(os.path.join(directory, name))


def step_build(run: Run) -> dict:
    """``build_graph``'s rounds in segments, each followed by a checkpoint;
    the graph is ``VamanaIndex.build``'s (same batch, pop width, tail
    fraction, prune chunk, sampler seed and masks)."""
    from ..core.data import VectorDataset
    from ..core.graph import NeighborGraph
    from ..core.medioid import compute_medioid
    from ..index.vamana import build as build_mod
    from ..index.vamana.index import VamanaIndex
    from ..ops import distance as dist_ops
    from ..ops.kernels.beam_step import beam_step
    rows, _ = run.rows()
    distance = dist_ops.DistanceType.L2
    params = build_parameters().resolved(distance)
    r = params.graph_max_degree
    t0 = time.perf_counter()
    data = VectorDataset.from_array(rows, device=run.device)
    run.sync()
    upload_s = time.perf_counter() - t0
    batch = build_mod.default_batch_size(run.n)
    total = 2 * -(-run.n // batch)
    state = _load_state(run, run.n, r)
    resumed_at = None if state is None else state[2]
    if state is None:
        t0 = time.perf_counter()
        entry = compute_medioid(data)
        graph = NeighborGraph.empty(run.n, r, device=run.device)
        run.sync()
        state = (graph, entry, 0, time.perf_counter() - t0)
    graph, entry, next_round, seconds = state
    launches = 0
    while next_round < total:
        stop = min(next_round + run.segment_rounds, total)
        t0 = time.perf_counter()
        before = beam_step.launches
        graph, _ = build_mod.build_graph(
            data, params, distance, entry_point=entry, batch_size=batch,
            prune_chunk=run.prune_chunk, pop_width=4, tail_frac=4,
            sampled_entries=True, graph=graph, _rounds=(next_round, stop))
        run.sync()
        segment_s = time.perf_counter() - t0
        launches += beam_step.launches - before
        seconds += segment_s
        t0 = time.perf_counter()
        _save_state(run, graph, entry, stop, seconds)
        run.log(f"scale_10m build: rounds {next_round}-{stop} of {total} "
                f"in {segment_s:.1f} s ({(stop - next_round) / segment_s:.3f}"
                f" rounds/s), checkpoint {time.perf_counter() - t0:.1f} s")
        next_round = stop
        if next_round < total and run.deadline is not None \
                and time.time() > run.deadline:
            rate = next_round / seconds
            return {"done": False, "rounds": total, "next_round": next_round,
                    "batch": batch, "prune_chunk": run.prune_chunk,
                    "seconds": seconds,
                    "rounds_per_s": rate, "projected_s": total / rate,
                    "beam_step_launches": launches}
    index = VamanaIndex(graph, data, entry, distance,
                        build_parameters=params)
    index.enable_entry_sampler()
    mean_degree = index.graph.mean_degree()
    t0 = time.perf_counter()
    tmp = run.path("index.tmp")
    shutil.rmtree(tmp, ignore_errors=True)
    index.save(tmp)
    os.replace(tmp, run.path("index"))
    save_s = time.perf_counter() - t0
    shutil.rmtree(run.path("build_state"), ignore_errors=True)
    return {"done": True, "seconds": seconds, "rounds": total,
            "batch": batch, "prune_chunk": run.prune_chunk,
            "resumed_at_round": resumed_at,
            "rounds_per_s": total / seconds, "mean_degree": mean_degree,
            "entry_point": int(entry), "upload_s": upload_s,
            "save_s": save_s, "beam_step_launches": launches}


def step_f32(run: Run) -> dict:
    from ..ops.kernels.beam_step import beam_step
    index = run.index()
    queries, gt = run.queries(), run.gt()
    out, launches = launches_of(beam_step, lambda: window_sweep(
        index, queries, gt, WINDOWS))
    return {**out, "assemble_s": run.assemble_s,
            "beam_step_launches": launches, "packed": index._packed
            is not None, "mean_degree": index.graph.mean_degree()}


def step_lvq8x8(run: Run) -> dict:
    from ..core.loading import dispatch_load
    from ..index.vamana.index import VamanaIndex
    from ..ops.kernels.beam_step import beam_step_lvq
    from ..quantization import lvq as lvq_mod
    lvq_dir = run.path("lvq8x8")
    compress_s = None
    if not os.path.isdir(lvq_dir):
        rows, _ = run.rows()
        t0 = time.perf_counter()
        lvq_mod.compress_and_save_host(lvq_dir + ".tmp", rows, bits=8,
                                       residual_bits=8)
        os.replace(lvq_dir + ".tmp", lvq_dir)
        compress_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lvq = dispatch_load(lvq_dir, device=run.device)
    run.sync()
    load_s = time.perf_counter() - t0
    f32 = run.index()
    index = VamanaIndex(f32.graph, lvq, f32.entry_point, f32.distance,
                        query_batch_size=f32.query_batch_size)
    index.enable_entry_sampler()
    index.pop_width = f32.pop_width
    queries, gt = run.queries(), run.gt()
    out, launches = launches_of(beam_step_lvq, lambda: window_sweep(
        index, queries, gt, LVQ_WINDOWS))
    code_bytes = sum(t.numel() * t.element_size()
                     for t in (lvq.codes, lvq.res_codes))
    return {**out, "kind": lvq.kind, "compress_s": compress_s,
            "load_s": load_s, "code_bytes": code_bytes,
            "n_dead": lvq.padded_dim - lvq.dim,
            "beam_step_lvq_launches": launches}


def step_int8(run: Run) -> dict:
    from ..lib import datatypes as dt
    from ..ops.kernels.beam_step import beam_step
    index = run.index()
    queries, gt = run.queries(), run.gt()
    batch = index.query_batch_size
    index.query_upload_dtype = "int8"
    index.query_batch_size = min(dt.pad_to(len(queries), 8), 8192)
    try:
        out, launches = launches_of(beam_step, lambda: window_sweep(
            index, queries, gt, INT8_WINDOWS))
    finally:
        index.query_upload_dtype = None
        index.query_batch_size = batch
    return {**out, "query_upload": "int8", "host_rerank": False,
            "beam_step_launches": launches}


def step_ivf(run: Run) -> dict:
    from ..index.ivf.clustering import Clustering
    from ..index.ivf.index import IVFIndex, save_packed_layout_host
    from ..index.ivf.params import IVFSearchParameters
    run.drop_index()
    ivf_dir = run.path("ivf")
    params = ivf_build_parameters(run.n)
    out = {"num_centroids": params.num_centroids,
           "training_fraction": params.training_fraction,
           "num_iterations": params.num_iterations}
    if not os.path.isdir(ivf_dir):
        rows, _ = run.rows()
        t0 = time.perf_counter()
        clustering = Clustering.build(params, rows, device=run.device)
        run.sync()
        out["train_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        save_packed_layout_host(ivf_dir + ".tmp", clustering, rows, "l2",
                                eltype="bfloat16")
        os.replace(ivf_dir + ".tmp", ivf_dir)
        out["pack_save_s"] = time.perf_counter() - t0
        out["largest_cluster"] = int(clustering.cluster_sizes().max())
        del clustering
        gc.collect()
    t0 = time.perf_counter()
    index = IVFIndex.assemble_from_file(ivf_dir, device=run.device)
    run.sync()
    out["assemble_s"] = time.perf_counter() - t0
    index.query_batch_size = max(index.query_batch_size,
                                 min(2500, run.n_queries))
    queries, gt = run.queries(), run.gt()
    recall = {}
    for probes in IVF_PROBES:
        sp = IVFSearchParameters(n_probes=probes, k_reorder=1)
        recall[probes] = recall_at_10(gt, index.search(queries, K, sp))
        if probes >= index.num_probe_units:
            break
    first = next((p for p in recall if recall[p] >= RECALL_TARGET), None)
    qps = None
    if first is not None:
        sp = IVFSearchParameters(n_probes=first, k_reorder=1)
        qps = median_qps(lambda q, k: index.search_async(q, k, sp), queries)
    layout_rows = int(index.ids_padded.numel())
    return {**out, "recall": {str(p): r for p, r in recall.items()},
            "first_n_probes": first, "qps": qps, "slot": index.slot,
            "probe_units": index.num_probe_units,
            "layout_rows": layout_rows, "padding": layout_rows / run.n,
            "layout_bytes": layout_rows * index.data.padded_dim * 2}


STEP_FUNCTIONS = {"data": step_data, "gt": step_gt, "build": step_build,
                  "f32": step_f32, "lvq8x8": step_lvq8x8,
                  "int8": step_int8, "ivf": step_ivf}
# what each step reads that another step writes
NEEDS = {"gt": ("queries.npy",), "build": (),
         "f32": ("index", "queries.npy", "gt.npy"),
         "lvq8x8": ("index", "queries.npy", "gt.npy"),
         "int8": ("index", "queries.npy", "gt.npy"),
         "ivf": ("queries.npy", "gt.npy"), "data": ()}


def run_step(run: Run, name: str) -> dict:
    """Run one step unless its ``<step>.json`` exists (then its kept line
    with ``"cached": true``, refused if it is of another configuration);
    print and keep the line."""
    from ..examples import card_line
    done = run.path(f"{name}.json")
    if os.path.exists(done):
        with open(done) as f:
            line = {**json.load(f), "cached": True}
        run.check(f"{name}.json", line)
        print(json.dumps(line), flush=True)
        return line
    missing = [p for p in NEEDS[name] if not os.path.exists(run.path(p))]
    if missing:
        raise RuntimeError(f"scale_10m {name}: run the steps that write "
                           f"{missing} first")
    if run.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(run.device)
    t0 = time.perf_counter()
    out = STEP_FUNCTIONS[name](run)
    run.sync()
    line = {"step": name, **out, "step_s": time.perf_counter() - t0,
            **run.config(),
            "peak_device_bytes": (torch.cuda.max_memory_allocated(run.device)
                                  if run.device.type == "cuda" else None),
            "host_peak_rss_bytes": resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss * 1024,
            "card": card_line() if run.device.type == "cuda" else None}
    print(json.dumps(line), flush=True)
    if out.get("done", True):
        with open(done + ".tmp", "w") as f:
            json.dump(line, f)
        os.replace(done + ".tmp", done)
    return line


def run(directory: str = ".bench10m", steps=STEPS, device="cuda",
        **kwargs) -> dict:
    """Run ``steps`` (in ``STEPS`` order) over ``directory``; returns each
    step's line.  A build stopped by its deadline ends the run there."""
    r = Run(directory, device=device, **kwargs)
    out = {}
    for name in STEPS:
        if name not in steps:
            continue
        out[name] = run_step(r, name)
        if not out[name].get("done", True):
            break
    return out


def prune_chunk_trial(directory: str, chunks=(4096, None),
                      segments: int = 4, segment_rounds: int = 250,
                      device="cuda", **kwargs) -> dict:
    """The build's first ``segments * segment_rounds`` rounds at each
    prune chunk of ``chunks`` (None: ``build_graph``'s default), one after
    the other in this process, each into ``<directory>/chunk_<c>``: the
    build line after every segment (seconds and rounds per second so
    far), and whether the graphs after the last segment are identical."""
    out, graphs = {}, {}
    for chunk in chunks:
        run_ = Run(os.path.join(directory, f"chunk_{chunk}"), device=device,
                   segment_rounds=segment_rounds, prune_chunk=chunk,
                   deadline=0.0, **kwargs)
        lines = [run_step(run_, "build") for _ in range(segments)]
        out[str(run_.prune_chunk)] = lines
        with open(run_.path("build_state", "state.json")) as f:
            state = json.load(f)
        graphs[run_.prune_chunk] = [
            np.load(run_.path("build_state", state[name]))
            for name in ("adjacency", "degrees")]
        del run_
        gc.collect()
    first, *rest = graphs.values()
    out["identical"] = all(np.array_equal(a, b) for other in rest
                           for a, b in zip(first, other))
    print(json.dumps({"prune_chunk_trial": out["identical"]}), flush=True)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    parser.add_argument("--dir", default=".bench10m",
                        help="cache directory (default .bench10m)")
    parser.add_argument("--step", action="append", choices=STEPS,
                        help="run only this step (repeatable; default all)")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda)")
    parser.add_argument("--deadline-s", type=float, default=None,
                        help="stop the build after the segment that ends "
                             "this many seconds after the start")
    args = parser.parse_args(argv)
    deadline = None if args.deadline_s is None else \
        time.time() + args.deadline_s
    run(args.dir, steps=args.step or STEPS, device=args.device,
        deadline=deadline)
    return 0


if __name__ == "__main__":
    sys.exit(main())
