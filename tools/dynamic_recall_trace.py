"""Trace a dynamic Vamana index's recall through its mutations.

Runs one sequence of add / delete / consolidate / compact calls through
either package on the CPU and prints, after the build and after every
step, recall@10 at windows 40 and 100 against the exact search over the
live rows, the mean degree of the valid rows, the edges that point at
deleted rows, how many valid rows the entry point reaches, and the entry
point (slot and external id).  Neither package is changed.

Scales:
- ``example``: ``examples/example_dynamic.py``: 8,000 x 64 rows (seed 7),
  200 queries, R 32 and window 64; build over 6,000 rows, add 1,000,
  delete ids 0-499, consolidate, compact;
- ``job``: the ``vamana_dynamic`` job of ``chip_smoke.py``'s tools phase:
  20,000 x 128 rows (seed 42), 1,000 queries, the main path's build
  parameters; two cycles of deleting 2,000 random live ids, adding their
  rows back under new ids, consolidate and compact (the runner's draws).

``--repair`` (the port only) replaces the port's ``consolidate_round``
for this run with a copy (:func:`repair_round`) that re-prunes every
affected vertex from a wider candidate set.  ``uncapped``: the same
candidates (its alive neighbours and the alive neighbours of its deleted
neighbours), all of them pruned, where consolidate keeps the 4R nearest;
``wide``: the alive neighbours of all its neighbours too, all pruned.  It
tests whether the candidates that consolidate keeps are what loses
recall.

    python3 tools/dynamic_recall_trace.py --package jax --scale example
    python3 tools/dynamic_recall_trace.py --package torch --scale job \\
        [--repair {uncapped,wide}] [--device cpu]

On eight CPU cores the example scale takes about a minute, the job scale
about four; ``--repair uncapped`` at the job scale took 46 minutes on
four.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WINDOWS = (40, 100)
SLOT_VALID, SLOT_DELETED = 1, 2
MAIN_BUILD = dict(alpha=1.1, graph_max_degree=32, window_size=100,
                  max_candidate_pool_size=300, prune_to=28)


def package(name: str, device: str):
    """(the package's namespace, a constructor of MutableVamanaIndex)."""
    sys.path.insert(0, HERE)
    if name == "jax":
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        import scalablevectorsearch_tpu as svt
        from scalablevectorsearch_tpu.index.vamana.dynamic import (
            MutableVamanaIndex)

        def make(params, data, ids):
            return MutableVamanaIndex(params, data, ids, "l2")

        def exact(x, q, k):
            return svt.exhaustive_search(x, q, k)
    else:
        import scalablevectorsearch_tpu_torch as svt

        def make(params, data, ids):
            return svt.MutableVamanaIndex(params, data, ids, "l2",
                                          device=device)

        def exact(x, q, k):
            return svt.exhaustive_search(x, q, k, device=device)
    return svt, make, exact


def repair_round(graph, data, node_ids, node_valid, deleted_mask, *,
                 prune_to, alpha, distance, max_degree, prune_chunk, pool_cap,
                 wide: bool):
    """The port's ``consolidate_round`` with every candidate pruned
    (``pool_cap`` is ignored) and, where ``wide``, the second hop taken
    through every neighbour, not only the deleted ones."""
    import torch
    from scalablevectorsearch_tpu_torch.index.vamana import build as bmod
    from scalablevectorsearch_tpu_torch.ops import topk as topk_ops
    r = graph.max_degree
    b = node_ids.shape[0]
    cap = deleted_mask.shape[0]
    adj = graph.neighbors(node_ids.clamp_min(0))
    adj_deleted = deleted_mask[adj.clamp(0, cap - 1)] & (adj >= 0)
    hop2 = graph.neighbors(adj.clamp_min(0).reshape(-1)).reshape(b, r * r)
    through = (adj >= 0) if wide else adj_deleted
    hop2 = torch.where(through.repeat_interleave(r, dim=1), hop2, -1)
    cand = torch.cat([adj, hop2], dim=1)
    cand_deleted = deleted_mask[cand.clamp(0, cap - 1)]
    cand = torch.where(cand_deleted | (cand < 0) | (cand == node_ids[:, None]),
                       -1, cand)
    keys = bmod._score_against(data, distance, data.get(node_ids),
                               data.norms_of(node_ids), cand)
    keys = topk_ops.mask_first_duplicates(keys, cand)
    keys = torch.where(node_valid[:, None], keys, float("inf"))
    keys, cand = topk_ops.smallest_k(keys, cand, cand.shape[1])
    rows, degs = bmod._prune_pools(data, cand, keys, node_ids, alpha,
                                   prune_to, distance, prune_chunk)
    commit = torch.where(node_valid, node_ids, graph.capacity)
    return graph.replace_rows(commit, bmod._pad_cols(rows, max_degree),
                              degs)


def host(x) -> np.ndarray:
    """A device array of either package on the host."""
    if type(x).__module__.startswith("torch"):
        return x.cpu().numpy()
    return np.asarray(x)


def graph_stats(index) -> dict:
    """Mean degree of valid rows, edges into deleted rows, valid rows the
    entry point reaches (through valid and deleted rows, as a search
    walks), the entry point."""
    adj, deg = host(index.graph.adjacency), host(index.graph.degrees)
    status = np.asarray(index.status)
    n = min(adj.shape[0], status.shape[0])
    adj, deg, status = adj[:n], deg[:n], status[:n]
    valid = status == SLOT_VALID
    walkable = valid | (status == SLOT_DELETED)
    edges = adj[walkable]
    into_deleted = int((status[edges[edges >= 0]] == SLOT_DELETED).sum())
    seen = np.zeros(n, dtype=bool)
    frontier = np.asarray([index.entry_point])
    seen[frontier] = True
    while frontier.size:
        nxt = adj[frontier].ravel()
        nxt = np.unique(nxt[nxt >= 0])
        nxt = nxt[walkable[nxt] & ~seen[nxt]]
        seen[nxt] = True
        frontier = nxt
    entry_ext = int(np.asarray(index.translator.to_external(
        np.asarray([index.entry_point])))[0])
    return {"mean_degree": float(deg[valid].mean()),
            "edges_into_deleted": into_deleted,
            "reached": f"{int((seen & valid).sum())}/{int(valid.sum())}",
            "entry": f"{index.entry_point} (id {entry_ext})"}


def trace(pkg: str, scale: str, device: str, repair: str) -> list:
    svt, make, exact = package(pkg, device)
    if repair != "none":
        if pkg != "torch":
            raise SystemExit("--repair exists for the port only")
        import functools
        from scalablevectorsearch_tpu_torch.index.vamana import dynamic
        dynamic.consolidate_round = functools.partial(
            repair_round, wide=repair == "wide")
    if scale == "example":
        data, queries = svt.generate_test_dataset(8_000, 200, 64, seed=7)
        params = svt.VamanaBuildParameters(graph_max_degree=32,
                                           window_size=64)
        n0 = 6000
    else:
        data, queries = svt.generate_test_dataset(20_000, 1000, 128,
                                                  seed=42)
        params = svt.VamanaBuildParameters(**MAIN_BUILD)
        n0 = 20_000
    live = dict(zip(range(n0), range(n0)))          # external id -> row
    t0 = time.perf_counter()
    index = make(params, data[:n0], np.arange(n0))
    rows = []

    def record(step):
        ext = np.fromiter(live.keys(), dtype=np.int64, count=len(live))
        rows_live = np.asarray([live[int(e)] for e in ext])
        gt = ext[exact(data[rows_live], queries, 10).ids]
        row = {"step": step, "size": index.size}
        for w in WINDOWS:
            index.search_window_size = w
            row[f"w{w}"] = svt.k_recall_at_n(gt, index.search(queries, 10))
        row.update(graph_stats(index))
        row["seconds"] = round(time.perf_counter() - t0, 1)
        rows.append(row)
        print(" | ".join(f"{k} {v:.4f}" if isinstance(v, float)
                         and k.startswith("w") else f"{k} {v}"
                         for k, v in row.items()), flush=True)

    record("build")
    if scale == "example":
        index.add_points(data[6000:7000], np.arange(6000, 7000))
        live.update(zip(range(6000, 7000), range(6000, 7000)))
        record("add 1000")
        index.delete_points(np.arange(0, 500))
        for e in range(500):
            del live[e]
        record("delete 500")
        index.consolidate()
        record("consolidate")
        index.compact()
        record("compact")
        return rows
    rng = np.random.default_rng(0)                  # the runner's draws
    next_id, per_cycle = n0, n0 // 10
    for c in range(2):
        ext = np.fromiter(live.keys(), dtype=np.int64, count=len(live))
        victims = rng.choice(ext, size=per_cycle, replace=False)
        moved = np.asarray([live.pop(int(v)) for v in victims])
        index.delete_points(victims)
        record(f"cycle {c + 1} delete {per_cycle}")
        new_ids = np.arange(next_id, next_id + per_cycle)
        next_id += per_cycle
        index.add_points(data[moved], new_ids)
        live.update(zip(new_ids.tolist(), moved.tolist()))
        record(f"cycle {c + 1} add {per_cycle}")
        index.consolidate()
        record(f"cycle {c + 1} consolidate")
        index.compact()
        record(f"cycle {c + 1} compact")
    return rows


def main(argv: list) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=("jax", "torch"), required=True)
    ap.add_argument("--scale", choices=("example", "job"), required=True)
    ap.add_argument("--repair", choices=("none", "uncapped", "wide"),
                    default="none")
    ap.add_argument("--device", default="cpu",
                    help="the port's device (default cpu)")
    args = ap.parse_args(argv)
    if args.package == "torch":
        import torch
        torch.set_num_threads(min(8, os.cpu_count() or 1))
    trace(args.package, args.scale, args.device, args.repair)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
