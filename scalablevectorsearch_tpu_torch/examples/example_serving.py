"""Serving-throughput example: pipelined searches, packed neighborhoods,
half-width uploads, latency percentiles.

Counterpart of the JAX package's ``examples/example_serving.py``.  The
reference saturates serving QPS with a threadpool of concurrent searches
(include/svs/index/vamana/index.h:556-603); here several whole search
calls stay in flight with ``search_async``, so that the host's work for
call N+1 overlaps call N on the card.  Times are the host's clock.  Run
on the card:

    python -m scalablevectorsearch_tpu_torch.examples.example_serving
"""

from __future__ import annotations

import time

import numpy as np

import scalablevectorsearch_tpu_torch as svt
from scalablevectorsearch_tpu_torch.examples import card_line, on_device


def run(device="cuda", n: int = 50_000, n_queries: int = 2000,
        dim: int = 128, reps: int = 4) -> dict:
    """Recall@10 at window 12, QPS of ``reps`` blocking and ``reps``
    pipelined searches, and p50 / p95 of 8 searches of one query batch."""
    device = on_device(device)
    data, queries = svt.generate_test_dataset(n, n_queries, dim, seed=9)
    gt = svt.exhaustive_search(data, queries, 10, device=device)

    params = svt.VamanaBuildParameters(
        alpha=1.1, graph_max_degree=32, window_size=100,
        max_candidate_pool_size=300, prune_to=28)
    # sampled_entries: build searches start inside each node's region; the
    # entry sampler is then enabled for serving (per-query entries from a
    # resident sample, entry.py)
    index = svt.Vamana.build(params, data, svt.L2, sampled_entries=True,
                             device=device)

    # packed neighborhoods: one super-row per expanded node holds the
    # neighbours' rows, so serving gathers r-fold fewer, larger rows
    index.enable_packed_serving()
    # sampled entries roughly halve the equal-recall window (24 -> 12)
    index.search_window_size = 12

    res = index.search(queries, 10)  # warm up
    out = {"recall": svt.k_recall_at_n(gt, res)}

    # --- blocking serving loop (one search at a time) -----------------------
    t0 = time.perf_counter()
    for _ in range(reps):
        index.search(queries, 10)
    out["qps_blocking"] = len(queries) * reps / (time.perf_counter() - t0)

    # --- pipelined serving loop (several searches in flight) ----------------
    t0 = time.perf_counter()
    handles = [index.search_async(queries, 10) for _ in range(reps)]
    results = [h.result() for h in handles]
    out["qps_pipelined"] = len(queries) * reps / (time.perf_counter() - t0)
    assert all(np.array_equal(r.ids, res.ids)     # identical answers
               for r in results)

    # --- per-batch latency distribution -------------------------------------
    qb = index.index.query_batch_size
    index.search(queries[:qb], 10)  # warm this exact batch shape
    lat = []
    for _ in range(8):
        t1 = time.perf_counter()
        index.search(queries[:qb], 10)
        lat.append((time.perf_counter() - t1) * 1e3)
    out.update(batch_queries=qb,
               p50_ms=float(np.percentile(lat, 50)),
               p95_ms=float(np.percentile(lat, 95)))
    return out


def main():
    out = run()
    print(f"card: {card_line()}")
    print(f"recall@10={out['recall']:.4f}  "
          f"blocking={out['qps_blocking']:.0f} qps  "
          f"pipelined={out['qps_pipelined']:.0f} qps")
    print(f"batch latency ({out['batch_queries']} queries): "
          f"p50={out['p50_ms']:.1f} ms  p95={out['p95_ms']:.1f} ms")


if __name__ == "__main__":
    main()
