"""Tiny cells for the CPU tests: the benchmark's own configurations and
traffic mixes with their scale cut so that a whole run takes seconds on
the CPU; every width (128 and 96 columns) stays."""

from __future__ import annotations

import json
from pathlib import Path

from annbench import harness

ROOT = Path(harness.__file__).resolve().parents[1]


def bench() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def cell(name: str, n: int = 1200, pool: int = 240, per_call: int = 60):
    """``(config, traffic)`` of the cell ``name`` at ``n`` rows, a pool of
    ``pool`` queries and calls of ``per_call`` (single-query mixes keep
    theirs); the Vamana build at a narrower window and IVF at 16
    centroids, so that the CPU builds in seconds."""
    w = {x["name"]: x for x in bench()["workloads"]}[name]
    config = harness.load_json("configs", w["config"])
    traffic = harness.load_json("traffic", w["traffic"])
    config.update(n=n, pool=pool)
    build = config["index"]["build"]
    if config["index"]["kind"] == "vamana":
        build.update(graph_max_degree=16, window_size=24,
                     max_candidate_pool_size=48, prune_to=16)
    else:
        build.update(num_centroids=16, training_fraction=1.0,
                     minibatch_size=n)
        config["index"]["search"]["n_probes"] = 4
    if traffic["queries_per_call"] > 1:
        traffic["queries_per_call"] = per_call
    traffic["warmup_calls"] = 1
    return config, traffic


def run(name: str, section: str = "end_to_end", seconds: float = 0.3,
        seed: int = 2 ** 31 + 11, **sizes) -> dict:
    config, traffic = cell(name, **sizes)
    metrics = harness.cell_metrics(bench(), name, section)
    return harness.run(config, traffic, metrics, seed=seed, seconds=seconds,
                       traced=section == "per_layer", device="cpu")
