"""Vamana through the port's public entry point ``Vamana``: the library
build (``Vamana.build``, sampled entries), packed serving rows where the
configuration asks for them, and the fixed search window."""

from __future__ import annotations

import time

import torch

from . import sync


def build(config: dict, rows: torch.Tensor, device) -> tuple:
    """``(index, facts)``: the served index over ``rows`` and what the
    metrics may read of it (``build_s``: host clock around the build,
    ending in a device synchronise)."""
    import scalablevectorsearch_tpu_torch as svt
    spec = config["index"]
    b = spec["build"]
    params = svt.VamanaBuildParameters(
        alpha=b["alpha"], graph_max_degree=b["graph_max_degree"],
        window_size=b["window_size"],
        max_candidate_pool_size=b["max_candidate_pool_size"],
        prune_to=b["prune_to"])
    sync(device)
    t0 = time.perf_counter()
    index = svt.Vamana.build(params, rows, config["metric"],
                             sampled_entries=b["sampled_entries"],
                             device=device)
    sync(device)
    build_s = time.perf_counter() - t0
    packed = spec["serving"].get("packed_rows")
    if packed:
        index.enable_packed_serving(getattr(torch, packed))
    configure(index, spec["search"])
    return index, {"kind": "vamana", "build_s": build_s,
                   "window": index.search_window_size,
                   "mean_degree": float(index.index.graph.mean_degree())}


def configure(index, search: dict) -> None:
    index.search_window_size = int(search["window"])
