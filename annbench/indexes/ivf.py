"""IVF through the port's public entry point ``IVF``: ``IVF.build`` in
process (k-means on the device, the padded posting layout packed on the
host and uploaded in the rows' own type) and the fixed ``n_probes``."""

from __future__ import annotations

import time

import torch

from . import sync


def build(config: dict, rows: torch.Tensor, device) -> tuple:
    """``(index, facts)``, as ``vamana.build``; the facts add the layout's
    slot (rows per probe unit, padding included) and probe units."""
    import scalablevectorsearch_tpu_torch as svt
    spec = config["index"]
    b = spec["build"]
    params = svt.IVFBuildParameters(
        num_centroids=b["num_centroids"], minibatch_size=b["minibatch_size"],
        num_iterations=b["num_iterations"],
        is_hierarchical=b["is_hierarchical"],
        training_fraction=b["training_fraction"])
    host = rows.cpu().numpy()        # the build takes host rows
    sync(device)
    t0 = time.perf_counter()
    index = svt.IVF.build(params, host, config["metric"], device=device)
    sync(device)
    build_s = time.perf_counter() - t0
    configure(index, spec["search"])
    return index, {"kind": "ivf", "build_s": build_s,
                   "n_probes": index.n_probes, "slot": index.index.slot,
                   "probe_units": index.index.num_probe_units,
                   "layout_rows": int(index.index.ids_padded.numel())}


def configure(index, search: dict) -> None:
    import scalablevectorsearch_tpu_torch as svt
    index.search_parameters = svt.IVFSearchParameters(
        n_probes=int(search["n_probes"]),
        k_reorder=int(search.get("k_reorder", 1)))
