"""What the benchmark takes from the program: the package itself, from
the checkout the benchmark runs in, and its kernels' launch counters."""

from __future__ import annotations

import importlib
from pathlib import Path

PACKAGE = "scalablevectorsearch_tpu_torch"
ROOT = Path(__file__).resolve().parents[1]
# the port's launch counters: (module, function whose ``launches`` counts)
COUNTERS = {
    "beam_step": ("ops.kernels.beam_step", "beam_step"),
    "beam_step_lvq": ("ops.kernels.beam_step", "beam_step_lvq"),
    "beam_update": ("ops.kernels.beam_update", "beam_update"),
    "score_rows": ("ops.kernels.gather_distance", "score_rows"),
    "gather_score_l2_partial": ("ops.kernels.gather_distance",
                                "gather_score_l2_partial"),
}


def import_program():
    """The port's package, which has to be the checkout's own."""
    module = importlib.import_module(PACKAGE)
    where = Path(module.__file__).resolve()
    if ROOT not in where.parents:
        raise ImportError(f"{PACKAGE} was imported from {where}, not from "
                          f"the checkout at {ROOT}")
    return module


def launch_counts() -> dict:
    """``{counter: launches so far}`` for each of the port's kernels."""
    out = {}
    for name, (module, function) in COUNTERS.items():
        mod = importlib.import_module(f"{PACKAGE}.{module}")
        out[name] = getattr(mod, function).launches
    return out
