"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python3 annbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The last line of standard output is one JSON object: ``correct``,
``attempted`` and ``failed`` (queries sent in the window, and those whose
answer had a bad slot), ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``check``: each number compared with its limit,
which also end standard error.  Without a CUDA device, or with fewer than
the cell asks for, the run exits 1 and prints no result; so it does when a
module of the JAX package, JAX itself or Flax is loaded once the window
has closed.  The program is imported from the checkout this file is in.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# import the benchmark as the package ``annbench`` from the checkout's
# root, never its modules by their bare names from its own folder
sys.path[0] = str(ROOT)

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "scalablevectorsearch_tpu"}


def log(msg: str) -> None:
    print(f"annbench: {msg}", file=sys.stderr, flush=True)


def fail(msg: str) -> int:
    log(msg)
    return 1


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def result_line(bench: dict, cell: dict, record: dict, metrics: list,
                trace: int) -> dict:
    import torch
    out = {"correct": record["check"]["correct"],
           "attempted": sum(record["queries_per_call"]),
           "failed": record["check"]["failed"],
           "metrics": {m["name"]: {"value": record["values"][m["name"]],
                                   "unit": m["unit"]}
                       for m in metrics
                       if record["values"][m["name"]] is not None},
           "device": {"platform": "gpu",
                      "kind": torch.cuda.get_device_name(0),
                      "count": cell["chips"],
                      "memory_peak_bytes": record["memory_peak_bytes"]}}
    if trace:
        idle = record["idle"]
        out["device"]["busy_s"] = idle["busy_s"]
        out["device"]["window_s"] = idle["window_s"]
        out["breakdown"] = {"device_ops": idle["top_ops"],
                            "idle_gaps": idle["idle_gaps"]}
    check = record["check"]
    out["check"] = {name: {"value": value, "limit": check["limits"][name]}
                    for name, value in check["numbers"].items()}
    return out


def main(argv=None) -> int:
    args = parse(argv)
    bench_path = ROOT / "BENCHMARK.json"
    with open(bench_path) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        return fail(f"no workload {args.workload!r} in {bench_path}")
    cell = cells[args.workload]
    from annbench import harness, program
    config = harness.load_json("configs", cell["config"])
    traffic = harness.load_json("traffic", cell["traffic"])
    # the program's options as the configuration states them, before the
    # program is imported (it reads them then)
    os.environ.update(config.get("program_env", {}))
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        return fail(f"{args.workload} needs {cell['chips']} CUDA device(s); "
                    f"this machine has "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    program.import_program()
    section = "per_layer" if args.trace else "end_to_end"
    metrics = harness.cell_metrics(bench, args.workload, section)
    record = harness.run(config, traffic, metrics, seed=args.seed,
                         seconds=args.seconds, traced=bool(args.trace),
                         device="cuda", started=STARTED, log=log)
    loaded = sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    if loaded:
        return fail(f"modules loaded that the port may not use: {loaded}")
    missing = [m["name"] for m in metrics
               if record["values"][m["name"]] is None]
    if missing:
        log(f"metrics with nothing to read in this run: {missing}")
    out = result_line(bench, cell, record, metrics, args.trace)
    print(json.dumps(out), flush=True)
    for name, entry in out["check"].items():
        log(f"check {name} {entry['value']!r} limit {entry['limit']!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
