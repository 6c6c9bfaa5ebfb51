"""The control of a cell's ``correct``: the plain reference put in the
program's place, computed one precision below the configuration's, which
has to come out not correct.

    python3 annbench/control.py --workload <cell> --seeds 1,2,3 \\
        --seconds <s>

Each seed is run in this process as ``run.py`` runs it, with its data,
its traffic, its window and its check, but every call is answered by the
exact search of ``reference.py`` at the configuration's
``control.precision`` (``tf32`` for float32 rows scored with TF32 off).
One JSON line per seed: ``correct`` and each number compared with its
limit.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


class Answered:
    """A call already answered, in the shape ``PendingSearch.result()``
    gives: ``result()`` returns it, with ``ids`` and ``distances``."""

    def __init__(self, ids, distances):
        self.ids, self.distances = ids, distances

    def result(self):
        return self


class ReferenceIndex:
    """The exact search over the cell's rows at ``precision``."""

    def __init__(self, rows, precision: str):
        self.rows, self.precision = rows, precision

    def search_async(self, queries, k: int) -> Answered:
        import numpy as np
        import torch
        from annbench import reference
        q = torch.from_numpy(np.asarray(queries, np.float32)).to(
            self.rows.device)
        ids, dist = reference.exact_knn(self.rows, q, k, self.precision)
        return Answered(ids.cpu().numpy(), dist.float().cpu().numpy())


def build(config: dict, rows, device) -> tuple:
    """The control in the program's place: ``harness.run``'s ``build``."""
    precision = config["control"]["precision"]
    return ReferenceIndex(rows, precision), {"kind": "reference",
                                             "precision": precision}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    from annbench import harness, program
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    cell = {w["name"]: w for w in bench["workloads"]}[args.workload]
    config = harness.load_json("configs", cell["config"])
    traffic = harness.load_json("traffic", cell["traffic"])
    os.environ.update(config.get("program_env", {}))
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 1
    program.import_program()
    for seed in (int(s) for s in args.seeds.split(",")):
        record = harness.run(config, traffic, [], seed=seed,
                             seconds=args.seconds, traced=False,
                             device="cuda", build=build)
        check = record["check"]
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": config["control"]["precision"],
                          "correct": check["correct"],
                          "numbers": check["numbers"],
                          "limits": check["limits"],
                          "recall_at_10": check["recall_at_10"],
                          "calls": len(record["calls"])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)        # the package ``annbench``, not its files
    sys.exit(main())
