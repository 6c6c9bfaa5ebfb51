"""The one-time sweep that fixes a configuration's search parameter.

    python3 annbench/sweep.py --config <name> --param <key> \\
        --values 10,11,12 --seeds 1,2,3 [--per-call 2000]

For each seed: the configuration's rows and query pool drawn as a run
draws them, the exact top-k of the pool by the plain reference, the index
built by its kind's module, and for each value of ``index.search[param]``
the recall@k of the whole pool served in calls of ``per-call`` queries.
One JSON line per seed.  It measures recall only, never speed.
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import time  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", required=True)
    p.add_argument("--param", required=True)
    p.add_argument("--values", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--per-call", type=int, default=2000)
    args = p.parse_args(argv)
    from annbench import data, harness, program, reference
    config = harness.load_json("configs", args.config)
    os.environ.update(config.get("program_env", {}))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 1
    program.import_program()
    kind = harness.load_index_kind(config["index"]["kind"])
    k = int(config["k"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        rows, pool = data.make(config["data"], config["n"], config["pool"],
                               config["dim"], seed, "cuda")
        truth = reference.exact_knn(rows, pool, k)[0].cpu().numpy()
        pool_host = pool.cpu().numpy()
        del pool
        index, facts = kind.build(config, rows, "cuda")
        del rows
        harness.free("cuda")
        recall = {}
        for value in args.values.split(","):
            kind.configure(index, {**config["index"]["search"],
                                   args.param: int(value)})
            hits = 0
            for s in range(0, len(pool_host), args.per_call):
                ids = index.search(pool_host[s:s + args.per_call], k).ids
                hits += sum(len(np.intersect1d(a, b)) for a, b in
                            zip(ids, truth[s:s + args.per_call]))
            recall[value] = hits / (len(pool_host) * k)
        print(json.dumps({"config": args.config, "seed": seed,
                          "param": args.param, "recall": recall,
                          "facts": facts,
                          "seconds": time.perf_counter() - t0}), flush=True)
        del index
        harness.free("cuda")
    return 0


if __name__ == "__main__":
    sys.exit(main())
