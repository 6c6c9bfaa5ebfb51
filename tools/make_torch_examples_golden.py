"""Write data/golden/torch_examples_reference.json with the JAX package.

Runs the six examples of ``examples/`` unchanged, each in a child process
on the CPU (``JAX_PLATFORMS=cpu``; the multi-chip one over eight virtual
devices, ``--xla_force_host_platform_device_count=8``), one after the
other, and parses the lines they print into the numbers that the port's
examples (``scalablevectorsearch_tpu_torch/examples``) return from
``run()``, under the same keys:

- ``vamana``: recall@10 per window (10 / 20 / 30 / 40) and the window
  ``calibrate`` picks for recall 0.95;
- ``compression``: recall@10 at window 40 of the f32, SQ-int8, LVQ-8 and
  LeanVec indexes;
- ``dynamic``: the two printed sizes and the recall after consolidate and
  compact;
- ``ivf``: the cluster count, the largest cluster, recall@10 at n_probes
  2 / 8 / 32 and of the LVQ postings with the rerank;
- ``serving``: recall@10 (the example's QPS and latencies are not kept);
- ``multichip``: the recall of its five parts.

The file holds recall, sizes and the calibrated window, never a time.
``chip_smoke.py::phase_examples`` holds the port's examples on the GPU to
it.  Run from the repository root (934 s on eight CPU cores):

    python3 tools/make_torch_examples_golden.py [OUT.json]
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(HERE, "data", "golden", "torch_examples_reference.json")
NAMES = ("vamana", "compression", "dynamic", "ivf", "serving", "multichip")
NUM = r"([0-9]+(?:\.[0-9]+)?)"


def parse(name: str, text: str) -> dict:
    """The numbers of one example's printed lines, by the keys of the
    port's ``run()``."""
    def one(pattern, cast=float):
        found = re.search(pattern, text)
        if found is None:
            raise ValueError(f"{name}: no line matches {pattern!r}")
        return cast(found.group(1))

    if name == "vamana":
        return {"recall": {w: float(r) for w, r in re.findall(
                    r"window=\s*(\d+)\s+recall@10=" + NUM, text)},
                "calibrated_window": one(r"recall>=0\.95: (\d+)", int)}
    if name == "compression":
        return {key: one(label + r".*recall@10=" + NUM) for key, label in (
            ("float32", r"float32 \(uncompressed\)"),
            ("sq_int8", r"SQ int8"), ("lvq8", r"LVQ int8"),
            ("leanvec", r"LeanVec 128->64"))}
    if name == "dynamic":
        return {"initial_size": one(r"initial size: (\d+)", int),
                "size_after_add_delete": one(r"after add\+delete: (\d+)",
                                             int),
                "recall": one(r"post-consolidate recall@10: " + NUM)}
    if name == "ivf":
        return {"clusters": one(r"clusters: (\d+)", int),
                "max_size": one(r"max size: (\d+)", int),
                "recall": {p: float(r) for p, r in re.findall(
                    r"n_probes=\s*(\d+)\s+recall@10=" + NUM, text)},
                "lvq_rerank": one(r"LVQ postings \+ rerank recall@10: "
                                  + NUM)}
    if name == "serving":
        return {"recall": one(r"recall@10=" + NUM)}
    if name == "multichip":
        return {key: one(pattern + r".*recall@10[^:]*: " + NUM)
                for key, pattern in (
                    ("flat", r"sharded flat"), ("ivf", r"sharded IVF"),
                    ("dp_vamana", r"query-parallel vamana"),
                    ("sharded_lvq8", r"sharded-graph vamana over sharded"),
                    ("sharded_dynamic", r"sharded dynamic vamana"))}
    raise ValueError(name)


def run_example(name: str) -> tuple:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    if name == "multichip":
        env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " --xla_force_host_"
                            "platform_device_count=8").strip()
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "examples", f"example_{name}.py")],
        cwd=HERE, env=env, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"example_{name}.py exited {proc.returncode}:\n"
                           f"{proc.stderr[-4000:]}")
    return proc.stdout, time.perf_counter() - t0


def main(argv: list) -> int:
    out_path = argv[0] if argv else OUT
    examples = {}
    for name in NAMES:
        text, seconds = run_example(name)
        examples[name] = parse(name, text)
        print(f"example_{name}: {seconds:.0f} s; {examples[name]}",
              file=sys.stderr, flush=True)
    with open(out_path, "w") as f:
        json.dump({"generated_by": "tools/make_torch_examples_golden.py",
                   "source": "examples/example_*.py, unchanged, JAX on the "
                             "CPU (multichip: 8 virtual devices)",
                   "examples": examples}, f, indent=2)
        f.write("\n")
    print(f"wrote {out_path}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
