"""Spread of the port's IVF golden rows over k-means++ generator seeds.

The port draws its k-means++ seeding from a ``torch.Generator`` where the
JAX package draws from ``jax.random``, so its IVF recall rows
(``data/golden/ivf_reference.json``, written by the JAX package) can only
agree within the spread those draws cause.  This script recomputes every
row as ``benchmark/runner.py`` builds it (10k x 128, seed 1234, 100
centroids, hierarchical, 10 iterations; recall@10 at n_probes 1, 4, 16, 32)
with the generator's seed XORed by 0, 1, 2, 3 and 4 (0 is what the port
draws; every numpy generator stays the JAX package's), and prints each
row, its difference from the reference and the largest difference per
row over the seeds.  On the CPU (a few seconds per seed):

    python3 tools/ivf_golden_spread.py [--device cpu] [--seeds 5]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

GOLDEN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "data", "golden", "ivf_reference.json")


def main(argv: list) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cpu")
    parser.add_argument("--seeds", type=int, default=5)
    args = parser.parse_args(argv)
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    import scalablevectorsearch_tpu_torch as svt
    from scalablevectorsearch_tpu_torch.index.ivf import kmeans
    with open(GOLDEN) as f:
        golden = json.load(f)
    spec, k = golden["dataset"], golden["num_neighbors"]
    data, queries = svt.generate_test_dataset(
        spec["n"], spec["n_queries"], spec["dim"], seed=spec["seed"])
    truth = {e["distance"]: svt.exhaustive_search(
        data, queries, k, e["distance"], device=args.device)
        for e in golden["expected"]}
    draw = kmeans._kmeanspp_init
    worst = {}
    for offset in range(args.seeds):
        kmeans._kmeanspp_init = (
            lambda x, seed, n, o=offset: draw(x, int(seed) ^ o, n))
        for entry in golden["expected"]:
            distance, bp = entry["distance"], entry["build_parameters"]
            index = svt.IVF.build(svt.IVFBuildParameters(
                num_centroids=bp["num_centroids"],
                is_hierarchical=bp["is_hierarchical"], num_iterations=10),
                data, distance, device=args.device).index
            cells = []
            for probes, want in entry["recalls"].items():
                got = svt.k_recall_at_n(truth[distance], index.search(
                    queries, k, svt.IVFSearchParameters(n_probes=int(probes))))
                key = (distance, probes)
                worst[key] = max(worst.get(key, 0.0), abs(got - want))
                cells.append(f"{probes}:{got:.4f}({got - want:+.4f})")
            print(f"seed ^ {offset} {distance}: " + " ".join(cells),
                  flush=True)
    kmeans._kmeanspp_init = draw
    print("largest |port - reference| over the seeds: " + ", ".join(
        f"{d} n_probes {p}: {v:.4f}" for (d, p), v in worst.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
