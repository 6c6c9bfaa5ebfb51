"""Write data/golden/torch_kinds_reference.json with the JAX package.

Golden recall rows for four dataset kinds over the setup of
``data/golden/vamana_reference.json``: 10,000 x 128 rows and 500 queries of
``generate_test_dataset`` (seed 1234), k 10, L2, that file's L2 build
parameters, windows 10 / 20 / 30 / 40.  Each row builds one Vamana index
with the JAX package over one kind of dataset and measures recall@10
against the exact search over the f32 rows:

- ``bf16``: bfloat16 rows (``VectorDataset.from_array(..., dtype=bf16)``);
- ``sq_int8``: ``SQDataset.compress`` (one global int8 scale);
- ``lvq8``: ``LVQDataset.compress(bits=8)``;
- ``lvq8x8``: ``LVQDataset.compress(bits=8, residual_bits=8)``: the build
  runs over the full reconstruction, serving traverses the primary level
  and reranks the retained beam with both levels.

The file has the schema of ``vamana_reference.json`` with one more key per
row, ``dataset_kind``.  ``chip_smoke.py::phase_golden`` holds the port's
build and search of each row on the GPU to it.  Run on the CPU from the
repository root (about ten minutes on eight cores):

    JAX_PLATFORMS=cpu python3 tools/make_torch_kinds_golden.py [OUT.json]
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = os.path.join(HERE, "data", "golden", "vamana_reference.json")
OUT = os.path.join(HERE, "data", "golden", "torch_kinds_reference.json")
KINDS = ("bf16", "sq_int8", "lvq8", "lvq8x8")
BUILD_KEYS = ("alpha", "graph_max_degree", "window_size",
              "max_candidate_pool_size", "prune_to")


def dataset_of(kind: str, data: np.ndarray):
    import jax.numpy as jnp
    from scalablevectorsearch_tpu.core.data import VectorDataset
    from scalablevectorsearch_tpu.quantization.lvq import LVQDataset
    from scalablevectorsearch_tpu.quantization.scalar import SQDataset
    if kind == "bf16":
        return VectorDataset.from_array(data, dtype=jnp.bfloat16)
    if kind == "sq_int8":
        return SQDataset.compress(data)
    if kind == "lvq8":
        return LVQDataset.compress(data, bits=8)
    if kind == "lvq8x8":
        return LVQDataset.compress(data, bits=8, residual_bits=8)
    raise ValueError(kind)


def main(argv: list) -> int:
    sys.path.insert(0, HERE)
    from scalablevectorsearch_tpu.core.io import generate_test_dataset
    from scalablevectorsearch_tpu.core.recall import k_recall_at_n
    from scalablevectorsearch_tpu.index.flat import exhaustive_search
    from scalablevectorsearch_tpu.index.vamana.index import VamanaIndex
    from scalablevectorsearch_tpu.index.vamana.params import (
        VamanaBuildParameters)
    out_path = argv[0] if argv else OUT
    with open(REFERENCE) as f:
        reference = json.load(f)
    spec, k = reference["dataset"], reference["num_neighbors"]
    l2 = next(e for e in reference["expected"] if e["distance"] == "L2")
    windows = [int(w) for w in l2["recalls"]]
    data, queries = generate_test_dataset(
        spec["n"], spec["n_queries"], spec["dim"], seed=spec["seed"])
    gt = exhaustive_search(data, queries, k, distance="L2")
    params = VamanaBuildParameters(**{key: l2["build_parameters"][key]
                                      for key in BUILD_KEYS})
    expected = []
    for kind in KINDS:
        index = VamanaIndex.build(params, dataset_of(kind, data), "L2")
        recalls = {}
        for window in windows:
            index.search_window_size = window
            recalls[str(window)] = round(
                k_recall_at_n(gt, index.search(queries, k)), 5)
        print(kind, recalls, flush=True)
        expected.append({"distance": "L2", "dataset_kind": kind,
                         "build_parameters": params.resolved("L2").__dict__,
                         "recalls": recalls})
    out = {"schema": reference["schema"], "version": reference["version"],
           "num_neighbors": k, "dataset": spec, "expected": expected}
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
