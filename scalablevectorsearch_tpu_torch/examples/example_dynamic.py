"""Dynamic index example: add / delete / consolidate / compact.

Counterpart of the JAX package's ``examples/example_dynamic.py``.  Run on
the card:

    python -m scalablevectorsearch_tpu_torch.examples.example_dynamic
"""

from __future__ import annotations

import numpy as np

import scalablevectorsearch_tpu_torch as svt
from scalablevectorsearch_tpu_torch.examples import on_device


def run(device="cuda", n: int = 8_000, n_queries: int = 200, dim: int = 64,
        n_build: int = 6000, n_add: int = 1000, n_delete: int = 500) -> dict:
    """Build over the first ``n_build`` rows, add the next ``n_add``,
    delete ids ``0 .. n_delete - 1``, consolidate and compact; recall@10
    at window 40 over the live set."""
    device = on_device(device)
    data, queries = svt.generate_test_dataset(n, n_queries, dim, seed=7)

    params = svt.VamanaBuildParameters(graph_max_degree=32, window_size=64)
    index = svt.DynamicVamana.build(params, data[:n_build],
                                    np.arange(n_build), svt.L2,
                                    device=device)
    index.search_window_size = 40
    out = {"initial_size": index.size}

    # stream in new points under fresh external ids
    index.add_points(data[n_build:n_build + n_add],
                     np.arange(n_build, n_build + n_add))
    # retire old ones
    index.delete_points(np.arange(0, n_delete))
    out["size_after_add_delete"] = index.size

    res = index.search(queries, 10)
    assert not np.isin(res.ids, np.arange(n_delete)).any(), \
        "deleted id surfaced!"

    # consolidate rewires the graph around deleted nodes; compact densifies
    index.consolidate().compact()
    live = np.sort(index.all_ids())
    gt = svt.exhaustive_search(data[live], queries, 10, device=device)
    res = index.search(queries, 10)
    out["recall"] = svt.k_recall_at_n(live[gt.ids], res)
    out["deleted_surfaced"] = bool(np.isin(res.ids, np.arange(n_delete))
                                   .any())
    return out


def main():
    out = run()
    print("initial size:", out["initial_size"])
    print("after add+delete:", out["size_after_add_delete"])
    print(f"post-consolidate recall@10: {out['recall']:.4f}")


if __name__ == "__main__":
    main()
