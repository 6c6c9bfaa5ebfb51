"""Vector compression example: SQ, LVQ and LeanVec under a Vamana index.

Counterpart of the JAX package's ``examples/example_compression.py``.  Run
on the card:

    python -m scalablevectorsearch_tpu_torch.examples.example_compression
"""

from __future__ import annotations

import numpy as np

import scalablevectorsearch_tpu_torch as svt
from scalablevectorsearch_tpu_torch.examples import on_device

DIM = 128
LABELS = {"float32": "float32 (uncompressed)",
          "sq_int8": "SQ int8 (global scale)",
          "lvq8": "LVQ int8 (per-vector)",
          "leanvec": "LeanVec 128->64 + rerank"}
BYTES_PER_VECTOR = {"float32": DIM * 4, "sq_int8": DIM, "lvq8": DIM + 8,
                    "leanvec": 64 + DIM + 16}


def anisotropic_data(n: int, n_queries: int) -> tuple:
    """(data, queries), float32 host arrays: anisotropic, as learned
    embeddings are (LeanVec's regime)."""
    rng = np.random.default_rng(0)
    basis = np.linalg.qr(rng.normal(size=(DIM, DIM)))[0].astype(np.float32)
    scales = np.geomspace(20, 0.05, DIM).astype(np.float32)
    data = ((rng.normal(size=(n, DIM)) * scales) @ basis).astype(np.float32)
    queries = ((rng.normal(size=(n_queries, DIM)) * scales) @ basis
               ).astype(np.float32)
    return data, queries


def run(device="cuda", n: int = 10_000, n_queries: int = 300) -> dict:
    """Recall@10 at window 40 of each kind (keys of ``LABELS``) and the
    kinds' bytes per vector."""
    device = on_device(device)
    data, queries = anisotropic_data(n, n_queries)
    gt = svt.exhaustive_search(data, queries, 10, device=device)
    params = svt.VamanaBuildParameters(graph_max_degree=32, window_size=64)

    def recall(index):
        index.search_window_size = 40
        return svt.k_recall_at_n(gt, index.search(queries, 10))

    return {
        "float32": recall(svt.Vamana.build(params, data, svt.L2,
                                           device=device)),
        "sq_int8": recall(svt.Vamana.build(
            params, svt.SQDataset.compress(data, device=device), svt.L2)),
        "lvq8": recall(svt.Vamana.build(
            params, svt.LVQDataset.compress(data, device=device), svt.L2)),
        "leanvec": recall(svt.LeanVecVamana.build(
            params, data, svt.L2, target_dim=64, rerank_multiplier=3,
            device=device)),
        "bytes_per_vector": dict(BYTES_PER_VECTOR),
    }


def main():
    out = run()
    print("compression sweep (window=40):")
    for key, label in LABELS.items():
        print(f"  {label:28s} {BYTES_PER_VECTOR[key]:4d} B/vec  "
              f"recall@10={out[key]:.4f}")


if __name__ == "__main__":
    main()
