"""IVF example: k-means clustering, assembly, probe sweep, compressed
postings with reranking.

Counterpart of the JAX package's ``examples/example_ivf.py``.  Run on the
card:

    python -m scalablevectorsearch_tpu_torch.examples.example_ivf
"""

from __future__ import annotations

import scalablevectorsearch_tpu_torch as svt
from scalablevectorsearch_tpu_torch.examples import on_device
from scalablevectorsearch_tpu_torch.index.ivf.index import IVFIndex

PROBES = (2, 8, 32)


def run(device="cuda", n: int = 20_000, n_queries: int = 500, dim: int = 96,
        num_centroids: int = 256, minibatch_size: int = 5000) -> dict:
    device = on_device(device)
    data, queries = svt.generate_test_dataset(n, n_queries, dim, seed=5)
    gt = svt.exhaustive_search(data, queries, 10, device=device)

    # --- train clustering once, assemble many ways (reference workflow) ----
    params = svt.IVFBuildParameters(num_centroids=num_centroids,
                                    minibatch_size=minibatch_size,
                                    num_iterations=8, training_fraction=0.5)
    clustering = svt.Clustering.build(params, data, device=device)
    out = {"clusters": clustering.num_centroids,
           "max_size": int(clustering.cluster_sizes().max()), "recall": {}}

    index = svt.IVF.assemble_from_clustering(clustering, data, svt.L2,
                                             device=device)
    for probes in PROBES:
        index.n_probes = probes
        out["recall"][str(probes)] = svt.k_recall_at_n(
            gt, index.search(queries, 10))

    # --- LVQ-compressed posting lists + full-precision rerank --------------
    compressed = IVFIndex.assemble_from_clustering(
        clustering, data, svt.L2, dataset_cls=svt.LVQDataset, rerank=True,
        device=device)
    res = compressed.search(queries, 10,
                            svt.IVFSearchParameters(n_probes=16, k_reorder=3))
    out["lvq_rerank"] = svt.k_recall_at_n(gt, res)
    return out


def main():
    out = run()
    print("clusters:", out["clusters"], "max size:", out["max_size"])
    for probes, recall in out["recall"].items():
        print(f"  n_probes={int(probes):3d}  recall@10={recall:.4f}")
    print(f"LVQ postings + rerank recall@10: {out['lvq_rerank']:.4f}")


if __name__ == "__main__":
    main()
