"""Multi-device example: dataset-sharded search over a device mesh.

Counterpart of the JAX package's ``examples/example_multichip.py``.  The
mesh spans every CUDA device where there are two or more; on one card it
is 8 logical shards of ``cuda:0``; with ``run(device="cpu")``, 8 x
``"cpu"``.  Run on the card:

    python -m scalablevectorsearch_tpu_torch.examples.example_multichip
"""

from __future__ import annotations

import numpy as np
import torch

import scalablevectorsearch_tpu_torch as svt
from scalablevectorsearch_tpu_torch.examples import on_device
from scalablevectorsearch_tpu_torch.lib.datatypes import pad_matrix
from scalablevectorsearch_tpu_torch.parallel import mesh as mesh_mod
from scalablevectorsearch_tpu_torch.parallel import sharded
from scalablevectorsearch_tpu_torch.parallel.dynamic import (
    ShardedMutableVamanaIndex)


def mesh_devices(device) -> tuple:
    """(the mesh's devices, what they are): every CUDA device where there
    are two or more, else 8 logical shards of the one device."""
    device = on_device(device)
    if device.type == "cuda" and torch.cuda.device_count() >= 2:
        n = torch.cuda.device_count()
        return [f"cuda:{i}" for i in range(n)], f"{n} CUDA devices"
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda:0")
    return [str(device)] * 8, f"8 logical shards of {device}"


def run(device="cuda", n: int = 20_000, n_queries: int = 100, dim: int = 64,
        num_centroids: int = 64, m: int = 4_000, n_add: int = 500,
        n_delete: int = 250) -> dict:
    """Recall@10 of the five parts; ``m`` rows build the sharded dynamic
    index, ``n_add`` more are added and ids ``0 .. n_delete - 1``
    deleted."""
    devices, what = mesh_devices(device)
    out = {"devices": len(devices), "mesh": what}
    data, queries = svt.generate_test_dataset(n, n_queries, dim, seed=3)
    mesh = mesh_mod.make_mesh(len(devices), axis_name="shard",
                              devices=devices)
    lead = mesh.lead
    gt = svt.exhaustive_search(data, queries, 10, device=lead)
    q = torch.from_numpy(pad_matrix(queries)).to(lead)

    # --- flat search with dataset rows sharded across the mesh -------------
    ds = sharded.shard_dataset(svt.VectorDataset.from_array(data,
                                                            device=lead), mesh)
    _keys, ids = sharded.sharded_flat_search(mesh, ds, q, 10, svt.L2)
    out["flat"] = svt.k_recall_at_n(gt.ids, ids.cpu().numpy()[:n_queries])

    # --- IVF with posting lists sharded by cluster --------------------------
    params = svt.IVFBuildParameters(num_centroids=num_centroids,
                                    num_iterations=5, training_fraction=0.5)
    ivf = svt.IVF.build(params, data, svt.L2, device=lead).index
    _keys, ids = sharded.sharded_ivf_search(mesh, ivf, q, 10, n_probes=16)
    out["ivf"] = svt.k_recall_at_n(gt.ids, ids.cpu().numpy()[:n_queries])

    # --- query-parallel Vamana (index replicated, queries sharded) ---------
    mesh_dp = mesh_mod.make_mesh(len(devices), axis_name="dp",
                                 devices=devices)
    vparams = svt.VamanaBuildParameters(graph_max_degree=24, window_size=48)
    v = svt.VamanaIndex.build(vparams, data, svt.L2, device=lead)
    entry = torch.tensor([v.entry_point], dtype=torch.int32, device=lead)
    search = dict(window=40, capacity=40, max_iters=100, distance=svt.L2)
    res = sharded.dp_greedy_search(mesh_dp, v.graph, v.data, q, entry,
                                   **search)
    out["dp_vamana"] = svt.k_recall_at_n(
        gt.ids, res.ids.cpu().numpy()[:n_queries, :10])

    # --- sharded-graph Vamana over LVQ codes (memory-scaling config) -------
    # graph rows and compressed codes sharded across the mesh; decode is
    # local, only (B, K) key panels cross between devices
    lvq = svt.LVQDataset.compress(data, bits=8, device=lead)
    res = sharded.sharded_greedy_search(mesh, v.graph, lvq, q, entry,
                                        **search)
    out["sharded_lvq8"] = svt.k_recall_at_n(
        gt.ids, res.ids.cpu().numpy()[:n_queries, :10])

    # --- sharded dynamic Vamana: mutations over shard views ----------------
    dyn = ShardedMutableVamanaIndex(vparams, data[:m], np.arange(m), svt.L2,
                                    mesh)
    dyn.add_points(data[m:m + n_add], np.arange(100_000, 100_000 + n_add))
    dyn.delete_points(np.arange(0, n_delete))
    dyn.consolidate()
    dyn.compact()
    res = dyn.search(queries, 10)
    live = np.concatenate([data[n_delete:m], data[m:m + n_add]])
    live_ext = np.concatenate([np.arange(n_delete, m),
                               np.arange(100_000, 100_000 + n_add)])
    gt_live = svt.exhaustive_search(live, queries, 10, device=lead)
    out["sharded_dynamic"] = float(np.mean(
        [len(set(live_ext[g]) & set(r)) / 10
         for g, r in zip(gt_live.ids, res.ids)]))
    out["sharded_dynamic_ids"] = res.ids
    return out


def main():
    out = run()
    print(f"devices: {out['devices']} ({out['mesh']})")
    print(f"sharded flat recall@10: {out['flat']:.4f}")
    print(f"sharded IVF recall@10 (16 probes): {out['ivf']:.4f}")
    print(f"query-parallel vamana recall@10: {out['dp_vamana']:.4f}")
    print(f"sharded-graph vamana over sharded LVQ8 recall@10: "
          f"{out['sharded_lvq8']:.4f}")
    print(f"sharded dynamic vamana (after add/delete/consolidate/compact) "
          f"recall@10: {out['sharded_dynamic']:.4f}")


if __name__ == "__main__":
    main()
