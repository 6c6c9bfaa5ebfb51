"""End-to-end Vamana example: build, search, calibrate, persist.

Counterpart of the JAX package's ``examples/example_vamana.py``.  Run on
the card:

    python -m scalablevectorsearch_tpu_torch.examples.example_vamana
"""

from __future__ import annotations

import tempfile

import numpy as np

import scalablevectorsearch_tpu_torch as svt
from scalablevectorsearch_tpu_torch.examples import on_device

WINDOWS = (10, 20, 30, 40)


def run(device="cuda", n: int = 10_000, n_queries: int = 500,
        dim: int = 128) -> dict:
    device = on_device(device)
    # --- data --------------------------------------------------------------
    data, queries = svt.generate_test_dataset(n, n_queries, dim, seed=1234)
    gt = svt.exhaustive_search(data, queries, 10, device=device)

    # --- build -------------------------------------------------------------
    # alpha 1.2: data/golden/vamana_reference.json builds its L2 row at
    # alpha 1.1, so its recalls are not this example's
    params = svt.VamanaBuildParameters(
        alpha=1.2, graph_max_degree=32, window_size=100,
        max_candidate_pool_size=250, prune_to=28)
    index = svt.Vamana.build(params, data, svt.L2, device=device)
    out = {"size": index.size, "graph_max_degree": index.graph_max_degree,
           "recall": {}}

    # --- recall sweep ------------------------------------------------------
    for window in WINDOWS:
        index.search_window_size = window
        out["recall"][str(window)] = svt.k_recall_at_n(
            gt, index.search(queries, 10))

    # --- calibration (sets the winner on the index) -------------------------
    calibrated = svt.calibrate(index.index, queries, gt.ids, 10,
                               target_recall=0.95)
    out["calibrated_window"] = calibrated.buffer_config.search_window_size
    out["calibrated_recall"] = svt.k_recall_at_n(gt,
                                                 index.search(queries, 10))

    # --- persistence -------------------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        index.save(tmp)
        reloaded = svt.Vamana.assemble(tmp, device=device)
        # the serving switches calibrate may set (packed rows, pop width,
        # tail fraction, upload type) are not part of a checkpoint: the
        # copy serves as the calibrated index does
        live = index.index
        if getattr(live, "_packed", None) is not None:
            reloaded.enable_packed_serving()
        reloaded.pop_width = live.pop_width
        reloaded.index.tail_frac = live.tail_frac
        reloaded.index.query_upload_dtype = live.query_upload_dtype
        assert np.array_equal(reloaded.search(queries[:8], 5).ids,
                              index.search(queries[:8], 5).ids)
    out["round_trip"] = True
    return out


def main():
    out = run()
    print(f"built: {out['size']} points, R={out['graph_max_degree']}")
    for window, recall in out["recall"].items():
        print(f"  window={int(window):3d}  recall@10={recall:.4f}")
    print(f"calibrated window for recall>=0.95: {out['calibrated_window']}")
    print("save/assemble roundtrip OK")


if __name__ == "__main__":
    main()
