"""The port's Vamana example (``scalablevectorsearch_tpu_torch/examples/
example_vamana.py``) against the JAX package's example's calls, on the CPU.

The examples' tests run the port's ``run(device="cpu", <small sizes>)``
and the same sequence of calls through the JAX package at the same sizes
(the JAX examples take no arguments), and compare the two at the
tolerance each docstring states.  One file holds at most what runs in
90 s on one core: ``tests/test_torch_examples_compression_dynamic.py``,
``tests/test_torch_examples_ivf_serving.py`` and
``tests/test_torch_examples_multichip.py`` hold the other five.
"""

import contextlib
import functools

import numpy as np
import torch

from scalablevectorsearch_tpu.core.io import generate_test_dataset as jgen
from scalablevectorsearch_tpu.core.recall import k_recall_at_n
from scalablevectorsearch_tpu.index.flat import exhaustive_search as jexh
from scalablevectorsearch_tpu.index.vamana.calibrate import (
    CalibrationParameters as JCalibration, calibrate as jcalibrate)
from scalablevectorsearch_tpu.index.vamana.params import (
    VamanaBuildParameters as JParams)
from scalablevectorsearch_tpu.orchestrators.vamana import Vamana as JVamana

from scalablevectorsearch_tpu_torch import Vamana
from scalablevectorsearch_tpu_torch.examples import example_vamana
from scalablevectorsearch_tpu_torch.index.vamana import calibrate as tcal

torch.set_num_threads(1)

VAMANA = dict(n=800, n_queries=50, dim=32)
ONE_AXIS = dict(pop_widths=(4,), tail_fracs=(4,), capacity_multipliers=(1,),
                try_packed=False, trim_capacity=False, timing_reps=1,
                search_window_upper=32)


def test_vamana_example_matches_jax(tmp_path, monkeypatch):
    """Recall per window identical (the f32 build equals the JAX package's
    adjacency on the CPU), the same calibrated window, its recall >= 0.95,
    and the port's checkpoint, assembled by the JAX package, searching the
    port's ids.  Calibration runs with one value per axis in both
    packages (ONE_AXIS): with more, host-clock QPS picks the winner and
    so the window."""
    monkeypatch.setattr(example_vamana.tempfile, "TemporaryDirectory",
                        lambda: contextlib.nullcontext(str(tmp_path)))
    monkeypatch.setattr(tcal, "CalibrationParameters",
                        functools.partial(tcal.CalibrationParameters,
                                          **ONE_AXIS))
    out = example_vamana.run("cpu", **VAMANA)

    data, queries = jgen(VAMANA["n"], VAMANA["n_queries"], VAMANA["dim"],
                         seed=1234)
    gt = jexh(data, queries, 10)
    index = JVamana.build(JParams(alpha=1.2, graph_max_degree=32,
                                  window_size=100,
                                  max_candidate_pool_size=250, prune_to=28),
                          data, "l2")
    want = {}
    for window in example_vamana.WINDOWS:
        index.search_window_size = window
        want[str(window)] = k_recall_at_n(gt, index.search(queries, 10))
    assert out["recall"] == want
    calibrated = jcalibrate(index.index, queries, gt.ids, 10,
                            target_recall=0.95,
                            parameters=JCalibration(**ONE_AXIS))
    assert out["calibrated_window"] == \
        calibrated.buffer_config.search_window_size
    assert out["calibrated_recall"] >= 0.95
    assert out["round_trip"]

    # the port's checkpoint (the run's index, calibrated) in the JAX package
    ported = Vamana.assemble(str(tmp_path), device="cpu")
    loaded = JVamana.assemble(str(tmp_path))
    np.testing.assert_array_equal(loaded.search(queries, 10).ids,
                                  ported.search(queries, 10).ids)
