"""Whole runs through the harness on the CPU at tiny sizes: every cell in
both modes, the faults the check has to catch, the command's refusals,
and a configuration, a traffic mix and a metric added as files alone.
``run.py`` itself needs a card; ``harness.run`` is the seam these tests
drive (the CPU run has no device trace, so the device metrics read
nothing here)."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from annbench import harness
from annbench.tests import tiny

CELLS = [w["name"] for w in tiny.bench()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("section", ["end_to_end", "per_layer"])
def test_a_tiny_run_of_every_cell_is_correct(cell, section):
    record = tiny.run(cell, section)
    assert record["check"]["correct"], record["check"]
    assert record["check"]["recall_at_10"] > 0.8
    values = record["values"]
    expected = {m["name"] for m in harness.cell_metrics(tiny.bench(), cell,
                                                        section)}
    assert set(values) == expected
    device_only = {"device_mem_gb", "beam_step_roofline_pct"} | {
        name for name in expected if name.startswith("device_idle_pct")}
    for name, value in values.items():
        if name in device_only:
            assert value is None, name      # no device number from a CPU run
        else:
            assert value is not None and value >= 0, name
    if section == "end_to_end":
        assert values["setup_s"] > 0
    throughput = [values[name] for name in ("qps", "qps.ivf", "qps.batch")
                  if name in values]
    assert all(value > 0 for value in throughput)
    if "beam_launches_per_call.batch" in values:
        # the CPU runs the kernels' plain versions, which count nothing
        assert values["beam_launches_per_call.batch"] == 0
    if "ivf_rows_scanned_per_query" in values:
        facts = record["facts"]
        assert values["ivf_rows_scanned_per_query"] == \
            facts["n_probes"] * facts["slot"]


def broken_run(cell, monkeypatch, target, attr, make):
    """A tiny run with ``target.attr`` replaced by ``make(original)``."""
    monkeypatch.setattr(target, attr, make(getattr(target, attr)))
    return tiny.run(cell)["check"]


def unchanged_step(real):
    """The beam step returns the beam it was given and pops nothing."""
    def step(beam_keys, beam_packed, vecs, cand_ids, queries, **kw):
        b, k = cand_ids.shape
        return (beam_keys, beam_packed,
                torch.full((b, kw["m"]), -1, dtype=torch.int32),
                torch.full((b, k), float("inf")), cand_ids)
    return step


def half_batch(real):
    """Each dispatch answers the first half of its queries only."""
    def dispatch(*args, **kw):
        ids, vals = real(*args, **kw)
        half = ids.shape[0] // 2
        ids, vals = ids.clone(), vals.clone()
        ids[half:] = -1
        vals[half:] = float("inf")
        return ids, vals
    return dispatch


def altered_answer(real):
    """Each dispatch changes one id of its first query."""
    def dispatch(*args, **kw):
        ids, vals = real(*args, **kw)
        ids = ids.clone()
        ids[0, 0] = (ids[0, 0] + 1) % 1000
        return ids, vals
    return dispatch


def test_the_check_fails_each_fault_of_the_vamana_path(monkeypatch):
    from scalablevectorsearch_tpu_torch.index.vamana import index, search
    cell = "sift-128-l2-vamana.batch2000"
    faults = [(search, "beam_step", unchanged_step),
              (index, "_search_batch", half_batch),
              (index, "_search_batch", altered_answer)]
    for target, attr, make in faults:
        with monkeypatch.context() as m:
            got = broken_run(cell, m, target, attr, make)
        assert not got["correct"], (make.__name__, got)


def unchanged_scan(real):
    """The posting scan's merge returns the running best unchanged."""
    def merge(best_keys, best_ids, keys, ids, keep):
        return best_keys, best_ids
    return merge


def test_the_check_fails_each_fault_of_the_ivf_path(monkeypatch):
    from scalablevectorsearch_tpu_torch.index.ivf import index
    cell = "deep-96-l2-ivf.batch2000"
    faults = [(index.topk_ops, "merge_smallest", unchanged_scan),
              (index, "_ivf_serve_batch", half_batch),
              (index, "_ivf_serve_batch", altered_answer)]
    for target, attr, make in faults:
        with monkeypatch.context() as m:
            got = broken_run(cell, m, target, attr, make)
        assert not got["correct"], (make.__name__, got)


def run_py(cwd, *args):
    return subprocess.run(
        [sys.executable, "annbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", *args],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_the_command_refuses_a_machine_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = run_py(tiny.ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_the_command_refuses_a_checkout_without_the_program(tmp_path):
    shutil.copy(tiny.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(tiny.ROOT / "annbench", tmp_path / "annbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run_py(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
    probe = subprocess.run(
        [sys.executable, "-c",
         "from annbench import program; program.import_program()"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert probe.returncode != 0 and "Error" in probe.stderr


def test_a_run_loads_no_module_of_jax():
    code = (
        "import sys; from annbench.tests import tiny\n"
        "tiny.run('deep-96-l2-ivf.batch2000')\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & "
        "{'jax', 'jaxlib', 'flax', 'scalablevectorsearch_tpu'}), "
        "'scalablevectorsearch_tpu_torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tiny.ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    assert out.stdout.split() == ["[]", "True"]


NEW_METRIC = '''"""Calls answered in the window."""


def read(record):
    return float(len(record["calls"]))
'''


def test_a_cell_and_a_metric_are_added_as_files_alone(tmp_path):
    """A configuration, a traffic mix and a per-layer metric added as new
    files and new BENCHMARK.json entries, in a copy, are found by name and
    run, with no existing file edited."""
    shutil.copytree(tiny.ROOT / "annbench", tmp_path / "annbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "annbench").rglob("*")
              if p.is_file()}
    bench = tiny.bench()
    config, _ = tiny.cell("sift-128-l2-vamana.batch2000")
    config.update(name="tiny-64-l2-vamana", dim=64, n=900)
    (tmp_path / "annbench" / "configs" / "tiny-64-l2-vamana.json").write_text(
        json.dumps(config))
    (tmp_path / "annbench" / "traffic" / "batch30.json").write_text(
        json.dumps({"name": "batch30", "loop": "closed", "clients": 1,
                    "queries_per_call": 30, "warmup_calls": 1}))
    (tmp_path / "annbench" / "metrics" / "calls.tiny.py").write_text(
        NEW_METRIC)
    cell = "tiny-64-l2-vamana.batch30"
    bench["workloads"].append({"name": cell, "config": "tiny-64-l2-vamana",
                               "traffic": "batch30", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "calls.tiny", "unit": "calls",
                               "better": "higher", "source": "host_clock",
                               "layer": "entry", "moves": "qps",
                               "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import json, sys\n"
        f"sys.path[:0] = [{str(tmp_path)!r}, {str(tiny.ROOT)!r}]\n"
        "from annbench import harness\n"
        f"assert harness.__file__.startswith({str(tmp_path)!r})\n"
        "bench = json.load(open('BENCHMARK.json'))\n"
        f"w = [x for x in bench['workloads'] if x['name'] == {cell!r}][0]\n"
        "config = harness.load_json('configs', w['config'])\n"
        "traffic = harness.load_json('traffic', w['traffic'])\n"
        f"metrics = harness.cell_metrics(bench, {cell!r}, 'per_layer')\n"
        "r = harness.run(config, traffic, metrics, seed=5, seconds=0.2,\n"
        "                traced=True, device='cpu')\n"
        "print(json.dumps({'values': r['values'],\n"
        "                  'correct': r['check']['correct']}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["correct"]
    assert got["values"] == {"calls.tiny": got["values"]["calls.tiny"]}
    assert got["values"]["calls.tiny"] >= 1
    assert {p: p.read_bytes() for p in before} == before


@pytest.mark.parametrize("cell", ["sift-128-l2-vamana.batch2000",
                                  "deep-96-l2-ivf.batch2000"])
def test_the_control_comes_out_not_correct(cell):
    """The reference at TF32 in the program's place fails ``dist_gap``
    (at the chip's size too: ``control.py``), where the float64 reference
    in the same place passes."""
    from annbench import control
    config, traffic = tiny.cell(cell, n=4000, pool=400, per_call=100)
    got = {}
    for precision in ("tf32", "float64"):
        config["control"]["precision"] = precision
        got[precision] = harness.run(config, traffic, [], seed=9,
                                     seconds=0.2, traced=False, device="cpu",
                                     build=control.build)["check"]
    assert not got["tf32"]["correct"]
    assert got["tf32"]["numbers"]["dist_gap"] > config["limits"]["dist_gap"]
    assert got["float64"]["correct"]
    assert got["float64"]["numbers"]["dist_gap"] < 1e-6
