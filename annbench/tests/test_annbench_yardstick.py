"""The yardstick on the CPU: the frozen generator, the plain reference,
the roofline arithmetic, the comparison that decides ``correct``, the
traffic plan, and ``BENCHMARK.json`` against the benchmark's contract."""

from __future__ import annotations

import ast
import json
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from annbench import check, data, harness, reference, roofline
from annbench.tests import tiny

SPEC = {"distribution": "clustered", "center_scale": 10.0, "noise": 1.0,
        "points_per_cluster": 512, "min_clusters": 8}


def test_generator_is_a_function_of_the_seed():
    big = 2 ** 31 + 12345
    rows, queries = data.make(SPEC, 2000, 50, 32, big, "cpu")
    again = data.make(SPEC, 2000, 50, 32, big, "cpu")
    other = data.make(SPEC, 2000, 50, 32, big + 1, "cpu")
    assert rows.shape == (2000, 32) and queries.shape == (50, 32)
    assert rows.dtype == queries.dtype == torch.float32
    assert torch.equal(rows, again[0]) and torch.equal(queries, again[1])
    assert not torch.equal(rows, other[0])
    assert data.fingerprint(rows) == data.fingerprint(again[0])


def test_generator_draws_separated_clusters():
    """Centres of scale 10 and unit noise: a query's nearest row is about
    2 d away in squared L2, a random row about 200 d."""
    rows, queries = data.make(SPEC, 4096, 64, 32, 7, "cpu")
    d2 = torch.cdist(queries.double(), rows.double()).square()
    nearest = d2.min(1).values.mean().item()
    assert nearest < 2.5 * 32
    assert d2.median().item() > 100 * 32
    with pytest.raises(ValueError):
        data.make({**SPEC, "distribution": "uniform"}, 10, 2, 4, 0, "cpu")


def test_reference_is_the_float64_brute_force(monkeypatch):
    rows, queries = data.make(SPEC, 3000, 70, 24, 3, "cpu")
    monkeypatch.setattr(reference, "ROW_BLOCK", 512)
    monkeypatch.setattr(reference, "QUERY_BLOCK", 32)
    ids, dist = reference.exact_knn(rows, queries, 10)
    x, q = rows.double().numpy(), queries.double().numpy()
    full = ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    want = np.argsort(full, axis=1, kind="stable")[:, :10]
    assert np.array_equal(ids.numpy(), want)
    np.testing.assert_allclose(dist.numpy(),
                               np.take_along_axis(full, want, 1), rtol=1e-9)
    pairs = reference.pair_distances(rows, queries, ids)
    np.testing.assert_allclose(pairs.numpy(), dist.numpy(), rtol=1e-9)


def test_step_bound_counts_the_bytes_by_hand():
    # b 2, c 4, k 8, d 16, bf16 rows, f32 queries, m 2, 3 dead candidates:
    # inputs 32 + 32 + 512 + 64 + 128, outputs 2 (32 + 8 + 64), less the
    # dead rows' 3 x 16 x 2 bytes
    got = roofline.step_bound(b=2, c=4, k=8, d=16, row_itemsize=2,
                              query_itemsize=4, m=2, dead_rows=3,
                              flops_per_value=4)
    assert got["bytes"] == 768 + 208 - 96
    assert got["flops"] == 4 * 13 * 16
    assert got["bound_by"] == "bytes"
    assert got["bound_s"] == pytest.approx(880 / 3.35e12)
    # 12 of 16 columns live: the padding of the 13 live rows and 2 queries
    live = roofline.step_bound(b=2, c=4, k=8, d=16, row_itemsize=2,
                               query_itemsize=4, m=2, dead_rows=3,
                               flops_per_value=4, live=12)
    assert live["bytes"] == 880 - 4 * (13 * 2 + 2 * 4)
    assert live["flops"] == 4 * 13 * 12
    ops = roofline.bound_of(10, 67e12)
    assert ops["bound_by"] == "operations" and ops["bound_s"] == 1.0


def exact_answers(rows, pool, k=10):
    ids, dist = reference.exact_knn(rows, pool, k)
    return [(np.arange(pool.shape[0]), ids.numpy(),
             dist.float().numpy())]


def test_judge_passes_the_exact_answer_and_fails_each_fault():
    rows, pool = data.make(SPEC, 2000, 40, 32, 5, "cpu")
    limits = {"bad_slots": 0, "dist_gap": 1e-3}
    good = check.judge(rows, pool, exact_answers(rows, pool), 10, limits)
    assert good["correct"] and good["recall_at_10"] == 1.0
    assert good["numbers"] == {"bad_slots": 0,
                               "dist_gap": pytest.approx(0, abs=1e-6)}

    def judged(edit):
        qi, ids, dist = exact_answers(rows, pool)[0]
        edit(ids, dist)
        return check.judge(rows, pool, [(qi, ids, dist)], 10, limits)

    def unanswered(ids, dist):
        ids[3, 5:] = -1
        dist[3, 5:] = np.inf

    def altered(ids, dist):
        ids[7, 0] = (ids[7, 0] + 1) % 2000

    def repeated(ids, dist):
        ids[1, 4], dist[1, 4] = ids[1, 3], dist[1, 3]

    def descending(ids, dist):
        dist[2, 9] = dist[2, 8] / 2

    for edit, number in ((unanswered, "bad_slots"), (altered, "dist_gap"),
                         (repeated, "bad_slots"), (descending, "bad_slots")):
        got = judged(edit)
        assert not got["correct"], edit.__name__
        assert got["numbers"][number] > limits[number], edit.__name__
    assert judged(unanswered)["failed"] == 1


def test_plan_gives_every_seed_the_same_sizes_in_another_order():
    traffic = {"loop": "closed", "clients": 1, "queries_per_call": 50}
    a = harness.plan(traffic, 1000, 2 ** 31 + 3)
    b = harness.plan(traffic, 1000, 2 ** 31 + 4)
    assert a.shape == b.shape == (20, 50)
    assert np.array_equal(np.sort(a.ravel()), np.arange(1000))
    assert not np.array_equal(a, b)
    assert np.array_equal(a, harness.plan(traffic, 1000, 2 ** 31 + 3))
    cycled = harness.plan({**traffic, "cycles": 3}, 1000, 2 ** 31 + 3)
    assert cycled.shape == (60, 50)
    assert np.array_equal(cycled[:20], a)       # one cycle is the plan
    for c in range(3):
        assert np.array_equal(np.sort(cycled[20 * c:20 * (c + 1)].ravel()),
                              np.arange(1000))
    assert not np.array_equal(cycled[20:40], a)
    with pytest.raises(ValueError):
        harness.plan({**traffic, "queries_per_call": 300}, 1000, 1)
    with pytest.raises(ValueError):
        harness.plan({**traffic, "loop": "open"}, 1000, 1)


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_benchmark_json_keeps_the_contract():
    bench = tiny.bench()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert "annbench" in bench["paths"]
    assert 1 <= bench["run_seconds"] <= 51
    configs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"])
        assert c["file"] == f"annbench/configs/{c['name']}.json"
        with open(tiny.ROOT / c["file"]) as f:
            assert set(c["reduced"]) == set(json.load(f)["reduced"])
    cells = [w["name"] for w in bench["workloads"]]
    assert len(set(cells)) == len(cells)
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in configs
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert (tiny.ROOT / "annbench" / "traffic"
                / f"{w['traffic']}.json").exists()
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (tiny.ROOT / "annbench" / "metrics"
                / f"{m['name']}.py").exists()
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(cells)
        for cell in m["workloads"]:
            # each cell a per-layer metric lists reports what it moves
            assert m["moves"] in {e["name"] for e in harness.cell_metrics(
                bench, cell, "end_to_end")}, (m["name"], cell)
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
    for cell in cells:
        assert harness.cell_metrics(bench, cell, "per_layer")


YARDSTICK = ("data", "reference", "check", "roofline", "trace")


def test_the_reference_imports_nothing_of_the_program():
    for name in YARDSTICK:
        tree = ast.parse((tiny.ROOT / "annbench" / f"{name}.py").read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                roots = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                roots = [(node.module or "").split(".")[0]] \
                    if node.level == 0 else ["annbench"]
            else:
                continue
            assert not {"scalablevectorsearch_tpu_torch",
                        "scalablevectorsearch_tpu", "jax"} & set(roots), name
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys; import annbench.reference, annbench.check, "
         "annbench.data, annbench.roofline, annbench.trace; "
         "print(sorted({m.split('.')[0] for m in sys.modules} & "
         "{'scalablevectorsearch_tpu_torch', 'scalablevectorsearch_tpu', "
         "'jax', 'jaxlib', 'flax'}))"],
        cwd=tiny.ROOT, capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
