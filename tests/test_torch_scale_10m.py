"""The port's Deep-10M run (``benchmark/scale_10m.py``) at 2,000 x 96 with
200 queries on the CPU, every step held to the JAX package's own calls on
the same inputs (bench.py's ``_scale_10m*``):

- data and gt: the JAX package's rows, queries and exact top-10;
- build: R 32, ``prune_to`` 28, alpha 1.1 and sampled entries as at 10M,
  with a narrower window and pool (40 and 80 for 100 and 300) so that the
  builds fit the test's time.  Recall per window equals the JAX build's,
  the entry point is the same and at least 98% of the adjacency rows are
  identical.  The other rows differ by single edges (at most 2 ids per
  row): the two packages round L2 keys in another order, so prune
  decisions that sit on a tie go either way, and later rounds follow from
  those edges.  ``tests/test_torch_scale_10m_ties.py`` proves every such
  row a tie, round by round, at the run's own window and pool;
- lvq8x8: the saved codes, scales, biases, mean and residual level equal
  the JAX package's ``compress_and_save_host`` output; the port
  compresses in row blocks, which give the whole array's bits;
- int8: recall per window within one neighbour in the whole query set of
  the JAX index's under int8 uploads (the quantized queries move the
  single-edge differences of the graphs into the results);
- ivf: the run is given the JAX package's k-means of the same rows (K 134
  over this data's 8 clusters splits them at arbitrary borders, so even
  from the JAX package's k-means++ draws the port's training moves 7 of
  the 2,000 assignments; ``tests/test_torch_ivf.py`` holds the training);
  the layout's probe units and slot are the JAX package's, and recall per
  n_probes is within one neighbour in the whole query set;
- resumption: the build is stopped after one segment and resumed; it
  gives ``VamanaIndex.build``'s graph bit for bit (uninterrupted), and a
  second run skips every finished step;
- the cache: a run of another configuration over it is refused.
"""

import json
import os

import numpy as np
import pytest
import torch

from scalablevectorsearch_tpu.core.io import generate_test_dataset as jgen
from scalablevectorsearch_tpu.core.recall import k_recall_at_n as jrecall
from scalablevectorsearch_tpu.index.flat import exhaustive_search as jexh
from scalablevectorsearch_tpu.index.ivf.clustering import (
    Clustering as JClustering)
from scalablevectorsearch_tpu.index.ivf.index import (
    IVFIndex as JIVFIndex, save_packed_layout_host as jsave_layout)
from scalablevectorsearch_tpu.index.ivf.params import (
    IVFBuildParameters as JIVFBuild, IVFSearchParameters as JIVFSearch)
from scalablevectorsearch_tpu.index.vamana.index import (
    VamanaIndex as JVamanaIndex)
from scalablevectorsearch_tpu.index.vamana.params import (
    VamanaBuildParameters as JParams)
from scalablevectorsearch_tpu.quantization import lvq as jlvq

from scalablevectorsearch_tpu_torch.benchmark import scale_10m
from scalablevectorsearch_tpu_torch.core.loading import dispatch_load
from scalablevectorsearch_tpu_torch.index.ivf.clustering import (
    Clustering as TClustering)
from scalablevectorsearch_tpu_torch.index.vamana.index import VamanaIndex
from scalablevectorsearch_tpu_torch.quantization import lvq as tlvq

torch.set_num_threads(1)

N, NQ = 2000, 200
NARROW = dict(alpha=1.1, graph_max_degree=32, window_size=40,
              max_candidate_pool_size=80, prune_to=28)
SEGMENT = 30                    # rounds; the build has 2 x 40


def narrow_parameters():
    from scalablevectorsearch_tpu_torch.index.vamana.params import (
        VamanaBuildParameters)
    return VamanaBuildParameters(**NARROW)


def hits(recall: float) -> int:
    """Neighbours found in the whole query set."""
    return round(recall * NQ * 10)


@pytest.fixture(scope="module")
def jax_clustering():
    """The JAX package's k-means of the run's rows at the ivf step's
    parameters."""
    data, _ = jgen(N, NQ, 96, seed=scale_10m.SEED)
    p = scale_10m.ivf_build_parameters(N)
    return JClustering.build(JIVFBuild(
        num_centroids=p.num_centroids, num_iterations=p.num_iterations,
        training_fraction=p.training_fraction,
        is_hierarchical=False).resolved(N), data)


@pytest.fixture(scope="module")
def patched(jax_clustering):
    def jax_trained(cls, parameters, data, device="cuda"):
        return cls(centroids=np.asarray(jax_clustering.centroids),
                   assignments=np.asarray(jax_clustering.assignments))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(scale_10m, "build_parameters", narrow_parameters)
        mp.setattr(TClustering, "build", classmethod(jax_trained))
        # fewer windows than at 10M: each is a JAX compile
        mp.setattr(scale_10m, "WINDOWS", (12, 16, 24))
        mp.setattr(scale_10m, "LVQ_WINDOWS", (12, 16))
        mp.setattr(scale_10m, "INT8_WINDOWS", (12, 17))
        mp.setattr(scale_10m, "IVF_PROBES", (1, 4, 12, 32))
        yield mp


@pytest.fixture(scope="module")
def full(patched, tmp_path_factory):
    """The build stopped after its first segment, then every step in a
    second run, which resumes the build (the run's line for each step and
    the stopped build's line)."""
    directory = str(tmp_path_factory.mktemp("scale_10m"))
    stopped = scale_10m.run(directory, steps=("data", "gt", "build"),
                            device="cpu", n=N, n_queries=NQ,
                            segment_rounds=SEGMENT, deadline=0.0)
    lines = scale_10m.run(directory, device="cpu", n=N, n_queries=NQ,
                          segment_rounds=SEGMENT)
    return directory, lines, stopped["build"]


@pytest.fixture(scope="module")
def jax_side():
    data, queries = jgen(N, NQ, 96, seed=scale_10m.SEED)
    gt = jexh(data, queries, 10)
    index = JVamanaIndex.build(JParams(**NARROW), data, "l2",
                               sampled_entries=True)
    return data, queries, gt, index


def test_every_step_prints_its_line(full):
    directory, lines, _ = full
    assert list(lines) == list(scale_10m.STEPS)
    for name, line in lines.items():
        assert line["step"] == name and line["n"] == N
        assert line["card"] is None and line["peak_device_bytes"] is None
        assert line["host_peak_rss_bytes"] > 0
        assert line.get("cached", False) == (name in ("data", "gt"))
        with open(os.path.join(directory, f"{name}.json")) as f:
            assert {**json.load(f), **line} == line
    assert lines["build"]["done"] and lines["build"]["rounds"] == 80
    assert lines["lvq8x8"]["kind"] == "LVQ8x8"
    assert lines["lvq8x8"]["n_dead"] == 32
    assert lines["ivf"]["num_centroids"] == int(np.sqrt(N) * 3)
    for name in ("f32", "lvq8x8", "int8"):
        first = lines[name]["first_window"]
        assert first is not None and lines[name]["qps"] > 0
        assert lines[name]["recall"][str(first)] >= 0.9
    assert not os.path.exists(os.path.join(directory, "build_state"))


def test_second_run_skips_finished_steps(full, monkeypatch, capsys):
    directory, lines, _ = full

    def refuse(run):
        raise AssertionError("a finished step ran again")

    monkeypatch.setattr(scale_10m, "STEP_FUNCTIONS",
                        {name: refuse for name in scale_10m.STEPS})
    again = scale_10m.run(directory, device="cpu", n=N, n_queries=NQ)
    for name in scale_10m.STEPS:
        assert again[name] == {**lines[name], "cached": True}, name
    printed = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert [p["step"] for p in printed] == list(scale_10m.STEPS)


def test_data_and_gt_match_jax(full, jax_side):
    directory, _, _ = full
    data, queries, gt, _ = jax_side
    np.testing.assert_array_equal(
        np.load(os.path.join(directory, "queries.npy")), queries)
    np.testing.assert_array_equal(
        np.load(os.path.join(directory, "gt.npy")), np.asarray(gt.ids))


def test_build_matches_jax(full, jax_side):
    directory, lines, _ = full
    _, queries, gt, jindex = jax_side
    tindex = VamanaIndex.assemble(os.path.join(directory, "index"),
                                  device="cpu")
    assert tindex.entry_point == jindex.entry_point
    assert tindex._entry_cfg is not None           # the sampler config
    tadj = tindex.graph.adjacency.numpy()[:N]
    jadj = np.asarray(jindex.graph.adjacency)[:N]
    same = (tadj == jadj).all(1)
    assert same.mean() >= 0.98, same.mean()
    for a, b in zip(tadj[~same], jadj[~same]):
        assert len(set(a[a >= 0]) ^ set(b[b >= 0])) <= 2
    assert abs(lines["build"]["mean_degree"]
               - jindex.graph.mean_degree()) <= 0.01
    for w, recall in lines["f32"]["recall"].items():
        jindex.search_window_size = int(w)
        assert recall == jrecall(gt, jindex.search(queries, 10)), w


def test_int8_uploads_match_jax(full, jax_side):
    _, lines, _ = full
    _, queries, gt, jindex = jax_side
    jindex.query_upload_dtype = "int8"
    batch = jindex.query_batch_size
    jindex.query_batch_size = NQ
    try:
        for w, recall in lines["int8"]["recall"].items():
            jindex.search_window_size = int(w)
            want = jrecall(gt, jindex.search(queries, 10))
            assert abs(hits(recall) - hits(want)) <= 1, (w, recall, want)
    finally:
        jindex.query_upload_dtype = None
        jindex.query_batch_size = batch


def test_lvq8x8_codes_match_jax(full, jax_side, tmp_path):
    directory, _, _ = full
    data = jax_side[0]
    jlvq.compress_and_save_host(str(tmp_path), data, bits=8,
                                residual_bits=8)
    got = dispatch_load(os.path.join(directory, "lvq8x8"), device="cpu")
    want = dispatch_load(str(tmp_path), device="cpu")
    assert (got.n, got.dim, got.bits, got.residual_bits) == (N, 96, 8, 8)
    for name in ("codes", "scales", "biases", "mean", "res_codes",
                 "res_scales", "norms_sq", "full_norms_sq"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


@pytest.mark.parametrize("bits,residual_bits", [(8, 8), (4, 8), (8, 0)])
def test_row_blocks_compress_bit_for_bit(bits, residual_bits):
    x, _ = jgen(1003, 1, 96, seed=5)
    whole = tlvq.LVQDataset.compress(x, bits, residual_bits, device="cpu")
    blocks = tlvq.compress_host(x, bits, residual_bits, block_rows=128)
    assert (blocks.n, blocks.capacity) == (whole.n, whole.capacity)
    for name in ("codes", "scales", "biases", "mean", "norms_sq",
                 "res_codes", "res_scales", "full_norms_sq"):
        assert torch.equal(getattr(blocks, name), getattr(whole, name)), name


def test_ivf_matches_jax(full, jax_side, jax_clustering, tmp_path):
    _, lines, _ = full
    data, queries, gt, _ = jax_side
    jsave_layout(str(tmp_path), jax_clustering, data, "l2",
                 eltype="bfloat16")
    index = JIVFIndex.assemble_from_file(str(tmp_path))
    assert lines["ivf"]["probe_units"] == index.num_probe_units
    assert lines["ivf"]["slot"] == index.slot
    for probes, recall in lines["ivf"]["recall"].items():
        want = jrecall(gt, index.search(queries, 10, JIVFSearch(
            n_probes=int(probes), k_reorder=1)))
        assert abs(hits(recall) - hits(want)) <= 1, (probes, recall, want)


def test_resumed_build_equals_uninterrupted(full, jax_side):
    """The build stopped after one segment and resumed (in 30-round
    segments) against VamanaIndex.build (uninterrupted): the same graph
    bit for bit."""
    directory, lines, stopped = full
    assert not stopped["done"] and stopped["next_round"] == SEGMENT
    assert stopped["projected_s"] > stopped["seconds"] > 0
    assert lines["build"]["resumed_at_round"] == SEGMENT
    assert lines["build"]["prune_chunk"] == 256      # build_graph's default
    got = VamanaIndex.assemble(os.path.join(directory, "index"),
                               device="cpu")
    want = VamanaIndex.build(narrow_parameters(), jax_side[0], "l2",
                             sampled_entries=True, device="cpu")
    assert got.entry_point == want.entry_point
    n = want.graph.n
    assert torch.equal(got.graph.adjacency[:n], want.graph.adjacency[:n])
    assert torch.equal(got.graph.degrees[:n], want.graph.degrees[:n])
    assert torch.equal(got.data.vectors, want.data.vectors)


def test_a_step_needs_its_inputs(tmp_path):
    with pytest.raises(RuntimeError, match="first"):
        scale_10m.run(str(tmp_path), steps=("f32",), device="cpu", n=N,
                      n_queries=NQ)


def test_cli_runs_a_step(tmp_path, capsys, monkeypatch):
    """The command line runs the 10M configuration (here cut through the
    module's sizes); it has no size options."""
    monkeypatch.setattr(scale_10m, "N", 500)
    monkeypatch.setattr(scale_10m, "N_QUERIES", 20)
    assert scale_10m.main(["--dir", str(tmp_path), "--device", "cpu",
                           "--step", "data"]) == 0
    (line,) = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert line["step"] == "data" and line["rows"] == [500, 96]
    assert (line["n"], line["n_queries"], line["seed"]) == (500, 20, 13)
    assert np.load(tmp_path / "queries.npy").shape == (20, 96)
    with pytest.raises(SystemExit):
        scale_10m.main(["--dir", str(tmp_path), "--n", "500"])


@pytest.mark.parametrize("what", ["config", "step line", "build state"])
def test_a_cache_of_another_configuration_is_refused(tmp_path, what):
    directory = str(tmp_path)
    scale_10m.run(directory, steps=("data",), device="cpu", n=300,
                  n_queries=20)
    if what == "config":
        with pytest.raises(RuntimeError, match="config.json"):
            scale_10m.Run(directory, device="cpu", n=301, n_queries=20)
        return
    if what == "step line":
        os.remove(os.path.join(directory, "config.json"))
        with pytest.raises(RuntimeError, match="data.json"):
            scale_10m.run(directory, steps=("data",), device="cpu", n=300,
                          n_queries=21)
        return
    run = scale_10m.Run(directory, device="cpu", n=300, n_queries=20)
    os.makedirs(run.path("build_state"))
    state = {**run.config(), "prune_chunk": 4096}
    with open(run.path("build_state", "state.json"), "w") as f:
        json.dump(state, f)
    with pytest.raises(RuntimeError, match="chunks of 4096"):
        scale_10m._load_state(run, run.n, 32)
    with open(run.path("build_state", "state.json"), "w") as f:
        json.dump({**state, "n": 600, "prune_chunk": 256}, f)
    with pytest.raises(RuntimeError, match="build_state"):
        scale_10m._load_state(run, run.n, 32)


def test_needs_a_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        scale_10m.run(str(tmp_path))
