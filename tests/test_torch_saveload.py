"""Checkpoints of the PyTorch port against the JAX package's.

Every dataset kind, the Vamana index (directories and streams) and the flat
index are saved by one package and loaded by the other, in both
directions, on the same seeded 600 x 48 data: the loaded arrays and
capacities equal the saved object's (LVQ reconstruction norms within rtol
1e-6, since the JAX package recomputes them in f32 on load and the port in
float64 as ``compress`` does; row norms of a ``VectorDataset`` within rtol
1e-6, since each package sums them in its own order), the config tables
are equal apart from the UUID blob names, and the blobs are byte-equal.
"""

import io
import json
import os
import shutil

import numpy as np
import pytest
import torch

from scalablevectorsearch_tpu.core import loading as jloading
from scalablevectorsearch_tpu.core.data import VectorDataset as JVD
from scalablevectorsearch_tpu.core.data import save_vectors_host as jsvh
from scalablevectorsearch_tpu.core.io import generate_test_dataset
from scalablevectorsearch_tpu.index.flat import FlatIndex as JFlatIndex
from scalablevectorsearch_tpu.index.vamana import index as jindex_mod
from scalablevectorsearch_tpu.index.vamana.params import (
    VamanaBuildParameters as JParams)
from scalablevectorsearch_tpu.lib import saveload as jsaveload
from scalablevectorsearch_tpu.ops.distance import DistanceType as JDistance
from scalablevectorsearch_tpu.orchestrators.vamana import Vamana as JVamana
from scalablevectorsearch_tpu.quantization import lvq as jlvq
from scalablevectorsearch_tpu.quantization.scalar import SQDataset as JSQ
from scalablevectorsearch_tpu.utils import upgrader

import scalablevectorsearch_tpu_torch as svt
from scalablevectorsearch_tpu_torch import interop
from scalablevectorsearch_tpu_torch.core import data as tdata
from scalablevectorsearch_tpu_torch.core import loading as tloading
from scalablevectorsearch_tpu_torch.index.vamana import index as tindex_mod
from scalablevectorsearch_tpu_torch.lib import datatypes as tdt
from scalablevectorsearch_tpu_torch.lib import saveload as tsaveload
from scalablevectorsearch_tpu_torch.quantization import lvq as tlvq

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEGACY = os.path.join(ROOT, "data", "legacy")
N, DIM = 600, 48
NORMS = ("norms_sq", "full_norms_sq")
FIELDS = {
    "VectorDataset": ("vectors", "norms_sq"),
    "SQDataset": ("codes", "norms_sq", "code_sums", "scale", "bias"),
    "LVQDataset": ("codes", "scales", "biases", "mean", "norms_sq",
                   "res_codes", "res_scales", "full_norms_sq"),
}
LVQ_KINDS = {"lvq8": (8, 0), "lvq4": (4, 0), "lvq8x8": (8, 8),
             "lvq4x8": (4, 8)}
KINDS = ["float32", "bfloat16", "float16", "int8", "uint8", "sq8",
         *LVQ_KINDS]


@pytest.fixture(scope="module")
def rows():
    return generate_test_dataset(N, 40, DIM, seed=11)


def make_pair(kind: str, data: np.ndarray):
    """The same dataset made by each package: (JAX's, the port's)."""
    if kind in ("float32", "bfloat16", "float16"):
        return (JVD.from_array(data, dtype=kind),
                svt.VectorDataset.from_array(data, dtype=kind, device="cpu"))
    if kind in ("int8", "uint8"):
        shift = 128 if kind == "uint8" else 0
        ints = np.clip(np.rint(data * 30) + shift, -128 + shift,
                       127 + shift).astype(kind)
        return (JVD.from_array(ints),
                svt.VectorDataset.from_array(ints, device="cpu"))
    if kind == "sq8":
        return JSQ.compress(data), svt.SQDataset.compress(data, device="cpu")
    bits, res = LVQ_KINDS[kind]
    return (jlvq.LVQDataset.compress(data, bits=bits, residual_bits=res),
            svt.LVQDataset.compress(data, bits=bits, residual_bits=res,
                                    device="cpu"))


def arrays(ds) -> dict:
    """A dataset's state (either package) as host arrays, bfloat16 as its
    bits, scalars as f32, plus its capacity."""
    out = {"capacity": np.asarray(ds.capacity)}
    for name in FIELDS[type(ds).__name__]:
        v = getattr(ds, name)
        if isinstance(v, torch.Tensor):
            a = (v.view(torch.int16) if v.dtype == torch.bfloat16
                 else v).numpy()
        else:
            a = np.asarray(v)
            if a.dtype.name == "bfloat16":
                a = a.view(np.int16)
        out[name] = a.astype(np.float32) if a.ndim == 0 else a
    return out


def assert_same(got: dict, want: dict, norms_rtol: float = 0.0) -> None:
    assert got.keys() == want.keys()
    for name, w in want.items():
        if name in NORMS and norms_rtol:
            np.testing.assert_allclose(got[name], w, rtol=norms_rtol,
                                       err_msg=name)
        else:
            assert got[name].dtype == w.dtype, name
            np.testing.assert_array_equal(got[name], w, err_msg=name)


def assert_same_checkpoint(a, b) -> None:
    """Two checkpoint directories: equal tables apart from the UUID blob
    names, byte-equal blobs (sub-directories compared alike)."""
    ta, tb = jsaveload.read_table(str(a)), jsaveload.read_table(str(b))

    def blobs(t):
        return sorted(k for k, v in t.items()
                      if isinstance(v, str) and v.endswith(".npy"))

    assert blobs(ta) == blobs(tb)
    assert {k: v for k, v in ta.items() if k not in blobs(ta)} == \
        {k: v for k, v in tb.items() if k not in blobs(tb)}
    for key in blobs(ta):
        assert (a / ta[key]).read_bytes() == (b / tb[key]).read_bytes(), key


@pytest.mark.parametrize("kind", KINDS)
def test_dataset_checkpoint_crosses_both_ways(rows, kind, tmp_path):
    jds, tds = make_pair(kind, rows[0])
    assert_same(arrays(tds), arrays(jds), norms_rtol=1e-6)
    want_capacity = (tdt.padded_count(N, tds.dtype)
                     if isinstance(tds, svt.VectorDataset)
                     else tdt.pad_to(N, 32))
    assert tds.capacity == want_capacity
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jsaveload.save_to_disk(jds, str(jdir))
    tsaveload.save_to_disk(tds, str(tdir))
    assert_same_checkpoint(jdir, tdir)

    from_jax = tloading.dispatch_load(str(jdir), device="cpu")
    from_port = jloading.dispatch_load(str(tdir))
    assert type(from_jax) is type(tds)
    assert_same(arrays(from_jax), arrays(jds), norms_rtol=1e-6)
    assert_same(arrays(from_port), arrays(tds), norms_rtol=1e-6)
    assert_same(arrays(from_jax), arrays(from_port), norms_rtol=1e-6)
    # the port's own round trip is bit for bit, norms included
    assert_same(arrays(tloading.dispatch_load(str(tdir), device="cpu")),
                arrays(tds))


@pytest.mark.parametrize("fixture,bits,res", [("lvq8_v001", 8, 0),
                                              ("lvq4x8_v001", 4, 8)])
def test_legacy_lvq_fixture_loads_as_jax_loads_it(fixture, bits, res,
                                                  tmp_path):
    """The committed v0.0.1 checkpoints (unpadded, unpacked codes) load in
    the port to the arrays the JAX package loads after its upgrader (its
    own loader reads a v0.0.1 second level only once upgraded), and decode
    within 1e-5 of a fresh compress of the fixture data."""
    got = tloading.dispatch_load(os.path.join(LEGACY, fixture), device="cpu")
    upgraded = tmp_path / fixture
    shutil.copytree(os.path.join(LEGACY, fixture), upgraded)
    upgrader.upgrade(str(upgraded), backup=False)
    assert_same(arrays(got), arrays(jloading.dispatch_load(str(upgraded))),
                norms_rtol=1e-6)
    x = np.random.default_rng(7).normal(size=(48, 20)).astype(np.float32)
    fresh = svt.LVQDataset.compress(x, bits=bits, residual_bits=res,
                                    device="cpu")
    np.testing.assert_allclose(got.to_numpy(), fresh.to_numpy(), atol=1e-5)


def test_host_writers_match_jax(rows, tmp_path):
    """``compress_and_save_host`` and ``save_vectors_host`` (bfloat16 rows)
    write the JAX package's bytes; the LVQ one loads back equal to
    ``LVQDataset.compress`` bit for bit."""
    data = rows[0]
    jlvq.compress_and_save_host(str(tmp_path / "jl"), data, 4, 8)
    tlvq.compress_and_save_host(str(tmp_path / "tl"), data, 4, 8)
    assert_same_checkpoint(tmp_path / "jl", tmp_path / "tl")
    assert_same(arrays(tloading.dispatch_load(str(tmp_path / "tl"),
                                              device="cpu")),
                arrays(svt.LVQDataset.compress(data, 4, 8, device="cpu")))
    jsvh(str(tmp_path / "jv"), data, eltype="bfloat16")
    tdata.save_vectors_host(str(tmp_path / "tv"), data, eltype="bfloat16")
    assert_same_checkpoint(tmp_path / "jv", tmp_path / "tv")


@pytest.fixture(scope="module")
def jax_index(rows):
    """A JAX Vamana index (L2, sampled entries) at window 16, and the
    port's index over its state (``interop.vamana_from_arrays``)."""
    data, _queries = rows
    jv = JVamana.build(JParams(graph_max_degree=16, window_size=24,
                               max_candidate_pool_size=60, prune_to=14,
                               alpha=1.2), data, "l2", sampled_entries=True)
    jv.search_window_size = 16
    ji = jv.index
    carried = interop.vamana_from_arrays(
        np.asarray(ji.data.vectors)[:N, :DIM], np.asarray(ji.graph.adjacency),
        np.asarray(ji.graph.degrees), ji.entry_point, ji.distance.value,
        sampler_ids=np.asarray(ji._entry_sampler.ids), device="cpu")
    carried.search_window_size = 16
    return jv, carried


def assert_same_index(got, want) -> None:
    """Two port indexes hold the same state."""
    for a, b in ((got.graph.adjacency, want.graph.adjacency),
                 (got.graph.degrees, want.graph.degrees),
                 (got.data.vectors, want.data.vectors),
                 (got.data.norms_sq, want.data.norms_sq),
                 (got._entry_sampler.ids, want._entry_sampler.ids)):
        assert torch.equal(a, b)
    assert got.entry_point == want.entry_point


def test_vamana_checkpoint_crosses_both_ways(rows, jax_index, tmp_path):
    """JAX saves, the port assembles: the state of
    ``interop.vamana_from_arrays`` and its search, identically, and the JAX
    search's slots within the port's usual 98%.  The port saves that index
    again, JAX assembles it: the original JAX search, identically."""
    data, queries = rows
    jv, carried = jax_index
    jv.save(str(tmp_path / "jax"))
    tv = svt.Vamana.assemble(str(tmp_path / "jax"), device="cpu")
    assert tv.index._entry_cfg == jv.index._entry_cfg
    assert tv.search_window_size == 16
    assert_same_index(tv.index, carried)
    got, want = tv.search(queries, 10), carried.search(queries, 10)
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_array_equal(got.distances, want.distances)
    jres = jv.search(queries, 10)
    assert (np.sort(got.ids, 1) == np.sort(jres.ids, 1)).mean() >= 0.98

    tv.save(str(tmp_path / "port"))
    for sub in ("graph", "data"):
        assert_same_checkpoint(tmp_path / "jax" / sub, tmp_path / "port" / sub)
    with open(tmp_path / "jax" / "vamana_config.json") as fa, \
            open(tmp_path / "port" / "vamana_config.json") as fb:
        assert json.load(fa) == json.load(fb)
    back = JVamana.assemble(str(tmp_path / "port")).search(queries, 10)
    np.testing.assert_array_equal(back.ids, jres.ids)
    np.testing.assert_array_equal(back.distances, jres.distances)

    # save_host writes the same checkpoint from the host rows
    tv.index.save_host(str(tmp_path / "host"), data)
    for sub in ("graph", "data"):
        assert_same_checkpoint(tmp_path / "port" / sub,
                               tmp_path / "host" / sub)


def test_stream_archive_crosses_both_ways(rows, jax_index, tmp_path):
    """Both packages pack one directory to the same bytes; a JAX stream
    assembles in the port and a port stream in JAX, each searching as the
    index it came from."""
    _data, queries = rows
    jv, carried = jax_index
    jv.save(str(tmp_path))
    packs = [io.BytesIO(), io.BytesIO()]
    jindex_mod.saveload_pack_tree(str(tmp_path), packs[0])
    tindex_mod.saveload_pack_tree(str(tmp_path), packs[1])
    assert packs[0].getvalue() == packs[1].getvalue()

    stream = io.BytesIO()
    jv.save_stream(stream)
    stream.seek(0)
    tv = svt.Vamana.assemble_stream(stream, device="cpu")
    assert_same_index(tv.index, carried)
    np.testing.assert_array_equal(tv.search(queries, 10).ids,
                                  carried.search(queries, 10).ids)
    stream = io.BytesIO()
    tv.save_stream(stream)
    stream.seek(0)
    back = JVamana.assemble_stream(stream).search(queries, 10)
    want = jv.search(queries, 10)
    np.testing.assert_array_equal(back.ids, want.ids)
    np.testing.assert_array_equal(back.distances, want.distances)


def test_flat_checkpoint_crosses_both_ways(rows, tmp_path):
    data, queries = rows
    jflat = JFlatIndex.from_array(data, distance="mip")
    jflat.save(str(tmp_path / "jax"))
    tflat = svt.Flat.assemble(str(tmp_path / "jax"), device="cpu")
    want, got = jflat.search(queries, 10), tflat.search(queries, 10)
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_allclose(got.distances, want.distances, rtol=1e-5)
    tflat.save(str(tmp_path / "port"))
    assert_same_checkpoint(tmp_path / "jax", tmp_path / "port")
    back = JFlatIndex.assemble(str(tmp_path / "port")).search(queries, 10)
    np.testing.assert_array_equal(back.ids, want.ids)


@pytest.mark.parametrize("metric", ["L2", "MIP", "Cosine"])
def test_host_rerank_batch_bit_equal_to_jax(metric):
    rng = np.random.default_rng(3)
    vectors = rng.normal(size=(300, DIM)).astype(np.float32)
    norms = np.einsum("nd,nd->n", vectors, vectors).astype(np.float32)
    q = rng.normal(size=(20, DIM)).astype(np.float32)
    ids = rng.integers(0, 300, size=(20, 24)).astype(np.int32)
    ids[rng.random(ids.shape) < 0.2] = -1
    want = jindex_mod._host_rerank_batch(ids, q, vectors, norms,
                                         JDistance(metric), 10)
    got = tindex_mod._host_rerank_batch(ids, q, vectors, norms,
                                        svt.DistanceType(metric), 10)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_loaders_default_to_cuda(rows, jax_index, tmp_path):
    """Without a card, a loader given no device raises instead of loading
    onto the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    jax_index[0].save(str(tmp_path))
    with pytest.raises((RuntimeError, AssertionError)):
        tloading.dispatch_load(str(tmp_path / "data"))
    with pytest.raises((RuntimeError, AssertionError)):
        svt.Vamana.assemble(str(tmp_path))
