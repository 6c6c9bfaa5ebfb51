"""The IVF family of the PyTorch port against the JAX package.

k-means (assignment, minibatch step, empty-cluster split, full-dataset
assignment, Lloyd's step, and whole trainings seeded with the JAX package's
initial centroids), the packed posting layouts, the static index over the
JAX package's clustering (three metrics, both scan routes, two chunk
sizes, LVQ-8 postings with rerank, int8 and float16 query uploads),
checkpoints in both directions, one dynamic-IVF mutation sequence, the
batch iterator and the orchestrators, all on the CPU (the port with
``device="cpu"``) on the same seeded numpy inputs.

The k-means++ seeding draws differ by design (the JAX package draws with
``jax.random``, the port with a ``torch.Generator``); everything after the
seeding is held to the JAX package.  Where result ids differ, the test
proves the rows tied: both lists hold the same exact distances (float64 on
the host) within 1e-5 relative.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from scalablevectorsearch_tpu.core.io import generate_test_dataset
from scalablevectorsearch_tpu.index.ivf import clustering as jclust
from scalablevectorsearch_tpu.index.ivf import dynamic as jdyn
from scalablevectorsearch_tpu.index.ivf import index as jidx
from scalablevectorsearch_tpu.index.ivf import iterator as jiter
from scalablevectorsearch_tpu.index.ivf import kmeans as jkm
from scalablevectorsearch_tpu.index.ivf import params as jparams
from scalablevectorsearch_tpu.core import kmeans as jcore_km
from scalablevectorsearch_tpu.lib import saveload as jsaveload
from scalablevectorsearch_tpu.quantization.lvq import LVQDataset as JLVQ

import scalablevectorsearch_tpu_torch as svt
from scalablevectorsearch_tpu_torch import interop
from scalablevectorsearch_tpu_torch.core import kmeans as tcore_km
from scalablevectorsearch_tpu_torch.index.ivf import clustering as tclust
from scalablevectorsearch_tpu_torch.index.ivf import dynamic as tdyn
from scalablevectorsearch_tpu_torch.index.ivf import index as tidx
from scalablevectorsearch_tpu_torch.index.ivf import kmeans as tkm
from scalablevectorsearch_tpu_torch.lib import saveload as tsaveload
from scalablevectorsearch_tpu_torch.quantization.lvq import LVQDataset

torch.set_num_threads(1)

K = 32
JBP = dict(num_centroids=K, num_iterations=4, training_fraction=0.5,
           is_hierarchical=False)


@pytest.fixture(scope="module")
def clustered():
    return generate_test_dataset(2000, 48, 32, seed=21)


@pytest.fixture(scope="module")
def jclustering(clustered):
    data, _ = clustered
    return jclust.Clustering.build(jparams.IVFBuildParameters(**JBP), data)


def port_clustering(jc):
    return tclust.Clustering(np.asarray(jc.centroids),
                             np.asarray(jc.assignments))


def exact_values(data, queries, ids, distance):
    """Public distances of (q, ids) pairs in float64; +inf for -1."""
    x = data[np.maximum(ids, 0)].astype(np.float64)
    q = queries.astype(np.float64)[:, None, :]
    if distance == "l2":
        v = ((x - q) ** 2).sum(-1)
    elif distance == "mip":
        v = -(x * q).sum(-1)          # smaller is better, as keys
    else:
        v = -(x * q).sum(-1) / (np.linalg.norm(x, axis=-1)
                                * np.linalg.norm(q, axis=-1))
    return np.where(ids >= 0, v, np.inf)


def norm_scale(data, queries, distance):
    """(nq, 1) scale of the keys' rounding: ||q||^2 + max ||x||^2 for L2
    (the norm algebra's terms), ||q|| max ||x|| for MIP, 1 for cosine."""
    q2 = (queries.astype(np.float64) ** 2).sum(1, keepdims=True)
    x2 = (data.astype(np.float64) ** 2).sum(1).max()
    if distance == "l2":
        return q2 + x2
    return np.sqrt(q2 * x2) if distance == "mip" else np.ones_like(q2)


def assert_same_neighbors(want, got, data, queries, distance,
                          rtol=1e-5, label=""):
    """Ids equal, except rows whose two lists hold the same exact distances
    (sorted, float64) within ``rtol`` of the keys' scale
    (:func:`norm_scale`): near-ties, whose order the rounding of the norm
    algebra decides.  Returned distances within ``rtol`` of that scale.
    Returns the count of tied rows."""
    want_ids, got_ids = np.asarray(want.ids), np.asarray(got.ids)
    scale = rtol * norm_scale(data, queries, distance)
    rows = np.nonzero((want_ids != got_ids).any(1))[0]
    if rows.size:
        vw = np.sort(exact_values(data, queries[rows], want_ids[rows],
                                  distance), 1)
        vg = np.sort(exact_values(data, queries[rows], got_ids[rows],
                                  distance), 1)
        diff = np.where(np.isinf(vg) & np.isinf(vw), 0, np.abs(vg - vw))
        bad = (diff > scale[rows]).any(1)
        assert not bad.any(), (label, rows[bad][:5])
    wd, gd = np.asarray(want.distances), np.asarray(got.distances)
    np.testing.assert_array_equal(np.isfinite(gd), np.isfinite(wd),
                                  err_msg=label)
    diff = np.where(np.isfinite(wd), np.abs(gd - wd), 0)
    assert (diff <= scale).all(), (label, diff.max(), scale.min())
    return rows.size


def assert_assign_equal(want, got, x, centroids, label):
    """Assignments equal except proven near-ties: the two centroids' exact
    distances to the row within 1e-5 relative."""
    want, got = np.asarray(want), np.asarray(got)
    diff = np.nonzero(want != got)[0]
    x64, c64 = x.astype(np.float64), np.asarray(centroids, np.float64)
    for r in diff:
        dw = ((x64[r] - c64[want[r]]) ** 2).sum()
        dg = ((x64[r] - c64[got[r]]) ** 2).sum()
        assert abs(dw - dg) <= 1e-5 * max(dw, 1e-30), (label, r, dw, dg)
    assert diff.size <= 0.01 * want.size, (label, diff.size)


def test_parameter_tables_equal_jax():
    for kw in ({}, JBP, dict(num_centroids=7, training_fraction=1.0)):
        j, t = jparams.IVFBuildParameters(**kw), svt.IVFBuildParameters(**kw)
        assert t.save_table() == j.save_table()
        assert svt.IVFBuildParameters.from_table(j.save_table()) == t
        for n in (5, 1000, 100_000):
            assert dataclasses_dict(t.resolved(n)) == \
                dataclasses_dict(j.resolved(n))
    js, ts = jparams.IVFSearchParameters(7, 3), svt.IVFSearchParameters(7, 3)
    assert ts.save_table() == js.save_table()
    assert svt.IVFSearchParameters.from_table(js.save_table()) == ts
    with pytest.raises(ValueError):
        svt.IVFSearchParameters(n_probes=0)


def dataclasses_dict(p):
    import dataclasses
    return dataclasses.asdict(p)


def test_kmeans_steps_match_jax(clustered):
    """_assign, _minibatch_step, _split_empty, assign_full and core Lloyd's
    step on identical inputs: assignments equal except proven near-ties,
    centroids and counts within rtol 1e-5."""
    data, _ = clustered
    rng = np.random.default_rng(0)
    cents = data[rng.choice(len(data), K, replace=False)] + \
        rng.normal(scale=0.1, size=(K, data.shape[1])).astype(np.float32)
    cn = (cents.astype(np.float64) ** 2).sum(1).astype(np.float32)
    want = jkm._assign(jnp.asarray(data), jnp.asarray(cents), jnp.asarray(cn))
    got = tkm._assign(torch.from_numpy(data), torch.from_numpy(cents),
                      torch.from_numpy(cn))
    assert_assign_equal(want, got.numpy(), data, cents, "_assign")
    assert_assign_equal(jkm.assign_full(data, cents, batch=768),
                        tkm.assign_full(data, cents, batch=768,
                                        device="cpu"), data, cents,
                        "assign_full")

    batch = data[:600]
    counts = rng.integers(0, 5, K).astype(np.float32)
    jc, jn, ja = jkm._minibatch_step(jnp.asarray(batch), jnp.asarray(cents),
                                     jnp.asarray(counts), K)
    tc, tn, ta = tkm._minibatch_step(torch.from_numpy(batch),
                                     torch.from_numpy(cents),
                                     torch.from_numpy(counts), K)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-5)

    jl, jla = jcore_km._lloyd_step(jnp.asarray(data), jnp.asarray(cents), K)
    tl, tla = tcore_km._lloyd_step(torch.from_numpy(data),
                                   torch.from_numpy(cents), K)
    np.testing.assert_array_equal(tla.numpy(), np.asarray(jla))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)

    dead = counts.copy()
    dead[[3, 9]] = 0
    jsplit = jkm._split_empty(cents.copy(), dead.copy(),
                              np.random.default_rng(4))
    tsplit = tkm._split_empty(cents.copy(), dead.copy(),
                              np.random.default_rng(4))
    for a, b in zip(jsplit, tsplit):
        np.testing.assert_array_equal(a, b)


def jax_init(x, seed, k):
    """The JAX package's k-means++ draws, as the port's seeding."""
    return torch.from_numpy(np.asarray(jkm._kmeanspp_init(
        jnp.asarray(x.numpy()), seed, k)))


@pytest.mark.parametrize("trainer", ["kmeans_training",
                                     "hierarchical_kmeans",
                                     "train_clustering"])
def test_training_matches_jax_given_its_seeding(clustered, monkeypatch,
                                                trainer):
    """With the port's seeding replaced by the JAX package's initial
    centroids, the whole training follows the JAX package: centroids
    within 1e-5 of the data's largest magnitude (measured: at most 1.2e-7;
    the sums run in another order) and assignments equal except proven
    near-ties."""
    data, _ = clustered
    monkeypatch.setattr(tkm, "_kmeanspp_init", jax_init)
    x = data[:1200]
    if trainer == "train_clustering":
        kw = dict(num_centroids=16, num_iterations=3, training_fraction=0.5,
                  is_hierarchical=True)
        jc, ja = jkm.train_clustering(x, jparams.IVFBuildParameters(**kw))
        tc, ta = tkm.train_clustering(x, svt.IVFBuildParameters(**kw),
                                      device="cpu")
        assert_assign_equal(ja, ta, x, jc, trainer)
    else:
        kw = dict(minibatch_size=400, num_iterations=3, seed=11)
        jc = getattr(jkm, trainer)(x, 16, **kw)
        tc = getattr(tkm, trainer)(x, 16, device="cpu", **kw)
    scale = np.abs(x).max()
    np.testing.assert_allclose(tc, jc, rtol=0, atol=1e-5 * scale)


def test_kmeanspp_init_properties():
    """The port's own draws: deterministic for one seed, distinct data
    rows, and on well-separated clusters one centroid per cluster."""
    rng = np.random.default_rng(2)
    centers = rng.normal(scale=100, size=(12, 16)).astype(np.float32)
    x = np.concatenate([c + rng.normal(size=(50, 16)).astype(np.float32)
                        for c in centers])
    xt = torch.from_numpy(x)
    a, b = tkm._kmeanspp_init(xt, 7, 12), tkm._kmeanspp_init(xt, 7, 12)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert not np.array_equal(a.numpy(),
                              tkm._kmeanspp_init(xt, 8, 12).numpy())
    rows = [np.nonzero((x == c).all(1))[0] for c in a.numpy()]
    assert all(r.size == 1 for r in rows)
    picked = np.concatenate(rows)
    assert np.unique(picked).size == 12
    np.testing.assert_array_equal(np.sort(picked // 50), np.arange(12))


def test_packed_layouts_match_jax(clustered, jclustering):
    """pack_padded_clusters and _pack_layout_host equal, balanced and on a
    skewed clustering chunked by max_posting_factor."""
    data, _ = clustered
    for assign, factor in ((np.asarray(jclustering.assignments), None),
                           (np.minimum(np.arange(2000) // 50, 9), 1.5)):
        if factor is None:
            jc, tc = jclustering, port_clustering(jclustering)
        else:
            cents = np.stack([data[assign == c].mean(0) for c in range(10)])
            jc = jclust.Clustering(cents, assign.astype(np.int32))
            tc = tclust.Clustering(cents, assign.astype(np.int32))
        want = jidx._pack_layout_host(jc, data, max_posting_factor=factor)
        got = tidx._pack_layout_host(tc, data, max_posting_factor=factor)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    assert got[0].shape[0] > 10                   # chunked: more units


def test_bf16_layout_with_nonmultiple16_total(tmp_path):
    """The JAX package's case: 3 clusters of 5, slot 8, 24 packed rows, bf16
    capacity 32; the padding mask is widened to the capacity, and each
    point finds itself, through a host-packed checkpoint and through
    assemble_from_clustering with bf16 rows."""
    import functools
    rng = np.random.default_rng(4)
    centers = np.asarray([[0, 0], [40, 40], [-40, 40]], np.float32)
    x = np.repeat(centers, 5, axis=0) + \
        rng.normal(size=(15, 2)).astype(np.float32)
    clustering = tclust.Clustering(centers, np.repeat(np.arange(3), 5)
                                   .astype(np.int32))
    tidx.save_packed_layout_host(str(tmp_path / "bf16"), clustering, x,
                                 "l2", eltype="bfloat16")
    idx = svt.IVF.assemble_from_file(str(tmp_path / "bf16"),
                                     device="cpu").index
    bf16_rows = functools.partial(svt.VectorDataset.from_array,
                                  dtype=torch.bfloat16)
    idx2 = svt.IVF.assemble_from_clustering(
        clustering, x, "l2", dataset_cls=type(
            "BF16Rows", (), {"from_array": staticmethod(bf16_rows)}),
        device="cpu").index
    for index in (idx, idx2):
        assert index.data.dtype == torch.bfloat16
        assert index.data.capacity == 32 and index.ids_padded.shape[0] == 24
        assert torch.isinf(index.data.norms_sq[24:]).all()
        res = index.search(x[:6], 1, svt.IVFSearchParameters(n_probes=3))
        np.testing.assert_array_equal(res.ids[:, 0], np.arange(6))
    jx = jidx.IVFIndex.assemble_from_file(str(tmp_path / "bf16"))
    want = jx.search(x[:6], 1, jparams.IVFSearchParameters(n_probes=3))
    np.testing.assert_array_equal(np.asarray(want.ids), idx.search(
        x[:6], 1, svt.IVFSearchParameters(n_probes=3)).ids)


def pair(jc, data, distance, **kw):
    """A JAX and a port IVFIndex over the same clustering."""
    return (jidx.IVFIndex.assemble_from_clustering(jc, data, distance, **kw),
            tidx.IVFIndex.assemble_from_clustering(
                port_clustering(jc), data, distance, device="cpu"))


@pytest.mark.parametrize("distance", ["l2", "mip", "cosine"])
def test_search_matches_jax(clustered, jclustering, distance, monkeypatch):
    """The port's search equals the JAX package's at 1, 6 and all probe
    units; under L2 also on the row-gather route
    (SVT_IVF_SCAN_LAYOUT=0) and at tiles_per_step 2, against the JAX
    default route."""
    monkeypatch.setenv("SVT_QUERY_UPLOAD_DTYPE", "float32")
    data, queries = clustered
    j, t = pair(jclustering, data, distance)
    ties = 0
    for probes in (1, 6, K):
        sp = jparams.IVFSearchParameters(n_probes=probes)
        want = j.search(queries, 10, sp)
        got = t.search(queries, 10, svt.IVFSearchParameters(probes))
        assert t._scan_vecs is not None
        ties += assert_same_neighbors(want, got, data, queries, distance,
                                      label=f"{distance} {probes}")
        if distance == "l2" and probes == 6:
            for layout, tiles in (("0", 0), ("1", 2), ("0", 2)):
                monkeypatch.setenv("SVT_IVF_SCAN_LAYOUT", layout)
                t._scan_vecs = t._scan_ids = None
                t._scan_sub = 0
                t.scan_tiles_per_step = tiles
                other = t.search(queries, 10, svt.IVFSearchParameters(6))
                assert (t._scan_vecs is None) == (layout == "0")
                ties += assert_same_neighbors(
                    want, other, data, queries, distance,
                    label=f"layout {layout} tiles {tiles}")
            monkeypatch.setenv("SVT_IVF_SCAN_LAYOUT", "1")
            t.scan_tiles_per_step = 0
    assert ties <= 0.05 * len(queries)


def test_full_probe_equals_exhaustive(clustered, jclustering):
    data, queries = clustered
    t = tidx.IVFIndex.assemble_from_clustering(
        port_clustering(jclustering), data, "l2", device="cpu")
    got = t.search(queries, 10, svt.IVFSearchParameters(t.num_probe_units))
    want = svt.exhaustive_search(data, queries, 10, device="cpu")
    assert_same_neighbors(want, got, data, queries, "l2")


def test_lvq_postings_with_rerank_match_jax(clustered, jclustering,
                                            monkeypatch):
    """LVQ-8 postings (decoded by the row-gather route) with the k_reorder
    rerank against f32 rows."""
    monkeypatch.setenv("SVT_QUERY_UPLOAD_DTYPE", "float32")
    data, queries = clustered
    j = jidx.IVFIndex.assemble_from_clustering(
        jclustering, data, "l2", dataset_cls=JLVQ, rerank=True)
    t = tidx.IVFIndex.assemble_from_clustering(
        port_clustering(jclustering), data, "l2", dataset_cls=LVQDataset,
        rerank=True, device="cpu")
    sp = dict(n_probes=6, k_reorder=3)
    want = j.search(queries, 10, jparams.IVFSearchParameters(**sp))
    got = t.search(queries, 10, svt.IVFSearchParameters(**sp))
    assert t._scan_vecs is None            # codes take the row-gather route
    assert_same_neighbors(want, got, data, queries, "l2")


def test_query_upload_dtype_is_honoured(clustered, jclustering,
                                        monkeypatch):
    """The per-index attribute overrides the env default and gives the JAX
    package's search under the same upload (float16, int8)."""
    data, queries = clustered
    j, t = pair(jclustering, data, "l2")
    sp = dict(n_probes=6)
    monkeypatch.setenv("SVT_QUERY_UPLOAD_DTYPE", "float32")
    f32 = t.search(queries, 10, svt.IVFSearchParameters(**sp))
    for dtype in ("float16", "int8"):
        t.query_upload_dtype = j.query_upload_dtype = None
        monkeypatch.setenv("SVT_QUERY_UPLOAD_DTYPE", dtype)
        env = t.search(queries, 10, svt.IVFSearchParameters(**sp))
        monkeypatch.setenv("SVT_QUERY_UPLOAD_DTYPE", "float32")
        t.query_upload_dtype = j.query_upload_dtype = dtype
        got = t.search(queries, 10, svt.IVFSearchParameters(**sp))
        np.testing.assert_array_equal(got.ids, env.ids)
        np.testing.assert_array_equal(got.distances, env.distances)
        assert not np.array_equal(got.distances, f32.distances)
        want = j.search(queries, 10, jparams.IVFSearchParameters(**sp))
        q_up = queries if dtype == "float16" else None
        if q_up is not None:
            q_up = queries.astype(np.float16).astype(np.float32)
        else:
            scale = np.abs(queries).max(1, keepdims=True) / 127.0
            q_up = np.rint(queries / scale).astype(np.int8) * scale
        assert_same_neighbors(want, got, data, q_up.astype(np.float32), "l2",
                              rtol=1e-4, label=dtype)


def test_checkpoints_cross_both_ways(clustered, jclustering, tmp_path):
    """IVFIndex.save / assemble_from_file, save_packed_layout_host and
    Clustering save / load, each written by one package and read by the
    other: equal layouts and searches."""
    data, queries = clustered
    j, t = pair(jclustering, data, "l2")
    sp = jparams.IVFSearchParameters(n_probes=6)
    want = j.search(queries, 10, sp)
    j.save(str(tmp_path / "jax"))
    t.save(str(tmp_path / "port"))
    tl = tidx.IVFIndex.assemble_from_file(str(tmp_path / "jax"),
                                          device="cpu")
    jl = jidx.IVFIndex.assemble_from_file(str(tmp_path / "port"))
    for loaded in (tl, t):
        np.testing.assert_array_equal(loaded.ids_padded.numpy(),
                                      np.asarray(j.ids_padded))
        np.testing.assert_array_equal(loaded.centroids.numpy(),
                                      np.asarray(j.centroids))
        np.testing.assert_array_equal(loaded.data.norms_sq.isinf().numpy(),
                                      np.isinf(np.asarray(j.data.norms_sq)))
        assert (loaded.slot, loaded.n, loaded.n_clusters) == \
            (j.slot, j.n, j.n_clusters)
        got = loaded.search(queries, 10, svt.IVFSearchParameters(6))
        assert_same_neighbors(want, got, data, queries, "l2")
    np.testing.assert_array_equal(np.asarray(jl.search(queries, 10, sp).ids),
                                  np.asarray(want.ids))
    carried = interop.ivf_from_arrays(
        np.asarray(j.centroids), np.asarray(j.data.vectors)[
            : j.ids_padded.shape[0], :32], np.asarray(j.ids_padded), j.slot,
        j.n, j.n_clusters, "l2", device="cpu")
    got = carried.search(queries, 10, svt.IVFSearchParameters(6))
    np.testing.assert_array_equal(got.ids, t.search(
        queries, 10, svt.IVFSearchParameters(6)).ids)

    for writer in ("jax", "port"):
        path = str(tmp_path / f"host_{writer}")
        (jidx if writer == "jax" else tidx).save_packed_layout_host(
            path, jclustering if writer == "jax" else
            port_clustering(jclustering), data, "l2", eltype="bfloat16")
        with open(os.path.join(path, "data", "svs_config.json")) as f:
            assert json.load(f)["eltype"] == "bfloat16"
        tl = tidx.IVFIndex.assemble_from_file(path, device="cpu")
        jl = jidx.IVFIndex.assemble_from_file(path)
        assert tl.data.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            tl.data.vectors.float().numpy(),
            np.asarray(jl.data.vectors).astype(np.float32))
        got = tl.search(queries, 10, svt.IVFSearchParameters(6))
        np.testing.assert_array_equal(
            got.ids, np.asarray(jl.search(queries, 10, sp).ids))

    for writer in ("jax", "port"):
        path = str(tmp_path / f"clust_{writer}")
        if writer == "jax":
            jsaveload.save_to_disk(jclustering, path)
            loaded = tsaveload.load_from_disk(tclust.Clustering, path)
        else:
            tsaveload.save_to_disk(port_clustering(jclustering), path)
            loaded = jsaveload.load_from_disk(jclust.Clustering, path)
        np.testing.assert_array_equal(loaded.centroids,
                                      np.asarray(jclustering.centroids))
        np.testing.assert_array_equal(loaded.assignments,
                                      np.asarray(jclustering.assignments))
        np.testing.assert_array_equal(
            loaded.cluster_sizes(), jclustering.cluster_sizes())


def row_of(ext_ids):
    ext_ids = np.asarray(ext_ids)
    return np.where(ext_ids >= 0, (ext_ids - 7) // 3, -1)


def test_dynamic_sequence_matches_jax(clustered):
    """Add with unit growth, delete, add into freed slots, compact: equal
    layouts (slot positions, unit owners, occupancy, padding norms, norms
    within rtol 1e-6) and searches after every step; interop carries the
    JAX index's state into an equal port index."""
    data, queries = clustered
    base = data[:1000]
    jc = jclust.Clustering.build(jparams.IVFBuildParameters(
        num_centroids=16, num_iterations=3, training_fraction=1.0,
        is_hierarchical=False), base)
    ext = np.arange(2000, dtype=np.int64) * 3 + 7
    j = jdyn.DynamicIVFIndex(jc, base, ext[:1000], "l2", slot_slack=1.0)
    t = tdyn.DynamicIVFIndex(port_clustering(jc), base, ext[:1000], "l2",
                             slot_slack=1.0, device="cpu")

    def check(step, units=None):
        np.testing.assert_array_equal(t.ids_padded.numpy(),
                                      np.asarray(j.ids_padded), step)
        np.testing.assert_array_equal(t.unit_owner, j.unit_owner, step)
        np.testing.assert_array_equal(t._occupied, j._occupied, step)
        np.testing.assert_array_equal(t._fill, j._fill, step)
        jn, tn = np.asarray(j.data.norms_sq), t.data.norms_sq.numpy()
        np.testing.assert_array_equal(np.isinf(tn), np.isinf(jn), step)
        np.testing.assert_allclose(tn[np.isfinite(jn)], jn[np.isfinite(jn)],
                                   rtol=1e-6, err_msg=step)
        if units is not None:
            assert t.num_probe_units == units, step
        live = np.sort(j.translator.all_external_ids())
        np.testing.assert_array_equal(t.all_ids(), live, step)
        for probes in (3,) if units is None else (3, units):
            sp = dict(n_probes=probes)
            want = j.search(queries, 10, jparams.IVFSearchParameters(**sp))
            got = t.search(queries, 10, svt.IVFSearchParameters(**sp))
            assert np.isin(got.ids[got.ids >= 0], live).all(), step
            # external id 3 r + 7 is data row r
            assert_same_neighbors(
                type(want)(ids=row_of(want.ids), distances=want.distances),
                type(got)(ids=row_of(got.ids), distances=got.distances),
                data, queries, "l2", label=step)

    check("init", 16)
    for idx_ in (j, t):
        idx_.add_points(data[1000:1600], ext[1000:1600])
    check("add", None)
    assert t.num_probe_units > 16
    dead = ext[:1600:3]
    for idx_ in (j, t):
        idx_.delete_points(dead)
    check("delete")
    for idx_ in (j, t):
        idx_.add_points(data[1600:1900], ext[1600:1900])
    check("add into freed slots")
    carried = interop.dynamic_ivf_from_arrays(
        j._base_centroids, np.asarray(j.data.vectors)[
            : j.unit_owner.size * j.slot, :32],
        np.asarray(j.ids_padded), j.slot, j.unit_owner, j._fill, j._occupied,
        j.translator.to_external(np.flatnonzero(j._occupied)), "l2",
        device="cpu")
    sp = dict(n_probes=5)
    np.testing.assert_array_equal(
        carried.search(queries, 10, svt.IVFSearchParameters(**sp)).ids,
        t.search(queries, 10, svt.IVFSearchParameters(**sp)).ids)
    for idx_ in (j, t):
        idx_.compact()
    check("compact", 16)


def test_iterator_pages_match_jax(clustered, jclustering, monkeypatch):
    """Pages of IVFBatchIterator over the same layout: disjoint, equal to
    the JAX package's except proven ties; restart repeats page one."""
    monkeypatch.setenv("SVT_QUERY_UPLOAD_DTYPE", "float32")
    data, queries = clustered
    j, t = pair(jclustering, data, "l2")
    ji = jiter.IVFBatchIterator(j, queries[0], batch_size=8)
    ti = svt.IVFBatchIterator(t, queries[0], batch_size=8)
    seen = set()
    for page in range(4):
        want, got = ji.next(), ti.next()
        assert_same_neighbors(want, got, data, queries[:1], "l2",
                              label=f"page {page}")
        assert not seen & set(got.ids[0].tolist())
        seen |= set(got.ids[0].tolist())
        assert ti.batch_number == ji.batch_number == page + 1
    first = got
    ti.restart()
    ji.restart()
    np.testing.assert_array_equal(ti.next().ids, ji.next().ids)
    assert first.ids.shape == (1, 8)


def test_orchestrators(clustered, tmp_path):
    """IVF and DynamicIVF through their public surface on the CPU."""
    data, queries = clustered
    params = svt.IVFBuildParameters(**JBP)
    ivf = svt.IVF.build(params, data, "l2", device="cpu")
    assert ivf.size == 2000 and ivf.num_centroids == K
    assert ivf.dimensions == 32 and ivf.index.num_probe_units == K
    ivf.n_probes = 8
    assert ivf.search_parameters == svt.IVFSearchParameters(8, 1)
    res = ivf.search(queries[:10], 5)
    assert res.ids.shape == (10, 5)
    np.testing.assert_array_equal(ivf.search_async(queries[:10], 5)
                                  .result().ids, res.ids)
    ivf.save(str(tmp_path / "ivf"))
    again = svt.IVF.assemble_from_file(str(tmp_path / "ivf"), device="cpu")
    assert again.index.build_parameters == params
    again.n_probes = 8
    np.testing.assert_array_equal(again.search(queries[:10], 5).ids,
                                  res.ids)
    ext = np.arange(1000, dtype=np.int64) * 5
    div = svt.DynamicIVF.build(params, data[:1000], ext, "l2", device="cpu")
    assert div.size == 1000 and div.has_id(5) and not div.has_id(6)
    div.add_points(data[1000:1100], np.arange(10_000, 10_100))
    div.delete_points(ext[:50])
    div.consolidate().compact()
    assert div.size == 1050 and div.dimensions == 32
    res = div.search(queries, 10)
    assert np.isin(res.ids, div.all_ids()).all()


def test_no_cpu_fallback(clustered):
    """With no device argument the IVF family goes to the GPU; with no card
    it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    data, _ = clustered
    params = svt.IVFBuildParameters(num_centroids=4, num_iterations=1)
    clustering = svt.Clustering.build(params, data[:200], device="cpu")
    for build in (lambda: svt.IVF.build(params, data[:200], "l2"),
                  lambda: svt.Clustering.build(params, data[:200]),
                  lambda: svt.IVF.assemble_from_clustering(
                      clustering, data[:200], "l2"),
                  lambda: svt.DynamicIVF.build(params, data[:200],
                                               np.arange(200), "l2")):
        with pytest.raises((RuntimeError, AssertionError)):
            build()
