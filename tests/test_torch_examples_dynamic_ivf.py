"""The port's dynamic and IVF examples
(``scalablevectorsearch_tpu_torch/examples``) against the JAX package's
examples' calls on the CPU, as ``tests/test_torch_examples.py`` says.
"""

import numpy as np
import torch

import jax.numpy as jnp

from scalablevectorsearch_tpu.core.io import generate_test_dataset as jgen
from scalablevectorsearch_tpu.core.recall import k_recall_at_n
from scalablevectorsearch_tpu.index.flat import exhaustive_search as jexh
from scalablevectorsearch_tpu.index.ivf import kmeans as jkm
from scalablevectorsearch_tpu.index.ivf.clustering import (
    Clustering as JClustering)
from scalablevectorsearch_tpu.index.ivf.index import IVFIndex as JIVF
from scalablevectorsearch_tpu.index.ivf.params import (
    IVFBuildParameters as JIVFParams, IVFSearchParameters as JIVFSearch)
from scalablevectorsearch_tpu.index.vamana.params import (
    VamanaBuildParameters as JParams)
from scalablevectorsearch_tpu.orchestrators.dynamic_vamana import (
    DynamicVamana as JDynamicVamana)
from scalablevectorsearch_tpu.quantization.lvq import LVQDataset as JLVQ

from scalablevectorsearch_tpu_torch.examples import (example_dynamic,
                                                     example_ivf)
from scalablevectorsearch_tpu_torch.index.ivf import kmeans as tkm

torch.set_num_threads(1)

DYNAMIC = dict(n=900, n_queries=50, dim=32, n_build=600, n_add=200,
               n_delete=100)
IVF = dict(n=3000, n_queries=100, dim=32, num_centroids=48,
           minibatch_size=1000)


def test_dynamic_example_matches_jax():
    """Identical sizes, recall within 0.01 after consolidate and compact,
    and no deleted id surfacing before or after."""
    out = example_dynamic.run("cpu", **DYNAMIC)

    n_build, n_add, n_delete = (DYNAMIC[k] for k in ("n_build", "n_add",
                                                     "n_delete"))
    data, queries = jgen(DYNAMIC["n"], DYNAMIC["n_queries"], DYNAMIC["dim"],
                         seed=7)
    index = JDynamicVamana.build(JParams(graph_max_degree=32, window_size=64),
                                 data[:n_build], np.arange(n_build), "l2")
    index.search_window_size = 40
    assert out["initial_size"] == index.size
    index.add_points(data[n_build:n_build + n_add],
                     np.arange(n_build, n_build + n_add))
    index.delete_points(np.arange(0, n_delete))
    assert out["size_after_add_delete"] == index.size
    index.consolidate().compact()
    live = np.sort(index.all_ids())
    gt = jexh(data[live], queries, 10)
    recall = k_recall_at_n(live[gt.ids], index.search(queries, 10))
    assert abs(out["recall"] - recall) <= 0.01
    assert not out["deleted_surfaced"]


def jax_init(x, seed, k):
    """The JAX package's k-means++ draws, as the port's seeding."""
    return torch.from_numpy(np.asarray(jkm._kmeanspp_init(
        jnp.asarray(x.numpy()), seed, k)))


def test_ivf_example_matches_jax(monkeypatch):
    """With the port's k-means++ seeding replaced by the JAX package's
    (the draws differ by design): the same cluster count and largest
    cluster, recall@10 within 0.01 at every n_probes and for the LVQ
    postings with the rerank."""
    monkeypatch.setattr(tkm, "_kmeanspp_init", jax_init)
    out = example_ivf.run("cpu", **IVF)

    data, queries = jgen(IVF["n"], IVF["n_queries"], IVF["dim"], seed=5)
    gt = jexh(data, queries, 10)
    clustering = JClustering.build(JIVFParams(
        num_centroids=IVF["num_centroids"],
        minibatch_size=IVF["minibatch_size"], num_iterations=8,
        training_fraction=0.5), data)
    assert out["clusters"] == clustering.num_centroids
    assert out["max_size"] == int(clustering.cluster_sizes().max())
    index = JIVF.assemble_from_clustering(clustering, data, "l2")
    for probes in example_ivf.PROBES:
        res = index.search(queries, 10, JIVFSearch(n_probes=probes))
        assert abs(out["recall"][str(probes)]
                   - k_recall_at_n(gt, res)) <= 0.01, probes
    compressed = JIVF.assemble_from_clustering(
        clustering, data, "l2", dataset_cls=JLVQ, rerank=True)
    res = compressed.search(queries, 10, JIVFSearch(n_probes=16,
                                                    k_reorder=3))
    assert abs(out["lvq_rerank"] - k_recall_at_n(gt, res)) <= 0.01
