"""Every adjacency row in which the port's Vamana build differs from the JAX
package's, proven a near-tie.

Both packages run the Deep-10M run's build (``benchmark/scale_10m.py``:
alpha 1.1, R 32, window 100, pool 300, ``prune_to`` 28, sampled entries)
over the first 1,000 rows of its generator, round by round from one state:
before each round the JAX package's ``build_round`` is given the port's
graph, so that every difference is that round's own and not a later
round's echo of an earlier one.  A row x that differs after a round is
explained when

- a decision of a prune sits on a tie in float64: for an id v in one
  package's row and not the other's, or at another place in it, either
  alpha * d(p, v) against d(x, v), for p in either row and alpha 1 or 1.1
  (the prune's two levels), or d(x, v) against d(x, w), for w in either
  row, lies within ``TIE`` of the squared norms involved: a few units of
  float32 rounding of keys formed as ||a||^2 - 2<a, b> + ||b||^2; or
- it differs in an edge to a row so explained (a reverse edge of that
  row's differing edges, or its re-prune).

Every differing row must be explained.  As a control, rows of each batch
that do not differ are put to the first test as if two of their ids had
differed: under a tenth of them may pass, so that a difference that is
not a tie fails the test all but surely.

The run's prune-chunk trial (``scale_10m.prune_chunk_trial``) is held
here too: pruning a round in smaller chunks than ``build_graph``'s
default gives the same graph bit for bit.
"""

import numpy as np
import torch

import jax.numpy as jnp

from scalablevectorsearch_tpu.core.data import VectorDataset as JData
from scalablevectorsearch_tpu.core.graph import NeighborGraph as JGraph
from scalablevectorsearch_tpu.core.medioid import (
    compute_medioid as jmedioid)
from scalablevectorsearch_tpu.index.vamana import build as jbuild
from scalablevectorsearch_tpu.index.vamana import search as jsearch
from scalablevectorsearch_tpu.index.vamana.entry import (
    build_sampler as jsampler)
from scalablevectorsearch_tpu.ops import distance as jdist

from scalablevectorsearch_tpu_torch.benchmark import scale_10m
from scalablevectorsearch_tpu_torch.core.data import VectorDataset
from scalablevectorsearch_tpu_torch.core.graph import NeighborGraph
from scalablevectorsearch_tpu_torch.core.io import generate_test_dataset
from scalablevectorsearch_tpu_torch.core.medioid import compute_medioid
from scalablevectorsearch_tpu_torch.index.vamana import build as tbuild
from scalablevectorsearch_tpu_torch.index.vamana.entry import build_sampler

torch.set_num_threads(1)

N = 1000
TIE = 2.0 ** -21


def explained_rows(x64, at, aj, differing, changed=None) -> dict:
    """{row: why} for the rows of ``differing`` (after one round from one
    state, ``at`` the port's adjacency, ``aj`` the JAX package's) that a
    float64 near-tie or a chain of differing edges from one explains.
    ``changed``: a row's ids to test for ties (default: those in which
    the two rows differ; the control picks others)."""
    norms = (x64 ** 2).sum(1)

    def d(a, b):
        return float(((x64[a] - x64[b]) ** 2).sum())

    def edges(adj, x):
        return set(int(i) for i in adj[x] if i >= 0)

    def differ(x):
        moved = at[x] != aj[x]
        return (edges(at, x) ^ edges(aj, x)) | set(
            int(i) for i in np.concatenate([at[x][moved], aj[x][moved]])
            if i >= 0)

    changed = changed or differ

    why = {}
    for x in differing:
        both = edges(at, x) | edges(aj, x)
        gaps = [(abs(alpha * d(p, v) - d(x, v))
                 / (alpha * (norms[p] + norms[v]) + norms[x] + norms[v]),
                 f"alpha {alpha} * d({p}, {v}) against d({x}, {v})")
                for v in changed(x) for p in both - {v, x}
                for alpha in (1.0, 1.1)]
        gaps += [(abs(d(x, v) - d(x, w)) / (norms[x] + norms[v] + norms[w]),
                  f"d({x}, {v}) against d({x}, {w})")
                 for v in changed(x) for w in both - {v, x}]
        gap, what = min(gaps, default=(np.inf, ""))
        if gap <= TIE:
            why[x] = f"{what}: {gap:.3g}"
    grew = True
    while grew:
        grew = False
        for x in differing:
            root = next((u for u in why if x in changed(u)), None)
            if x not in why and root is not None:
                why[x] = f"an edge of row {root}"
                grew = True
    return why


def test_every_differing_build_row_is_a_near_tie():
    rows, _ = generate_test_dataset(N, 1, 96, seed=scale_10m.SEED)
    x64 = rows.astype(np.float64)
    params = scale_10m.build_parameters().resolved("l2")
    r, window = params.graph_max_degree, params.window_size
    data, jdata = VectorDataset.from_array(rows, device="cpu"), \
        JData.from_array(rows)
    entry = compute_medioid(data)
    assert entry == jmedioid(jdata)
    sampler = jsampler(jdata, None, seed=0)
    sample_ids = np.asarray(sampler.ids)
    assert np.array_equal(build_sampler(data, None, seed=0).ids.numpy(),
                          sample_ids)
    b = tbuild.default_batch_size(N)
    num_batches = -(-N // b)
    graph = NeighborGraph.empty(N, r, device="cpu")
    differing, unexplained, control = 0, [], []
    rng = np.random.default_rng(0)
    for rnd in range(2 * num_batches):
        pass_idx, batch_idx = divmod(rnd, num_batches)
        start = batch_idx * b
        state = JGraph(adjacency=jnp.asarray(graph.adjacency.numpy()),
                       degrees=jnp.asarray(graph.degrees.numpy()), n=N,
                       max_degree=r)
        graph, _ = tbuild.build_graph(
            data, params, "l2", entry_point=entry, batch_size=b,
            pop_width=4, tail_frac=4, sampled_entries=True, graph=graph,
            _rounds=(rnd, rnd + 1))
        ids = np.arange(start, start + b, dtype=np.int32)
        valid = ids < N
        jgraph, _ = jbuild.build_round(
            state, jdata, jnp.asarray(np.minimum(ids, N - 1)),
            jnp.asarray(valid), jnp.asarray([entry], dtype=jnp.int32),
            sampler, jnp.asarray(sample_ids >= (N if pass_idx else start)),
            window=window, capacity=window,
            max_iters=jsearch.default_max_iters(window),
            distance=jdist.DistanceType.L2,
            pool_size=params.max_candidate_pool_size,
            gen_alpha=float(params.alpha),
            rev_alpha=(1.0, float(params.alpha))[pass_idx],
            prune_to=params.prune_to, max_degree=r, prune_chunk=256,
            pop_width=4, tail_frac=4)
        at = graph.adjacency.numpy()[:N]
        aj = np.asarray(jgraph.adjacency)[:N]
        rows_off = [int(x) for x in np.nonzero((at != aj).any(1))[0]]
        why = explained_rows(x64, at, aj, rows_off)
        differing += len(rows_off)
        unexplained += [(rnd, x) for x in rows_off if x not in why]
        same = [int(x) for x in ids[valid] if x not in rows_off
                and (at[x] >= 0).sum() >= 2][:5]
        picks = {x: set(rng.choice(at[x][at[x] >= 0], 2, replace=False)
                        .tolist()) for x in same}
        control += [x in explained_rows(x64, at, aj, [x], picks.get)
                    for x in same]
    assert differing > 0          # the packages round differently
    assert not unexplained, (unexplained, differing)
    assert np.mean(control) < 0.1, np.mean(control)


def test_prune_chunk_trial_gives_the_same_graph(tmp_path):
    out = scale_10m.prune_chunk_trial(
        str(tmp_path), chunks=(4, None), segments=2, segment_rounds=5,
        device="cpu", n=600, n_queries=20)      # batches of 15 rows
    assert out["identical"] is True
    for chunk in ("4", "256"):
        assert [line["next_round"] for line in out[chunk]] == [5, 10]
        assert all(line["prune_chunk"] == int(chunk) and not line["done"]
                   for line in out[chunk])
