"""IVF k-means training: minibatch + hierarchical.

PyTorch counterpart of ``scalablevectorsearch_tpu/index/ivf/kmeans.py``:

* minibatch k-means with per-centroid running-count learning rates and
  empty-cluster splitting (``kmeans_training``, reference
  ``include/svs/index/ivf/common.h:563-633``; ``centroid_split``
  ``common.h:450-543``);
* 2-level hierarchical training: level 1 over ~sqrt(K) clusters, then
  per-cluster level-2 k-means with centroids allocated in proportion to
  the cluster's mass (``hierarchical_kmeans.h:28-47,68-200``).

Assignment is one queries x centroids matmul + argmin (``compute_matmul``,
``common.h:241-323``), at full fp32 precision.

Two choices differ from the JAX package, each on purpose:

* **Per-cluster sums in a fixed order.**  ``jax.ops.segment_sum`` becomes
  :func:`_segment_sums`, a one-hot (K, m) x (m, d) matmul.  ``index_add_``
  would sum with atomics on the GPU, in an order that changes from run to
  run, and so would the centroids.
* **k-means++ draws.**  The JAX package draws its seeding with
  ``jax.random`` (threefry), which this package cannot reproduce without
  JAX.  :func:`_kmeanspp_init` draws from the same D^2 distribution with a
  ``torch.Generator`` seeded from ``seed``, by inverse CDF (one uniform per
  pick, nothing read back to the host).  Every numpy generator is the JAX
  package's, so given the same initial centroids the training is the same.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ...ops import distance as dist_ops
from .params import IVFBuildParameters

# rows of the one-hot matmul per chunk (bounds its (K, chunk) transient)
SEGMENT_CHUNK = 16384


def _segment_sums(values: torch.Tensor, assign: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-cluster sums (k, d) and counts (k,) of ``values`` (m, d) by
    ``assign`` (m,): one-hot matmuls at full fp32 precision over fixed
    chunks, summed in chunk order, so the result is the same on every
    run."""
    clusters = torch.arange(k, device=values.device)
    sums = values.new_zeros((k, values.shape[1]), dtype=torch.float32)
    counts = values.new_zeros((k,), dtype=torch.float32)
    for start in range(0, values.shape[0], SEGMENT_CHUNK):
        onehot = (assign[None, start:start + SEGMENT_CHUNK]
                  == clusters[:, None]).float()
        with dist_ops.matmul_precision(dist_ops.HIGHEST):
            sums = sums + onehot @ values[start:start + SEGMENT_CHUNK].float()
        counts = counts + onehot.sum(1)
    return sums, counts


def _assign(x: torch.Tensor, centroids: torch.Tensor,
            centroid_norms: torch.Tensor) -> torch.Tensor:
    """argmin-L2 assignment via norm algebra (common.h:854-890): the q-norm
    term is constant per row so only -2qc + |c|^2 is needed."""
    dots = dist_ops.dot_matrix(x, centroids)
    keys = centroid_norms[None, :] - 2.0 * dots
    return torch.argmin(keys, dim=-1).to(torch.int32)


def _minibatch_step(batch: torch.Tensor, centroids: torch.Tensor,
                    counts: torch.Tensor, num_centroids: int):
    """One minibatch update: assign, then move each centroid toward its
    members with a 1/count learning rate (Sculley-style; the reference's
    running-count update in kmeans_training)."""
    cn = centroids.square().sum(-1)
    assign = _assign(batch, centroids, cn)
    batch_sums, batch_counts = _segment_sums(batch, assign, num_centroids)
    new_counts = counts + batch_counts
    # target = running mean of all points seen so far
    lr = torch.where(new_counts > 0,
                     batch_counts / new_counts.clamp_min(1.0), 0.0)
    means = batch_sums / batch_counts.clamp_min(1.0)[:, None]
    centroids = torch.where((batch_counts > 0)[:, None],
                            centroids + lr[:, None] * (means - centroids),
                            centroids)
    return centroids, new_counts, assign


def _d2_to(x: torch.Tensor, x_norm: torch.Tensor, c: torch.Tensor
           ) -> torch.Tensor:
    """(n,) squared L2 distances of the rows of ``x`` to one row ``c``."""
    with dist_ops.matmul_precision(dist_ops.HIGHEST):
        dots = x @ c
    return (x_norm - 2.0 * dots + c.square().sum()).clamp_min(0.0)


def _kmeanspp_init(x: torch.Tensor, seed: int, k: int) -> torch.Tensor:
    """k-means++ seeding on ``x``'s device: each pick samples a row with
    probability proportional to its squared distance from the chosen set
    (D^2 sampling, weights ``min_d2 + 1e-30`` as in the JAX package), then
    folds the new centroid into the running min-D^2 with one matvec.

    Draws come from a ``torch.Generator`` seeded with ``seed``: one
    ``randint`` for the first row, then one uniform per pick, mapped
    through the float64 cumulative weights (``searchsorted``).  A row
    already chosen has weight 0 in float64 and is never drawn again.  The
    loop reads nothing back to the host."""
    n, d = x.shape
    x = x.float()
    gen = torch.Generator(device=x.device)
    gen.manual_seed(int(seed))
    x_norm = x.square().sum(-1)
    first = torch.randint(0, n, (1,), generator=gen, device=x.device)
    u = torch.rand((k,), generator=gen, device=x.device, dtype=torch.float64)
    centroids = x.new_zeros((k, d))
    c = x[first][0]
    centroids[0] = c
    min_d2 = _d2_to(x, x_norm, c)
    for i in range(1, k):
        cdf = torch.cumsum(min_d2.double() + 1e-30, 0)
        idx = torch.searchsorted(cdf, (u[i] * cdf[-1]).reshape(1),
                                 right=True).clamp_max(n - 1)
        c = x[idx][0]
        centroids[i] = c
        min_d2 = torch.minimum(min_d2, _d2_to(x, x_norm, c))
    return centroids


def _split_empty(centroids: np.ndarray, counts: np.ndarray,
                 rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    """Empty-cluster handling (common.h:450-543): replace each dead centroid
    with a jittered copy of the centroid with the largest count."""
    dead = counts < 1.0
    if not dead.any():
        return centroids, counts
    order = np.argsort(-counts)
    donors = order[: int(dead.sum())]
    idx_dead = np.nonzero(dead)[0]
    for d, donor in zip(idx_dead, donors):
        jitter = rng.normal(scale=1e-3, size=centroids.shape[1])
        centroids[d] = centroids[donor] + jitter
        counts[d] = counts[donor] / 2
        counts[donor] = counts[donor] / 2
    return centroids, counts


def kmeans_training(x: np.ndarray, num_centroids: int, *,
                    minibatch_size: int, num_iterations: int,
                    seed: int, device="cuda") -> np.ndarray:
    """Minibatch k-means on ``device``; returns (num_centroids, d) f32
    centroids.  The rows are uploaded once and each minibatch is gathered
    on the device; the centroids come back to the host once per iteration
    for the empty-cluster split."""
    x = np.asarray(x, dtype=np.float32)
    n = x.shape[0]
    num_centroids = min(num_centroids, n)
    rng = np.random.default_rng(seed)
    xd = torch.from_numpy(x).to(device)
    centroids = _kmeanspp_init(xd, seed, num_centroids)
    counts = torch.zeros((num_centroids,), dtype=torch.float32,
                         device=device)
    mb = min(minibatch_size, n)
    for _it in range(num_iterations):
        order = rng.permutation(n)
        for start in range(0, n, mb):
            sel = order[start: start + mb]
            if sel.size < mb:  # equal batches: wrap the tail
                sel = np.concatenate([sel, order[: mb - sel.size]])
            batch = xd[torch.from_numpy(sel).to(device)]
            centroids, counts, _ = _minibatch_step(
                batch, centroids, counts, num_centroids)
        c_host, n_host = _split_empty(centroids.cpu().numpy().copy(),
                                      counts.cpu().numpy().copy(), rng)
        centroids = torch.from_numpy(c_host).to(device)
        counts = torch.from_numpy(n_host).to(device)
    return centroids.cpu().numpy().copy()


def hierarchical_kmeans(x: np.ndarray, num_centroids: int, *,
                        minibatch_size: int, num_iterations: int,
                        seed: int, device="cuda") -> np.ndarray:
    """2-level training (hierarchical_kmeans.h:68-200): level 1 with
    ~sqrt(num_centroids) clusters, then per-level-1-cluster level-2 k-means
    with centroids allocated proportionally to cluster mass."""
    x = np.asarray(x, dtype=np.float32)
    n = x.shape[0]
    num_centroids = min(num_centroids, n)
    k1 = max(int(np.sqrt(num_centroids)), 1)
    level1 = kmeans_training(x, k1, minibatch_size=minibatch_size,
                             num_iterations=num_iterations, seed=seed,
                             device=device)
    assign = assign_full(x, level1, device=device)
    counts = np.bincount(assign, minlength=k1).astype(np.float64)

    # proportional allocation (hierarchical_kmeans.h:28-47)
    alloc = np.maximum(np.rint(counts / counts.sum() * num_centroids), 1
                       ).astype(np.int64)
    while alloc.sum() > num_centroids:
        alloc[np.argmax(alloc)] -= 1
    while alloc.sum() < num_centroids:
        alloc[np.argmax(counts / alloc)] += 1

    out = []
    rng = np.random.default_rng(seed + 1)
    for c in range(k1):
        members = x[assign == c]
        kc = int(alloc[c])
        if members.shape[0] == 0:
            out.append(level1[c][None, :].repeat(kc, axis=0)
                       + rng.normal(scale=1e-3, size=(kc, x.shape[1])))
            continue
        kc = min(kc, members.shape[0])
        out.append(kmeans_training(
            members, kc, minibatch_size=minibatch_size,
            num_iterations=max(num_iterations // 2, 2),
            seed=seed + 2 + c, device=device))
    centroids = np.concatenate(out, axis=0).astype(np.float32)
    return centroids[:num_centroids]


def assign_full(x: np.ndarray, centroids: np.ndarray, batch: int = 65536,
                device="cuda") -> np.ndarray:
    """Full-dataset cluster assignment in batches (common.h:775-850); one
    read back to the host at the end."""
    x = np.asarray(x, dtype=np.float32)
    c = torch.from_numpy(np.asarray(centroids, dtype=np.float32)).to(device)
    cn = c.square().sum(-1)
    parts = [_assign(torch.from_numpy(x[start: start + batch]).to(device),
                     c, cn)
             for start in range(0, x.shape[0], batch)]
    if not parts:
        return np.empty(0, dtype=np.int32)
    return torch.cat(parts).cpu().numpy()


def train_clustering(x: np.ndarray, params: IVFBuildParameters,
                     device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """Full training pipeline: sample -> train -> assign everything.

    Returns (centroids (K, d) f32, assignments (n,) int32).
    """
    x = np.asarray(x, dtype=np.float32)
    n = x.shape[0]
    params = params.resolved(n)
    rng = np.random.default_rng(params.seed)
    n_train = max(int(n * params.training_fraction), params.num_centroids)
    n_train = min(n_train, n)
    sample = x[rng.choice(n, size=n_train, replace=False)] \
        if n_train < n else x
    trainer = hierarchical_kmeans if params.is_hierarchical else \
        kmeans_training
    centroids = trainer(sample, params.num_centroids,
                        minibatch_size=params.minibatch_size,
                        num_iterations=params.num_iterations,
                        seed=params.seed, device=device)
    return (centroids.astype(np.float32),
            assign_full(x, centroids, device=device))
