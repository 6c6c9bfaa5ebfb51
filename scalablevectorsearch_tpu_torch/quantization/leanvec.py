"""LeanVec: dimensionality-reduced graph search with a full-dimensional
rerank.

PyTorch counterpart of ``scalablevectorsearch_tpu/quantization/leanvec.py``:

* **train**: mean-center a sample and take the top ``target_dim``
  eigenvectors of its covariance (PCA), or, given a query training set
  (``train(x, queries=...)``), the query-aware OOD projection pair of
  :func:`_ood_projections`.  The fit is numpy float64 on the host, a copy
  of the JAX package's code, so both packages compute the same maps;
* **primary**: LVQ-8 codes of the projected vectors (``target_dim``
  columns).  The graph is built and searched over them, through
  ``beam_step_lvq`` with the lanes past ``target_dim`` dead;
* **secondary**: LVQ-8 codes of the full vectors, used to re-score the top
  ``rerank_multiplier * k`` candidates (``rerank_kernel``).

:class:`LeanVecVamana` wraps a :class:`VamanaIndex` over the primary with
the query projection and the rerank at the search boundary.  Datasets are
created on ``device="cuda"`` unless the caller passes another device.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np
import torch

from ..core.query_result import QueryResult
from ..lib import datatypes as dt
from ..lib import saveload
from ..ops import distance as dist_ops
from .lvq import LVQDataset


def _ood_projections(data_centered: np.ndarray, queries_raw: np.ndarray,
                     target_dim: int, ridge: float = 1e-6):
    """Query-aware (OOD) projection pair, [TBAH24] closed form.

    Minimizes the expected inner-product distortion
    ``E[(q^T x - (B q)^T (A x))^2] = || Q^{1/2} (I - B^T A) D^{1/2} ||_F^2``
    over rank-``target_dim`` maps, where ``D = E[x x^T]`` (data centered by
    the data mean) and ``Q = E[q q^T]`` (queries raw) are the two
    second-moment matrices.  The optimum is the truncated SVD of
    ``S = Q^{1/2} D^{1/2}``:

        A = Sigma^{1/2} V_d'^T D^{-1/2}   (data map)
        B = Sigma^{1/2} U_d'^T Q^{-1/2}   (query map)

    Returns ``(A^T, B^T)`` as (d, d') f32 matrices applied as ``x @ A^T``.
    """
    d = data_centered.shape[1]

    def sqrt_pair(mat):
        lam, vec = np.linalg.eigh(mat.astype(np.float64))
        lam = np.maximum(lam, ridge * max(lam.max(), 1e-30))
        return (vec * np.sqrt(lam)) @ vec.T, \
            (vec / np.sqrt(lam)) @ vec.T
    D = data_centered.T.astype(np.float64) @ data_centered / \
        data_centered.shape[0]
    Q = queries_raw.T.astype(np.float64) @ queries_raw / \
        queries_raw.shape[0]
    D_half, D_inv_half = sqrt_pair(D)
    Q_half, Q_inv_half = sqrt_pair(Q)
    u, sig, vt = np.linalg.svd(Q_half @ D_half)
    root = np.sqrt(sig[:target_dim])
    a_t = D_inv_half @ vt[:target_dim].T * root[None, :]   # (d, d')
    b_t = Q_inv_half @ u[:, :target_dim] * root[None, :]   # (d, d')
    if a_t.shape != (d, target_dim):
        raise ValueError(f"projection shape {a_t.shape}")
    return a_t.astype(np.float32), b_t.astype(np.float32)


@dataclasses.dataclass
class LeanVecDataset:
    """Projection + primary (reduced) + secondary (full) datasets.

    ``projection`` is the data map and ``query_projection`` the query map;
    the PCA path uses one map for both (``query_projection is
    projection``).  ``query_mean`` centers the queries before projection:
    the data mean for PCA, zero for the OOD pair.  The maps and means are
    host arrays; the two LVQ datasets live on their device."""

    mean: np.ndarray              # (d,)
    projection: np.ndarray        # (d, d') data map
    primary: LVQDataset           # over projected vectors (n, d')
    secondary: LVQDataset         # over full vectors (n, d)
    query_projection: np.ndarray = None  # (d, d') query map
    query_mean: np.ndarray = None        # (d,) query centering

    def __post_init__(self):
        if self.query_projection is None:
            self.query_projection = self.projection
        if self.query_mean is None:
            self.query_mean = self.mean

    @classmethod
    def train(cls, x, target_dim: Optional[int] = None, *,
              queries=None, training_sample: int = 100_000, seed: int = 0,
              device="cuda") -> "LeanVecDataset":
        """Fit the reduction: with ``queries`` (a representative query
        training set) the query-aware OOD pair, without it data-only PCA.
        ``target_dim`` defaults to ``max(d // 2, 8)``."""
        x = np.asarray(x, dtype=np.float32)
        n, d = x.shape
        target_dim = target_dim or max(d // 2, 8)
        if target_dim > d:
            raise ValueError(f"target_dim {target_dim} > dim {d}")
        rng = np.random.default_rng(seed)
        sample = x[rng.choice(n, size=min(n, training_sample),
                              replace=False)] if n > training_sample else x
        mean = sample.mean(axis=0)
        centered = (sample - mean).astype(np.float64)
        if queries is not None:
            q = np.asarray(queries, dtype=np.float32)
            if q.ndim != 2 or q.shape[1] != d:
                raise ValueError(
                    f"query training set must be (m, {d}), got {q.shape}")
            if q.shape[0] > training_sample:
                q = q[rng.choice(q.shape[0], size=training_sample,
                                 replace=False)]
            projection, query_projection = _ood_projections(
                centered.astype(np.float32), q, target_dim)
            query_mean = np.zeros(d, dtype=np.float32)
        else:
            cov = centered.T @ centered / centered.shape[0]
            _eigvals, eigvecs = np.linalg.eigh(cov)
            projection = eigvecs[:, ::-1][:, :target_dim].astype(np.float32)
            query_projection = projection
            query_mean = None   # post_init: the data mean
        projected = (x - mean) @ projection
        return cls(mean=mean.astype(np.float32), projection=projection,
                   primary=LVQDataset.compress(projected, device=device),
                   secondary=LVQDataset.compress(x, device=device),
                   query_projection=query_projection,
                   query_mean=query_mean)

    @property
    def n(self) -> int:
        return self.primary.n

    @property
    def dim(self) -> int:
        return self.secondary.dim

    @property
    def reduced_dim(self) -> int:
        return self.primary.dim

    def project_queries(self, queries: np.ndarray) -> np.ndarray:
        q = np.asarray(queries, dtype=np.float32)
        return (q - self.query_mean) @ self.query_projection

    # -- persistence ----------------------------------------------------------
    SCHEMA = "leanvec_dataset"
    VERSION = saveload.Version(0, 0, 2)   # 0.0.2: optional query_projection

    def save_to(self, directory: str) -> None:
        """``primary/`` and ``secondary/`` LVQ checkpoints beside
        ``leanvec_config.json`` (the JAX package's layout)."""
        os.makedirs(directory, exist_ok=True)
        saveload.save_to_disk(self.primary,
                              os.path.join(directory, "primary"))
        saveload.save_to_disk(self.secondary,
                              os.path.join(directory, "secondary"))
        ctx = saveload.SaveContext(directory)
        body = {
            "mean": ctx.save_array(self.mean),
            "projection": ctx.save_array(self.projection),
        }
        if self.query_projection is not self.projection:
            body["query_projection"] = ctx.save_array(self.query_projection)
            body["query_mean"] = ctx.save_array(self.query_mean)
        table = saveload.save_table(self.SCHEMA, self.VERSION, body)
        with open(os.path.join(directory, "leanvec_config.json"), "w") as f:
            json.dump(table, f, indent=2)

    @classmethod
    def load_from(cls, directory: str, device="cuda") -> "LeanVecDataset":
        from ..core.loading import dispatch_load
        with open(os.path.join(directory, "leanvec_config.json")) as f:
            table = json.load(f)
        saveload.check_table(table, cls.SCHEMA, cls.VERSION)
        ctx = saveload.LoadContext(directory)
        qproj = (ctx.load_array(table["query_projection"])
                 if "query_projection" in table else None)
        qmean = (ctx.load_array(table["query_mean"])
                 if "query_mean" in table else None)
        return cls(mean=ctx.load_array(table["mean"]),
                   projection=ctx.load_array(table["projection"]),
                   primary=dispatch_load(os.path.join(directory, "primary"),
                                         device=device),
                   secondary=dispatch_load(
                       os.path.join(directory, "secondary"), device=device),
                   query_projection=qproj, query_mean=qmean)


class LeanVecVamana:
    """Vamana over the reduced-dimension primary with full-dimension
    reranking."""

    def __init__(self, index, leanvec: LeanVecDataset,
                 rerank_multiplier: int = 3):
        self._index = index
        self._leanvec = leanvec
        self.rerank_multiplier = rerank_multiplier

    @classmethod
    def build(cls, parameters, data, distance, *,
              target_dim: Optional[int] = None,
              rerank_multiplier: int = 3, queries=None, device="cuda",
              **kwargs) -> "LeanVecVamana":
        """Train on ``data`` (or take a trained :class:`LeanVecDataset`),
        then build a Vamana graph over the primary; ``queries``: an
        optional query training set for the OOD projection.  ``kwargs`` go
        to ``VamanaIndex.build``."""
        from ..index.vamana.index import VamanaIndex
        leanvec = data if isinstance(data, LeanVecDataset) else \
            LeanVecDataset.train(data, target_dim=target_dim,
                                 queries=queries, device=device)
        index = VamanaIndex.build(parameters, leanvec.primary, distance,
                                  **kwargs)
        return cls(index, leanvec, rerank_multiplier)

    @property
    def index(self):
        """The Vamana index over the primary (projected) codes."""
        return self._index

    @property
    def leanvec(self) -> LeanVecDataset:
        return self._leanvec

    @property
    def size(self) -> int:
        return self._index.size

    @property
    def dimensions(self) -> int:
        return self._leanvec.dim

    @property
    def search_window_size(self) -> int:
        return self._index.search_window_size

    @search_window_size.setter
    def search_window_size(self, w: int) -> None:
        self._index.search_window_size = w

    def enable_entry_sampler(self, n_samples=None,
                             n_entries: int = 1, seed: int = 0) -> None:
        """Per-query sampled entries on the primary (entry.py), selected
        with the projected queries, so sample and beam share one space."""
        self._index.enable_entry_sampler(n_samples, n_entries, seed)

    def disable_entry_sampler(self) -> None:
        self._index.disable_entry_sampler()

    def search(self, queries, k: int) -> QueryResult:
        """Project, search the primary for ``k * rerank_multiplier``
        candidates, re-score them against the secondary with the f32
        queries, keep the k best."""
        queries = np.asarray(queries)
        if queries.ndim == 1:
            queries = queries[None, :]
        if queries.shape[1] != self._leanvec.dim:
            raise ValueError(
                f"query dim {queries.shape[1]} != {self._leanvec.dim}")
        fetch = max(k * self.rerank_multiplier, k)
        inner = self._index.search(self._leanvec.project_queries(queries),
                                   fetch)
        return self.rerank(queries, inner.ids, k)

    def rerank(self, queries: np.ndarray, candidate_ids: np.ndarray,
               k: int) -> QueryResult:
        """Re-score (nq, c) candidate ids (-1 = none) against the
        secondary with the f32 (nq, d) queries and keep the k best."""
        from ..index.ivf.index import rerank_kernel
        sec = self._leanvec.secondary
        queries = np.asarray(queries)
        nq = queries.shape[0]
        n_pad = dt.pad_to(nq, 8)
        qdev = torch.from_numpy(dt.pad_matrix(
            queries.astype(np.float32), n_pad=n_pad,
            d_pad=sec.padded_dim)).to(sec.device)
        cand = torch.from_numpy(np.pad(
            np.asarray(candidate_ids), ((0, n_pad - nq), (0, 0)),
            constant_values=-1).astype(np.int32)).to(sec.device)
        keys, ids = rerank_kernel(sec, qdev, None, cand, k=k,
                                  distance=self._index.distance)
        return QueryResult(
            ids=ids[:nq].cpu().numpy().astype(np.int64),
            distances=dist_ops.value_from_key(
                self._index.distance, keys[:nq]).cpu().numpy())

    def save(self, config_dir: str) -> None:
        self._index.save(os.path.join(config_dir, "index"))
        self._leanvec.save_to(os.path.join(config_dir, "leanvec"))

    @classmethod
    def assemble(cls, config_dir: str, rerank_multiplier: int = 3,
                 device="cuda", **kwargs) -> "LeanVecVamana":
        """Load a LeanVec index that either package saved onto
        ``device``."""
        from ..index.vamana.index import VamanaIndex
        index = VamanaIndex.assemble(os.path.join(config_dir, "index"),
                                     device=device, **kwargs)
        leanvec = LeanVecDataset.load_from(
            os.path.join(config_dir, "leanvec"), device=device)
        return cls(index, leanvec, rerank_multiplier)
