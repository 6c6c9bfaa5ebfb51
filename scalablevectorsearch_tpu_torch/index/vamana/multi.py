"""Multi-vector dynamic index: many vectors per external label.

PyTorch counterpart of ``scalablevectorsearch_tpu/index/vamana/multi.py``
(the reference's ``MultiMutableVamanaIndex``,
``include/svs/index/vamana/multi.h:155``): each external label owns any
number of vectors, and a search returns each label once, at its best
distance (the reference's label-deduplicating ``MultiBatchIterator``,
multi.h:31).  A host-side label layer over :class:`MutableVamanaIndex`,
whose external ids are the vector ids (vids): the vid -> label map is a
dense growable numpy array, so the dedup is vectorized.  Persistence is the
reference's pair (``multi.h:602-628`` save, the reload constructor
``multi.h:248``): the inner dynamic index plus the vid -> label table.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np

from ...core.query_result import QueryResult
from ...lib import saveload
from .dynamic import MutableVamanaIndex
from .params import VamanaBuildParameters, VamanaSearchParameters

_NO_LABEL = np.int64(-1)


def dedup_by_label(labels: np.ndarray, values: np.ndarray, k: int):
    """Vectorized first-occurrence-by-label selection.

    ``labels``: (nq, F) int64, columns sorted best-first, -1 = invalid.
    Returns ((nq, k) labels, (nq, k) gather columns, (nq,) distinct counts):
    for each row, the first ``k`` distinct non-negative labels in column
    order (== each label at its best distance) — the lockstep analog of the
    reference's per-query label set (multi.h:31)."""
    nq, f = labels.shape
    valid = labels >= 0
    # composite (row, label) keys; np.unique(return_index) marks the FIRST
    # flattened occurrence of each pair, and flatten order is row-major with
    # columns ascending = best-first
    span = labels.max(initial=0) + 2
    keys = (np.arange(nq, dtype=np.int64)[:, None] * span
            + np.where(valid, labels, -1))
    _, first = np.unique(keys.ravel(), return_index=True)
    keep = np.zeros(nq * f, dtype=bool)
    keep[first] = True
    keep = keep.reshape(nq, f) & valid
    # compact keepers to the left, preserving order
    order = np.argsort(~keep, axis=1, kind="stable")[:, :k]
    sel_keep = np.take_along_axis(keep, order, axis=1)
    out_labels = np.where(sel_keep,
                          np.take_along_axis(labels, order, axis=1), -1)
    out_vals = np.where(sel_keep,
                        np.take_along_axis(values, order, axis=1), np.inf)
    return out_labels, out_vals, keep.sum(axis=1)


class MultiMutableVamanaIndex:
    SCHEMA = "multi_vamana_index_parameters"
    VERSION = saveload.Version(0, 0, 1)
    CONFIG_FILENAME = "multi_vamana_config.json"

    def __init__(self, parameters: VamanaBuildParameters, data, labels,
                 distance, **kwargs):
        data = np.asarray(data, dtype=np.float32)
        labels = np.asarray(labels, dtype=np.int64)
        if data.shape[0] != labels.size:
            raise ValueError("data / labels length mismatch")
        self._next_vid = data.shape[0]
        vids = np.arange(data.shape[0], dtype=np.int64)
        # dense vid -> label (vids are sequential); -1 = deleted/unknown
        self._vid_label = labels.copy()
        self._label_counts: dict[int, int] = {}
        for l in labels:
            self._label_counts[int(l)] = self._label_counts.get(int(l), 0) + 1
        self._inner = MutableVamanaIndex(parameters, data, vids, distance,
                                         **kwargs)

    def _label_of(self, vids: np.ndarray) -> np.ndarray:
        """Vectorized vid -> label (-1 for invalid/deleted vids)."""
        ok = (vids >= 0) & (vids < self._vid_label.size)
        return np.where(ok, self._vid_label[np.maximum(vids, 0)], _NO_LABEL)

    # -- properties ----------------------------------------------------------
    @property
    def size(self) -> int:
        """Number of distinct labels (reference multi.h size semantics)."""
        return len(self._label_counts)

    @property
    def num_vectors(self) -> int:
        return self._inner.size

    @property
    def dimensions(self) -> int:
        return self._inner.dimensions

    @property
    def search_parameters(self) -> VamanaSearchParameters:
        return self._inner.search_parameters

    @search_parameters.setter
    def search_parameters(self, p) -> None:
        self._inner.search_parameters = p

    @property
    def search_window_size(self) -> int:
        return self._inner.search_window_size

    @search_window_size.setter
    def search_window_size(self, w: int) -> None:
        self._inner.search_window_size = w

    def enable_entry_sampler(self, n_samples=None,
                             n_entries: int = 1, seed: int = 0) -> None:
        """Per-query sampled entries on the inner index (entry.py)."""
        self._inner.enable_entry_sampler(n_samples, n_entries, seed)

    def disable_entry_sampler(self) -> None:
        self._inner.disable_entry_sampler()

    def all_labels(self) -> np.ndarray:
        return np.sort(np.fromiter(self._label_counts.keys(), dtype=np.int64))

    def has_id(self, label: int) -> bool:
        return int(label) in self._label_counts

    # -- search ----------------------------------------------------------------
    def search(self, queries, k: int,
               parameters: Optional[VamanaSearchParameters] = None,
               cancel=None) -> QueryResult:
        """Label-deduplicated top-k: over-fetch vectors, keep each label's
        best hit (multi.h MultiBatchIterator semantics).

        The fetch starts at ``k * (1 + mean multiplicity)`` and DOUBLES while
        any query holds fewer than ``k`` distinct labels (skewed label
        multiplicity can eat an average-sized fetch — one hot label's copies
        crowd out the rest), until k labels are found or the whole index has
        been fetched.  The fetch ladder is powers of two, as in the JAX
        package, and doubling re-searches only the queries still short of
        ``k`` labels."""
        queries = np.asarray(queries, dtype=np.float32)
        if queries.ndim == 1:
            queries = queries[None, :]
        nv = max(self.num_vectors, k)
        mean_mult = max(self.num_vectors / max(self.size, 1), 1.0)
        want_fetch = max(k * (1 + mean_mult), 2 * k)
        fetch = int(min(1 << int(np.ceil(np.log2(want_fetch))), nv))

        def params_for(fetch):
            # widen the pop horizon with the over-fetch: the dispatch no
            # longer floors window at k (sub-k horizons are a legal serving
            # point), but an over-fetching caller genuinely needs the
            # exploration depth to scale with what it asks for.  Cap the
            # derived iteration budget: retries double fetch toward
            # num_vectors, and exploration saturates far before an
            # uncapped 2*fetch+16 loop would end.
            p = parameters or self._inner.search_parameters
            cfg = p.buffer_config
            if cfg.search_window_size >= fetch:
                return p
            widened = p.with_window(fetch,
                                    max(cfg.search_buffer_capacity, fetch))
            return dataclasses.replace(
                widened,
                max_iters=min(widened.resolved_max_iters(), 256))

        inner_res = self._inner.search(queries, fetch,
                                       parameters=params_for(fetch),
                                       cancel=cancel)
        out_labels, out_vals, n_distinct = dedup_by_label(
            self._label_of(inner_res.ids), inner_res.distances, k)
        want = min(k, self.size)
        while fetch < nv:
            short = np.nonzero(n_distinct < want)[0]
            if short.size == 0:
                break
            fetch = min(2 * fetch, nv)
            sub = self._inner.search(queries[short], fetch,
                                     parameters=params_for(fetch),
                                     cancel=cancel)
            sl, sv, sn = dedup_by_label(
                self._label_of(sub.ids), sub.distances, k)
            out_labels[short], out_vals[short] = sl, sv
            n_distinct[short] = sn
        return QueryResult(ids=out_labels, distances=out_vals)

    # -- mutation -----------------------------------------------------------------
    def add_points(self, points, labels) -> None:
        """Add vectors under (possibly pre-existing) labels."""
        points = np.asarray(points, dtype=np.float32)
        labels = np.asarray(labels, dtype=np.int64)
        vids = np.arange(self._next_vid, self._next_vid + points.shape[0],
                         dtype=np.int64)
        self._next_vid += points.shape[0]
        self._inner.add_points(points, vids)
        grow = self._next_vid - self._vid_label.size
        if grow > 0:
            self._vid_label = np.concatenate(
                [self._vid_label,
                 np.full(grow, _NO_LABEL, dtype=np.int64)])
        self._vid_label[vids] = labels
        for l in labels:
            self._label_counts[int(l)] = self._label_counts.get(int(l), 0) + 1

    def delete_points(self, labels) -> None:
        """Delete every vector belonging to the given labels."""
        doomed = np.unique(np.asarray(labels, dtype=np.int64).ravel())
        missing = set(int(l) for l in doomed) - set(self._label_counts)
        if missing:
            raise KeyError(f"labels not present: {sorted(missing)[:10]}")
        mask = np.isin(self._vid_label, doomed)
        vids = np.nonzero(mask)[0]
        self._inner.delete_points(vids.astype(np.int64))
        self._vid_label[vids] = _NO_LABEL
        for l in doomed:
            del self._label_counts[int(l)]

    def consolidate(self) -> None:
        self._inner.consolidate()

    def compact(self) -> None:
        self._inner.compact()

    # -- persistence ------------------------------------------------------------
    def save(self, config_dir: str) -> None:
        """Persist inner index + vid->label table (reference
        multi.h:602-628 saves the inner index plus its label maps)."""
        os.makedirs(config_dir, exist_ok=True)
        self._inner.save(os.path.join(config_dir, "inner"))
        ctx = saveload.SaveContext(config_dir)
        table = saveload.save_table(self.SCHEMA, self.VERSION, {
            "next_vid": int(self._next_vid),
            "vid_label": ctx.save_array(self._vid_label),
        })
        with open(os.path.join(config_dir, self.CONFIG_FILENAME), "w") as f:
            json.dump(table, f, indent=2)

    @classmethod
    def assemble(cls, config_dir: str, **kwargs) -> "MultiMutableVamanaIndex":
        """Reload a saved multi-vector index (reference reload ctor,
        multi.h:248)."""
        with open(os.path.join(config_dir, cls.CONFIG_FILENAME)) as f:
            table = json.load(f)
        saveload.check_table(table, cls.SCHEMA, cls.VERSION)
        ctx = saveload.LoadContext(config_dir)
        obj = cls.__new__(cls)
        obj._inner = MutableVamanaIndex.assemble(
            os.path.join(config_dir, "inner"), **kwargs)
        obj._next_vid = int(table["next_vid"])
        obj._vid_label = ctx.load_array(table["vid_label"]).astype(np.int64)
        # live labels = labels of vids still present in the inner index
        live_vids = obj._inner.all_ids()
        counts: dict[int, int] = {}
        for l in obj._vid_label[live_vids]:
            if l >= 0:
                counts[int(l)] = counts.get(int(l), 0) + 1
        obj._label_counts = counts
        return obj
