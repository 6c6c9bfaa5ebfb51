"""Carry a Vamana index's state from the JAX package into this one.

Two routes.  The checkpoint route: a directory (or stream) that the JAX
package's ``VamanaIndex.save`` wrote loads here with
``VamanaIndex.assemble(directory, device=...)`` (``assemble_stream`` for a
stream), and this package's ``save`` writes what the JAX package's
``assemble`` reads; datasets cross alike through ``core.loading
.dispatch_load``.  The in-process route, below, takes the arrays of a live
JAX index, which are plain numpy: the dataset rows ``np.asarray(idx.data.vectors)
[:n, :dim]``, ``idx.graph.adjacency`` and ``idx.graph.degrees``,
``idx.entry_point`` and, for a sampled-entries index,
``idx._entry_sampler.ids``.  :func:`vamana_from_arrays` turns it into a
:class:`VamanaIndex` that computes the same search, so the two packages can
be run on one graph.  An LVQ dataset carries across through
:func:`lvq_from_arrays` (its ``codes``, ``scales``, ``biases``, ``mean``,
``n``, ``dim``, ``bits`` and, for two levels, ``res_codes`` /
``res_scales``) and stands in place of the rows; an ``SQDataset`` through
:func:`sq_from_arrays` (its ``codes``, ``scale``, ``bias``, ``n``,
``dim``).  A float16 / int8 table carries across through
:func:`dataset_from_array` with ``dtype=``.  A JAX ``MutableVamanaIndex``
carries across through :func:`dynamic_vamana_from_arrays`, from the arrays
its ``save`` writes: the rows and the slot ``status`` up to the high-water
mark ``idx.data.n``, ``idx.translator.to_external(np.arange(n))``, the
adjacency, the entry point, ``idx.parameters`` and ``idx.data.capacity``.
A JAX ``LeanVecDataset`` carries across through :func:`leanvec_from_arrays`
(its ``mean``, ``projection``, ``query_projection`` and ``query_mean``, and
its ``primary`` and ``secondary`` as :func:`lvq_from_arrays` arguments); a
``LeanVecVamana`` is then ``LeanVecVamana(vamana_from_arrays(primary, ...),
leanvec)``.

The IVF family carries across the same way.  A JAX ``IVFIndex`` through
:func:`ivf_from_arrays`: its ``centroids`` (one row per probe unit), the
reordered rows ``np.asarray(idx.data.vectors)[:total, :dim]`` (or an LVQ /
SQ dataset over them), ``ids_padded``, ``slot``, ``n`` and ``n_clusters``.
A JAX ``DynamicIVFIndex`` through :func:`dynamic_ivf_from_arrays`: its
``_base_centroids``, the rows of every slot, ``ids_padded``, ``slot``,
``unit_owner``, ``_fill``, ``_occupied`` and the external ids of the
occupied slots.  A JAX ``InvertedIndex`` through
:func:`inverted_from_arrays`: the centroid rows and ``centroid_ids``, the
primary graph's adjacency, degrees and entry point, and the posting layout
(rows, ``ids_padded``, ``slot``, ``n``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .core.data import VectorDataset
from .core.graph import NeighborGraph
from .core.translation import IDTranslator
from .index.inverted.index import InvertedIndex
from .index.ivf.dynamic import DynamicIVFIndex
from .index.ivf.index import IVFIndex, _poison_padding
from .index.vamana.dynamic import MutableVamanaIndex
from .index.vamana.entry import build_sampler
from .index.vamana.index import VamanaIndex
from .index.vamana.params import VamanaBuildParameters
from .quantization.leanvec import LeanVecDataset
from .quantization.lvq import LVQDataset, _unpack4
from .quantization.scalar import SQDataset


def dataset_from_array(vectors, *, dtype=None, device="cuda"
                       ) -> VectorDataset:
    """(n, dim) rows (bf16 as ``ml_dtypes.bfloat16`` is fine) -> dataset."""
    return VectorDataset.from_array(vectors, dtype=dtype, device=device)


def graph_from_arrays(adjacency, degrees, n: int, *, device="cuda"
                      ) -> NeighborGraph:
    """(capacity, R) adjacency and (capacity,) degrees -> graph, kept as
    given (the padded capacity included)."""
    adjacency = np.array(adjacency, dtype=np.int32)   # writable copies
    degrees = np.array(degrees, dtype=np.int32)
    if adjacency.shape[0] != degrees.shape[0] or adjacency.shape[0] < n:
        raise ValueError(f"adjacency {adjacency.shape} / degrees "
                         f"{degrees.shape} do not hold {n} nodes")
    return NeighborGraph(adjacency=torch.from_numpy(adjacency).to(device),
                         degrees=torch.from_numpy(degrees).to(device),
                         n=n, max_degree=adjacency.shape[1])


def lvq_from_arrays(codes, scales, biases, mean, *, n: int, dim: int,
                    bits: int, residual_bits: int = 0, res_codes=None,
                    res_scales=None, device="cuda") -> LVQDataset:
    """A JAX ``LVQDataset``'s numpy state -> the port's ``LVQDataset``.

    ``codes`` (capacity, w1) and ``res_codes`` are the stored rows (padded,
    nibble-packed at 4 bits); ``mean`` is (d_pad,) or (dim,).  The codes,
    scales, biases and mean are taken as given; the reconstruction norms
    are recomputed on the host in float64 the way ``compress`` computes
    them, which reproduces the JAX dataset's norms bit for bit.
    """
    def unpacked(rows, b):
        rows = np.array(rows, dtype=np.int8)[:n]      # writable copy
        if b == 4:
            rows = _unpack4(torch.from_numpy(rows)).numpy()
        return rows[:, :dim]

    return LVQDataset.from_codes(
        unpacked(codes, bits), np.asarray(scales)[:n], np.asarray(biases)[:n],
        np.asarray(mean)[:dim], bits=bits, residual_bits=residual_bits,
        res_codes=unpacked(res_codes, residual_bits) if residual_bits
        else None,
        res_scales=np.asarray(res_scales)[:n] if residual_bits else None,
        device=device)


def leanvec_from_arrays(mean, projection, primary: dict, secondary: dict, *,
                        query_projection=None, query_mean=None,
                        device="cuda") -> LeanVecDataset:
    """A JAX ``LeanVecDataset``'s numpy state -> the port's
    ``LeanVecDataset``.  ``primary`` and ``secondary`` are the keyword
    arguments of :func:`lvq_from_arrays` for the two LVQ datasets;
    ``query_projection`` / ``query_mean`` are left ``None`` for a PCA
    dataset, whose query map is its data map."""
    return LeanVecDataset(
        mean=np.array(mean, dtype=np.float32),
        projection=np.array(projection, dtype=np.float32),
        primary=lvq_from_arrays(**primary, device=device),
        secondary=lvq_from_arrays(**secondary, device=device),
        query_projection=None if query_projection is None else
        np.array(query_projection, dtype=np.float32),
        query_mean=None if query_mean is None else
        np.array(query_mean, dtype=np.float32))


def sq_from_arrays(codes, scale, bias, *, n: int, dim: int, device="cuda"
                   ) -> SQDataset:
    """A JAX ``SQDataset``'s numpy state -> the port's ``SQDataset``.

    ``codes`` are the stored (capacity, d_pad) rows; ``scale`` and ``bias``
    the global f32 pair.  The norms and code sums are recomputed on the
    host as ``compress`` computes them, which reproduces the JAX dataset's
    bit for bit."""
    codes = np.asarray(codes)
    return SQDataset.from_codes(codes[:n, :dim], float(scale), float(bias),
                                capacity=codes.shape[0], device=device)


def vamana_from_arrays(vectors, adjacency, degrees, entry_point: int,
                       distance, *, sampler_ids: Optional[np.ndarray] = None,
                       dtype=None, device="cuda") -> VamanaIndex:
    """Build a port :class:`VamanaIndex` over a JAX index's state;
    ``vectors`` may be an :class:`LVQDataset` (:func:`lvq_from_arrays`) or
    an :class:`SQDataset` (:func:`sq_from_arrays`)."""
    if isinstance(vectors, (LVQDataset, SQDataset)):
        data = vectors
    else:
        data = dataset_from_array(vectors, dtype=dtype, device=device)
    graph = graph_from_arrays(adjacency, degrees, data.n, device=device)
    index = VamanaIndex(graph, data, entry_point, distance)
    if sampler_ids is not None:
        index._entry_sampler = build_sampler(data, len(sampler_ids),
                                             ids=sampler_ids)
    return index


def dynamic_vamana_from_arrays(vectors, adjacency, degrees, status,
                               external_ids, entry_point: int, distance,
                               parameters: VamanaBuildParameters, *,
                               capacity: int, sampler_cfg=None,
                               device="cuda") -> MutableVamanaIndex:
    """Build a port :class:`MutableVamanaIndex` over a JAX dynamic index's
    state, without a build: ``vectors`` (high-water, dim) rows, ``status``
    and ``external_ids`` aligned with them (the ids of slots that are not
    VALID are ignored), the (rows, R) adjacency and degrees, the resolved
    build ``parameters`` and the storage ``capacity``.  ``sampler_cfg``:
    the JAX index's ``_sampler_cfg`` ``(n_samples, n_entries, seed)``; the
    sample is drawn from the VALID slots as the JAX index draws it."""
    data = VectorDataset.from_array(np.asarray(vectors, np.float32),
                                    capacity=capacity, device=device)
    graph = graph_from_arrays(adjacency, degrees, data.n, device=device)
    index = MutableVamanaIndex.from_state(data, graph, status, external_ids,
                                          entry_point, distance, parameters)
    if sampler_cfg is not None:
        index.enable_entry_sampler(*sampler_cfg)
    return index


def ivf_from_arrays(centroids, rows, ids_padded, slot: int, n: int,
                    n_clusters: int, distance, *, dtype=None,
                    rerank_rows=None, device="cuda") -> IVFIndex:
    """A port :class:`IVFIndex` over a JAX ``IVFIndex``'s layout:
    ``centroids`` (units, d or d_pad), the reordered ``rows`` (total, dim)
    (stored as ``dtype``), or an :class:`LVQDataset` / :class:`SQDataset`
    over them, ``ids_padded`` (total,), ``slot``, ``n`` and ``n_clusters``.
    ``rerank_rows``: the (n, dim) f32 rows of the k_reorder pass."""
    if isinstance(rows, (LVQDataset, SQDataset)):
        data = rows
    else:
        data = dataset_from_array(rows, dtype=dtype, device=device)
    ids_padded = np.asarray(ids_padded, dtype=np.int32)
    rerank_data = None if rerank_rows is None else dataset_from_array(
        np.asarray(rerank_rows, np.float32), device=device)
    return IVFIndex(centroids, _poison_padding(data, ids_padded), ids_padded,
                    slot, n, distance, rerank_data=rerank_data,
                    n_clusters=n_clusters)


def dynamic_ivf_from_arrays(base_centroids, vectors, ids_padded, slot: int,
                            unit_owner, fill, occupied, external_ids,
                            distance, *, device="cuda") -> DynamicIVFIndex:
    """A port :class:`DynamicIVFIndex` over a JAX ``DynamicIVFIndex``'s
    state: the (k, d) logical centroids, the (total, dim) rows of every
    slot (free slots' rows are ignored), ``ids_padded``, ``slot``, the
    probe units' owners, their fill, the occupied mask and the external
    ids of the occupied slots in slot order."""
    occupied = np.asarray(occupied, dtype=bool)
    live = np.flatnonzero(occupied)
    translator = IDTranslator(occupied.size)
    translator.insert(np.asarray(external_ids, dtype=np.int64), live)
    return DynamicIVFIndex.from_state(
        base_centroids, vectors, ids_padded, slot, unit_owner, fill,
        occupied, translator, distance, device=device)


def inverted_from_arrays(centroid_rows, centroid_ids, adjacency, degrees,
                         entry_point: int, rows, ids_padded, slot: int,
                         n: int, distance, *, device="cuda"
                         ) -> InvertedIndex:
    """A port :class:`InvertedIndex` over a JAX ``InvertedIndex``'s state:
    the (k, dim) centroid rows and their dataset ids, the primary graph's
    (capacity, R) adjacency, degrees and entry point, and the posting
    layout's (total, dim) rows, ``ids_padded``, ``slot`` and ``n``."""
    centroid_data = dataset_from_array(
        np.asarray(centroid_rows, np.float32), device=device)
    graph = graph_from_arrays(adjacency, degrees, centroid_data.n,
                              device=device)
    ids_padded = np.asarray(ids_padded, dtype=np.int32)
    data = _poison_padding(dataset_from_array(
        np.asarray(rows, np.float32), device=device), ids_padded)
    return InvertedIndex(graph, centroid_data, centroid_ids, data,
                         ids_padded, slot, n, entry_point, distance)
