"""Search-parameter calibration.

PyTorch counterpart of ``scalablevectorsearch_tpu/index/vamana/
calibrate.py``: given calibration queries and their ground truth, find the
cheapest search configuration that reaches a target recall.  The axes:

* **window**: binary search per pop width, decided by recall alone;
* **window/capacity split**: smaller pop horizons with larger retention
  (``capacity_multipliers``, fractional ones included), always probed for
  two-level datasets, whose retained capacity is the rerank pool;
* **pop_width** and **tail_frac** of the index;
* **packed serving**: recall is measured again packed, since packing
  changes the scoring precision;
* **visited_set**: the optional exact visited filter;
* **query upload dtype**: the opt-in int8 axis (``try_int8_uploads``),
  outermost, since the quantized query changes every score.

Among the feasible configurations the winner is the one with the highest
measured QPS on the host's clock, which is noisy on a GPU host: which
feasible configuration wins can change from run to run, the recall it
reaches cannot fall below the target.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from ...core.recall import k_recall_at_n
from .params import SearchBufferConfig, VamanaSearchParameters


@dataclasses.dataclass
class CalibrationParameters:
    """The search ranges and the axes to try."""

    search_window_lower: int = 1
    search_window_upper: int = 512
    max_window_trials: int = 12
    # probe the window/capacity split after the window search
    trim_capacity: bool = True
    timing_reps: int = 2
    pop_widths: tuple = (4, 8)
    tail_fracs: tuple = (4,)
    capacity_multipliers: tuple = (1, 2)
    try_packed: bool = True
    try_visited_set: bool = False
    # int8 query uploads: an outermost axis, off by default
    try_int8_uploads: bool = False


@dataclasses.dataclass
class CalibrationResult:
    """Winning configuration + what was measured."""

    search_parameters: VamanaSearchParameters
    pop_width: int
    tail_frac: int
    packed: bool
    qps: float
    recall: float
    trials: int
    # winning host->device query dtype (None = the env default, float16)
    query_upload_dtype: Optional[str] = None


def calibrate(index, queries, groundtruth, k: int, target_recall: float,
              parameters: Optional[CalibrationParameters] = None
              ) -> VamanaSearchParameters:
    """Find the cheapest search configuration reaching ``target_recall``.

    ``index`` is a ``VamanaIndex`` (``Vamana(...).index``) or any index
    with ``search`` / ``search_parameters``.  Sets the winner on the index
    (search parameters, pop width, tail fraction, packed serving, query
    upload dtype) and returns its ``VamanaSearchParameters``;
    :func:`calibrate_full` returns the whole record."""
    return calibrate_full(index, queries, groundtruth, k, target_recall,
                          parameters).search_parameters


def calibrate_full(index, queries, groundtruth, k: int,
                   target_recall: float,
                   parameters: Optional[CalibrationParameters] = None
                   ) -> CalibrationResult:
    params = parameters or CalibrationParameters()
    queries = np.asarray(queries)
    gt = np.asarray(getattr(groundtruth, "ids", groundtruth))
    trials = [0]

    has_pop = hasattr(index, "pop_width")
    has_tail = hasattr(index, "tail_frac")
    pop_widths = tuple(params.pop_widths) if has_pop else (None,)
    tail_fracs = tuple(params.tail_fracs) if has_tail else (None,)

    # packed neighbourhoods change scoring precision: an outer axis, with
    # recall measured again per packed state
    packed_states = [getattr(index, "_packed", None) is not None]
    if (params.try_packed and not packed_states[0]
            and hasattr(index, "enable_packed_serving")):
        # enable_packed_serving's own guard, without packing up front:
        # an uncompressed VectorDataset, an SQDataset or LVQ
        from ...quantization.lvq import LVQDataset
        packable = isinstance(index.data, LVQDataset) or (
            hasattr(index.data, "vectors")
            and not getattr(index.data, "residual_bits", 0))
        if packable:
            packed_states.append(True)

    # int8 uploads change every score: the outermost axis
    upload_states = [getattr(index, "query_upload_dtype", None)]
    if params.try_int8_uploads and upload_states[0] != "int8" and \
            hasattr(index, "query_upload_dtype"):
        upload_states.append("int8")

    def set_state(m, tf, packed, upload=None):
        if m is not None:
            index.pop_width = m
        if tf is not None:
            index.tail_frac = tf
        if hasattr(index, "query_upload_dtype"):
            index.query_upload_dtype = upload
        if packed and getattr(index, "_packed", None) is None:
            index.enable_packed_serving()
        elif not packed and getattr(index, "_packed", None) is not None:
            index.disable_packed_serving()

    def sp_for(window: int, capacity: int,
               visited: bool = False) -> VamanaSearchParameters:
        return VamanaSearchParameters(
            buffer_config=SearchBufferConfig(window, max(capacity, window)),
            visited_set=visited)

    def recall_at(window: int, capacity: int, visited=False) -> float:
        trials[0] += 1
        res = index.search(queries, k, parameters=sp_for(window, capacity,
                                                         visited))
        return k_recall_at_n(gt, res, n=k, k=k)

    def qps_at(window: int, capacity: int, visited=False) -> float:
        sp = sp_for(window, capacity, visited)
        index.search(queries, k, parameters=sp)  # warm-up
        t0 = time.perf_counter()
        if hasattr(index, "search_async"):
            # pipelined reps, as serving QPS is quoted
            pend = [index.search_async(queries, k, parameters=sp)
                    for _ in range(params.timing_reps)]
            for p in pend:
                p.result()
        else:
            for _ in range(params.timing_reps):
                index.search(queries, k, parameters=sp)
        dt = time.perf_counter() - t0
        return len(queries) * params.timing_reps / max(dt, 1e-9)

    lo0 = max(params.search_window_lower, 1)
    hi0 = max(params.search_window_upper, lo0)
    # two-level datasets rerank from the retained capacity: keep the
    # widened-retention probes even when trim_capacity is off
    reranking = bool(getattr(index.data, "residual_bits", 0)) or \
        getattr(index, "rerank_data", None) is not None
    visited_states = (False, True) if params.try_visited_set else (False,)

    best = None   # (qps, w, cap, m, tf, packed, visited, recall, upload)

    for up in upload_states:
        for packed in packed_states:
            for m in pop_widths:
                for tf in tail_fracs:
                    set_state(m, tf, packed, up)
                    for visited in visited_states:
                        # 1) binary-search the smallest feasible window
                        #    with k-floored retention
                        lo, hi = lo0, hi0
                        if recall_at(hi, max(hi, k), visited) < \
                                target_recall:
                            continue  # unreachable on this combination
                        w_best = hi
                        t = 0
                        while lo <= hi and t < params.max_window_trials:
                            mid = (lo + hi) // 2
                            if recall_at(mid, max(mid, k),
                                         visited) >= target_recall:
                                w_best = mid
                                hi = mid - 1
                            else:
                                lo = mid + 1
                            t += 1
                        feasible = [(w_best, max(w_best, k))]
                        # 2) split probes: a smaller pop horizon with a
                        #    larger retention
                        if params.trim_capacity or reranking:
                            mults = params.capacity_multipliers
                            if reranking and 3 not in mults:
                                mults = tuple(mults) + (3,)
                            for w2 in sorted({max(1, w_best // 2),
                                              max(1, (3 * w_best) // 4)}):
                                if w2 >= w_best:
                                    continue
                                for mult in mults:
                                    # fractional multipliers round up to
                                    # an int capacity
                                    cap = max(k, int(-(-mult * w_best // 1)))
                                    if cap < w2:
                                        continue
                                    if recall_at(w2, cap,
                                                 visited) >= target_recall:
                                        feasible.append((w2, cap))
                                        break  # smallest feasible retention
                        # 3) the highest measured QPS among the feasible
                        for (w, cap) in feasible:
                            q = qps_at(w, cap, visited)
                            if best is None or q > best[0]:
                                best = (q, w, cap, m, tf, packed, visited,
                                        recall_at(w, cap, visited), up)

    if best is None:
        # unreachable everywhere: best effort at the upper window on the
        # default axes
        set_state(pop_widths[0], tail_fracs[0], packed_states[0],
                  upload_states[0])
        cfg = sp_for(hi0, max(hi0, k))
        index.search_parameters = cfg
        return CalibrationResult(
            search_parameters=cfg,
            pop_width=pop_widths[0] or 0, tail_frac=tail_fracs[0] or 0,
            packed=packed_states[0], qps=0.0,
            recall=recall_at(hi0, max(hi0, k)), trials=trials[0],
            query_upload_dtype=upload_states[0])

    q, w, cap, m, tf, packed, visited, rec, up = best
    set_state(m, tf, packed, up)
    cfg = sp_for(w, cap, visited)
    index.search_parameters = cfg
    return CalibrationResult(
        search_parameters=cfg, pop_width=m or 0, tail_frac=tf or 0,
        packed=packed, qps=q, recall=rec, trials=trials[0],
        query_upload_dtype=up)
