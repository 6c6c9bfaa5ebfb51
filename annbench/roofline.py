"""The H100's published peaks and the least time a kernel launch needs.

Frozen copies of ``chip_smoke.py``'s ``bound_of`` and ``step_bound``
(the byte and operation count of one beam step), taking a launch's
shapes as numbers so that the benchmark can apply them to the launches a
cell really makes.  Peaks: NVIDIA's H100 SXM data sheet at its 700 W
limit, dense, float32 outside the tensor cores.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def bound_of(bytes_moved: int, flops: int) -> dict:
    """The least seconds for ``bytes_moved`` bytes of HBM traffic and
    ``flops`` float32 operations: the larger of the two over their peaks."""
    bytes_s = bytes_moved / HBM_BYTES_PER_S
    ops_s = flops / F32_FLOPS_PER_S
    return {"bytes": bytes_moved, "flops": flops,
            "bound_s": max(bytes_s, ops_s),
            "bound_by": "bytes" if bytes_s >= ops_s else "operations"}


def step_bound(*, b: int, c: int, k: int, d: int, row_itemsize: int,
               query_itemsize: int, m: int, dead_rows: int,
               flops_per_value: int, live: int = None) -> dict:
    """Least time for one beam step: its inputs read once (beam keys and
    packed ids (b, c) of 4 bytes, rows (b, k, d), candidate ids (b, k) of
    4 bytes, queries (b, d)) and its five outputs written once (keys and
    packed ids (b, c), pops (b, m), pool keys and ids (b, k)), over the HBM
    peak, against ``flops_per_value`` float32 operations per row value over
    the float32 peak.  The ``dead_rows`` rows of invalid candidates (id -1)
    do not count: no output depends on them.  With ``live``, only the first
    ``live`` columns of the rows and the queries count."""
    live = d if live is None else live
    inputs = (2 * b * c * 4 + b * k * d * row_itemsize + b * k * 4
              + b * d * query_itemsize)
    outputs = b * (c * 8 + m * 4 + k * 8)
    padding = (d - live) * ((b * k - dead_rows) * row_itemsize
                            + b * query_itemsize)
    return bound_of(inputs + outputs - dead_rows * d * row_itemsize - padding,
                    flops_per_value * (b * k - dead_rows) * live)
