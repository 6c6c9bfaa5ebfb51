"""``beam_step``'s share of its roofline over the kernels' traced stretch.

The bound of each launch is the frozen ``roofline.step_bound`` applied to
that launch's own inputs: its shapes, and its invalid candidates (id -1),
counted on the device and read once after the window.  The time is the
profiler's device time of the ``beam_step`` kernels (``DenseRows`` rows)
launched in the same stretch.  The wrapper that records the inputs sits
on the search loop's reference to ``beam_step`` while the stretch lasts.
"""

import contextlib

import torch

from annbench import roofline

FLOPS_PER_VALUE = 4          # L2: a product and a sum, for the dot and the norm


@contextlib.contextmanager
def instrument(record: dict):
    from scalablevectorsearch_tpu_torch.index.vamana import search
    real = search.beam_step
    launches = record.setdefault("beam_step_launches", [])

    def recorded(beam_keys, beam_packed, vecs, cand_ids, queries, **kw):
        out = real(beam_keys, beam_packed, vecs, cand_ids, queries, **kw)
        b, c = beam_keys.shape
        launches.append(((b, c, vecs.shape[1], vecs.shape[2],
                          vecs.element_size(), queries.element_size(),
                          kw["m"]), (cand_ids < 0).sum()))
        return out

    search.beam_step = recorded
    try:
        yield
    finally:
        search.beam_step = real


def read(record: dict):
    launches = record.get("beam_step_launches")
    kernels = record.get("kernels")
    if not launches or not kernels:
        return None
    seconds = sum(s for name, (s, _n) in kernels["ops"].items()
                  if "beam_step_kernel" in name and "DenseRows" in name)
    if seconds <= 0:
        return None
    dead = torch.stack([d for _shape, d in launches]).tolist()
    bound = sum(roofline.step_bound(
        b=b, c=c, k=k, d=d, row_itemsize=rs, query_itemsize=qs, m=m,
        dead_rows=n_dead, flops_per_value=FLOPS_PER_VALUE)["bound_s"]
        for ((b, c, k, d, rs, qs, m), _), n_dead in zip(launches, dead))
    return 100.0 * bound / seconds
