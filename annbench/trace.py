"""Reading the device trace of a traced sub-window.

``Profiled`` runs ``torch.profiler`` over a stretch of calls, recording
device activity only (kernels, copies, sets), which keeps the profiler's
own cost on the host small.  Nothing is written to disk: the events are
taken from the profiler's in-memory results once the window has closed.
Event times are the profiler's, on the host's wall clock
(``time.time_ns``); the benchmark's host spans are moved onto that clock
by one offset taken beside the window.
"""

from __future__ import annotations

import bisect
import time

import torch

TOP = 10


class Profiled:
    """A context manager that profiles the device while it is entered."""

    def __init__(self):
        self.prof = None
        self.t0_ns = self.t1_ns = 0

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self.t0_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.t1_ns = time.time_ns()
        self.prof.stop()
        return False

    def events(self) -> list:
        """``[(name, start_ns, end_ns)]`` of the device's activity inside
        the profiled stretch."""
        from torch.autograd import DeviceType
        out = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            start, end = max(e.start_ns(), self.t0_ns), min(e.end_ns(),
                                                           self.t1_ns)
            if end > start:
                out.append((e.name(), start, end))
        return out


def merged(events: list) -> list:
    """The union of the events' intervals, as sorted disjoint
    ``[start_ns, end_ns]`` pairs."""
    out = []
    for _name, start, end in sorted(events, key=lambda e: e[1]):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def by_name(events: list) -> dict:
    """``{name: [seconds, count]}`` of device time by operation."""
    out = {}
    for name, start, end in events:
        entry = out.setdefault(name, [0.0, 0])
        entry[0] += (end - start) * 1e-9
        entry[1] += 1
    return out


def reduce(profiled: Profiled, spans: list) -> dict:
    """What a traced stretch says: its wall seconds, the seconds in which
    some operation ran on the device, time by operation, the ten longest
    operations by total and the ten longest idle gaps, each named by the
    host span (``spans``: sorted ``(name, start_ns, end_ns)`` on the
    profiler's clock) open when the gap began."""
    events = profiled.events()
    busy = merged(events)
    ops = by_name(events)
    gaps = []
    edge = profiled.t0_ns
    for start, end in busy + [[profiled.t1_ns, profiled.t1_ns]]:
        if start > edge:
            gaps.append((edge, start))
        edge = max(edge, end)
    starts = [s[1] for s in spans]
    named = []
    for start, end in gaps:
        i = bisect.bisect_right(starts, start) - 1
        name = spans[i][0] if i >= 0 and spans[i][2] > start else "between"
        named.append([name, (end - start) * 1e-9])
    named.sort(key=lambda g: -g[1])
    top_ops = sorted(([name, s] for name, (s, _n) in ops.items()),
                     key=lambda o: -o[1])
    return {"window_s": (profiled.t1_ns - profiled.t0_ns) * 1e-9,
            "busy_s": sum(end - start for start, end in busy) * 1e-9,
            "ops": ops, "top_ops": top_ops[:TOP], "idle_gaps": named[:TOP],
            "events": len(events)}
