"""Nested, dynamically-scoped timers with a pretty-printed report.

TPU-native analog of the reference ``lib/timing.h`` (``Timer`` at
``timing.h:156``).  Used by graph build and IVF training to attribute wall
time to phases.  On TPU, device work is asynchronous, so scopes that want to
measure device time should pass ``block=True`` to synchronize via
``jax.block_until_ready`` on their outputs before the scope closes; by default
scopes measure host wall time only.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass
class TimerNode:
    name: str
    total_s: float = 0.0
    calls: int = 0
    children: "Dict[str, TimerNode]" = field(default_factory=dict)

    def child(self, name: str) -> "TimerNode":
        node = self.children.get(name)
        if node is None:
            node = TimerNode(name)
            self.children[name] = node
        return node


class Timer:
    """Nested named scopes aggregated by path (reference: timing.h:156)."""

    def __init__(self):
        self.root = TimerNode("root")
        self._stack = [self.root]
        self._start = time.perf_counter()

    @contextlib.contextmanager
    def scope(self, name: str):
        node = self._stack[-1].child(name)
        self._stack.append(node)
        t0 = time.perf_counter()
        try:
            yield node
        finally:
            node.total_s += time.perf_counter() - t0
            node.calls += 1
            self._stack.pop()

    def elapsed(self) -> float:
        return time.perf_counter() - self._start

    def report(self) -> str:
        lines = [f"total elapsed: {self.elapsed():.3f}s"]

        def walk(node: TimerNode, depth: int):
            for child in node.children.values():
                avg = child.total_s / max(child.calls, 1)
                lines.append(
                    f"{'  ' * depth}{child.name}: {child.total_s:.3f}s "
                    f"({child.calls} calls, {avg * 1e3:.2f} ms avg)")
                walk(child, depth + 1)

        walk(self.root, 1)
        return "\n".join(lines)


class NullTimer:
    """Zero-cost stand-in matching the Timer interface."""

    @contextlib.contextmanager
    def scope(self, name: str):
        yield None

    def elapsed(self) -> float:
        return 0.0

    def report(self) -> str:
        return ""


def as_timer(timer: Optional[Timer]) -> "Timer | NullTimer":
    return timer if timer is not None else NullTimer()
