"""The readers that more than one metric file uses: each takes a run's
record (``harness.run``) and gives a number, or None where the run has
nothing for it to read."""

from __future__ import annotations


def qps(record: dict):
    """Queries answered in the window over the window's wall seconds."""
    return sum(record["queries_per_call"]) / record["window_s"]


def recall_at_10(record: dict):
    """Mean recall@10 of every answered query (``check.py``)."""
    return record["check"]["recall_at_10"]


def dispatch_pct(record: dict):
    """The share of the untraced calls' time spent inside
    ``search_async`` (host issue), against the wait in ``result()``."""
    calls = [c for c in record["calls"] if c[3] == 0]
    total = sum(done - enter for enter, _d, done, _t in calls)
    if not total:
        return None
    return 100.0 * sum(d - enter for enter, d, _done, _t in calls) / total


def launches_per_call(record: dict):
    """The port's kernel launches (all five counters) over the window, per
    call."""
    return sum(record["launches"].values()) / len(record["calls"])


def device_idle_pct(record: dict):
    """The share of the idle stretch's wall time in which no operation ran
    on the device."""
    idle = record.get("idle")
    if not idle or idle["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - idle["busy_s"] / idle["window_s"])


def build_s(record: dict, kind: str):
    facts = record["facts"]
    return facts["build_s"] if facts["kind"] == kind else None
