"""Queries answered per second by the calls of a traced run that ran
outside its profiled stretches, over those calls' own time (entering
``search_async`` until ``result()`` returns), in the Vamana batch cell.

Its host-bound loop's throughput drifts with the shared host's speed by
more than any bound an end-to-end metric may have, so there it is read
per layer and not held to a bound (PERF.md, section 2)."""


def read(record: dict):
    calls = [c for c in record["calls"] if c[3] == 0]
    sizes = [n for c, n in zip(record["calls"], record["queries_per_call"])
             if c[3] == 0]
    total = sum(done - enter for enter, _d, done, _t in calls)
    if not total:
        return None
    return sum(sizes) / (total * 1e-9)
