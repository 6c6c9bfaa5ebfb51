"""One run of one cell: set-up, the measured window, the check.

The cell's configuration, traffic mix, index kind and metrics are found by
name (``configs/<name>.json``, ``traffic/<name>.json``,
``indexes/<kind>.py``, ``metrics/<name>.py``).  ``run`` takes them as
data and a device, so that the tests can drive a whole run on the CPU at a
tiny size; ``run.py`` gives it the card.

Set-up: the rows and the query pool drawn from the seed on the device,
the index built and prepared by its kind's module (the drawn rows freed
once it holds its own), the calls planned, and the first calls of the
plan served as warm-up.  The window: a closed loop of one client, each
call ``search_async(queries, k).result()`` on the next block of the plan,
until ``seconds`` have passed; a call runs from entering ``search_async``
until ``result()`` returns.  In a traced run two stretches of the window
of up to 3 s are profiled: one from a quarter of the window for the
device's idle share, one from half of it, with the kernel metrics'
instruments on, for the kernels' times.
After the window the program's state is freed and the answers are judged
against the plain reference (``check.py``) over the rows drawn again.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import time
from pathlib import Path

import numpy as np
import torch

from . import check, data, program, trace

HERE = Path(__file__).resolve().parent
# the traced stretches: where each starts, as a share of the window, and
# its length, at most a quarter of the window: idle share, kernels
IDLE_STRETCH = 0.25
KERNEL_STRETCH = 0.5
STRETCH_S = 3.0


def load_json(folder: str, name: str) -> dict:
    with open(HERE / folder / f"{name}.json") as f:
        return json.load(f)


def load_metric(name: str):
    """The reader module ``metrics/<name>.py``: ``read(record)`` gives the
    metric or None, and an optional ``instrument(record)`` gives a context
    manager that is entered for the kernels' traced stretch."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "annbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_index_kind(kind: str):
    return importlib.import_module(f"{__package__}.indexes.{kind}")


def cell_metrics(bench: dict, cell: str, section: str) -> list:
    """The entries of ``bench[section]`` that ``cell`` reports: those that
    list it under ``workloads``, and those without the key whose end-to-end
    metric the cell reports."""
    e2e = {m["name"] for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])}
    out = []
    for m in bench[section]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif section == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def plan(traffic: dict, pool: int, seed: int) -> np.ndarray:
    """The calls' blocks of pool indices, (cycles * pool /
    queries_per_call, queries_per_call): ``cycles`` (1 by default)
    permutations of the pool drawn from the seed, each cut into calls, so
    that a batch's slowest query shares its call with other queries in
    each cycle and no few blocks set the window's work.  Every seed gets
    the same sizes in another order."""
    if traffic.get("loop") != "closed" or traffic.get("clients") != 1:
        raise ValueError("the traffic generator runs a closed loop of one "
                         "client")
    per_call = int(traffic["queries_per_call"])
    if pool % per_call:
        raise ValueError(f"a pool of {pool} does not split into calls of "
                         f"{per_call}")
    rng = np.random.default_rng([int(seed) & (2 ** 64 - 1), 1])
    return np.concatenate([rng.permutation(pool) for _ in range(
        int(traffic.get("cycles", 1)))]).reshape(-1, per_call)


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def serve(index, queries: list, k: int, seconds: float,
          stretches: tuple = ()) -> tuple:
    """The closed loop: ``(calls, results)``, one ``(enter, dispatched,
    done, stretch)`` per call in ``perf_counter_ns`` (``stretch`` is 1 +
    the index of the traced stretch it ran in, else 0).  ``stretches``:
    ``(start_s, stop_s, context manager)``, each entered at the first call
    boundary at or after its start and left at the first after its stop."""
    calls, results = [], []
    todo = list(stretches)
    active, tag = None, 0
    t0 = time.perf_counter_ns()
    end = t0 + int(seconds * 1e9)
    i = 0
    while True:
        now = time.perf_counter_ns()
        if active is not None and now >= t0 + active[1] * 1e9:
            active[2].__exit__(None, None, None)
            active, tag = None, 0
        if active is None and todo and now >= t0 + todo[0][0] * 1e9:
            active = todo.pop(0)
            active[2].__enter__()
            tag = len(stretches) - len(todo)
        block = queries[i % len(queries)]
        enter = time.perf_counter_ns()
        pending = index.search_async(block, k)
        dispatched = time.perf_counter_ns()
        results.append(pending.result())
        done = time.perf_counter_ns()
        calls.append((enter, dispatched, done, tag))
        i += 1
        if done >= end:
            break
    if active is not None:
        active[2].__exit__(None, None, None)
    return calls, results


def spans_of(calls: list, tag: int, offset_ns: int) -> list:
    """The host spans of the calls of one traced stretch, on the
    profiler's clock: ``search_async``, ``result`` and the client's own
    time up to the next call."""
    out = []
    stretch = [c for c in calls if c[3] == tag]
    for j, (enter, dispatched, done, _tag) in enumerate(stretch):
        nxt = stretch[j + 1][0] if j + 1 < len(stretch) else done
        out += [("search_async", enter + offset_ns, dispatched + offset_ns),
                ("result", dispatched + offset_ns, done + offset_ns),
                ("client", done + offset_ns, nxt + offset_ns)]
    return out


def run(config: dict, traffic: dict, metrics: list, *, seed: int,
        seconds: float, traced: bool, device, started: float = None,
        build=None, log=lambda msg: None) -> dict:
    """One run; returns its record (what the metric readers read) with the
    metrics' values under ``values`` and the check under ``check``.
    ``build(config, rows, device) -> (index, facts)`` puts another index in
    the program's place (the control); by default the configuration's
    index kind builds it."""
    started = time.perf_counter() if started is None else started
    cuda = torch.device(device).type == "cuda"
    k = int(config["k"])
    rows, pool = data.make(config["data"], config["n"], config["pool"],
                           config["dim"], seed, device)
    stamp = data.fingerprint(rows)
    pool_host = pool.cpu().numpy()
    del pool
    log(f"data: {config['n']} x {config['dim']} rows, a pool of "
        f"{config['pool']} queries, {time.perf_counter() - started:.1f} s")
    build = build or load_index_kind(config["index"]["kind"]).build
    index, facts = build(config, rows, device)
    del rows
    free(device)
    log(f"index: {facts}")
    blocks = plan(traffic, int(config["pool"]), seed)
    queries = [pool_host[b] for b in blocks]
    readers = {m["name"]: load_metric(m["name"]) for m in metrics}
    for i in range(int(traffic["warmup_calls"])):
        index.search_async(queries[i % len(queries)], k).result()
    record = {"facts": facts, "traced": traced and cuda}
    stretches = ()
    if record["traced"]:
        with trace.Profiled():           # the profiler's own start-up
            index.search_async(queries[0], k).result()
        idle = trace.Profiled()
        kernels = trace.Profiled()
        hooks = [r.instrument(record) for r in readers.values()
                 if hasattr(r, "instrument")]

        @contextlib.contextmanager
        def kernel_stretch():
            with kernels, contextlib.ExitStack() as stack:
                for hook in hooks:
                    stack.enter_context(hook)
                yield

        length = min(STRETCH_S, seconds / 4)
        stretches = tuple((start * seconds, start * seconds + length, cm)
                          for start, cm in ((IDLE_STRETCH, idle),
                                            (KERNEL_STRETCH,
                                             kernel_stretch())))
    if cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    # what set-up left behind is never garbage: keep the collector from
    # walking it in the window
    gc.collect()
    gc.freeze()
    record["setup_s"] = time.perf_counter() - started
    log(f"set-up {record['setup_s']:.2f} s; window of {seconds} s")
    before = program.launch_counts()
    offset_ns = time.time_ns() - time.perf_counter_ns()
    calls, results = serve(index, queries, k, seconds, stretches)
    after = program.launch_counts()
    gc.unfreeze()
    record["window_s"] = (calls[-1][2] - calls[0][0]) * 1e-9
    record["calls"] = calls
    record["queries_per_call"] = [len(queries[i % len(queries)])
                                  for i in range(len(calls))]
    record["launches"] = {name: after[name] - before[name]
                          for name in after}
    if cuda:
        record["window_peak_bytes"] = torch.cuda.max_memory_allocated()
        record["memory_peak_bytes"] = max(setup_peak,
                                          record["window_peak_bytes"])
    if record["traced"]:
        record["idle"] = trace.reduce(idle, spans_of(calls, 1, offset_ns))
        record["kernels"] = trace.reduce(kernels,
                                         spans_of(calls, 2, offset_ns))
        for name in ("idle", "kernels"):
            r = record[name]
            log(f"traced {name} stretch: {r['events']} device events, busy "
                f"{r['busy_s']:.6f} s of {r['window_s']:.6f} s")
    answers = [(blocks[i % len(blocks)], res.ids, res.distances)
               for i, res in enumerate(results)]
    del index, results
    free(device)
    rows, pool = data.make(config["data"], config["n"], config["pool"],
                           config["dim"], seed, device)
    if data.fingerprint(rows) != stamp:
        raise RuntimeError("the rows drawn again differ from the rows "
                           "served")
    record["check"] = check.judge(rows, pool, answers, k, config["limits"])
    del rows, pool
    free(device)
    record["values"] = {name: reader.read(record)
                        for name, reader in readers.items()}
    return record
