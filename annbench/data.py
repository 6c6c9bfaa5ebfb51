"""The benchmark's frozen data generator.

Rows and queries are drawn on the device from the seed with one
``torch.Generator``, in float32, the type they are served in.  The
``clustered`` distribution is the arithmetic of the program's
``core/io.py::generate_test_dataset`` (clustered branch), copied here so
that a change to the program cannot change the benchmark's data: Gaussian
cluster centres of standard deviation ``center_scale``, one centre per
``points_per_cluster`` rows (at least ``min_clusters``), every row and
query a uniformly chosen centre plus unit-scale Gaussian noise.  The same
seed on the same device and PyTorch gives the same tensors.
"""

from __future__ import annotations

import torch

# rows per chunk when adding the centres, so that the (n, d) gather of
# centres never needs a second full-size buffer
_CHUNK = 1 << 20


def make(spec: dict, n: int, n_queries: int, dim: int, seed: int,
         device) -> tuple:
    """``(rows (n, dim), queries (n_queries, dim))`` float32 tensors on
    ``device``, drawn from ``seed`` as ``spec`` (a configuration's
    ``data`` entry) says."""
    if spec.get("distribution") != "clustered":
        raise ValueError(f"unknown data distribution {spec.get('distribution')!r}")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    n_clusters = max(int(spec.get("min_clusters", 8)),
                     n // int(spec["points_per_cluster"]))
    centers = torch.randn((n_clusters, dim), generator=gen, device=device)
    centers.mul_(float(spec["center_scale"]))
    noise = float(spec.get("noise", 1.0))

    def draw(count: int) -> torch.Tensor:
        out = torch.randn((count, dim), generator=gen, device=device)
        out.mul_(noise)
        assign = torch.randint(0, n_clusters, (count,), generator=gen,
                               device=device)
        for start in range(0, count, _CHUNK):
            stop = min(start + _CHUNK, count)
            out[start:stop].add_(centers[assign[start:stop]])
        return out

    rows = draw(n)
    queries = draw(n_queries)
    return rows, queries


def fingerprint(rows: torch.Tensor) -> float:
    """A float64 sum over a strided sample of the rows: the reference
    checks with it that the rows it draws again after the window are the
    ones the program was given."""
    step = max(1, rows.shape[0] // 4096)
    return float(rows[::step].double().sum())
