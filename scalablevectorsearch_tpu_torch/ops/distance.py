"""Batched distance computation.

PyTorch counterpart of ``scalablevectorsearch_tpu/ops/distance.py``.  The
unit of work is a dense key matrix: ``Q (B, d) x X (N, d) -> (B, N)`` by one
matmul plus norm algebra.  Keys are smaller-is-better for every metric (MIP
and cosine keys are negated similarities); :func:`value_from_key` recovers
public distances.  L2 keys are squared distances.

Precision: the JAX package pins its scoring matmuls to HIGHEST because bf16
scoring cost recall.  Here every matmul runs under an explicit fp32 matmul
precision, so a caller that enabled TF32 globally does not change the
results.  ``SVT_SCORE_PRECISION`` keeps its name and its three levels:
HIGHEST = full fp32 (default), HIGH = torch's "high" (TF32 on the GPU),
DEFAULT = torch's "medium" (bf16 products).
"""

from __future__ import annotations

import contextlib
import enum
import os
from typing import Optional

import torch


class DistanceType(enum.Enum):
    """Runtime distance enum (reference: ``DistanceType`` core/distance.h:41)."""

    L2 = "L2"
    MIP = "MIP"
    Cosine = "Cosine"


_PRECISIONS = {"DEFAULT": "medium", "HIGH": "high", "HIGHEST": "highest"}


def _precision_from_env(var: str, default: str) -> str:
    return _PRECISIONS[os.environ.get(var, default).upper()]


# Candidate scoring precision (the JAX package's SVT_SCORE_PRECISION knob).
SCORE_PRECISION = _precision_from_env("SVT_SCORE_PRECISION", "HIGHEST")
HIGHEST = "highest"


@contextlib.contextmanager
def matmul_precision(precision: str):
    """Run fp32 matmuls at ``precision`` and restore the caller's setting."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(precision)
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def as_distance(d) -> DistanceType:
    if isinstance(d, DistanceType):
        return d
    name = str(d).lower()
    aliases = {"l2": "L2", "euclidean": "L2", "mip": "MIP", "ip": "MIP",
               "inner_product": "MIP", "innerproduct": "MIP",
               "cosine": "Cosine", "cosine_similarity": "Cosine"}
    if name not in aliases:
        raise ValueError(f"unknown distance {d!r}")
    return DistanceType(aliases[name])


def dot_matrix(queries: torch.Tensor, vectors: torch.Tensor,
               precision: str = HIGHEST) -> torch.Tensor:
    """Q (B, d) x X (N, d) -> (B, N) f32 inner products."""
    with matmul_precision(precision):
        return queries.float() @ vectors.float().T


def pairwise_keys(distance: DistanceType,
                  queries: torch.Tensor,
                  vectors: torch.Tensor,
                  vector_norms_sq: Optional[torch.Tensor] = None,
                  query_norms_sq: Optional[torch.Tensor] = None,
                  precision: str = HIGHEST) -> torch.Tensor:
    """Full (B, N) key matrix between query rows and dataset rows.

    ``vector_norms_sq`` (N,) may carry +inf for padding rows, which makes
    padded rows lose every comparison.
    """
    distance = as_distance(distance)
    dots = dot_matrix(queries, vectors, precision=precision)
    if distance == DistanceType.MIP:
        return -dots
    if vector_norms_sq is None:
        vector_norms_sq = vectors.float().square().sum(-1)
    pad = torch.where(torch.isinf(vector_norms_sq), float("inf"), 0.0)[None]
    if query_norms_sq is None:
        query_norms_sq = queries.float().square().sum(-1)
    if distance == DistanceType.L2:
        keys = (query_norms_sq[:, None] - 2.0 * dots
                + vector_norms_sq[None, :])
        return keys.clamp_min(0.0) + pad
    denom = query_norms_sq[:, None].clamp_min(1e-30).sqrt() * \
        vector_norms_sq[None, :].clamp_min(1e-30).sqrt()
    return -dots / denom + pad


def gathered_keys(distance: DistanceType,
                  queries: torch.Tensor,
                  gathered: torch.Tensor,
                  gathered_norms_sq: Optional[torch.Tensor] = None,
                  query_norms_sq: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """Keys between each query and its own gathered candidates:
    ``queries`` (B, d), ``gathered`` (B, R, d) -> (B, R) f32 keys."""
    distance = as_distance(distance)
    qf = queries.float()
    gf = gathered.float()
    with matmul_precision(SCORE_PRECISION):
        dots = torch.bmm(gf, qf[:, :, None])[:, :, 0]
    if distance == DistanceType.MIP:
        return -dots
    if gathered_norms_sq is None:
        gathered_norms_sq = gf.square().sum(-1)
    if query_norms_sq is None:
        query_norms_sq = qf.square().sum(-1)
    if distance == DistanceType.L2:
        return (query_norms_sq[:, None] - 2.0 * dots
                + gathered_norms_sq).clamp_min(0.0)
    denom = query_norms_sq[:, None].clamp_min(1e-30).sqrt() * \
        gathered_norms_sq.clamp_min(1e-30).sqrt()
    return -dots / denom


def keys_from_parts(distance: DistanceType, dots: torch.Tensor,
                    x2: torch.Tensor, query_norms_sq: torch.Tensor
                    ) -> torch.Tensor:
    """(B, R) ``<q, x>`` and ``||x||^2`` (``score_rows``' two outputs) and
    (B,) ``||q||^2`` -> (B, R) keys, with :func:`gathered_keys`' formulas
    and clamps."""
    distance = as_distance(distance)
    if distance == DistanceType.MIP:
        return -dots
    if distance == DistanceType.L2:
        return (query_norms_sq[:, None] - 2.0 * dots + x2).clamp_min(0.0)
    denom = query_norms_sq[:, None].clamp_min(1e-30).sqrt() * \
        x2.clamp_min(1e-30).sqrt()
    return -dots / denom


def keys_from_l2_partial(partial: torch.Tensor,
                         query_norms_sq: torch.Tensor) -> torch.Tensor:
    """(B, R) ``||x||^2 - 2 <q, x>`` (``gather_score_l2_partial``) and (B,)
    ``||q||^2`` -> (B, R) L2 keys ``max(||q||^2 + partial, 0)``.  The sum is
    rounded in another order than :func:`gathered_keys`'
    ``q2 - 2 dots + x2``, so keys differ from it at ulp level."""
    return (query_norms_sq[:, None] + partial).clamp_min(0.0)


def value_from_key(distance: DistanceType, keys):
    """Convert internal smaller-is-better keys to public distances."""
    distance = as_distance(distance)
    if distance == DistanceType.L2:
        return keys
    return -keys


def key_from_value(distance: DistanceType, values):
    distance = as_distance(distance)
    if distance == DistanceType.L2:
        return values
    return -values
