"""beam_step of the PyTorch port against the JAX package's reference.

The plain PyTorch version runs here on the CPU beside the JAX
``beam_step_reference`` (the Pallas kernel's math in plain XLA) on the same
numpy inputs.  The CUDA kernel needs the card: its tests are in
``test_torch_gpu.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from scalablevectorsearch_tpu.ops.pallas.beam_step import beam_step_reference
from scalablevectorsearch_tpu_torch.ops.kernels import beam_step as bs

torch.set_num_threads(1)

# (B, C, K, d, window, m): the shapes of tests/test_pallas.py
SHAPES = [(8, 16, 32, 128, 12, 2), (16, 48, 128, 128, 48, 4),
          (8, 24, 8, 64, 24, 4)]


def make_case(rng, B, C, K, d, n_ids=400):
    """Inputs as tests/test_pallas.py builds them: a sorted beam with some
    visited and some empty slots, candidates with 20% invalid ids, rows
    gathered from one table."""
    beam_ids = np.stack([rng.choice(n_ids, C, replace=False)
                         for _ in range(B)]).astype(np.int32)
    beam_keys = np.sort(
        rng.normal(size=(B, C)).astype(np.float32) ** 2, axis=1)
    vis = (rng.random((B, C)) < 0.5).astype(np.int32)
    for bi in range(B):
        nv = rng.integers(0, C // 3 + 1)
        if nv:
            beam_keys[bi, C - nv:] = np.inf
    beam_packed = np.where(np.isfinite(beam_keys),
                           beam_ids | (vis << 30), -1).astype(np.int32)
    cand_ids = rng.choice(n_ids, (B, K)).astype(np.int32)
    cand_ids[rng.random((B, K)) < 0.2] = -1
    table = rng.normal(size=(n_ids, d)).astype(np.float32)
    queries = rng.normal(size=(B, d)).astype(np.float32)
    vecs = table[np.maximum(cand_ids, 0)]
    return beam_keys, beam_packed, vecs, cand_ids, queries


def assert_same_step(got, want, tol):
    """Outputs of two beam_step implementations agree: keys within ``tol``,
    popped exact, the pool exact (it is in id order), and the beam's packed
    values exact on finite slots, or as (key, id) multisets among tied
    keys."""
    gk, gp, gpop, gpk, gpi = (np.asarray(x) for x in got)
    wk, wp, wpop, wpk, wpi = (np.asarray(x) for x in want)
    np.testing.assert_allclose(gk, wk, rtol=tol, atol=tol, err_msg="keys")
    np.testing.assert_array_equal(gpop, wpop, err_msg="popped")
    np.testing.assert_allclose(gpk, wpk, rtol=tol, atol=tol,
                               err_msg="pool_keys")
    np.testing.assert_array_equal(gpi, wpi, err_msg="pool_ids")
    for r in range(wk.shape[0]):
        fin = np.isfinite(wk[r])
        keys, g, w = wk[r][fin], gp[r][fin], wp[r][fin]
        if not np.array_equal(g, w):
            for v in np.unique(keys):
                assert sorted(g[keys == v]) == sorted(w[keys == v]), \
                    f"packed row {r}"


@pytest.mark.parametrize("vec_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("metric", [0, 1, 2])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax_reference(rng, shape, metric, vec_dtype):
    B, C, K, d, window, m = shape
    bk, bp, vecs, cids, q = make_case(rng, B, C, K, d)
    if vec_dtype == "bfloat16":
        # the same bf16 rows on both sides (rounded once, in torch)
        vecs_t = torch.from_numpy(vecs).to(torch.bfloat16)
        vecs_j = jnp.asarray(vecs_t.float().numpy()).astype(jnp.bfloat16)
    else:
        vecs_t, vecs_j = torch.from_numpy(vecs), jnp.asarray(vecs)
    want = beam_step_reference(jnp.asarray(bk), jnp.asarray(bp), vecs_j,
                               jnp.asarray(cids), jnp.asarray(q),
                               metric=metric, window=window, m=m)
    got = bs.beam_step(torch.from_numpy(bk), torch.from_numpy(bp), vecs_t,
                       torch.from_numpy(cids), torch.from_numpy(q),
                       metric=metric, window=window, m=m)
    assert_same_step([x.numpy() for x in got], want, 1e-5)


def test_cpu_dispatch_runs_plain_and_counts_no_launch(rng):
    bk, bp, vecs, cids, q = make_case(rng, 4, 16, 32, 64)
    before = bs.beam_step.launches
    args = [torch.from_numpy(x) for x in (bk, bp, vecs, cids, q)]
    got = bs.beam_step(*args, metric=0, window=12, m=2)
    want = bs.beam_step_plain(*args, metric=0, window=12, m=2)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert bs.beam_step.launches == before
