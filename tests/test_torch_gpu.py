"""GPU-only tests of the PyTorch port (marked ``gpu``; skip without a card).

They import no JAX, so they also run where JAX is not installed; from the
repository root:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""

import numpy as np
import pytest
import torch

import chip_smoke
import scalablevectorsearch_tpu_torch as svt
from scalablevectorsearch_tpu_torch.ops.kernels import beam_step as bs

torch.set_num_threads(1)

# (B, C, K, d, window, m): the main path's serving and build shapes, the
# widest beam and candidate list with a dimension that needs more than
# 48 KB of shared memory, and an odd dimension that takes the scalar loads
EDGE_SHAPES = [chip_smoke.SERVING_SHAPE, chip_smoke.BUILD_SHAPE,
               (2, 1024, 1024, 4096, 700, 40), (8, 7, 5, 50, 3, 2)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")


@pytest.mark.gpu
@pytest.mark.parametrize("query_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("vec_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", EDGE_SHAPES)
def test_kernel_matches_plain_exactly(cuda, shape, vec_dtype, query_dtype):
    """On inputs with exact f32 dot products the kernel and the plain
    version share one tie order, so all five outputs are identical."""
    rng = np.random.default_rng(sum(shape))
    _b, _c, _k, _d, window, m = shape
    for metric in (0, 1, 2):
        args = chip_smoke.make_case(rng, shape, grid=True,
                                    query_dtype=query_dtype)
        args[2] = args[2].to(vec_dtype)
        before = bs.beam_step.launches
        got = bs.beam_step(*args, metric=metric, window=window, m=m)
        want = bs.beam_step_plain(*args, metric=metric, window=window, m=m)
        torch.cuda.synchronize()
        assert bs.beam_step.launches == before + 1
        for name, g, w in zip(("keys", "packed", "popped", "pool_keys",
                               "pool_ids"), got, want):
            assert torch.equal(g, w), (metric, name)


@pytest.mark.gpu
def test_kernel_rejects_what_it_does_not_take(cuda):
    args = chip_smoke.make_case(np.random.default_rng(0), (4, 16, 8, 32, 8, 2),
                                grid=True)
    with pytest.raises(ValueError, match="contiguous"):
        bs.beam_step(args[0], args[1], args[2].transpose(1, 2).contiguous()
                     .transpose(1, 2), args[3], args[4], metric=0, window=8,
                     m=2)
    with pytest.raises(TypeError):
        bs.beam_step(args[0], args[1], args[2].half(), args[3], args[4],
                     metric=0, window=8, m=2)
    with pytest.raises(ValueError, match="on cpu"):
        bs.beam_step(args[0], args[1], args[2].cpu(), args[3], args[4],
                     metric=0, window=8, m=2)


@pytest.mark.gpu
def test_build_and_search_on_gpu_match_cpu(cuda):
    """The same build and search on the card and on the CPU: recall within
    0.05 (f32 rounding differs), and the card's run goes through the
    kernel in both phases."""
    data, queries = svt.generate_test_dataset(2000, 100, 48, seed=7)
    params = svt.VamanaBuildParameters(graph_max_degree=16, window_size=32,
                                       max_candidate_pool_size=64,
                                       prune_to=14)
    recalls = {}
    for device in ("cpu", "cuda"):
        before = bs.beam_step.launches
        index = svt.Vamana.build(params, data, "l2", sampled_entries=True,
                                 device=device)
        built = bs.beam_step.launches - before
        gt = svt.exhaustive_search(data, queries, 10, device=device)
        index.search_window_size = 16
        before = bs.beam_step.launches
        recalls[device] = svt.k_recall_at_n(gt, index.search(queries, 10))
        served = bs.beam_step.launches - before
        if device == "cuda":
            assert built > 0 and served > 0
        else:
            assert built == 0 and served == 0
    assert abs(recalls["cuda"] - recalls["cpu"]) <= 0.05, recalls
