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


@pytest.mark.gpu
@pytest.mark.parametrize("metric", [0, 1, 2])
@pytest.mark.parametrize("label", ["serving", "build"])
def test_lvq_kernel_matches_plain_exactly(cuda, label, metric):
    """beam_step_lvq on exact (grid) LVQ inputs: the in-register decode,
    the dead-lane correction and the shared tie order make all five outputs
    identical to beam_step_lvq_plain at the main path's serving (n_dead 28)
    and build (n_dead 0) shapes."""
    shape = {"serving": chip_smoke.SERVING_SHAPE,
             "build": chip_smoke.BUILD_SHAPE}[label]
    rng = np.random.default_rng(sum(shape) + metric)
    n_dead = chip_smoke.LVQ_DEAD[label]
    _b, _c, _k, _d, window, m = shape
    args = chip_smoke.make_lvq_case(rng, shape, n_dead, grid=True)
    kw = dict(metric=metric, window=window, m=m, n_dead=n_dead)
    before = bs.beam_step_lvq.launches
    got = bs.beam_step_lvq(*args, **kw)
    want = bs.beam_step_lvq_plain(*args, **kw)
    torch.cuda.synchronize()
    assert bs.beam_step_lvq.launches == before + 1
    for name, g, w in zip(("keys", "packed", "popped", "pool_keys",
                           "pool_ids"), got, want):
        assert torch.equal(g, w), name


@pytest.mark.gpu
def test_lvq_kernel_odd_widths(cuda):
    """A dimension that is no multiple of 16 takes the one-code loads, and
    d_pad 256 puts 16 lanes on a row; exact inputs still match."""
    for shape, n_dead in (((8, 7, 5, 50, 3, 2), 3),
                          ((16, 32, 64, 256, 24, 4), 100)):
        args = chip_smoke.make_lvq_case(np.random.default_rng(5), shape,
                                        n_dead, grid=True)
        for metric in (0, 1, 2):
            kw = dict(metric=metric, window=shape[4], m=shape[5],
                      n_dead=n_dead)
            got = bs.beam_step_lvq(*args, **kw)
            want = bs.beam_step_lvq_plain(*args, **kw)
            torch.cuda.synchronize()
            assert all(torch.equal(g, w) for g, w in zip(got, want)), \
                (shape, metric)


@pytest.mark.gpu
def test_lvq_serving_on_gpu_matches_cpu(cuda):
    """An LVQ-8 index over one graph on the card and on the CPU: packed
    and unpacked serving agree with each other on the card, recall within
    0.02 of the CPU's, and the card's serving runs beam_step_lvq."""
    data, queries = svt.generate_test_dataset(2000, 100, 48, seed=7)
    params = svt.VamanaBuildParameters(graph_max_degree=16, window_size=32,
                                       max_candidate_pool_size=64,
                                       prune_to=14)
    built = svt.Vamana.build(params, data, "l2", device="cpu").index
    gt = svt.exhaustive_search(data, queries, 10, device="cpu")
    recalls = {}
    for device in ("cpu", "cuda"):
        graph = svt.NeighborGraph(built.graph.adjacency.to(device),
                                  built.graph.degrees.to(device),
                                  built.graph.n, built.graph.max_degree)
        index = svt.VamanaIndex(graph, svt.LVQDataset.compress(
            data, bits=8, device=device), built.entry_point, "l2")
        index.search_window_size = 16
        before = bs.beam_step_lvq.launches
        plain = index.search(queries, 10)
        index.enable_packed_serving()
        packed = index.search(queries, 10)
        served = bs.beam_step_lvq.launches - before
        assert (served > 0) == (device == "cuda")
        np.testing.assert_array_equal(plain.ids, packed.ids)
        recalls[device] = svt.k_recall_at_n(gt, packed)
    assert abs(recalls["cuda"] - recalls["cpu"]) <= 0.02, recalls


@pytest.mark.gpu
def test_lvq_kernel_rejects_what_it_does_not_take(cuda):
    shape = (4, 16, 8, 128, 8, 2)
    args = chip_smoke.make_lvq_case(np.random.default_rng(0), shape, 28,
                                    grid=True)
    kw = dict(metric=0, window=8, m=2, n_dead=28)

    def call(i, value, **over):
        a = list(args)
        a[i] = value
        return bs.beam_step_lvq(*a, **{**kw, **over})

    with pytest.raises(TypeError, match="int8"):
        call(2, args[2].float())
    with pytest.raises(TypeError, match="scales"):
        call(3, args[3].double())
    with pytest.raises(TypeError, match="mean"):
        call(5, args[5][:, :64].contiguous())
    with pytest.raises(TypeError, match="queries"):
        call(7, args[7].bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        call(2, args[2].transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="on cpu"):
        call(4, args[4].cpu())
    for n_dead in (-1, 128):
        with pytest.raises(ValueError, match="n_dead"):
            call(0, args[0], n_dead=n_dead)
