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


# ---------------------------------------------------------------------------
# The scored route's kernels: beam_update, score_rows, gather_score_l2_partial
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("grid", [True, False])
@pytest.mark.parametrize("shape", EDGE_SHAPES)
def test_beam_update_kernel_matches_plain_exactly(cuda, shape, grid):
    """The keys are inputs, so tied (grid) and real keys alike give the
    plain version's five outputs exactly."""
    from scalablevectorsearch_tpu_torch.ops.kernels import beam_update as bu
    rng = np.random.default_rng(sum(shape) + grid)
    _b, c, k, _d, window, m = shape
    args = chip_smoke.make_update_case(rng, shape, grid)
    before = bu.beam_update.launches
    got = bu.beam_update(*args, window=window, m=m)
    want = bu.beam_update_plain(*args, window=window, m=m)
    torch.cuda.synchronize()
    assert bu.beam_update.launches == before + 1
    assert got[3].shape == (shape[0], c + k)
    for name, g, w in zip(("keys", "packed", "popped", "pool_keys",
                           "pool_ids"), got, want):
        assert torch.equal(g, w), name


@pytest.mark.gpu
@pytest.mark.parametrize("d", [128, 50, 256])
def test_score_rows_kernel_matches_plain(cuda, d):
    """Exact (grid) inputs give identical dots and norms; d 50 takes the
    scalar loads."""
    from scalablevectorsearch_tpu_torch.ops.kernels import (
        gather_distance as gd)
    rng = np.random.default_rng(d)
    rows = torch.from_numpy(chip_smoke.grid_values(rng, (64, 37, d), d))
    q = torch.from_numpy(chip_smoke.grid_values(rng, (64, d), d))
    before = gd.score_rows.launches
    got = gd.score_rows(rows.cuda(), q.cuda())
    want = gd.score_rows_plain(rows, q)
    torch.cuda.synchronize()
    assert gd.score_rows.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


# (K, B) of the gather: K below, at and above one 32-id chunk and 128, and
# K 1024 (a query split over four warps at B 1); B 1 and the tail's 418;
# then every id equal, and a table or queries off 16-byte alignment (the
# generic path)
GATHER_CASES = [f"k{k}_b{b}" for k in (1, 5, 127, 128, 129, 1024)
                for b in (1, 418)] + ["one_id", "unaligned_table",
                                      "unaligned_queries"]


def _misaligned(t: torch.Tensor, offset_bytes: int) -> torch.Tensor:
    """A contiguous copy of ``t`` whose data starts ``offset_bytes`` past a
    16-byte boundary."""
    skip = offset_bytes // t.element_size()
    flat = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
    out = flat[skip:skip + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 16 == offset_bytes
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("case", GATHER_CASES)
@pytest.mark.parametrize("d", [128, 256, 96, 50])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16, torch.int8, torch.uint8])
def test_gather_score_l2_partial_kernel_matches_plain(cuda, dtype, d, case):
    """Exact (grid) tables of every element type give the plain version's
    partial keys exactly, real-valued ones within rtol 1e-5 (atol 1e-5 of
    the keys' scale: the sums run in another order), ids outside the table
    (clamped) included.  d 128 and 256 take the fast path for every type;
    d 96 and 50 (rows of no whole multiple of 128 bytes) and unaligned
    tensors the generic one."""
    from scalablevectorsearch_tpu_torch.ops.kernels import (
        gather_distance as gd)
    rng = np.random.default_rng(d + GATHER_CASES.index(case))
    k, b = (128, 418) if not case.startswith("k") else \
        map(int, case[1:].split("_b"))
    n_rows = 300
    ids = rng.integers(-3, n_rows + 10, size=(b, k)).astype(np.int32)
    if case == "one_id":
        ids[:] = rng.integers(0, n_rows)
    ids = torch.from_numpy(ids).cuda()
    for grid in (True, False):
        if grid:
            base = torch.from_numpy(chip_smoke.grid_values(
                rng, (n_rows, d), d))
            q = torch.from_numpy(chip_smoke.grid_values(rng, (b, d), d))
        else:
            base = torch.from_numpy(rng.normal(size=(n_rows, d)).astype(
                np.float32))
            q = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32))
        if dtype in (torch.int8, torch.uint8):
            base = (base * 32).round().clamp(-127, 127)
            if dtype == torch.uint8:
                base = base.abs()
        table, q = base.to(dtype).cuda(), q.cuda()
        if case == "unaligned_table":
            table = _misaligned(table, 8)
        elif case == "unaligned_queries":
            q = _misaligned(q, 4)
        before = gd.gather_score_l2_partial.launches
        got = gd.gather_score_l2_partial(table, ids, q)
        want = gd.gather_score_l2_partial_plain(table, ids, q)
        torch.cuda.synchronize()
        assert gd.gather_score_l2_partial.launches == before + 1
        if grid:
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(
                got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))


@pytest.mark.gpu
def test_scored_kernels_reject_what_they_do_not_take(cuda):
    from scalablevectorsearch_tpu_torch.ops.kernels import (
        gather_distance as gd)
    rows = torch.zeros((4, 8, 32), device="cuda")
    q = torch.zeros((4, 32), device="cuda")
    ids = torch.zeros((4, 8), dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError, match="float32"):
        gd.score_rows(rows.half(), q)
    with pytest.raises(ValueError, match="contiguous"):
        gd.score_rows(rows.transpose(1, 2).contiguous().transpose(1, 2), q)
    with pytest.raises(ValueError, match="cpu"):
        gd.score_rows(rows, q.cpu())
    with pytest.raises(TypeError):
        gd.gather_score_l2_partial(rows[0].double(), ids, q)
    with pytest.raises(TypeError):
        gd.gather_score_l2_partial(rows[0], ids.long(), q)


@pytest.mark.gpu
def test_scored_and_wide_search_on_gpu_match_cpu(cuda):
    """float16 and SQ-int8 datasets over one graph on the card and on the
    CPU: recall within 0.02, and the card's searches run the scored
    route's kernels; a 1100-slot beam takes the wide route there."""
    from scalablevectorsearch_tpu_torch.ops.kernels import beam_update as bu
    from scalablevectorsearch_tpu_torch.ops.kernels import (
        gather_distance as gd)
    data, queries = svt.generate_test_dataset(2000, 100, 48, seed=7)
    params = svt.VamanaBuildParameters(graph_max_degree=16, window_size=32,
                                       max_candidate_pool_size=64,
                                       prune_to=14)
    built = svt.Vamana.build(params, data, "l2", device="cpu").index
    gt = svt.exhaustive_search(data, queries, 10, device="cpu")
    for kind, scorer in (("float16", gd.gather_score_l2_partial),
                         ("sq", gd.score_rows)):
        recalls, ids = {}, {}
        for device in ("cpu", "cuda"):
            graph = svt.NeighborGraph(built.graph.adjacency.to(device),
                                      built.graph.degrees.to(device),
                                      built.graph.n, built.graph.max_degree)
            ds = svt.SQDataset.compress(data, device=device) \
                if kind == "sq" else svt.VectorDataset.from_array(
                    data, dtype=torch.float16, device=device)
            index = svt.VamanaIndex(graph, ds, built.entry_point, "l2")
            index.search_window_size = 16
            before = (bu.beam_update.launches, scorer.launches)
            recalls[device] = svt.k_recall_at_n(gt, index.search(queries, 10))
            launched = (bu.beam_update.launches - before[0],
                        scorer.launches - before[1])
            assert (min(launched) > 0) == (device == "cuda"), launched
            index.search_window_size = 1100
            before = (bu.beam_update.launches, scorer.launches)
            ids[device] = index.search(queries, 10).ids
            assert bu.beam_update.launches == before[0]
            assert (scorer.launches > before[1]) == (device == "cuda")
        assert abs(recalls["cuda"] - recalls["cpu"]) <= 0.02, (kind, recalls)
        same = np.sort(ids["cuda"], 1) == np.sort(ids["cpu"], 1)
        assert same.mean() >= 0.98, (kind, same.mean())


# ---------------------------------------------------------------------------
# The warp-per-query core of csrc/beam_step.cu: edge cases of all four
# entry routes (beam_step over f32 and bf16 rows, beam_step_lvq,
# beam_update) on exact inputs, and the id-range trap
# ---------------------------------------------------------------------------

# (B, C, K, d, window, m): K not a power of two (5, 100, 127, 129 - the
# last sorts 256 elements in registers), K = C = 1024 (the sorts in shared
# memory), one query, and the serving search's compacted tail (B 418)
CORE_SHAPES = {
    "k5": (16, 16, 5, 128, 12, 4),
    "k100": (16, 100, 100, 128, 100, 4),
    "k127": (16, 16, 127, 128, 12, 4),
    "k129": (16, 32, 129, 128, 24, 4),
    "k1024": (2, 1024, 1024, 4096, 700, 40),
    "b1": (1, 16, 128, 128, 12, 4),
    "b418": chip_smoke.TAIL_SHAPE,
}
# candidate rewrites at the serving widths (B 32)
CORE_EDITS = ("all_invalid", "all_in_beam", "one_id", "unaligned")
CORE_ROUTES = ("f32", "bf16", "lvq", "update")


def _core_inputs(route, shape, rng):
    """Exact inputs of one route and the keyword arguments of its call."""
    _b, _c, _k, d, window, m = shape
    if route == "update":
        return (chip_smoke.make_update_case(rng, shape, grid=True),
                dict(window=window, m=m))
    if route == "lvq":
        n_dead = 3 if d > 3 else 0
        return (chip_smoke.make_lvq_case(rng, shape, n_dead, grid=True),
                dict(metric=0, window=window, m=m, n_dead=n_dead))
    args = chip_smoke.make_case(rng, shape, grid=True)
    if route == "bf16":
        args[2] = args[2].to(torch.bfloat16)
    return args, dict(metric=0, window=window, m=m)


def _edit_candidates(args, route, edit, rng):
    """Rewrites the candidate ids (the rows stay: the kernel and the plain
    version score the same rows) or moves the row block off 16 bytes."""
    ids_at = {"update": 3, "lvq": 6}.get(route, 3)
    cand = args[ids_at]
    beam_keys, beam_packed = args[0], args[1]
    if edit == "all_invalid":
        cand = torch.full_like(cand, -1)
    elif edit == "all_in_beam":
        live = torch.where(torch.isfinite(beam_keys),
                           beam_packed & bs.ID_MASK, -1)
        n_live = torch.isfinite(beam_keys).sum(1, keepdim=True).clamp_min(1)
        cols = torch.arange(cand.shape[1], device=cand.device)[None, :]
        cand = torch.gather(live, 1, cols % n_live).to(torch.int32)
    elif edit == "one_id":
        cand = torch.full_like(cand, int(rng.integers(0, 400)))
    elif edit == "unaligned":
        rows = args[2]
        flat = torch.empty(rows.numel() + 1, dtype=rows.dtype,
                           device=rows.device)
        flat[1:] = rows.reshape(-1)
        args[2] = flat[1:].view(rows.shape)
        assert args[2].is_contiguous() and args[2].data_ptr() % 16 != 0
    args[ids_at] = cand.contiguous()
    return args


def _run_route(route, args, kw):
    from scalablevectorsearch_tpu_torch.ops.kernels import beam_update as bu
    kernel, plain = {
        "update": (bu.beam_update, bu.beam_update_plain),
        "lvq": (bs.beam_step_lvq, bs.beam_step_lvq_plain),
    }.get(route, (bs.beam_step, bs.beam_step_plain))
    before = kernel.launches
    got = kernel(*args, **kw)
    want = plain(*args, **kw)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    return got, want


@pytest.mark.gpu
@pytest.mark.parametrize("route,case", [
    (route, case) for route in CORE_ROUTES
    for case in list(CORE_SHAPES) + list(CORE_EDITS)
    if not (route == "update" and case == "unaligned")])  # reads no rows
def test_core_edge_cases_match_plain_exactly(cuda, route, case):
    """All five outputs identical to the plain version on exact inputs."""
    rng = np.random.default_rng(len(case) * 7 + len(route))
    shape = CORE_SHAPES.get(case, (32, 16, 128, 128, 12, 4))
    args, kw = _core_inputs(route, shape, rng)
    if case in CORE_EDITS:
        args = _edit_candidates(args, route, case, rng)
    got, want = _run_route(route, args, kw)
    for name, g, w in zip(("keys", "packed", "popped", "pool_keys",
                           "pool_ids"), got, want):
        assert torch.equal(g, w), (route, case, name)


_TRAP_SCRIPT = """
import sys, numpy as np, torch
import chip_smoke
from scalablevectorsearch_tpu_torch.ops.kernels import beam_step as bs
from scalablevectorsearch_tpu_torch.ops.kernels import beam_update as bu
route = sys.argv[1]
rng = np.random.default_rng(0)
shape = (4, 16, 32, 128, 12, 4)
if route == "update":
    args = chip_smoke.make_update_case(rng, shape, grid=True)
    call = lambda a: bu.beam_update(*a, window=12, m=4)
    at = 3
elif route == "lvq":
    args = chip_smoke.make_lvq_case(rng, shape, 0, grid=True)
    call = lambda a: bs.beam_step_lvq(*a, metric=0, window=12, m=4, n_dead=0)
    at = 6
else:
    args = chip_smoke.make_case(rng, shape, grid=True)
    call = lambda a: bs.beam_step(*a, metric=0, window=12, m=4)
    at = 3
call(args)
torch.cuda.synchronize()
print("valid ids ran", flush=True)
args[at][2, 5] = 1 << 30
call(args)
torch.cuda.synchronize()
print("no trap", flush=True)
"""


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["dense", "lvq", "update"])
def test_id_at_visited_bit_traps(cuda, route):
    """An id >= 2^30 traps inside the kernel (the wrappers no longer check
    on the host); the trap ends the CUDA context, so it runs in a child
    process, which must fail at the synchronisation after the bad call."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", _TRAP_SCRIPT, route],
                          cwd=root, capture_output=True, text=True,
                          timeout=300, check=False)
    assert "valid ids ran" in proc.stdout, proc.stderr[-2000:]
    assert "no trap" not in proc.stdout
    assert proc.returncode != 0


def _dataset_on_card(kind: str, data: np.ndarray):
    if kind in ("float32", "bfloat16", "float16"):
        return svt.VectorDataset.from_array(data, dtype=kind)
    if kind == "int8":
        return svt.VectorDataset.from_array(
            np.clip(np.rint(data * 30), -128, 127).astype(np.int8))
    if kind == "sq8":
        return svt.SQDataset.compress(data)
    bits, res = {"lvq8": (8, 0), "lvq4x8": (4, 8)}[kind]
    return svt.LVQDataset.compress(data, bits=bits, residual_bits=res)


def _tensors(obj) -> dict:
    import dataclasses
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)
            if isinstance(getattr(obj, f.name), torch.Tensor)}


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["float32", "bfloat16", "float16", "int8",
                                  "sq8", "lvq8", "lvq4x8"])
def test_checkpoint_round_trip_on_gpu(cuda, kind, tmp_path):
    """An index built on the card, saved and assembled onto the card: every
    tensor of graph, dataset and sampler is on the card and equal to the
    live index's, and the search gives identical ids and distances."""
    data, queries = svt.generate_test_dataset(600, 40, 48, seed=11)
    params = svt.VamanaBuildParameters(graph_max_degree=16, window_size=24,
                                       max_candidate_pool_size=60,
                                       prune_to=14)
    live = svt.Vamana.build(params, _dataset_on_card(kind, data), "l2",
                            sampled_entries=True)
    live.search_window_size = 16
    live.save(str(tmp_path))
    loaded = svt.Vamana.assemble(str(tmp_path))
    for part in ("graph", "data", "_entry_sampler"):
        got = _tensors(getattr(loaded.index, part))
        want = _tensors(getattr(live.index, part))
        assert got.keys() == want.keys()
        for name, t in got.items():
            assert t.is_cuda, (part, name)
            assert torch.equal(t, want[name]), (part, name)
    want, got = live.search(queries, 10), loaded.search(queries, 10)
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_array_equal(got.distances, want.distances)


@pytest.mark.gpu
@pytest.mark.parametrize("fixture,bits,res", [("lvq8_v001", 8, 0),
                                              ("lvq4x8_v001", 4, 8)])
def test_legacy_lvq_fixtures_load_on_gpu(cuda, fixture, bits, res):
    """Checkpoints the JAX package wrote in the v0.0.1 layout load straight
    onto the card and decode within 1e-5 of a fresh compress."""
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    got = svt.dispatch_load(os.path.join(root, "data", "legacy", fixture))
    assert all(t.is_cuda for t in _tensors(got).values())
    x = np.random.default_rng(7).normal(size=(48, 20)).astype(np.float32)
    fresh = svt.LVQDataset.compress(x, bits=bits, residual_bits=res)
    np.testing.assert_allclose(got.to_numpy(), fresh.to_numpy(), atol=1e-5)


@pytest.mark.gpu
def test_dynamic_index_on_gpu_matches_cpu(cuda):
    """One dynamic index, carried from the CPU to the card, through one
    add (growing the storage), delete, consolidate and compact cycle on
    both devices.  The rows are integers, so every distance is exact on
    both and the card's beam_step and the CPU's plain version rank alike:
    after every step the two searches return the same ids except at
    near-ties (at most 0.1% of the rows), no deleted id, and on the card
    beam_step launches in the add and in every search."""
    from scalablevectorsearch_tpu_torch import interop
    data, queries = svt.generate_test_dataset(2400, 1000, 48, seed=9)
    data, queries = np.round(data), np.round(queries)
    params = svt.VamanaBuildParameters(graph_max_degree=16, window_size=32,
                                       max_candidate_pool_size=64,
                                       prune_to=14)
    cpu = svt.MutableVamanaIndex(params, data[:1500], np.arange(1500), "l2",
                                 capacity=1600, device="cpu")
    n = cpu.data.n
    card = interop.dynamic_vamana_from_arrays(
        data[:1500], cpu.graph.adjacency.numpy(), cpu.graph.degrees.numpy(),
        cpu.status[:n], cpu.translator.to_external(np.arange(n)),
        cpu.entry_point, "l2", cpu.parameters, capacity=cpu.data.capacity,
        device="cuda")
    dead = np.random.default_rng(3).choice(1900, size=300, replace=False)
    steps = (("add", lambda i: i.add_points(data[1500:1900],
                                            np.arange(1500, 1900))),
             ("delete", lambda i: i.delete_points(dead)),
             ("consolidate", lambda i: i.consolidate()),
             ("compact", lambda i: i.compact()))
    for index in (cpu, card):
        index.search_window_size = 20
        index.enable_entry_sampler(n_samples=128, seed=1)
    for name, step in steps:
        before = bs.beam_step.launches
        for index in (cpu, card):
            step(index)
        assert (bs.beam_step.launches > before) == (name == "add"), name
        assert card.data.capacity == cpu.data.capacity == 3200
        np.testing.assert_array_equal(card.status, cpu.status)
        before = bs.beam_step.launches
        got, want = card.search(queries, 10), cpu.search(queries, 10)
        assert bs.beam_step.launches > before, name
        same = (np.sort(got.ids, 1) == np.sort(want.ids, 1)).all(1)
        rows = (card.graph.adjacency.cpu() == cpu.graph.adjacency).all(1)
        assert same.mean() >= 0.999, (name, same.mean(),
                                      rows.float().mean())
        if name != "add":
            assert not np.isin(got.ids, dead).any(), name


@pytest.mark.gpu
@pytest.mark.parametrize("metric", [0, 1, 2])
@pytest.mark.parametrize("label", [label for label, _ in
                                   chip_smoke.LEANVEC_CHECK_SHAPES])
def test_lvq_kernel_leanvec_dead_lanes(cuda, label, metric):
    """LeanVec's primary: 64 live lanes of 128 (n_dead 64), at the serving,
    tail and build shapes; on exact (grid) inputs all five outputs equal
    beam_step_lvq_plain's."""
    shape = dict(chip_smoke.LEANVEC_CHECK_SHAPES)[label]
    n_dead = 128 - chip_smoke.LEANVEC_DIM
    _b, _c, _k, _d, window, m = shape
    args = chip_smoke.make_lvq_case(np.random.default_rng(sum(shape) + metric),
                                    shape, n_dead, grid=True)
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
def test_leanvec_search_on_gpu_matches_cpu(cuda, tmp_path):
    """One LeanVec index (2000 x 48 to 24 dimensions, OOD) trained and built
    on the CPU, saved and assembled onto the card: over the CPU's graph the
    card's reranked search gives the CPU's ids on >= 99% of slots and
    distances within 1e-5 of ||q||^2 + ||x||^2, launching beam_step_lvq; a
    build on the card launches it too."""
    from scalablevectorsearch_tpu_torch.quantization.leanvec import (
        LeanVecDataset, LeanVecVamana)
    data, queries = svt.generate_test_dataset(2000, 200, 48, seed=7)
    params = svt.VamanaBuildParameters(graph_max_degree=16, window_size=32,
                                       max_candidate_pool_size=64,
                                       prune_to=14)
    cpu = LeanVecVamana.build(params, data, "l2", queries=queries[100:],
                              device="cpu")
    cpu.save(str(tmp_path))
    card = LeanVecVamana.assemble(str(tmp_path), device="cuda")
    assert card.leanvec.primary.device.type == "cuda"
    cpu.search_window_size = card.search_window_size = 20
    before = bs.beam_step_lvq.launches
    got = card.search(queries[:100], 10)
    assert bs.beam_step_lvq.launches > before
    want = cpu.search(queries[:100], 10)
    same = np.sort(got.ids, 1) == np.sort(want.ids, 1)
    assert same.mean() >= 0.99, same.mean()
    exact = got.ids == want.ids
    qn = (queries[:100].astype(np.float64) ** 2).sum(1)
    xn = cpu.leanvec.secondary.norms_sq.numpy()
    scale = qn[:, None] + xn[np.maximum(got.ids, 0)]
    assert np.all(np.abs(got.distances - want.distances)[exact]
                  <= 1e-5 * scale[exact])
    before = bs.beam_step_lvq.launches
    built = LeanVecVamana.build(params, LeanVecDataset.train(
        data, queries=queries[100:], device="cuda"), "l2")
    assert bs.beam_step_lvq.launches > before
    assert built.index.graph.adjacency.device.type == "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("label", ["inverted serving", "inverted build"])
def test_kernel_matches_plain_at_inverted_shapes(cuda, label):
    """beam_step at the inverted index's shapes (its primary search over
    10,000 centroids at window 32, its build rounds at pop width 1): on
    exact (grid) inputs all five outputs equal beam_step_plain's, f32
    rows and queries as the index gives them."""
    shape = dict(chip_smoke.UNTIMED_STEP_SHAPES)[label]
    _b, _c, _k, _d, window, m = shape
    rng = np.random.default_rng(sum(shape))
    for metric in (0, 1, 2):
        args = chip_smoke.make_case(rng, shape, grid=True)
        got = bs.beam_step(*args, metric=metric, window=window, m=m)
        want = bs.beam_step_plain(*args, metric=metric, window=window, m=m)
        torch.cuda.synchronize()
        for name, g, w in zip(("keys", "packed", "popped", "pool_keys",
                               "pool_ids"), got, want):
            assert torch.equal(g, w), (metric, name)


@pytest.mark.gpu
def test_ivf_family_on_gpu_matches_cpu(cuda, monkeypatch, tmp_path):
    """IVF (both scan routes), DynamicIVF through add / delete / compact,
    and the inverted index over integer-valued rows, where every distance
    is exact in f32 on both devices: from one clustering (one CPU build
    for the inverted index, assembled onto the card) the card's searches
    give the CPU's ids and distances exactly; the inverted searches and a
    build on the card launch beam_step."""
    data, queries = svt.generate_test_dataset(3000, 200, 48, seed=9)
    data, queries = np.round(data), np.round(queries)
    monkeypatch.setenv("SVT_QUERY_UPLOAD_DTYPE", "float32")

    def same(got, want, label):
        np.testing.assert_array_equal(got.ids, want.ids, err_msg=label)
        np.testing.assert_array_equal(got.distances, want.distances,
                                      err_msg=label)

    bp = svt.IVFBuildParameters(num_centroids=48, num_iterations=4,
                                training_fraction=1.0,
                                is_hierarchical=False)
    clustering = svt.Clustering.build(bp, data, device="cpu")
    sp = svt.IVFSearchParameters(n_probes=6)
    ivf = {dev: svt.IVF.assemble_from_clustering(
        clustering, data, "l2", device=dev).index for dev in ("cpu", "cuda")}
    want = ivf["cpu"].search(queries, 10, sp)
    same(ivf["cuda"].search(queries, 10, sp), want, "ivf")
    monkeypatch.setenv("SVT_IVF_SCAN_LAYOUT", "0")
    rows_route = svt.IVF.assemble_from_clustering(
        clustering, data, "l2", device="cuda").index
    same(rows_route.search(queries, 10, sp), want, "ivf row-gather route")
    assert rows_route._scan_vecs is None
    monkeypatch.delenv("SVT_IVF_SCAN_LAYOUT")

    from scalablevectorsearch_tpu_torch.index.ivf.dynamic import (
        DynamicIVFIndex)
    dyn = {dev: DynamicIVFIndex(clustering, data, np.arange(3000), "l2",
                                slot_slack=1.0, device=dev)
           for dev in ("cpu", "cuda")}
    extra = np.round(svt.generate_test_dataset(400, 1, 48, seed=10)[0])
    for name, step in (("add", lambda i: i.add_points(
                           extra, np.arange(5000, 5400))),
                       ("delete", lambda i: i.delete_points(
                           np.arange(0, 3000, 4))),
                       ("compact", lambda i: i.compact())):
        for index in dyn.values():
            step(index)
        assert dyn["cuda"].num_probe_units == dyn["cpu"].num_probe_units
        same(dyn["cuda"].search(queries, 10, sp),
             dyn["cpu"].search(queries, 10, sp), f"dynamic ivf {name}")

    params = svt.InvertedBuildParameters(
        primary_parameters=svt.VamanaBuildParameters(
            graph_max_degree=16, window_size=32, max_candidate_pool_size=64,
            prune_to=14))
    cpu = svt.Inverted.build(params, data, "l2", device="cpu")
    cpu.save(str(tmp_path / "inverted"))
    card = svt.Inverted.assemble(str(tmp_path / "inverted"), device="cuda")
    isp = svt.InvertedSearchParameters(max_probes=8)
    before = bs.beam_step.launches
    got = card.index.search(queries, 10, isp)
    assert bs.beam_step.launches > before
    same(got, cpu.index.search(queries, 10, isp), "inverted")
    before = bs.beam_step.launches
    built = svt.Inverted.build(params, data, "l2")
    assert bs.beam_step.launches > before
    assert built.index.data.device.type == "cuda"


@pytest.mark.gpu
def test_runner_on_gpu_matches_cpu(cuda, tmp_path):
    """The benchmark runner's Vamana jobs on the card against the same
    jobs on the CPU: the same keys, num_points and windows, recall within
    0.05 (f32 rounding differs), beam_step launching; the IVF generator's
    rows within 0.1 (the k-means++ draws of a CUDA generator are not the
    CPU generator's)."""
    from scalablevectorsearch_tpu_torch import benchmark
    tiny = {"synthetic": {"n": 2000, "n_queries": 100, "dim": 48, "seed": 7}}
    bp = {"graph_max_degree": 16, "window_size": 32}
    jobs = [dict(executable="vamana_search", **tiny, build_parameters=bp,
                 search_window_sizes=[10, 30]),
            dict(executable="vamana_test_generator", **tiny,
                 build_parameters=bp, search_window_sizes=[10, 20],
                 output_file=str(tmp_path / "golden.json")),
            dict(executable="ivf_test_generator", **tiny,
                 build_parameters={"num_centroids": 32}, n_probes=[2, 8])]
    before = bs.beam_step.launches
    card = benchmark.run_jobs(jobs)
    assert bs.beam_step.launches > before
    cpu = benchmark.run_jobs(jobs, device="cpu")
    a, b = card[0]["configs"], cpu[0]["configs"]
    assert [c["search_window_size"] for c in a] == [10, 30]
    for got, want in zip(a, b):
        assert got.keys() == want.keys()
        assert abs(got["recall"] - want["recall"]) <= 0.05
    for (got, want), tol in zip(zip(card[1:], cpu[1:]), (0.05, 0.1)):
        assert got.keys() == want.keys()
        for g, w in zip(got["expected"], want["expected"]):
            for key in w["recalls"]:
                assert abs(g["recalls"][key] - w["recalls"][key]) <= tol


@pytest.mark.gpu
def test_native_loader_and_reference_layout_on_gpu(cuda, tmp_path):
    """The native loader builds on the GPU machine; an index written in the
    reference layout loads onto the card and searches as on the CPU."""
    from scalablevectorsearch_tpu_torch.core import io as tio
    from scalablevectorsearch_tpu_torch.lib import native
    from scalablevectorsearch_tpu_torch.utils import svs_interop
    assert native.available()
    data, queries = svt.generate_test_dataset(2000, 100, 48, seed=8)
    data, queries = np.round(data), np.round(queries)
    tio.write_vecs(str(tmp_path / "x.fvecs"), data)
    np.testing.assert_array_equal(tio.read_vecs(str(tmp_path / "x.fvecs")),
                                  data)
    cpu = svt.VamanaIndex.build(svt.VamanaBuildParameters(
        graph_max_degree=16, window_size=32), data, "l2", device="cpu")
    cpu.search_window_size = 20
    svs_interop.save_reference_vamana(cpu, str(tmp_path / "cfg"),
                                      str(tmp_path / "graph"),
                                      str(tmp_path / "data"))
    card = svs_interop.load_reference_vamana(
        str(tmp_path / "cfg"), str(tmp_path / "graph"),
        str(tmp_path / "data"))
    assert card.data.vectors.device.type == "cuda"
    before = bs.beam_step.launches
    got, want = card.search(queries, 10), cpu.search(queries, 10)
    assert bs.beam_step.launches > before
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_array_equal(got.distances, want.distances)


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["sharded", "dp"])
@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_parallel_search_on_gpu_matches_cpu(cuda, path, dtype):
    """A search over 4 logical shards of cuda:0 (row-sharded views, or
    query chunks) and over 4 of the CPU, on integer rows whose dot products
    are exact in any order: identical ids and keys (the sharded f32 search
    runs score_rows and beam_update, float16 gather_score_l2_partial; dp
    runs beam_step or the scored route on every chunk)."""
    from scalablevectorsearch_tpu_torch.core.graph import NeighborGraph
    from scalablevectorsearch_tpu_torch.lib.datatypes import pad_matrix
    from scalablevectorsearch_tpu_torch.parallel import mesh as mesh_mod
    from scalablevectorsearch_tpu_torch.parallel import sharded
    rng = np.random.default_rng(5)
    x = rng.integers(-8, 8, size=(2000, 64)).astype(np.float32)
    adj = rng.integers(0, 2000, size=(2000, 16)).astype(np.int32)
    queries = pad_matrix(rng.integers(-8, 8, size=(64, 64)).astype(
        np.float32))
    fn = sharded.dp_greedy_search if path == "dp" else \
        sharded.sharded_greedy_search
    out = {}
    for dev in ("cpu", "cuda:0"):
        mesh = mesh_mod.make_mesh(4, "dp" if path == "dp" else "shard",
                                  devices=[dev] * 4)
        out[dev] = fn(mesh, NeighborGraph.from_array(adj, device=dev),
                      svt.VectorDataset.from_array(x, dtype=dtype,
                                                   device=dev),
                      torch.from_numpy(queries).to(dev),
                      torch.tensor([0], dtype=torch.int32, device=dev),
                      window=32, capacity=32, max_iters=80, distance="l2")
    assert out["cuda:0"].ids.is_cuda
    assert torch.equal(out["cuda:0"].ids.cpu(), out["cpu"].ids)
    assert torch.equal(out["cuda:0"].keys.cpu(), out["cpu"].keys)


# small sizes of the examples (scalablevectorsearch_tpu_torch/examples)
EXAMPLE_SIZES = {
    "vamana": dict(n=800, n_queries=50, dim=32),
    "compression": dict(n=600, n_queries=40),
    "dynamic": dict(n=900, n_queries=50, dim=32, n_build=600, n_add=200,
                    n_delete=100),
    "ivf": dict(n=3000, n_queries=100, dim=32, num_centroids=48,
                minibatch_size=1000),
    "serving": dict(n=1200, n_queries=100, dim=32, reps=2),
    "multichip": dict(n=2000, n_queries=40, dim=32, num_centroids=16, m=800,
                      n_add=100, n_delete=50),
}


def example_recalls(out: dict) -> dict:
    """The recall numbers of an example's ``run()`` result, flattened."""
    flat = {}
    for key, value in out.items():
        if isinstance(value, dict):
            flat.update({f"{key} {k}": v for k, v in value.items()
                         if isinstance(v, float)})
        elif isinstance(value, float) and not key.startswith(("qps", "p5",
                                                              "p9")):
            flat[key] = value
    return flat


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(EXAMPLE_SIZES))
def test_example_on_gpu_matches_cpu(cuda, name):
    """Each example's ``run(device="cuda")`` at a small size: its own
    asserts hold, a kernel of the repo launches (IVF runs none), and its
    recall numbers are within 0.05 of the same run on the CPU (f32
    rounding and the k-means++ draws differ)."""
    import importlib
    from chip_smoke import read_counts, zero_counts
    module = importlib.import_module(
        f"scalablevectorsearch_tpu_torch.examples.example_{name}")
    zero_counts()
    got = example_recalls(module.run(device="cuda", **EXAMPLE_SIZES[name]))
    launched = sum(read_counts().values())
    want = example_recalls(module.run(device="cpu", **EXAMPLE_SIZES[name]))
    assert got.keys() == want.keys()
    assert all(abs(got[k] - want[k]) <= 0.05 for k in got), (got, want)
    assert launched > 0 or name == "ivf"


@pytest.mark.gpu
def test_build_pruned_in_one_chunk_and_segments_gives_the_same_graph(cuda):
    """The 10M run (``benchmark/scale_10m.py``) drives ``build_graph`` in
    segments of rounds, and its prune-chunk trial prunes a round's 4096
    rows in one chunk, where ``VamanaIndex.build`` runs every round in one
    call and prunes 256 rows at a time: on the card the graph is the same
    bit for bit (each row is pruned on its own; a batched product's rows
    do not depend on the batch's size)."""
    from scalablevectorsearch_tpu_torch.benchmark import scale_10m
    from scalablevectorsearch_tpu_torch.index.vamana import build as bm
    n, batch = 40_000, 4096
    data, _ = svt.generate_test_dataset(n, 10, 96, seed=scale_10m.SEED)
    ds = svt.VectorDataset.from_array(data, device="cuda")
    params = scale_10m.build_parameters()
    kw = dict(batch_size=batch, pop_width=4, tail_frac=4,
              sampled_entries=True)
    want, entry = bm.build_graph(ds, params, "l2", prune_chunk=256, **kw)
    total, got = 2 * -(-n // batch), None
    for start in range(0, total, 7):
        got, _ = bm.build_graph(ds, params, "l2", entry_point=entry,
                                prune_chunk=4096, graph=got,
                                _rounds=(start, min(start + 7, total)), **kw)
    assert torch.equal(got.adjacency, want.adjacency)
    assert torch.equal(got.degrees, want.degrees)
