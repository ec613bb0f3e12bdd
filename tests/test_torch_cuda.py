"""The CUDA kernels (B1 tile product, B2 GAT tile aggregation, B5 tile row
max) against their plain PyTorch versions on the card, at small shapes that
stress the edges: ragged n, C not a multiple of 8 or of the staging width,
R not a multiple of the row slab, empty runs, filler-only runs, rows without
tile edges, factored plans (B1), every feature-width branch, and a non-edge
whose GAT branch product overflows to inf (B2).  Needs a CUDA card and nvcc; skips
elsewhere.  Run on the card (where jax, which tests/conftest.py imports,
may be absent) with:  python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

Tolerance: max|kernel - plain| <= 1e-5 * max|plain| (float32 summation
order only) on nonnegative and signed operands, plus the ops/validate gate
on the nonnegative ones (B2's den): signed sums of many terms cancel to
near zero, where two float32 summation orders differ by more than the
gate's floor.  B5 is a max: equal to the plain version, -inf rows included."""

import numpy as np
import pytest
import torch

from gnn_computing_tpu_torch.graph import CSRGraph, degree_sort, rmat_graph
from gnn_computing_tpu_torch.ops import cuda_bcsr, cuda_gat, cuda_rowmax
from gnn_computing_tpu_torch.ops.bcsr import bcsr_rowmax, bcsr_rowmax_plain, bcsr_spmm, bcsr_spmm_plain, round_h
from gnn_computing_tpu_torch.ops.bcsr_gat import _hybrid_row_shift, gat_bcsr, gat_bcsr_plain
from gnn_computing_tpu_torch.ops.validate import assert_valid
from gnn_computing_tpu_torch.schedule.tiles import densify

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("tr,tc,pack", [(64, 64, 1), (96, 40, 4), (72, 13, 1), (512, 256, 16)])
@pytest.mark.parametrize("f", [1, 24, 32, 33, 64, 100, 128])
@pytest.mark.parametrize("factored", [False, True])
def test_kernel_matches_plain(cuda_dev, tr, tc, pack, f, factored):
    g = rmat_graph(1237, 60000, seed=3, with_val=False)
    g = g.reorder(degree_sort(g))
    d, s = g.dst_per_edge, g.indices
    keep = (d < 800) | (d >= 1100)  # a band of rows with no edges at all
    g = CSRGraph.from_edges(d[keep], s[keep], g.num_nodes)
    kw = dict(tile_rows=tr, tile_cols=tc, threshold=3, ensure_row_coverage=False)
    if factored:
        rng = np.random.default_rng(0)
        sd = rng.uniform(0.5, 2.0, g.num_nodes).astype(np.float32)
        ss = rng.uniform(0.5, 2.0, g.n_src).astype(np.float32)
        kw.update(val=sd[g.dst_per_edge] * ss[g.indices], scale_dst=sd, scale_src=ss)
    tp = densify(g, **kw)[0].pad_runs(pack).to(cuda_dev)
    gen = torch.Generator(device=cuda_dev).manual_seed(f)
    for signed in (False, True):
        h = (torch.randn if signed else torch.rand)((g.n_src, f), generator=gen, device=cuda_dev)
        for mode in ("split", "native"):
            before = cuda_bcsr.launches
            got = bcsr_spmm(tp, h, h_mode=mode)
            assert cuda_bcsr.launches == before + 1
            want = bcsr_spmm_plain(tp, round_h(h, mode))
            torch.cuda.synchronize()
            if not signed:
                assert_valid(got, want, what=f"{mode} r{tr} c{tc} f{f}")
            assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def _gat_plan(dev, tr, tc, pack):
    """Count tiles of a graph with a band of rows without edges, and a last
    row-tile too sparse for any tile (after pad_runs a filler-only run)."""
    g = rmat_graph(1237, 60000, seed=3, with_val=False)
    g = g.reorder(degree_sort(g))
    d, s = g.dst_per_edge, g.indices
    keep = ((d < 800) | (d >= 1100)) & ((d < 1237 - tr) | (s % 97 == 0))
    g = CSRGraph.from_edges(d[keep], s[keep], g.num_nodes)
    tp = densify(g, tile_rows=tr, tile_cols=tc, threshold=3)[0].pad_runs(pack)
    return g, tp.to(dev)


def _gat_check(got, want, what):
    num, den = got
    ref_num, ref_den = want
    assert bool(torch.isfinite(num).all()) and bool(torch.isfinite(den).all()), what
    assert (num - ref_num).abs().max() <= 1e-5 * ref_num.abs().max(), what
    assert (den - ref_den).abs().max() <= 1e-5 * ref_den.abs().max(), what
    assert_valid(den, ref_den, what=f"{what} den")


@pytest.mark.parametrize("tr,tc,pack", [(64, 64, 1), (96, 40, 4), (72, 13, 1), (512, 256, 16)])
@pytest.mark.parametrize("f", [1, 24, 32, 33, 64, 100, 128])
def test_gat_kernel_matches_plain(cuda_dev, tr, tc, pack, f):
    g, tp = _gat_plan(cuda_dev, tr, tc, pack)
    gen = torch.Generator(device=cuda_dev).manual_seed(f)
    h = torch.randn((g.n_src, f), generator=gen, device=cuda_dev)
    for scale, shifts in ((0.1, (False, True)), (15.0, (True,))):
        att = torch.randn((g.num_nodes, 2), generator=gen, device=cuda_dev) * scale
        for shift in shifts:
            row_shift = _hybrid_row_shift(tp, None, att, 0.2) if shift else None
            before = cuda_gat.launches
            got = gat_bcsr(tp, h, att, row_shift=row_shift)
            assert cuda_gat.launches == before + 1
            want = gat_bcsr_plain(tp, h, att, row_shift=row_shift)
            torch.cuda.synchronize()
            _gat_check(got, want, f"r{tr} c{tc} f{f} scale{scale} shift{shift}")
    # rows without tile edges: den 0 and num 0
    empty = torch.zeros(g.num_nodes, dtype=torch.bool, device=cuda_dev)
    empty[800:1100] = True
    assert bool((got[1][empty] == 0).all()) and bool((got[0][empty] == 0).all())


def test_gat_kernel_non_edge_overflow_is_not_nan(cuda_dev):
    """Un-stabilized, the branch product of a non-edge (cnt == 0) can be inf;
    the kernel must select on the count, not multiply by it."""
    g, tp = _gat_plan(cuda_dev, 64, 64, 1)
    a = tp.a.cpu().numpy()
    rows = tp.tile_row.cpu().numpy()[:, None] * 64 + np.arange(64)[None, :]  # [T, R]
    cols = tp.tile_col.cpu().numpy()[:, None] * 64 + np.arange(64)[None, :]  # [T, C]
    # a zero cell (row, col), row != col, in a tile row that has edges
    t, i, j = next(
        (t, i, j) for t, i, j in np.argwhere(a == 0)
        if a[t, i].any() and rows[t, i] != cols[t, j] and rows[t, i] < g.num_nodes and cols[t, j] < g.n_src
    )
    att = torch.zeros((g.num_nodes, 2), device=cuda_dev)
    att[rows[t, i], 0] = 50.0
    att[cols[t, j], 1] = 50.0  # exp(50) * exp(50) overflows float32
    h = torch.rand((g.n_src, 8), device=cuda_dev)
    got = gat_bcsr(tp, h, att)
    want = gat_bcsr_plain(tp, h, att)
    torch.cuda.synchronize()
    _gat_check(got, want, "non-edge overflow")


@pytest.mark.parametrize("tr,tc,pack", [(64, 64, 1), (96, 40, 4), (72, 13, 1), (512, 256, 16)])
def test_rowmax_kernel_equals_plain(cuda_dev, tr, tc, pack):
    g, tp = _gat_plan(cuda_dev, tr, tc, pack)
    gen = torch.Generator(device=cuda_dev).manual_seed(tr)
    for scale in (1.0, 15.0):
        vals = torch.randn(g.n_src, generator=gen, device=cuda_dev) * scale
        before = cuda_rowmax.launches
        got = bcsr_rowmax(tp, vals)
        assert cuda_rowmax.launches == before + 1
        want = bcsr_rowmax_plain(tp, vals)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert bool(torch.isneginf(got[800:1100]).all())
