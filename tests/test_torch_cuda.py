"""The CUDA kernels (B1 tile product, B2 GAT tile aggregation in its modes
'maxdot' — dot_mode 'default' included — 'twodot' and 'merged', B3 and B4
GAT tile backward, B5 tile row max and B6 tile SDDMM, each over int8,
1-bit, float32 and bfloat16 tiles; the residual probe's P1 task sums and
P2 fused pass) against their plain PyTorch versions on the
card, at small shapes that
stress the edges: ragged n, C odd or not a multiple of 8 or of the staging
width, R not a multiple of the row slab (and, for 1-bit tiles, not a power
of two), empty runs, filler-only runs, rows without tile edges, factored
plans (B1), transposed plans (B1, B4), every feature-width branch, f up to
300 (B6's column chunks), cells on both leaky-relu branches, and a non-edge
whose unstabilized GAT score or SDDMM dot overflows to inf (B2, B3, B4, B6),
signed float cell values (every nonzero cell scored, C6; B6 keeps the cells
> 0); the gather-only path (no kernel: spmm and sddmm in every gather
mode, gat_aggregate, spmm_bidir and GAT gradients) on the card against the
same calls on the CPU; SAGE-LSTM (every strategy, float16 gates, the
layer, gradients; cuDNN's LSTM as a yardstick) and the edge MLP over the
gather plans on the card against the CPU and float64 oracles, no kernel
launched; the training Functions' gradients on the card against the same
Functions on the CPU, over int8, bit-tile and float-tile aggregators;
B1, B2, and B3 and B5 over the cell walk's hard plans (one run holding
every tile with an all-ones tile row, C = 128, 1-bit R = 200, single-tile
and empty runs, chunk edges inside runs), every call twice and bitwise
equal; B1's staged walk bitwise equal to its gather walk on the same chunk
cuts (a dense hub run, the quick-scale reddit plans' int8 parts) and its
counters; the figure harness's fig7 at --quick (its rows and launches); and
wrappers that raise, rather than fall back, on a malformed plan.  Needs a CUDA card and nvcc; skips
elsewhere.  Run on the card (where jax, which tests/conftest.py imports,
may be absent) with:  python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

Tolerance: max|kernel - plain| <= 1e-5 * max|plain| (float32 summation
order only) on nonnegative and signed operands, plus the ops/validate gate
on the nonnegative ones (B2's den): signed sums of many terms cancel to
near zero, where two float32 summation orders differ by more than the
gate's floor.  B5 is a max: equal to the plain version, -inf rows included.
B6 float32 cells: the same bound; bfloat16 cells at most one bfloat16 ulp
apart; cells without an edge exactly +0.  B1 and B2-B5 over a 1-bit part
are equal to the same kernel over the part unpacked to int8 (the same
operations in the same order).  B2 'default': within 1e-5 * max|plain|
plus one bfloat16 ulp (<= 2^-7 of it) of each rounded score times |h| (the
kernel's __expf score and the plain version's torch.exp may round to
neighbouring bfloat16 values); 'twodot' and 'merged' take their per-node
operands from the same torch code, so only the float32 sum order differs.
P1 and P2: 1e-5 * max|plain|; P2 walks B1's work list, so its dense_out is
bitwise B1's output times scale_dst and its task sums bitwise P1's.  The
hybrid op's residual kernel (R1): max|kernel - oracle| <= 1e-5 *
max|oracle| against a float64 edge-list oracle and the same against
spmm_plain added to the output (its own float32 sum order, and atomics
whose order varies from run to run: never bitwise)."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from gnn_computing_tpu_torch.aggregator import Aggregator
from gnn_computing_tpu_torch.graph import CSRGraph, degree_sort, rmat_graph
from gnn_computing_tpu_torch.ops import bcsr_gat, cuda_bcsr, cuda_gat, cuda_gat_bwd, cuda_residual, cuda_rowmax, cuda_sddmm
from gnn_computing_tpu_torch.ops.bcsr import bcsr_rowmax, bcsr_rowmax_plain, bcsr_spmm, bcsr_spmm_plain, round_h
from gnn_computing_tpu_torch.ops.bcsr_gat import (
    _global_bound_shift,
    _hybrid_row_shift,
    _score_terms,
    gat_bcsr,
    gat_bcsr_plain,
    gat_bwd_dad,
    gat_bwd_dad_plain,
    gat_bwd_dh_das,
    gat_bwd_dh_das_plain,
)
from gnn_computing_tpu_torch.ops.bcsr_gat import _factored_sums, factored_terms, gat_bcsr_factored, gat_bcsr_tiles
from gnn_computing_tpu_torch.ops.bcsr_sddmm import hybrid_sddmm, sddmm_bcsr, sddmm_bcsr_plain
from gnn_computing_tpu_torch.graph.sample import presample_fixed_neighbors
from gnn_computing_tpu_torch.models.sage_lstm import init_sage_lstm_params, sage_lstm_layer
from gnn_computing_tpu_torch.ops.edge_mlp import edge_mlp, edge_mlp_chunked
from gnn_computing_tpu_torch.ops.gat import gat_aggregate
from gnn_computing_tpu_torch.ops.lstm import LSTMParams, lstm_aggregate
from gnn_computing_tpu_torch.ops.reference import edge_mlp_dense
from gnn_computing_tpu_torch.ops.validate import relative_error_count
from gnn_computing_tpu_torch.ops.sddmm import sddmm
from gnn_computing_tpu_torch.ops.bcsr import hybrid_spmm
from gnn_computing_tpu_torch.ops.spmm import residual_spmm_, slots_from_edge_values_flat, spmm_plain, weighted_task_sums
from gnn_computing_tpu_torch.probes.overlap_dma_residual import dma_task_sums, fused_hybrid, fused_hybrid_plain
from gnn_computing_tpu_torch.schedule.locality import locality_plan
from gnn_computing_tpu_torch.schedule.neighbor_grouping import neighbor_grouping_plan
from gnn_computing_tpu_torch.ops.cuda_build import check_plan
from gnn_computing_tpu_torch.ops.validate import assert_valid
from gnn_computing_tpu_torch.schedule.tiles import densify, split_bit_tiles

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
    tp = densify(g, dtype=np.int8, **kw)[0].pad_runs(pack).to(cuda_dev)
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
    tp = densify(g, dtype=np.int8, tile_rows=tr, tile_cols=tc, threshold=3)[0].pad_runs(pack)
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
    """Un-stabilized, the score of a non-edge (cnt == 0) can be inf;
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


def _bwd_plans(dev, tr, tc, pack):
    """_gat_plan's graph as a forward plan and its transpose, both padded;
    the transpose has coverage fillers for the source tiles that hold no
    tile, and after pad_runs filler-only runs."""
    g = rmat_graph(1237, 60000, seed=3, with_val=False)
    g = g.reorder(degree_sort(g))
    d, s = g.dst_per_edge, g.indices
    keep = ((d < 800) | (d >= 1100)) & ((d < 1237 - tr) | (s % 97 == 0)) & ((s < 500) | (s >= 500 + 2 * tc))
    g = CSRGraph.from_edges(d[keep], s[keep], g.num_nodes)
    tp = densify(g, dtype=np.int8, tile_rows=tr, tile_cols=tc, threshold=3)[0]
    tp_t = tp.transpose()
    return g, tp.pad_runs(pack).to(dev), tp_t.pad_runs(pack).to(dev)


def _close(got, want, what):
    assert bool(torch.isfinite(got).all()), what
    assert (got - want).abs().max() <= 1e-5 * want.abs().max(), what


def _bwd_check(tp, tp_t, h, gbar, c, dm, asrc, what):
    before = (cuda_gat_bwd.dad_launches, cuda_gat_bwd.dh_das_launches)
    dad = gat_bwd_dad(tp, h, gbar, c, dm, asrc, 0.2)
    dh, das = gat_bwd_dh_das(tp_t, h, gbar, c, dm, asrc, 0.2)
    assert (cuda_gat_bwd.dad_launches, cuda_gat_bwd.dh_das_launches) == (before[0] + 1, before[1] + 1)
    want_dad = gat_bwd_dad_plain(tp, h, gbar, c, dm, asrc, 0.2)
    want_dh, want_das = gat_bwd_dh_das_plain(tp_t, h, gbar, c, dm, asrc, 0.2)
    torch.cuda.synchronize()
    _close(dad, want_dad, f"{what} d_ad")
    _close(dh, want_dh, f"{what} dh")
    _close(das, want_das, f"{what} d_as")
    return dad, dh, das


@pytest.mark.parametrize("tr,tc,pack", [(64, 64, 1), (96, 40, 4), (72, 13, 1), (256, 256, 16), (40, 300, 1)])
@pytest.mark.parametrize("f", [1, 24, 32, 33, 100, 128, 160, 300])
def test_gat_bwd_kernels_match_plain(cuda_dev, tr, tc, pack, f):
    g, tp, tp_t = _bwd_plans(cuda_dev, tr, tc, pack)
    n = g.num_nodes
    starts = tp_t.run_start.cpu().numpy()
    assert any(not tp_t.a[starts[r] : starts[r + 1]].any() for r in range(tp_t.num_row_tiles))  # filler-only
    gen = torch.Generator(device=cuda_dev).manual_seed(f)
    h = torch.randn((n, f), generator=gen, device=cuda_dev)
    gbar = torch.randn((n, f), generator=gen, device=cuda_dev)
    c = torch.randn(n, generator=gen, device=cuda_dev)
    for scale, shift in ((0.1, False), (1.0, False), (15.0, True)):
        att = torch.randn((n, 2), generator=gen, device=cuda_dev) * scale
        dm, asrc = _score_terms(att, _global_bound_shift(att, 0.2) if shift else None)
        z = att[:, 0:1] + att[:, 1][None, :200]
        assert bool((z > 0).any()) and bool((z < 0).any())  # both branches
        dad, dh, das = _bwd_check(tp, tp_t, h, gbar, c, dm, asrc, f"r{tr} c{tc} f{f} scale{scale}")
    # rows without tile edges give 0
    assert bool((dad[800:1100] == 0).all())
    assert bool((dh[500 : 500 + 2 * tc] == 0).all()) and bool((das[500 : 500 + 2 * tc] == 0).all())


def test_gat_bwd_kernels_non_edge_overflow_is_not_nan(cuda_dev):
    """Un-stabilized, the score of a non-edge (cnt == 0) can be inf;
    B3 and B4 must select on the count, not multiply by it."""
    g, tp, tp_t = _bwd_plans(cuda_dev, 64, 64, 1)
    a = tp.a.cpu().numpy()
    rows = tp.tile_row.cpu().numpy()[:, None] * 64 + np.arange(64)[None, :]
    cols = tp.tile_col.cpu().numpy()[:, None] * 64 + np.arange(64)[None, :]
    t, i, j = next(
        (t, i, j) for t, i, j in np.argwhere(a == 0)
        if a[t, i].any() and a[t, :, j].any() and rows[t, i] != cols[t, j]
        and rows[t, i] < g.num_nodes and cols[t, j] < g.n_src
    )
    n = g.num_nodes
    att = torch.zeros((n, 2), device=cuda_dev)
    att[rows[t, i], 0] = 50.0
    att[cols[t, j], 1] = 50.0  # exp(50) * exp(50) overflows float32
    dm, asrc = _score_terms(att)
    assert bool(torch.isinf(torch.exp(att[rows[t, i], 0] + att[cols[t, j], 1])))
    gen = torch.Generator(device=cuda_dev).manual_seed(0)
    h, gbar = (torch.randn((n, 8), generator=gen, device=cuda_dev) for _ in range(2))
    c = torch.randn(n, generator=gen, device=cuda_dev)
    _bwd_check(tp, tp_t, h, gbar, c, dm, asrc, "non-edge overflow")


@pytest.mark.parametrize("pack", [1, 16])
@pytest.mark.parametrize("f", [32, 64, 128])
def test_b1_b2_on_training_tiles(cuda_dev, pack, f):
    """B1 over a transposed [256, 256] plan (the GCN backward) and B2 at
    [256, 256] (the training plan's forward)."""
    g, tp, tp_t = _bwd_plans(cuda_dev, 256, 256, pack)
    gen = torch.Generator(device=cuda_dev).manual_seed(f)
    h = torch.randn((g.num_nodes, f), generator=gen, device=cuda_dev)
    got = bcsr_spmm(tp_t, h)
    want = bcsr_spmm_plain(tp_t, h)
    torch.cuda.synchronize()
    _close(got, want, f"B1 transposed f{f}")
    att = torch.randn((g.num_nodes, 2), generator=gen, device=cuda_dev)
    row_shift = _global_bound_shift(att, 0.2)
    got = gat_bcsr(tp, h, att, row_shift=row_shift, dot_mode="split2")
    want = gat_bcsr_plain(tp, h, att, row_shift=row_shift)
    torch.cuda.synchronize()
    _gat_check(got, want, f"B2 r256 c256 f{f}")


@pytest.mark.parametrize("stabilize", [False, "bound"])
def test_training_grads_on_card_match_cpu(cuda_dev, stabilize):
    """hybrid_spmm and hybrid_gat gradients on the card (B1 forward and
    backward; B2, B3, B4) against the same Functions on the CPU."""
    g = rmat_graph(1237, 60000, seed=3, with_val=False)
    g = g.reorder(degree_sort(g))
    cpu = Aggregator.schedule_hybrid(g, tile_dtype=np.int8, tile_rows=64, tile_cols=64, threshold=3, residual_block=4, pack=1,
                                     with_transpose=True, device="cpu")
    card = cpu.to(cuda_dev)
    rng = np.random.default_rng(0)
    h0 = torch.from_numpy(rng.standard_normal((g.num_nodes, 24)).astype(np.float32))
    a0 = torch.from_numpy(rng.standard_normal((g.num_nodes, 2)).astype(np.float32))
    w0 = torch.cos(torch.arange(g.num_nodes * 24, dtype=torch.float32)).reshape(g.num_nodes, 24)
    grads = {}
    for agg, dev in ((cpu, "cpu"), (card, cuda_dev)):
        h = h0.to(dev, copy=True).requires_grad_(True)
        att = a0.to(dev, copy=True).requires_grad_(True)
        before = (cuda_bcsr.launches, cuda_gat.launches, cuda_gat_bwd.dad_launches, cuda_gat_bwd.dh_das_launches)
        (agg.run(h) * w0.to(dev)).sum().backward()
        dh_spmm = h.grad.clone()
        h.grad = None
        (agg.run_gat(h, att, stabilize=stabilize) * w0.to(dev)).sum().backward()
        after = (cuda_bcsr.launches, cuda_gat.launches, cuda_gat_bwd.dad_launches, cuda_gat_bwd.dh_das_launches)
        want = (2, 1, 1, 1) if dev != "cpu" else (0, 0, 0, 0)
        assert tuple(x - y for x, y in zip(after, before)) == want
        grads[str(dev)] = (dh_spmm.cpu(), h.grad.cpu(), att.grad.cpu())
    torch.cuda.synchronize()
    for got, want, what in zip(grads["cuda"], grads["cpu"], ("hybrid_spmm dh", "hybrid_gat dh", "hybrid_gat datt")):
        _close(got, want, what)


def _split_plans(dev, tr, tc, pack):
    """_gat_plan's graph as an int8 plan and as its 1-bit and int8 parts
    (split before pad_runs), each padded; the parts' coverage fillers and
    the sparse last row-tile give filler-only runs."""
    g = rmat_graph(1237, 60000, seed=3, with_val=False)
    g = g.reorder(degree_sort(g))
    d, s = g.dst_per_edge, g.indices
    keep = ((d < 800) | (d >= 1100)) & ((d < 1237 - tr) | (s % 97 == 0))
    g = CSRGraph.from_edges(d[keep], s[keep], g.num_nodes)
    tp = densify(g, dtype=np.int8, tile_rows=tr, tile_cols=tc, threshold=3)[0]
    bits, ints = split_bit_tiles(tp)
    assert bits is not None and ints is not None
    return g, [p.pad_runs(pack).to(dev) for p in (tp, bits, ints)]


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(torch.finfo(torch.float32).tiny))) - 7)


def _sddmm_check(got, want, counts, what):
    zero = counts == 0
    bits = got.view(torch.int16) if got.dtype == torch.bfloat16 else got.view(torch.int32)
    assert bool((bits[zero] == 0).all()), f"{what}: a cell without an edge is not +0"
    g, w = got.float(), want.float()
    assert bool(torch.isfinite(g).all()), what
    if got.dtype == torch.bfloat16:
        assert bool(((g - w).abs() <= _bf16_ulp(torch.maximum(g.abs(), w.abs()))).all()), what
    else:
        assert (g - w).abs().max() <= 1e-5 * w.abs().max(), what


@pytest.mark.parametrize("tr,tc,pack", [(64, 64, 1), (96, 40, 4), (72, 13, 1), (256, 128, 16), (40, 300, 1)])
@pytest.mark.parametrize("f", [1, 24, 32, 33, 100, 128, 300])
def test_sddmm_kernel_matches_plain(cuda_dev, tr, tc, pack, f):
    g, plans = _split_plans(cuda_dev, tr, tc, pack)
    gen = torch.Generator(device=cuda_dev).manual_seed(f)
    a = torch.randn((g.n_src, f), generator=gen, device=cuda_dev)
    b = torch.randn((g.num_nodes, f), generator=gen, device=cuda_dev)
    for tp, label in zip(plans, ("int8", "1-bit part", "int8 part")):
        counts = tp.counts()
        for out in (torch.float32, torch.bfloat16):
            before = cuda_sddmm.launches
            got = sddmm_bcsr(tp, a, b, out_dtype=out, dot_mode="split23")
            assert cuda_sddmm.launches == before + 1
            want = sddmm_bcsr_plain(tp, a, b, out)
            torch.cuda.synchronize()
            assert got.dtype == out and got.shape == (tp.num_tiles, tr, tc)
            _sddmm_check(got, want, counts, f"{label} r{tr} c{tc} f{f} {out}")
        fillers = ~counts.reshape(tp.num_tiles, -1).bool().any(dim=1)
        assert bool(fillers.any()) and bool((got[fillers] == 0).all())


def test_sddmm_kernel_non_edge_overflow_is_zero(cuda_dev):
    """A non-edge whose dot overflows to inf must come out +0.  Its column
    neighbour (j ^ 1, the same lane) holds an edge, so the kernel computes
    both dots and must select on the count, never multiply by it."""
    g, plans = _split_plans(cuda_dev, 64, 64, 1)
    for tp in plans[1:]:
        counts = tp.counts().cpu().numpy()
        pair = counts.reshape(tp.num_tiles, 64, 32, 2)[..., ::-1].reshape(counts.shape)
        t, i, j = np.argwhere((counts == 0) & (pair > 0))[0]
        row = tp.tile_row[t].item() * 64 + i
        col = tp.tile_col[t].item() * 64 + j
        a = torch.rand((g.n_src, 8), device=cuda_dev)
        b = torch.rand((g.num_nodes, 8), device=cuda_dev)
        a[col] = 1e30
        b[row] = 1e30
        assert bool(torch.isinf((a[col] * b[row]).sum()))
        for out in (torch.float32, torch.bfloat16):
            got = sddmm_bcsr(tp, a, b, out_dtype=out)
            want = sddmm_bcsr_plain(tp, a, b, out)
            torch.cuda.synchronize()
            assert got[t, i, j].float().item() == 0.0
            _sddmm_check(got, want, tp.counts(), f"bits={tp.bits} {out}")


def test_hybrid_sddmm_on_card_matches_cpu(cuda_dev):
    """bench.py's SDDMM configuration in miniature: cells and residual slots
    on the card (B6 once per part) against the same op on the CPU."""
    g = rmat_graph(2048, 65536, seed=123, with_val=False)
    g = g.reorder(degree_sort(g))
    cpu = Aggregator.schedule_hybrid(g, tile_dtype=np.int8, with_transpose=False, tile_rows=256, tile_cols=128, threshold=24, residual_block=4,
                                     bit_tiles=True, pack=1, device="cpu")
    card = cpu.to(cuda_dev)
    rng = np.random.default_rng(0)
    a0 = torch.from_numpy((rng.standard_normal((g.num_nodes, 32)) * 0.1).astype(np.float32))
    b0 = torch.from_numpy((rng.standard_normal((g.num_nodes, 32)) * 0.1).astype(np.float32))
    want_cells, want_res = hybrid_sddmm(cpu.tile_parts(), cpu.plan, a0, b0, gather_dtype="f16_split2",
                                        dot_mode="split23")
    before = cuda_sddmm.launches
    got_cells, got_res = hybrid_sddmm(card.tile_parts(), card.plan, a0.to(cuda_dev), b0.to(cuda_dev),
                                      gather_dtype="f16_split2", dot_mode="split23")
    torch.cuda.synchronize()
    assert cuda_sddmm.launches == before + 2
    for got, want, p in zip(got_cells, want_cells, cpu.tile_parts()):
        _sddmm_check(got.cpu(), want, p.counts(), f"bits={p.bits}")
    assert (got_res.cpu() - want_res).abs().max() <= 1e-5 * want_res.abs().max()


@pytest.mark.parametrize("tr,tc,pack", [(64, 64, 1), (96, 40, 4), (72, 13, 1), (512, 256, 16), (40, 300, 1)])
@pytest.mark.parametrize("f", [1, 24, 32, 33, 64, 100, 128])
def test_bits_kernel_matches_plain(cuda_dev, tr, tc, pack, f):
    """B1 over a 1-bit part: equal to B1 over the same part unpacked to
    int8, and within the bound of the plain version."""
    g, (_, bits, _) = _split_plans(cuda_dev, tr, tc, pack)
    gen = torch.Generator(device=cuda_dev).manual_seed(f)
    unpacked = bits.unpack_bits()
    for signed in (False, True):
        h = (torch.randn if signed else torch.rand)((g.n_src, f), generator=gen, device=cuda_dev)
        for mode in ("split", "native"):
            before = cuda_bcsr.launches
            got = bcsr_spmm(bits, h, h_mode=mode)
            assert cuda_bcsr.launches == before + 1
            same = bcsr_spmm(unpacked, h, h_mode=mode)
            want = bcsr_spmm_plain(bits, round_h(h, mode))
            torch.cuda.synchronize()
            assert torch.equal(got, same)
            if not signed:
                assert_valid(got, want, what=f"bits {mode} r{tr} c{tc} f{f}")
            assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    # rows without tile edges give 0
    assert bool((got[800:1100] == 0).all())


def _bit_counts():
    return (cuda_gat.bits_launches, cuda_gat_bwd.dad_bits_launches, cuda_gat_bwd.dh_das_bits_launches,
            cuda_rowmax.bits_launches)


@pytest.mark.parametrize("tr,tc,pack", [(40, 13, 1), (72, 40, 4), (96, 64, 1), (256, 256, 16), (64, 200, 1)])
@pytest.mark.parametrize("f", [1, 24, 33, 100, 128, 160, 300])
def test_bit_gat_kernels_match_plain(cuda_dev, tr, tc, pack, f):
    """B2, B3 and B5 over a 1-bit part and B4 over its transpose (C % 8 ==
    0 only: the transpose packs C as its R): equal to the same kernel over
    the part unpacked to int8, within the bound of the plain version; each
    call adds one to its kernel's 1-bit launch count."""
    g, (_, bits, _) = _split_plans(cuda_dev, tr, tc, 1)
    host = dataclasses.replace(bits, a=bits.a.cpu().numpy(), tile_row=bits.tile_row.cpu().numpy(),
                               tile_col=bits.tile_col.cpu().numpy(), run_start=bits.run_start.cpu().numpy())
    bits = host.pad_runs(pack).to(cuda_dev)
    bits_t = host.transpose().pad_runs(pack).to(cuda_dev) if tc % 8 == 0 else None
    starts = bits.run_start.cpu().numpy()
    assert any(starts[r + 1] > starts[r] and not bits.a[starts[r] : starts[r + 1]].any()
               for r in range(bits.num_row_tiles))  # a filler-only run
    n = g.num_nodes
    gen = torch.Generator(device=cuda_dev).manual_seed(f)
    h = torch.randn((n, f), generator=gen, device=cuda_dev)
    gbar = torch.randn((n, f), generator=gen, device=cuda_dev)
    c = torch.randn(n, generator=gen, device=cuda_dev)
    for scale, shift in ((0.1, False), (15.0, True)):
        att = torch.randn((n, 2), generator=gen, device=cuda_dev) * scale
        row_shift = _hybrid_row_shift(bits, None, att, 0.2) if shift else None
        what = f"1-bit r{tr} c{tc} pack{pack} f{f} scale{scale}"
        before = _bit_counts()
        got = gat_bcsr(bits, h, att, row_shift=row_shift)
        assert cuda_gat.bits_launches == before[0] + 1
        same = gat_bcsr(bits.unpack_bits(), h, att, row_shift=row_shift)
        want = gat_bcsr_plain(bits, h, att, row_shift=row_shift)
        torch.cuda.synchronize()
        assert torch.equal(got[0], same[0]) and torch.equal(got[1], same[1]), what
        _gat_check(got, want, f"B2 {what}")
        dm, asrc = _score_terms(att, row_shift)
        args = (h, gbar, c, dm, asrc, 0.2)
        dad = gat_bwd_dad(bits, *args)
        assert torch.equal(dad, gat_bwd_dad(bits.unpack_bits(), *args)), what
        _close(dad, gat_bwd_dad_plain(bits, *args), f"B3 {what}")
        if bits_t is not None:
            dh, das = gat_bwd_dh_das(bits_t, *args)
            dh2, das2 = gat_bwd_dh_das(bits_t.unpack_bits(), *args)
            assert torch.equal(dh, dh2) and torch.equal(das, das2), what
            want_dh, want_das = gat_bwd_dh_das_plain(bits_t, *args)
            _close(dh, want_dh, f"B4 dh {what}")
            _close(das, want_das, f"B4 d_as {what}")
        mx = bcsr_rowmax(bits, att[:, 1].contiguous())
        assert torch.equal(mx, bcsr_rowmax_plain(bits, att[:, 1].contiguous())), what
        assert bool(torch.isneginf(mx[800:1100]).all())
        after = _bit_counts()
        assert tuple(x - y for x, y in zip(after, before)) == (1, 1, 1 if bits_t is not None else 0, 1)
    # rows without tile edges give 0
    assert bool((got[0][800:1100] == 0).all()) and bool((got[1][800:1100] == 0).all())
    assert bool((dad[800:1100] == 0).all())


def test_bit_gat_kernels_non_edge_overflow_is_not_nan(cuda_dev):
    """A non-edge of a 1-bit tile whose unstabilized score is inf: B2, B3 and
    B4 select on the bit, never multiply by it."""
    g, (_, bits, _) = _split_plans(cuda_dev, 64, 64, 1)
    bits_t = dataclasses.replace(bits, a=bits.a.cpu().numpy(), tile_row=bits.tile_row.cpu().numpy(),
                                 tile_col=bits.tile_col.cpu().numpy(),
                                 run_start=bits.run_start.cpu().numpy()).transpose().to(cuda_dev)
    a = bits.counts().cpu().numpy()
    rows = bits.tile_row.cpu().numpy()[:, None] * 64 + np.arange(64)[None, :]
    cols = bits.tile_col.cpu().numpy()[:, None] * 64 + np.arange(64)[None, :]
    t, i, j = next(
        (t, i, j) for t, i, j in np.argwhere(a == 0)
        if a[t, i].any() and a[t, :, j].any() and rows[t, i] != cols[t, j]
        and rows[t, i] < g.num_nodes and cols[t, j] < g.n_src
    )
    n = g.num_nodes
    att = torch.zeros((n, 2), device=cuda_dev)
    att[rows[t, i], 0] = 50.0
    att[cols[t, j], 1] = 50.0  # exp(50) * exp(50) overflows float32
    dm, asrc = _score_terms(att)
    assert bool(torch.isinf(torch.exp(att[rows[t, i], 0] + att[cols[t, j], 1])))
    gen = torch.Generator(device=cuda_dev).manual_seed(0)
    h, gbar = (torch.randn((n, 8), generator=gen, device=cuda_dev) for _ in range(2))
    c = torch.randn(n, generator=gen, device=cuda_dev)
    got = gat_bcsr(bits, h, att)
    want = gat_bcsr_plain(bits, h, att)
    torch.cuda.synchronize()
    _gat_check(got, want, "1-bit non-edge overflow")
    _bwd_check(bits, bits_t, h, gbar, c, dm, asrc, "1-bit non-edge overflow")


def test_bit_wrappers_refuse_r_not_multiple_of_8(cuda_dev):
    """A 1-bit plan whose R is not a multiple of 8 is refused by every
    wrapper with ValueError, before any launch."""
    g, (_, bits, _) = _split_plans(cuda_dev, 64, 64, 1)
    odd = dataclasses.replace(bits, tile_rows=60)
    with pytest.raises(ValueError, match="R % 8 == 0"):
        check_plan(odd, cuda_dev)
    n = g.num_nodes
    h = torch.rand((n, 8), device=cuda_dev)
    v = torch.rand((n, 2), device=cuda_dev)
    c = torch.rand(n, device=cuda_dev)
    before = (cuda_bcsr.launches, cuda_gat.launches, cuda_rowmax.launches,
              cuda_gat_bwd.dad_launches, cuda_gat_bwd.dh_das_launches)
    for call in (
        lambda: cuda_bcsr.bcsr_spmm_cuda(odd, h),
        lambda: cuda_gat.gat_bcsr_cuda(odd, h, v, c, 0.2),
        lambda: cuda_rowmax.rowmax_bcsr_cuda(odd, c),
        lambda: cuda_gat_bwd.gat_bwd_dad_cuda(odd, h, h, c, v, c, 0.2),
        lambda: cuda_gat_bwd.gat_bwd_dh_das_cuda(odd, h, h, c, v, c, 0.2),
    ):
        with pytest.raises(ValueError, match="R % 8 == 0"):
            call()
    assert before == (cuda_bcsr.launches, cuda_gat.launches, cuda_rowmax.launches,
                      cuda_gat_bwd.dad_launches, cuda_gat_bwd.dh_das_launches)


@pytest.mark.parametrize("stabilize", [False, True, "bound"])
def test_bit_training_grads_on_card_match_cpu(cuda_dev, stabilize):
    """hybrid_spmm and hybrid_gat gradients on a bit_tiles=True aggregator
    with transposed plans (every tile kernel over both parts) on the card
    against the same Functions on the CPU."""
    g = rmat_graph(1237, 60000, seed=3, with_val=False)
    g = g.reorder(degree_sort(g))
    cpu = Aggregator.schedule_hybrid(g, tile_dtype=np.int8, tile_rows=64, tile_cols=64, threshold=3, residual_block=4, pack=1,
                                     with_transpose=True, bit_tiles=True, device="cpu")
    assert [p.bits for p in cpu.tile_parts_t()] == [True, False]
    card = cpu.to(cuda_dev)
    rng = np.random.default_rng(0)
    h0 = torch.from_numpy(rng.standard_normal((g.num_nodes, 24)).astype(np.float32))
    a0 = torch.from_numpy(rng.standard_normal((g.num_nodes, 2)).astype(np.float32))
    w0 = torch.cos(torch.arange(g.num_nodes * 24, dtype=torch.float32)).reshape(g.num_nodes, 24)
    grads = {}
    for agg, dev in ((cpu, "cpu"), (card, cuda_dev)):
        h = h0.to(dev, copy=True).requires_grad_(True)
        att = a0.to(dev, copy=True).requires_grad_(True)
        before = (cuda_bcsr.bits_launches,) + _bit_counts()
        (agg.run(h) * w0.to(dev)).sum().backward()
        dh_spmm = h.grad.clone()
        h.grad = None
        (agg.run_gat(h, att, stabilize=stabilize) * w0.to(dev)).sum().backward()
        after = (cuda_bcsr.bits_launches,) + _bit_counts()
        want = (2, 1, 1, 1, 1 if stabilize is True else 0) if dev != "cpu" else (0,) * 5
        assert tuple(x - y for x, y in zip(after, before)) == want
        grads[str(dev)] = (dh_spmm.cpu(), h.grad.cpu(), att.grad.cpu())
    torch.cuda.synchronize()
    for got, want, what in zip(grads["cuda"], grads["cpu"], ("hybrid_spmm dh", "hybrid_gat dh", "hybrid_gat datt")):
        _close(got, want, f"1-bit {what}")


# ------------------------------------------------------- float tiles, epilogue
def _float_plan(dev, tr, tc, pack, fmt, factored):
    """_gat_plan's graph with random edge values as float32 or bfloat16
    tiles (factored: count tiles of float dtype with the scales beside)."""
    g = rmat_graph(1237, 60000, seed=3, with_val=False)
    g = g.reorder(degree_sort(g))
    d, s = g.dst_per_edge, g.indices
    keep = ((d < 800) | (d >= 1100)) & ((d < 1237 - tr) | (s % 97 == 0))
    g = CSRGraph.from_edges(d[keep], s[keep], g.num_nodes)
    rng = np.random.default_rng(5)
    if factored:
        sd = rng.uniform(0.5, 2.0, g.num_nodes).astype(np.float32)
        ss = rng.uniform(0.5, 2.0, g.n_src).astype(np.float32)
        kw = dict(val=sd[g.dst_per_edge] * ss[g.indices], scale_dst=sd, scale_src=ss)
    else:
        kw = dict(val=rng.uniform(-1.0, 2.0, g.num_edges).astype(np.float32))
    tp = densify(g, dtype=fmt, tile_rows=tr, tile_cols=tc, threshold=3, **kw)[0].pad_runs(pack)
    return g, tp.to(dev)


@pytest.mark.parametrize("tr,tc,pack", [(64, 64, 1), (96, 40, 4), (72, 13, 1), (512, 256, 16)])
@pytest.mark.parametrize("f", [1, 24, 33, 64, 100, 128])
@pytest.mark.parametrize("fmt", [np.float32, torch.bfloat16])
@pytest.mark.parametrize("factored", [False, True])
def test_float_tile_kernel_matches_plain(cuda_dev, tr, tc, pack, f, fmt, factored):
    """B1 over float32 and bfloat16 tiles (signed edge values, or factored
    counts) against bcsr_spmm_plain; each launch adds one to launches and
    float_launches; rows without tile edges give 0."""
    g, tp = _float_plan(cuda_dev, tr, tc, pack, fmt, factored)
    assert tp.a.dtype == (torch.float32 if fmt is np.float32 else torch.bfloat16)
    gen = torch.Generator(device=cuda_dev).manual_seed(f)
    for signed in (False, True):
        h = (torch.randn if signed else torch.rand)((g.n_src, f), generator=gen, device=cuda_dev)
        before = (cuda_bcsr.launches, cuda_bcsr.float_launches)
        got = bcsr_spmm(tp, h)
        assert (cuda_bcsr.launches, cuda_bcsr.float_launches) == (before[0] + 1, before[1] + 1)
        want = bcsr_spmm_plain(tp, h)
        torch.cuda.synchronize()
        _close(got, want, f"{fmt} r{tr} c{tc} f{f} signed {signed}")
    assert bool((got[800:1100] == 0).all())


@pytest.mark.parametrize("fmt", ["i8", "b1", "f32", "bf16"])
@pytest.mark.parametrize("f,f_out", [(1, 1), (32, 32), (33, 70), (64, 32), (100, 17), (128, 64), (128, 130)])
@pytest.mark.parametrize("factored", [False, True])
def test_epilogue_matches_plain(cuda_dev, fmt, f, f_out, factored):
    """B1's w_epilogue variant over every A format against bcsr_spmm_nn_plain
    (bcsr_spmm_plain, then torch.matmul): agg and trans within 1e-5 *
    max|plain|; one launch, counted in epilogue_launches."""
    from gnn_computing_tpu_torch.ops.fused_nn import bcsr_spmm_nn, bcsr_spmm_nn_plain

    if fmt in ("i8", "b1"):
        if factored and fmt == "b1":
            pytest.skip("a factored plan's 1-bit part is covered by i8 (the same counts)")
        g = rmat_graph(1237, 60000, seed=3, with_val=False)
        g = g.reorder(degree_sort(g))
        kw = dict(tile_rows=64, tile_cols=64, threshold=3)
        if factored:
            rng = np.random.default_rng(0)
            sd = rng.uniform(0.5, 2.0, g.num_nodes).astype(np.float32)
            ss = rng.uniform(0.5, 2.0, g.n_src).astype(np.float32)
            kw.update(val=sd[g.dst_per_edge] * ss[g.indices], scale_dst=sd, scale_src=ss)
        tp = densify(g, dtype=np.int8, **kw)[0]
        if fmt == "b1":
            tp = split_bit_tiles(tp)[0]
        tp = tp.to(cuda_dev)
    else:
        g, tp = _float_plan(cuda_dev, 96, 40, 1, np.float32 if fmt == "f32" else torch.bfloat16, factored)
    gen = torch.Generator(device=cuda_dev).manual_seed(f)
    h = torch.randn((g.n_src, f), generator=gen, device=cuda_dev)
    w = torch.randn((f, f_out), generator=gen, device=cuda_dev) * 0.1
    before = (cuda_bcsr.launches, cuda_bcsr.epilogue_launches)
    agg, trans = bcsr_spmm_nn(tp, h, w)
    assert (cuda_bcsr.launches, cuda_bcsr.epilogue_launches) == (before[0] + 1, before[1] + 1)
    want_agg, want_trans = bcsr_spmm_nn_plain(tp, h, w)
    torch.cuda.synchronize()
    _close(agg, want_agg, f"{fmt} f{f} agg")
    _close(trans, want_trans, f"{fmt} f{f}->{f_out} trans")


def test_epilogue_refuses_wide_f(cuda_dev):
    g, tp = _float_plan(cuda_dev, 64, 64, 1, np.float32, False)
    h = torch.rand((g.n_src, 129), device=cuda_dev)
    with pytest.raises(ValueError, match="f <= 128"):
        cuda_bcsr.bcsr_spmm_nn_cuda(tp, h, torch.rand((129, 8), device=cuda_dev))


def _float_bwd_plans(dev, tr, tc, pack, fmt, values):
    """_bwd_plans' graph as float32 or bfloat16 tiles of its edge counts
    ('counts', the JAX default schedule's values) or of signed edge values
    U(-1, 3) ('signed'), the forward plan and its transpose, both padded."""
    g, tp, tp_t = _float_host_plans(tr, tc, pack, fmt, values)
    return g, tp.to(dev), tp_t.to(dev)


@functools.lru_cache(maxsize=None)
def _float_host_plans(tr, tc, pack, fmt, values):
    """The host plans of _float_bwd_plans, built once per setting (the cases
    of one setting differ in f only)."""
    g = rmat_graph(1237, 60000, seed=3, with_val=False)
    g = g.reorder(degree_sort(g))
    d, s = g.dst_per_edge, g.indices
    keep = ((d < 800) | (d >= 1100)) & ((d < 1237 - tr) | (s % 97 == 0)) & ((s < 500) | (s >= 500 + 2 * tc))
    g = CSRGraph.from_edges(d[keep], s[keep], g.num_nodes)
    val = None
    if values == "signed":
        val = np.random.default_rng(5).uniform(-1.0, 3.0, g.num_edges).astype(np.float32)
    tp = densify(g, dtype=fmt, val=val, tile_rows=tr, tile_cols=tc, threshold=3)[0]
    return g, tp.pad_runs(pack), tp.transpose().pad_runs(pack)


def _float_counts():
    return (cuda_gat.float_launches, cuda_rowmax.float_launches, cuda_gat_bwd.dad_float_launches,
            cuda_gat_bwd.dh_das_float_launches, cuda_sddmm.float_launches)


@pytest.mark.parametrize("tr,tc,pack", [(64, 64, 1), (96, 40, 4), (72, 13, 1), (256, 256, 16), (40, 300, 1)])
@pytest.mark.parametrize("f", [1, 24, 33, 100, 128, 160])
@pytest.mark.parametrize("fmt", [np.float32, torch.bfloat16])
@pytest.mark.parametrize("values", ["counts", "signed"])
def test_float_gat_kernels_match_plain(cuda_dev, tr, tc, pack, f, fmt, values):
    """B2, B5, B3 and B4 over float32 and bfloat16 tiles (count values, and
    signed values: every nonzero cell is scored, C6) against their plain
    versions, unshifted, with the exact row shift and with the 'bound'
    shift; each launch counts in launches and float_launches; rows and
    sources without tile edges give 0 (B5: -inf)."""
    g, tp, tp_t = _float_bwd_plans(cuda_dev, tr, tc, pack, fmt, values)
    assert tp.format == ("float32" if fmt is np.float32 else "bfloat16")
    if values == "signed":
        assert bool((tp.a < 0).any())
    n = g.num_nodes
    gen = torch.Generator(device=cuda_dev).manual_seed(f)
    h = torch.randn((n, f), generator=gen, device=cuda_dev)
    gbar = torch.randn((n, f), generator=gen, device=cuda_dev)
    c = torch.randn(n, generator=gen, device=cuda_dev)
    for scale, shift in ((0.1, None), (15.0, "exact"), (15.0, "bound")):
        att = torch.randn((n, 2), generator=gen, device=cuda_dev) * scale
        before = _float_counts()
        rmax = bcsr_rowmax(tp, att[:, 1].contiguous())
        row_shift = None
        if shift == "exact":
            row_shift = _hybrid_row_shift(tp, None, att, 0.2)
        elif shift == "bound":
            row_shift = _global_bound_shift(att, 0.2)
        got = gat_bcsr(tp, h, att, row_shift=row_shift)
        dm, asrc = _score_terms(att, row_shift)
        dad = gat_bwd_dad(tp, h, gbar, c, dm, asrc, 0.2)
        dh, das = gat_bwd_dh_das(tp_t, h, gbar, c, dm, asrc, 0.2)
        b5 = 1 + (shift == "exact")  # B5 once more inside the exact shift
        assert tuple(x - y for x, y in zip(_float_counts(), before)) == (1, b5, 1, 1, 0)
        want = gat_bcsr_plain(tp, h, att, row_shift=row_shift)
        torch.cuda.synchronize()
        what = f"{values} {tp.format} r{tr} c{tc} f{f} scale{scale} {shift}"
        assert torch.equal(rmax, bcsr_rowmax_plain(tp, att[:, 1].contiguous())), what
        _close(got[0], want[0], f"{what} num")
        _close(got[1], want[1], f"{what} den")
        _close(dad, gat_bwd_dad_plain(tp, h, gbar, c, dm, asrc, 0.2), f"{what} d_ad")
        want_dh, want_das = gat_bwd_dh_das_plain(tp_t, h, gbar, c, dm, asrc, 0.2)
        _close(dh, want_dh, f"{what} dh")
        _close(das, want_das, f"{what} d_as")
    assert bool((got[0][800:1100] == 0).all()) and bool((got[1][800:1100] == 0).all())
    assert bool((dad[800:1100] == 0).all()) and bool(torch.isneginf(rmax[800:1100]).all())
    assert bool((dh[500 : 500 + 2 * tc] == 0).all()) and bool((das[500 : 500 + 2 * tc] == 0).all())


@pytest.mark.parametrize("tr,tc,pack", [(64, 64, 1), (96, 40, 4), (72, 13, 1), (256, 128, 16), (40, 300, 1)])
@pytest.mark.parametrize("f", [1, 24, 32, 33, 100, 128, 300])
@pytest.mark.parametrize("fmt", [np.float32, torch.bfloat16])
@pytest.mark.parametrize("values", ["counts", "signed"])
def test_float_sddmm_kernel_matches_plain(cuda_dev, tr, tc, pack, f, fmt, values):
    """B6 over float32 and bfloat16 tiles against sddmm_bcsr_plain: a cell
    holds its dot where its value is > 0 (the JAX rule), +0 elsewhere,
    negative cells of a signed plan included; float_launches counts it."""
    g, tp, _ = _float_bwd_plans(cuda_dev, tr, tc, pack, fmt, values)
    gen = torch.Generator(device=cuda_dev).manual_seed(f)
    a = torch.randn((g.n_src, f), generator=gen, device=cuda_dev)
    b = torch.randn((g.num_nodes, f), generator=gen, device=cuda_dev)
    edge = tp.counts() > 0
    for out in (torch.float32, torch.bfloat16):
        before = (cuda_sddmm.launches, cuda_sddmm.float_launches)
        got = sddmm_bcsr(tp, a, b, out_dtype=out, dot_mode="split23")
        assert (cuda_sddmm.launches, cuda_sddmm.float_launches) == (before[0] + 1, before[1] + 1)
        want = sddmm_bcsr_plain(tp, a, b, out)
        torch.cuda.synchronize()
        _sddmm_check(got, want, edge, f"{values} {tp.format} r{tr} c{tc} f{f} {out}")


def test_float_gat_kernels_non_edge_overflow_is_not_nan(cuda_dev):
    """Over float tiles, a cell whose value is 0 and whose unstabilized score
    is inf: B2, B3 and B4 select on the value, never multiply by it."""
    for fmt in (np.float32, torch.bfloat16):
        g, tp, tp_t = _float_bwd_plans(cuda_dev, 64, 64, 1, fmt, "counts")
        a = tp.counts().float().cpu().numpy()
        rows = tp.tile_row.cpu().numpy()[:, None] * 64 + np.arange(64)[None, :]
        cols = tp.tile_col.cpu().numpy()[:, None] * 64 + np.arange(64)[None, :]
        t, i, j = next(
            (t, i, j) for t, i, j in np.argwhere(a == 0)
            if a[t, i].any() and a[t, :, j].any() and rows[t, i] != cols[t, j]
            and rows[t, i] < g.num_nodes and cols[t, j] < g.n_src
        )
        n = g.num_nodes
        att = torch.zeros((n, 2), device=cuda_dev)
        att[rows[t, i], 0] = 50.0
        att[cols[t, j], 1] = 50.0  # exp(50) * exp(50) overflows float32
        dm, asrc = _score_terms(att)
        gen = torch.Generator(device=cuda_dev).manual_seed(0)
        h, gbar = (torch.randn((n, 8), generator=gen, device=cuda_dev) for _ in range(2))
        c = torch.randn(n, generator=gen, device=cuda_dev)
        got = gat_bcsr(tp, h, att)
        want = gat_bcsr_plain(tp, h, att)
        torch.cuda.synchronize()
        _gat_check(got, want, f"{tp.format} non-edge overflow")
        _bwd_check(tp, tp_t, h, gbar, c, dm, asrc, f"{tp.format} non-edge overflow")


@pytest.mark.parametrize("fmt", [None, torch.bfloat16])
@pytest.mark.parametrize("stabilize", [False, True, "bound"])
def test_float_training_grads_on_card_match_cpu(cuda_dev, fmt, stabilize):
    """The JAX default schedule (float32 count tiles, transposed plans) and
    its bfloat16 form: hybrid_gat's forward and gradients on the card (B2,
    B3, B4 and, for stabilize=True, B5, each over float tiles) against the
    same Function on the CPU; hybrid_sddmm's cells the same."""
    g = rmat_graph(1237, 60000, seed=3, with_val=False)
    g = g.reorder(degree_sort(g))
    cpu = Aggregator.schedule_hybrid(g, tile_dtype=fmt, tile_rows=64, tile_cols=64, threshold=3, residual_block=4,
                                     pack=1, device="cpu")
    card = cpu.to(cuda_dev)
    assert card.tile.format == ("float32" if fmt is None else "bfloat16")
    rng = np.random.default_rng(0)
    h0 = torch.from_numpy(rng.standard_normal((g.num_nodes, 24)).astype(np.float32))
    a0 = torch.from_numpy(rng.standard_normal((g.num_nodes, 2)).astype(np.float32))
    w0 = torch.cos(torch.arange(g.num_nodes * 24, dtype=torch.float32)).reshape(g.num_nodes, 24)
    res = {}
    for agg, dev in ((cpu, "cpu"), (card, cuda_dev)):
        h = h0.to(dev, copy=True).requires_grad_(True)
        att = a0.to(dev, copy=True).requires_grad_(True)
        before = _float_counts()
        out = agg.run_gat(h, att, stabilize=stabilize)
        (out * w0.to(dev)).sum().backward()
        with torch.no_grad():
            cells, _ = hybrid_sddmm(agg.tile_parts(), agg.plan, h, h)
        want = (1, 1 if stabilize is True else 0, 1, 1, 1) if dev != "cpu" else (0,) * 5
        assert tuple(x - y for x, y in zip(_float_counts(), before)) == want
        res[str(dev)] = (out.detach().cpu(), h.grad.cpu(), att.grad.cpu(), cells[0].cpu())
    torch.cuda.synchronize()
    for got, want, what in zip(res["cuda"][:3], res["cpu"][:3], ("out", "dh", "datt")):
        _close(got, want, f"{fmt} stabilize={stabilize} {what}")
    _sddmm_check(res["cuda"][3], res["cpu"][3], cpu.tile.counts() > 0, f"{fmt} hybrid_sddmm")


def test_wrappers_refuse_malformed_float_plans(cuda_dev):
    """Every float-tile wrapper raises ValueError, before any launch, on a
    plan whose tiles are not what its format says (float16, the wrong
    shape, not contiguous) or lie on another device: no fallback."""
    g, tp, tp_t = _float_bwd_plans(cuda_dev, 64, 64, 1, np.float32, "counts")
    n = g.num_nodes
    h = torch.rand((n, 8), device=cuda_dev)
    v = torch.rand((n, 2), device=cuda_dev)
    c = torch.rand(n, device=cuda_dev)
    bad_plans = [
        dataclasses.replace(tp, a=tp.a.half()),
        dataclasses.replace(tp, a=tp.a[:, :, :32]),
        dataclasses.replace(tp, a=tp.a.transpose(1, 2).contiguous().transpose(1, 2)),
        dataclasses.replace(tp, a=tp.a.cpu()),
        dataclasses.replace(tp.astype(torch.bfloat16), a=tp.a[:, :32].to(torch.bfloat16)),
    ]
    before = (cuda_gat.launches, cuda_rowmax.launches, cuda_gat_bwd.dad_launches, cuda_gat_bwd.dh_das_launches,
              cuda_sddmm.launches)
    for bad in bad_plans:
        for call in (
            lambda: cuda_gat.gat_bcsr_cuda(bad, h, v, c, 0.2),
            lambda: cuda_rowmax.rowmax_bcsr_cuda(bad, c),
            lambda: cuda_gat_bwd.gat_bwd_dad_cuda(bad, h, h, c, v, c, 0.2),
            lambda: cuda_gat_bwd.gat_bwd_dh_das_cuda(bad, h, h, c, v, c, 0.2),
            lambda: cuda_sddmm.sddmm_bcsr_cuda(bad, h, h),
        ):
            with pytest.raises(ValueError):
                call()
    assert before == (cuda_gat.launches, cuda_rowmax.launches, cuda_gat_bwd.dad_launches,
                      cuda_gat_bwd.dh_das_launches, cuda_sddmm.launches)


@pytest.mark.parametrize("big", [95.0, 120.0])
@pytest.mark.parametrize("stabilize", [True, "bound"])
def test_gat_kernels_wide_logits(cuda_dev, big, stabilize):
    """One source's as at 95 or 120 (exp(as) overflows float32): B2, B3 and
    B4 through hybrid_gat's forward and backward on the card equal the same
    Function on the CPU, finite, for both stabilizers."""
    g = rmat_graph(1237, 60000, seed=3, with_val=False)
    g = g.reorder(degree_sort(g))
    cpu = Aggregator.schedule_hybrid(g, tile_dtype=np.int8, tile_rows=64, tile_cols=64, threshold=3,
                                     residual_block=4, pack=1, device="cpu")
    card = cpu.to(cuda_dev)
    rng = np.random.default_rng(1)
    h0 = torch.from_numpy(rng.standard_normal((g.num_nodes, 24)).astype(np.float32))
    a0 = torch.from_numpy((rng.standard_normal((g.num_nodes, 2)) * 0.1).astype(np.float32))
    a0[5, 1] = big
    w0 = torch.cos(torch.arange(g.num_nodes * 24, dtype=torch.float32)).reshape(g.num_nodes, 24)
    res = {}
    for agg, dev in ((cpu, "cpu"), (card, cuda_dev)):
        h = h0.to(dev, copy=True).requires_grad_(True)
        att = a0.to(dev, copy=True).requires_grad_(True)
        out = agg.run_gat(h, att, stabilize=stabilize)
        (out * w0.to(dev)).sum().backward()
        res[str(dev)] = (out.detach().cpu(), h.grad.cpu(), att.grad.cpu())
    torch.cuda.synchronize()
    for got, want, what in zip(res["cuda"], res["cpu"], ("out", "dh", "datt")):
        _close(got, want, f"as={big} {stabilize} {what}")


# ------------------------------------------------- B2's other modes, P1 and P2
@functools.lru_cache(maxsize=None)
def _mode_plan(dev, fmt, tr, tc, pack):
    """_gat_plan's counts as int8 tiles, their 1-bit part, or float32 /
    bfloat16 tiles of signed values (every nonzero cell scored, C6)."""
    if fmt == "i8":
        return _gat_plan(dev, tr, tc, pack)[1]
    if fmt == "b1":
        g, _ = _gat_plan("cpu", tr, tc, 1)
        tp = densify(g, dtype=np.int8, tile_rows=tr, tile_cols=tc, threshold=3)[0]
        return split_bit_tiles(tp)[0].pad_runs(pack).to(dev)
    return _float_plan(dev, tr, tc, pack, {"f32": np.float32, "bf16": torch.bfloat16}[fmt], False)[1]


def _att(n, scale, gen, dev):
    return torch.randn((n, 2), generator=gen, device=dev) * scale


@pytest.mark.parametrize("tr,tc,pack", [(64, 64, 1), (72, 13, 1), (512, 256, 16)])
@pytest.mark.parametrize("f", [1, 33, 128])
@pytest.mark.parametrize("fmt", ["i8", "b1", "f32", "bf16"])
def test_gat_default_kernel_matches_plain(cuda_dev, tr, tc, pack, f, fmt):
    tp = _mode_plan(cuda_dev, fmt, tr, tc, pack)
    gen = torch.Generator(device=cuda_dev).manual_seed(f)
    h = torch.randn((tp.n_src, f), generator=gen, device=cuda_dev)
    for shift in (False, True):
        att = _att(tp.num_nodes, 0.5, gen, cuda_dev)
        row_shift = _hybrid_row_shift(tp, None, att, 0.2) if shift else None
        before = (cuda_gat.launches, cuda_gat.default_launches)
        num, den = gat_bcsr(tp, h, att, row_shift=row_shift, dot_mode="default")
        assert (cuda_gat.launches, cuda_gat.default_launches) == (before[0] + 1, before[1] + 1)
        ref_num, ref_den = gat_bcsr_plain(tp, h, att, row_shift=row_shift, dot_mode="default")
        a_abs = tp if not tp.format.startswith(("float", "bfloat")) else dataclasses.replace(tp, a=tp.a.abs())
        ulp = 2.0**-7 * gat_bcsr_plain(a_abs, h.abs(), att, row_shift=row_shift)[0] * (1 + 2.0**-7)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(num).all())
        assert bool(((num - ref_num).abs() <= 1e-5 * ref_num.abs().max() + ulp).all()), (fmt, shift)
        _close(den, ref_den, f"default den {fmt} shift={shift}")


@pytest.mark.parametrize("tr,tc,pack", [(64, 64, 1), (72, 13, 1), (512, 256, 16)])
@pytest.mark.parametrize("f", [1, 33, 128])
@pytest.mark.parametrize("fmt", ["i8", "b1", "f32", "bf16"])
@pytest.mark.parametrize("mode,hv", [("twodot", 2), ("twodot", 1), ("merged", 2), ("merged", 1)])
def test_factored_kernel_matches_plain(cuda_dev, tr, tc, pack, f, fmt, mode, hv):
    """The factored kernel against _factored_sums over the same per-node
    operands, att at scale 0.5 unshifted and with the exact shift, and at
    scale 15 with the exact shift, where the rows the factored form cannot
    hold are compared through gat_bcsr_tiles' rescue."""
    tp = _mode_plan(cuda_dev, fmt, tr, tc, pack)
    gen = torch.Generator(device=cuda_dev).manual_seed(f + 7)
    h = torch.randn((tp.n_src, f), generator=gen, device=cuda_dev)
    for scale, shift in ((0.5, False), (0.5, True), (15.0, True)):
        att = _att(tp.num_nodes, scale, gen, cuda_dev)
        row_shift = _hybrid_row_shift(tp, None, att, 0.2) if shift else None
        counter = "twodot_launches" if mode == "twodot" else "merged_launches"
        before = getattr(cuda_gat, counter)
        num, den, need = gat_bcsr_factored(tp, h, att, 0.2, mode, hv, row_shift)
        assert getattr(cuda_gat, counter) == before + 1
        terms = factored_terms(h, att, 0.2, mode, hv, row_shift)
        ref_num, ref_den = _factored_sums(tp, terms, mode)
        torch.cuda.synchronize()
        assert torch.equal(need, terms.need[: tp.num_nodes])
        keep = ~need
        what = f"{mode}{hv} {fmt} scale {scale} shift={shift}"
        if scale < 1:
            assert not bool(need.any()), what
        if bool(keep.any()):  # wide logits may mark every row of a plan
            _close(num[keep], ref_num[keep], f"{what} num")
            _close(den[keep], ref_den[keep], f"{what} den")
        got = gat_bcsr_tiles(tp, h, att, 0.2, mode=mode, hv_chunks=hv, row_shift=row_shift)
        exact = gat_bcsr_plain(tp, h, att, row_shift=row_shift)
        want = (torch.where(need[:, None], exact[0], ref_num), torch.where(need, exact[1], ref_den))
        torch.cuda.synchronize()
        for x, y, out in zip(got, want, ("num", "den")):
            _close(x, y, f"{what} rescued {out}")


@pytest.mark.parametrize("big", [95.0, 120.0])
@pytest.mark.parametrize("stabilize", [True, "bound"])
@pytest.mark.parametrize("mode", ["twodot", "merged"])
def test_factored_kernel_wide_logits(cuda_dev, big, stabilize, mode):
    """One source's as at 95 or 120: gat_bcsr_tiles on the card (the
    factored kernel, then B2 for the rescued rows) equals it on the CPU,
    finite; 'bound' with hybrid_gat's C2 rescue first."""
    g = rmat_graph(1237, 60000, seed=3, with_val=False)
    g = g.reorder(degree_sort(g))
    tp = densify(g, dtype=np.int8, tile_rows=64, tile_cols=64, threshold=3)[0]
    rng = np.random.default_rng(1)
    h0 = torch.from_numpy(rng.standard_normal((g.num_nodes, 24)).astype(np.float32))
    a0 = torch.from_numpy((rng.standard_normal((g.num_nodes, 2)) * 0.1).astype(np.float32))
    a0[5, 1] = big
    res = {}
    for dev in ("cpu", cuda_dev):
        p, h, att = tp.to(dev), h0.to(dev), a0.to(dev)
        shift = bcsr_gat._resolve_shift(p, None, att, 0.2, stabilize)
        before = dict(bcsr_gat.rescued)
        num, den = gat_bcsr_tiles(p, h, att, 0.2, mode=mode, row_shift=shift)
        if stabilize == "bound":
            shift = bcsr_gat._bound_rescue(p, None, att, 0.2, shift, den, None)
            num, den = gat_bcsr_tiles(p, h, att, 0.2, mode=mode, row_shift=shift)
        assert bcsr_gat.rescued["rows"] > before["rows"]
        res[str(dev)] = (num.cpu(), den.cpu())
    torch.cuda.synchronize()
    for got, want, what in zip(res["cuda"], res["cpu"], ("num", "den")):
        _close(got, want, f"{mode} as={big} {stabilize} {what}")


def _residual_plan(dev, block, values):
    g = rmat_graph(3001, 50000, seed=9, with_val=False)
    val = np.random.default_rng(2).uniform(-1.0, 2.0, g.num_edges).astype(np.float32) if values else None
    return g, neighbor_grouping_plan(g, block_size=block, val=val).to(dev)


@pytest.mark.parametrize("block", [1, 3, 4, 8, 32, 33])
@pytest.mark.parametrize("f", [1, 3, 24, 128, 130])
@pytest.mark.parametrize("values", [False, True])
def test_task_sums_kernel_matches_plain(cuda_dev, block, f, values):
    """P1 at residual blocks 1 to 33 (its slot loop whole, in unrolled
    steps of 4 and with a remainder): twice bitwise equal, against its
    plain version."""
    g, plan = _residual_plan(cuda_dev, block, values)
    h = torch.randn((g.n_src, f), generator=torch.Generator(device=cuda_dev).manual_seed(f), device=cuda_dev)
    before = cuda_residual.task_sums_launches
    got = _twice(lambda: dma_task_sums(plan, h))
    assert cuda_residual.task_sums_launches == before + 2
    want = weighted_task_sums(plan, h, plan.val)
    torch.cuda.synchronize()
    _close(got, want, f"task sums B={block} f={f}")
    # an unaligned h (a view one float in) takes the scalar path
    hv = torch.randn((g.n_src * f + 1,), device=cuda_dev)[1:].view(g.n_src, f)
    _close(dma_task_sums(plan, hv), weighted_task_sums(plan, hv, plan.val), f"task sums unaligned f={f}")


@pytest.mark.parametrize("fmt", ["i8", "f32", "bf16"])
@pytest.mark.parametrize("f", [1, 24, 33, 64, 128, 130])
@pytest.mark.parametrize("factored", [False, True])
@pytest.mark.parametrize("h_mode", ["split", "split3"])
def test_fused_hybrid_kernel_matches_plain(cuda_dev, fmt, f, factored, h_mode):
    g = rmat_graph(1237, 60000, seed=3, with_val=False)
    g = g.reorder(degree_sort(g))
    kw = dict(tile_rows=64, tile_cols=64, threshold=3)
    if factored:
        rng = np.random.default_rng(0)
        sd = rng.uniform(0.5, 2.0, g.num_nodes).astype(np.float32)
        ss = rng.uniform(0.5, 2.0, g.n_src).astype(np.float32)
        kw.update(val=sd[g.dst_per_edge] * ss[g.indices], scale_dst=sd, scale_src=ss)
    dtype = {"i8": np.int8, "f32": np.float32, "bf16": torch.bfloat16}[fmt]
    tp, res = densify(g, dtype=dtype, **kw)
    tp = tp.to(cuda_dev)
    plan = neighbor_grouping_plan(res, block_size=4).to(cuda_dev)
    h = torch.randn((g.n_src, f), generator=torch.Generator(device=cuda_dev).manual_seed(f), device=cuda_dev)
    before = (cuda_residual.fused_launches, cuda_bcsr.launches, cuda_residual.task_sums_launches)
    dense, ts = fused_hybrid(tp, plan, h, h_mode)
    assert (cuda_residual.fused_launches, cuda_bcsr.launches, cuda_residual.task_sums_launches) == (
        before[0] + 1, before[1], before[2]
    )
    want_dense, want_ts = fused_hybrid_plain(tp, plan, h, h_mode)
    torch.cuda.synchronize()
    _close(dense, want_dense, f"fused dense {fmt} f={f}")
    _close(ts, want_ts, f"fused task sums {fmt} f={f}")


def test_residual_wrappers_refuse(cuda_dev):
    """A 1-bit plan, CPU tensors and a plan whose n_src disagrees raise."""
    g = rmat_graph(1237, 60000, seed=3, with_val=False)
    tp, res = densify(g, dtype=np.int8, tile_rows=64, tile_cols=64, threshold=3)
    bits = split_bit_tiles(tp)[0]
    plan = neighbor_grouping_plan(res, block_size=4)
    h = torch.randn((g.n_src, 8), device=cuda_dev)
    with pytest.raises(ValueError, match="1-bit"):
        fused_hybrid(bits.to(cuda_dev), plan.to(cuda_dev), h)
    with pytest.raises(ValueError):
        cuda_residual.task_sums_cuda(plan.to("cpu"), h.cpu())
    with pytest.raises(ValueError):
        cuda_residual.fused_hybrid_cuda(tp.to(cuda_dev), plan.to(cuda_dev), h[:-1], h)
    with pytest.raises(ValueError):
        cuda_gat.gat_bcsr_factored_cuda(tp.to(cuda_dev), "twodot", (h,), torch.zeros(g.num_nodes, 4, device=cuda_dev),
                                        torch.zeros(g.n_src, 4, device=cuda_dev))


# ------------------------------------------------- the residual kernel (R1)
def _hub_graph():
    """2,003 rows: row 7 a hub of 3,000 in-edges (its residual spans many
    warps' spans at any block), 500 rows with none, the rest RMAT-like."""
    rng = np.random.default_rng(11)
    n = 2003
    d = np.concatenate([np.full(3000, 7), rng.integers(0, n, 20000)])
    d = d[(d < 1000) | (d >= 1500) | (d == 7)]
    s = rng.integers(0, n, d.shape[0])
    return CSRGraph.from_edges(d, s, n)


def _residual_plans(kind: str):
    """(host plan, graph) of one residual plan kind: neighbor grouping at
    blocks 1, 3, 4, 8, 33 and 200 (spans of one task past 128 slots), a
    plan padded with 57 pad tasks, and a locality plan (not sorted by
    destination)."""
    g = _hub_graph()
    if kind.startswith("ng"):
        return neighbor_grouping_plan(g, block_size=int(kind[2:])), g
    if kind == "padded":
        plan = neighbor_grouping_plan(g, block_size=4, pad_multiple=64)
        assert plan.num_tasks_padded - plan.num_tasks >= 8
        return plan, g
    plan = locality_plan(g, num_partitions=3, block_size=4)
    assert not plan.sorted_by_dst
    return plan, g


def _edge_oracle(g, h, out0, edge_val):
    """float64 out0 + A @ h over the edge list (index_add_)."""
    want = out0.double().cpu()
    contrib = h.double().cpu()[torch.from_numpy(g.indices.astype(np.int64))] * edge_val.double().cpu()[:, None]
    return want.index_add_(0, torch.from_numpy(g.dst_per_edge.astype(np.int64)), contrib)


@pytest.mark.parametrize("kind", ["ng1", "ng3", "ng4", "ng8", "ng33", "ng200", "padded", "locality"])
@pytest.mark.parametrize("f", [128, 64, 32, 33])
@pytest.mark.parametrize("values", [False, True])
def test_residual_spmm_kernel_matches_oracle(cuda_dev, kind, f, values):
    """R1 adds A_plan @ h into out: against a float64 edge-list oracle and
    spmm_plain, with the plan's values or ``val`` given; one launch a call;
    an unaligned h (a view one float in) takes the scalar path."""
    host, g = _residual_plans(kind)
    plan = host.to(cuda_dev)
    gen = torch.Generator(device=cuda_dev).manual_seed(f)
    h = torch.randn((g.n_src, f), generator=gen, device=cuda_dev)
    out0 = torch.randn((g.num_nodes, f), generator=gen, device=cuda_dev)
    if values:
        edge_val = torch.rand((g.num_edges,), generator=gen, device=cuda_dev) * 3.0 - 1.0
        val = slots_from_edge_values_flat(plan, edge_val)
    else:
        edge_val, val = torch.ones((g.num_edges,), device=cuda_dev), None
    before = cuda_residual.launches
    got = residual_spmm_(out0.clone(), plan, h, val=val)
    assert cuda_residual.launches == before + 1
    plain = out0 + spmm_plain(plan, h, val=val)
    torch.cuda.synchronize()
    want = _edge_oracle(g, h, out0, edge_val)
    _close(got.double().cpu(), want, f"R1 {kind} f={f} against float64")
    _close(got, plain, f"R1 {kind} f={f} against spmm_plain")
    hv = torch.randn((g.n_src * f + 1,), generator=gen, device=cuda_dev)[1:].view(g.n_src, f)
    _close(residual_spmm_(out0.clone(), plan, hv, val=val).double().cpu(), _edge_oracle(g, hv, out0, edge_val),
           f"R1 {kind} f={f} unaligned")


def test_residual_spmm_rows_without_residual_keep_out(cuda_dev):
    """Rows with no residual edge keep out's value bitwise (pad tasks, count
    0, add nothing)."""
    host, g = _residual_plans("padded")
    plan = host.to(cuda_dev)
    out0 = torch.randn((g.num_nodes, 64), device=cuda_dev)
    got = residual_spmm_(out0.clone(), plan, torch.randn((g.n_src, 64), device=cuda_dev))
    torch.cuda.synchronize()
    empty = torch.from_numpy(np.diff(g.indptr) == 0).to(cuda_dev)
    assert int(empty.sum()) >= 500
    assert torch.equal(got[empty], out0[empty])


def test_hybrid_spmm_residual_kernel_forward_and_grad(cuda_dev):
    """hybrid_spmm on the card: the residual through R1 once in the forward
    (over the plan) and once in the backward (over the transposed plan),
    forward and h's gradient against float64 autograd through the edge
    list; B1 twice."""
    g = rmat_graph(1237, 60000, seed=3, with_val=False)
    g = g.reorder(degree_sort(g))
    agg = Aggregator.schedule_hybrid(g, tile_dtype=np.int8, tile_rows=64, tile_cols=64, threshold=3, residual_block=4,
                                     pack=1, with_transpose=True, device=cuda_dev)
    assert agg.plan.num_edges > 0 and agg.plan_t.sorted_by_dst
    gen = torch.Generator(device=cuda_dev).manual_seed(4)
    h = torch.randn((g.num_nodes, 64), generator=gen, device=cuda_dev).requires_grad_(True)
    w = torch.randn((g.num_nodes, 64), generator=gen, device=cuda_dev)
    before = (cuda_residual.launches, cuda_bcsr.launches)
    out = agg.run(h)
    assert (cuda_residual.launches - before[0], cuda_bcsr.launches - before[1]) == (1, 1)
    (out * w).sum().backward()
    assert (cuda_residual.launches - before[0], cuda_bcsr.launches - before[1]) == (2, 2)
    torch.cuda.synchronize()
    hd = h.detach().cpu().double().requires_grad_(True)
    d, s = torch.from_numpy(g.dst_per_edge.astype(np.int64)), torch.from_numpy(g.indices.astype(np.int64))
    ref = torch.zeros((g.num_nodes, 64), dtype=torch.float64).index_add(0, d, hd[s])
    (ref * w.cpu().double()).sum().backward()
    _close(out.detach().cpu().double(), ref.detach(), "hybrid_spmm forward")
    _close(h.grad.cpu().double(), hd.grad, "hybrid_spmm dh")


def test_residual_spmm_refuses(cuda_dev):
    """R1 raises on float64 h, an out of the wrong shape, out sharing h's
    memory, a CPU plan, and a tensor that requires grad with grad on."""
    host, g = _residual_plans("ng4")
    plan = host.to(cuda_dev)
    h = torch.randn((g.n_src, 8), device=cuda_dev)
    out = torch.zeros((g.num_nodes, 8), device=cuda_dev)
    with pytest.raises(ValueError):
        residual_spmm_(out.double(), plan, h.double())
    with pytest.raises(ValueError):
        residual_spmm_(out[:-1], plan, h)
    with pytest.raises(ValueError, match="share memory"):
        cuda_residual.residual_spmm_cuda(h, plan, h)
    with pytest.raises(ValueError):
        residual_spmm_(out, host.to("cpu"), h)
    with pytest.raises(RuntimeError, match="requires grad"):
        residual_spmm_(out, plan, h.clone().requires_grad_(True))


# ------------------------------------------------------------ the cell walk
def _walk_host_plan(kind: str, fmt: str):
    """Host plans that stress B1's and B2's work list: 'skewed', one run
    holding every tile with one all-ones tile row; 'tail128', [256, 128]
    tiles (a row pass of 256 columns over 128); 'r200', [200, 64] tiles
    (the 1-bit part at R = 200); 'single_empty', a run of one tile and an
    empty run beside longer runs.  fmt: int8 counts ('i8'), their 1-bit
    part ('b1'), or the counts as float32 / bfloat16 tiles."""
    g = rmat_graph(1237, 60000, seed=3, with_val=False)
    g = g.reorder(degree_sort(g))
    tr, tc = {"tail128": (256, 128), "r200": (200, 64)}.get(kind, (64, 64))
    tp = densify(g, dtype=np.int8, tile_rows=tr, tile_cols=tc, threshold=3)[0]
    if fmt == "b1":
        tp = split_bit_tiles(tp)[0]
    elif fmt != "i8":
        tp = tp.astype({"f32": np.float32, "bf16": "bfloat16"}[fmt])
    a = np.array(tp.a)
    if kind == "skewed":
        a[0, 0, :] = 1  # the all-ones row: row 0 (bit plane 0 of byte row 0 in a 1-bit tile)
        return dataclasses.replace(tp, a=a, tile_row=np.zeros(tp.num_tiles, np.int32),
                                   run_start=np.array([0] + [tp.num_tiles] * tp.num_row_tiles, np.int32))
    if kind == "single_empty":
        rows = np.asarray(tp.tile_row)
        starts = np.asarray(tp.run_start)
        keep = (rows != 1) & ((rows != 2) | (np.arange(tp.num_tiles) == starts[2]))
        new_rows = rows[keep]
        return dataclasses.replace(
            tp, a=a[keep], tile_row=new_rows, tile_col=np.asarray(tp.tile_col)[keep],
            run_start=np.searchsorted(new_rows, np.arange(tp.num_row_tiles + 1)).astype(np.int32),
            num_tiles=int(keep.sum()),
        )
    return tp


@pytest.fixture(params=["chunked", "default"])
def walk_bound(request, monkeypatch):
    """'chunked': a chunk bound of 300 cells, so chunk edges fall inside the
    small plans' runs; 'default': the plan's own bound."""
    if request.param == "chunked":
        from gnn_computing_tpu_torch.ops import cell_walk

        monkeypatch.setattr(cell_walk, "MIN_BOUND", 300)
    return request.param


def _twice(fn):
    """fn() twice: the two results bitwise equal (no atomics in the walk)."""
    first, second = fn(), fn()
    first = first if isinstance(first, tuple) else (first,)
    second = second if isinstance(second, tuple) else (second,)
    for x, y in zip(first, second):
        assert torch.equal(x, y)
    return first if len(first) > 1 else first[0]


@pytest.mark.parametrize("fmt", ["i8", "b1", "f32", "bf16"])
@pytest.mark.parametrize("kind", ["skewed", "tail128", "r200", "single_empty"])
def test_cell_walk_kernels_match_plain(cuda_dev, walk_bound, kind, fmt):
    """B1 (and its w_epilogue) and B2 in every mode over the walk's hard
    plans, against their plain versions (1e-5 * max|plain|; 'default'
    plus one bfloat16 ulp of each rounded score times |h|); each call
    twice, bitwise equal."""
    from gnn_computing_tpu_torch.ops import cell_walk
    from gnn_computing_tpu_torch.ops.fused_nn import bcsr_spmm_nn, bcsr_spmm_nn_plain

    tp = _walk_host_plan(kind, fmt).to(cuda_dev)
    walk = cell_walk.walk_for(tp)
    if kind in ("skewed", "single_empty"):
        starts = tp.run_start.cpu().numpy()
        sizes = np.diff(starts)
        assert (sizes == 0).any() and ((sizes == 1).any() or kind == "skewed")
    if walk_bound == "chunked":
        assert walk.num_multi > 0  # chunk edges inside runs
    gen = torch.Generator(device=cuda_dev).manual_seed(11)
    n = tp.num_nodes
    for f in (1, 32, 64, 100, 128, 160):
        what = f"{kind} {fmt} f{f} {walk_bound}"
        h = torch.randn((tp.n_src, f), generator=gen, device=cuda_dev)
        got = _twice(lambda: cuda_bcsr.bcsr_spmm_cuda(tp, h))
        _close(got, bcsr_spmm_plain(tp, h), f"B1 {what}")
        if f <= 128:
            w = torch.randn((f, 24), generator=gen, device=cuda_dev) * 0.1
            agg, trans = _twice(lambda: bcsr_spmm_nn(tp, h, w))
            want_agg, want_trans = bcsr_spmm_nn_plain(tp, h, w)
            _close(agg, want_agg, f"B1 epilogue agg {what}")
            _close(trans, want_trans, f"B1 epilogue trans {what}")
        att = _att(n, 0.5, gen, cuda_dev)
        row_shift = _hybrid_row_shift(tp, None, att, 0.2)
        for shift in (None, row_shift):
            num, den = _twice(lambda: gat_bcsr(tp, h, att, row_shift=shift))
            ref_num, ref_den = gat_bcsr_plain(tp, h, att, row_shift=shift)
            _close(num, ref_num, f"B2 maxdot num {what}")
            _close(den, ref_den, f"B2 maxdot den {what}")
            num, den = _twice(lambda: gat_bcsr(tp, h, att, row_shift=shift, dot_mode="default"))
            ref_num, ref_den = gat_bcsr_plain(tp, h, att, row_shift=shift, dot_mode="default")
            ulp = 2.0**-7 * gat_bcsr_plain(tp, h.abs(), att, row_shift=shift)[0] * (1 + 2.0**-7)
            assert bool(((num - ref_num).abs() <= 1e-5 * ref_num.abs().max() + ulp).all()), f"default {what}"
            _close(den, ref_den, f"B2 default den {what}")
            for mode in ("twodot", "merged"):
                num, den, need = _twice(lambda: gat_bcsr_factored(tp, h, att, 0.2, mode, 2, shift))
                assert not bool(need.any())
                ref_num, ref_den = _factored_sums(tp, factored_terms(h, att, 0.2, mode, 2, shift), mode)
                _close(num, ref_num, f"B2 {mode} num {what}")
                _close(den, ref_den, f"B2 {mode} den {what}")
    torch.cuda.synchronize()


@pytest.fixture(params=["chunked", "fine", "default"])
def rowmax_dad_bounds(request, monkeypatch):
    """'chunked': a chunk bound of 300 cells; 'fine': the least bound the
    plan takes (a few tiles a chunk), so chunk edges fall inside the small
    plans' runs either way; 'default': the plan's own bound."""
    from gnn_computing_tpu_torch.ops import cell_walk

    if request.param != "default":
        monkeypatch.setattr(cell_walk, "MIN_BOUND", 300 if request.param == "chunked" else 2)
    return request.param


@pytest.mark.parametrize("fmt", ["i8", "b1", "f32", "bf16"])
@pytest.mark.parametrize("kind", ["skewed", "tail128", "r200", "single_empty"])
def test_walk_rowmax_dad_kernels_match_plain(cuda_dev, rowmax_dad_bounds, kind, fmt):
    """B5 and B3 over the walk's hard plans: B5 equal to its plain version
    (-inf rows included), B3 within 1e-5 * max|plain| at f up to 300 (the
    walk's f-slices), with the 'bound' shift and without; each call twice,
    bitwise equal, and one launch a call."""
    from gnn_computing_tpu_torch.ops import cell_walk

    tp = _walk_host_plan(kind, fmt).to(cuda_dev)
    if rowmax_dad_bounds != "default":
        assert cell_walk.walk_for(tp).num_multi > 0  # chunk edges inside runs
    gen = torch.Generator(device=cuda_dev).manual_seed(12)
    n = tp.num_nodes
    for scale in (1.0, 15.0):
        vals = torch.randn(tp.n_src, generator=gen, device=cuda_dev) * scale
        before = cuda_rowmax.launches
        got = _twice(lambda: bcsr_rowmax(tp, vals))
        assert cuda_rowmax.launches == before + 2
        want = bcsr_rowmax_plain(tp, vals)
        assert torch.equal(got, want), f"B5 {kind} {fmt} {rowmax_dad_bounds}"
        assert bool(torch.isneginf(want).any())
    for f in (1, 32, 64, 100, 128, 160, 300):
        h = torch.randn((n, f), generator=gen, device=cuda_dev)
        gbar = torch.randn((n, f), generator=gen, device=cuda_dev)
        c = torch.randn(n, generator=gen, device=cuda_dev)
        for scale, shift in ((0.5, False), (15.0, True)):
            att = torch.randn((n, 2), generator=gen, device=cuda_dev) * scale
            dm, asrc = _score_terms(att, _global_bound_shift(att, 0.2) if shift else None)
            before = cuda_gat_bwd.dad_launches
            got = _twice(lambda: gat_bwd_dad(tp, h, gbar, c, dm, asrc, 0.2))
            assert cuda_gat_bwd.dad_launches == before + 2
            _close(got, gat_bwd_dad_plain(tp, h, gbar, c, dm, asrc, 0.2),
                   f"B3 {kind} {fmt} f{f} scale{scale} {rowmax_dad_bounds}")
    torch.cuda.synchronize()


@pytest.mark.parametrize("fmt", ["i8", "b1", "f32", "bf16"])
@pytest.mark.parametrize("kind", ["skewed", "tail128", "r200", "single_empty"])
def test_walk_dh_das_sddmm_kernels_match_plain(cuda_dev, rowmax_dad_bounds, kind, fmt):
    """B4 on the cell walk over the walk's hard plans (each taken as a
    transposed plan) within 1e-5 * max|plain| of its plain version for dh
    and d_as, at f up to 300 (the walk's f-slices), with the 'bound' shift
    and without; B6 streamed over the same plans, float32 and bfloat16
    cells, against its plain version; each call twice, bitwise equal, and
    one launch a call."""
    from gnn_computing_tpu_torch.ops import cell_walk

    tp = _walk_host_plan(kind, fmt).to(cuda_dev)
    if rowmax_dad_bounds != "default":
        assert cell_walk.walk_for(tp).num_multi > 0  # chunk edges inside runs
    gen = torch.Generator(device=cuda_dev).manual_seed(13)
    n, n_src = tp.num_nodes, tp.n_src
    for f in (1, 32, 64, 100, 128, 160, 300):
        h = torch.randn((n, f), generator=gen, device=cuda_dev)
        gbar = torch.randn((n_src, f), generator=gen, device=cuda_dev)
        c = torch.randn(n_src, generator=gen, device=cuda_dev)
        for scale, shift in ((0.5, False), (15.0, True)):
            att = torch.randn((max(n, n_src), 2), generator=gen, device=cuda_dev) * scale
            dm, asrc = _score_terms(att, _global_bound_shift(att, 0.2) if shift else None)
            args = (h, gbar, c, dm[:n_src].contiguous(), asrc[:n].contiguous(), 0.2)
            before = cuda_gat_bwd.dh_das_launches
            dh, das = _twice(lambda: gat_bwd_dh_das(tp, *args))
            assert cuda_gat_bwd.dh_das_launches == before + 2
            want_dh, want_das = gat_bwd_dh_das_plain(tp, *args)
            what = f"B4 {kind} {fmt} f{f} scale{scale} {rowmax_dad_bounds}"
            _close(dh, want_dh, f"{what} dh")
            _close(das, want_das, f"{what} d_as")
        a = torch.randn((n_src, f), generator=gen, device=cuda_dev)
        b = torch.randn((n, f), generator=gen, device=cuda_dev)
        for out in (torch.float32, torch.bfloat16):
            before = cuda_sddmm.launches
            got = _twice(lambda: sddmm_bcsr(tp, a, b, out_dtype=out))
            assert cuda_sddmm.launches == before + 2
            _sddmm_check(got, sddmm_bcsr_plain(tp, a, b, out), tp.counts() > 0, f"B6 {kind} {fmt} f{f} {out}")
    torch.cuda.synchronize()


@pytest.mark.parametrize("fmt", ["i8", "f32", "bf16"])
@pytest.mark.parametrize("f", [1, 24, 64, 128, 160])
@pytest.mark.parametrize("factored", [False, True])
def test_fused_hybrid_on_cell_walk(cuda_dev, walk_bound, fmt, f, factored):
    """P2 on B1's cell walk: its dense_out bitwise B1's output times
    scale_dst, its task sums bitwise P1's, two calls bitwise equal; at a
    chunk bound of 300 cells (chunk edges inside runs) and the default;
    f = 160 takes the walk's f-slices."""
    from gnn_computing_tpu_torch.ops.bcsr import _post_scale, _pre_scale

    g = rmat_graph(1237, 60000, seed=3, with_val=False)
    g = g.reorder(degree_sort(g))
    kw = dict(tile_rows=64, tile_cols=64, threshold=3)
    if factored:
        rng = np.random.default_rng(0)
        sd = rng.uniform(0.5, 2.0, g.num_nodes).astype(np.float32)
        ss = rng.uniform(0.5, 2.0, g.n_src).astype(np.float32)
        kw.update(val=sd[g.dst_per_edge] * ss[g.indices], scale_dst=sd, scale_src=ss)
    tp, res = densify(g, dtype={"i8": np.int8, "f32": np.float32, "bf16": torch.bfloat16}[fmt], **kw)
    tp = tp.to(cuda_dev)
    plan = neighbor_grouping_plan(res, block_size=4).to(cuda_dev)
    h = torch.randn((g.n_src, f), generator=torch.Generator(device=cuda_dev).manual_seed(f), device=cuda_dev)
    x = _pre_scale(tp, round_h(h, "split")).contiguous()
    before = (cuda_residual.fused_launches, cuda_bcsr.launches, cuda_residual.task_sums_launches)
    dense, ts = _twice(lambda: cuda_residual.fused_hybrid_cuda(tp, plan, x, h))
    assert (cuda_residual.fused_launches, cuda_bcsr.launches, cuda_residual.task_sums_launches) == (
        before[0] + 2, before[1], before[2]
    )
    assert torch.equal(dense, _post_scale(tp, cuda_bcsr.bcsr_spmm_cuda(tp, x)))
    assert torch.equal(ts, cuda_residual.task_sums_cuda(plan, h))
    want_dense, want_ts = fused_hybrid_plain(tp, plan, h)
    torch.cuda.synchronize()
    _close(dense, want_dense, f"P2 dense {fmt} f={f} {walk_bound}")
    _close(ts, want_ts, f"P2 task sums {fmt} f={f}")


# ------------------------------------------------------------ B1's staged walk
def _dense_hub_graph(tr: int):
    """A degree-sorted RMAT graph with a planted dense block: its first tr
    rows to about a third of the first 1,536 columns."""
    g = rmat_graph(3000, 120000, seed=5, with_val=False)
    g = g.reorder(degree_sort(g))
    d, s = np.nonzero(np.random.default_rng(1).random((tr, 1536)) < 0.35)
    return CSRGraph.from_edges(np.concatenate([g.dst_per_edge, d]), np.concatenate([g.indices, s]), g.num_nodes)


@functools.lru_cache(maxsize=None)
def _dense_hub_host_plan(tr: int):
    """int8 [tr, 256] tiles of _dense_hub_graph: a hub run of dense tiles
    cut into several chunks beside sparse runs, pad_runs(16) fillers."""
    return densify(_dense_hub_graph(tr), dtype=np.int8, tile_rows=tr, tile_cols=256, threshold=3)[0].pad_runs(16)


@functools.lru_cache(maxsize=None)
def _quick_int8_parts():
    """The int8 parts of the benchmark's reddit plans at the quick scale
    (RMAT 65,536 v / 4,194,304 e, seed 123, degree sorted): the training
    plan [256, 256] t24 and its transpose, the forward plan [512, 256]
    t48, each split into 1-bit and int8 parts before pad_runs(16)."""
    g = rmat_graph(1 << 16, 1 << 22, seed=123, with_val=False)
    g = g.reorder(degree_sort(g))
    train = split_bit_tiles(densify(g, dtype=np.int8, tile_rows=256, tile_cols=256, threshold=24)[0])[1]
    fwd = split_bit_tiles(densify(g, dtype=np.int8, tile_rows=512, tile_cols=256, threshold=48)[0])[1]
    return {"quick training": train.pad_runs(16), "quick training, transposed": train.transpose().pad_runs(16),
            "quick forward": fwd.pad_runs(16)}


STAGED_PLANS = {
    "dense hub [256, 256]": lambda: _dense_hub_host_plan(256),
    "dense hub [512, 256]": lambda: _dense_hub_host_plan(512),
    **{k: (lambda k=k: _quick_int8_parts()[k]) for k in ("quick training", "quick training, transposed",
                                                          "quick forward")},
}


def _b1_oracle64(tp, h):
    """A @ h in float64 over the plan's tiles, [num_nodes, f]."""
    r, c, f = tp.tile_rows, tp.tile_cols, h.shape[1]
    hp = torch.zeros((tp.num_col_tiles * c, f), dtype=torch.float64, device=h.device)
    hp[: tp.n_src] = h.double()
    hp = hp.reshape(tp.num_col_tiles, c, f)
    out = torch.zeros((tp.num_row_tiles, r, f), dtype=torch.float64, device=h.device)
    for t0 in range(0, tp.num_tiles, 256):
        sl = slice(t0, t0 + 256)
        out.index_add_(0, tp.tile_row[sl].long(), torch.bmm(tp.counts(t0, t0 + 256).double(),
                                                             hp[tp.tile_col[sl].long()]))
    return out.reshape(-1, f)[: tp.num_nodes]


@pytest.mark.parametrize("kind", sorted(STAGED_PLANS))
def test_b1_staged_walk_equals_gather_walk(cuda_dev, monkeypatch, kind):
    """B1 and its w_epilogue with the plan's staged chunks staged (the
    launch's rule, cell_walk.stages, set to stage) bitwise equal to the
    same chunks walked by gathers (set not to), at f = 32, 64, 121 (the
    scalar path), 128 and 256 (two f-slices); every call twice, bitwise
    equal; one B1 launch a call either way; both within 1e-5 * max|oracle|
    of the float64 product; the plan's own launch bitwise the same."""
    from gnn_computing_tpu_torch.ops import cell_walk
    from gnn_computing_tpu_torch.ops.fused_nn import bcsr_spmm_nn

    tp = STAGED_PLANS[kind]().to(cuda_dev)
    walk = cell_walk.walk_for(tp)
    assert walk.num_staged > 0
    if kind.startswith("dense"):
        assert walk.num_multi > 0  # the hub run is cut into chunks
    rule = cell_walk.stages
    gen = torch.Generator(device=cuda_dev).manual_seed(5)
    for f in (32, 64, 121, 128, 256):
        h = torch.randn((tp.n_src, f), generator=gen, device=cuda_dev)
        w = torch.randn((f, 24), generator=gen, device=cuda_dev) * 0.1
        own = cuda_bcsr.bcsr_spmm_cuda(tp, h)
        outs = {}
        for path in ("staged", "gather"):
            monkeypatch.setattr(cell_walk, "stages", lambda *a, staged=path == "staged": staged)
            before = (cuda_bcsr.launches, cuda_bcsr.epilogue_launches)
            outs[path] = [_twice(lambda: cuda_bcsr.bcsr_spmm_cuda(tp, h))]
            if f <= 128:
                outs[path] += list(_twice(lambda: bcsr_spmm_nn(tp, h, w)))
            assert cuda_bcsr.launches == before[0] + 2 + 2 * (f <= 128)
            assert cuda_bcsr.epilogue_launches == before[1] + 2 * (f <= 128)
        monkeypatch.setattr(cell_walk, "stages", rule)
        for got, want in zip(outs["staged"], outs["gather"]):
            assert torch.equal(got, want), f"{kind} f={f}: the staged walk differs from the gather walk"
        assert torch.equal(own, outs["gather"][0])
        _close(outs["staged"][0], _b1_oracle64(tp, h).float(), f"B1 staged {kind} f={f}")
    torch.cuda.synchronize()


def test_b1_counts_staged_cells(cuda_dev, monkeypatch):
    """walk.cells and walk.staged_cells a B1 launch, from the cached list:
    the dense plan's int8 part stages cells where the launch stages them
    (cell_walk.stages set to stage), none where it does not; its 1-bit part
    none."""
    from gnn_computing_tpu_torch.ops import cell_walk
    from gnn_computing_tpu_torch.utils.profiling import recording

    bits, rest = split_bit_tiles(densify(_dense_hub_graph(256), dtype=np.int8, tile_rows=256, tile_cols=256,
                                         threshold=3)[0])
    for part, staged in ((rest, True), (bits, False)):
        tp = part.to(cuda_dev)
        walk = cell_walk.walk_for(tp)
        h = torch.randn((tp.n_src, 64), device=cuda_dev)
        with recording() as rec:
            for stage in (True, False):
                monkeypatch.setattr(cell_walk, "stages", lambda *a, stage=stage: stage)
                cuda_bcsr.bcsr_spmm_cuda(tp, h)
        assert rec.counters["walk.cells"] == 2 * walk.total_cells > 0
        assert rec.counters["walk.staged_cells"] == walk.staged_cells
        assert (walk.staged_cells > 0) == staged
    torch.cuda.synchronize()


def _gather_graph(sched):
    """An RMAT graph with edge values; for 'nop' (one task a row) a graph of
    16 in-neighbours a node, from a numpy seed."""
    if sched == "nop":
        rng = np.random.default_rng(5)
        n = 1237
        return CSRGraph(np.arange(n + 1) * 16, rng.integers(0, n, n * 16), val=rng.standard_normal(n * 16))
    return rmat_graph(1237, 60000, seed=3, with_val=True)


@pytest.mark.parametrize("sched,kw", [
    ("neighbor_grouping", dict(block_size=32)),
    ("locality_neighbor_grouping", dict(num_partitions=8, block_size=32)),
    ("nop", {}),
], ids=["ng32", "lasng32", "nop"])
def test_gather_path_on_card_matches_cpu(cuda_dev, sched, kw):
    """The gather-only path on the card against the same calls on the CPU:
    spmm and sddmm (slots and edges) in every gather mode, gat_aggregate
    (stabilize False and True), and the gradients of spmm_bidir (h and the
    slot values, through Aggregator.run) and of run_gat, the card's and the
    CPU's each within 1e-5 * max|ref| of float64 autograd over the same
    plan.  No kernel launches on this path."""
    g = _gather_graph(sched)
    cpu = Aggregator.schedule(g, sched, with_transpose=True, device="cpu", **kw)
    card = cpu.to(cuda_dev)
    rng = np.random.default_rng(1)
    h0, a0, b0, ct0 = (torch.from_numpy(rng.standard_normal((g.num_nodes, f)).astype(np.float32))
                       for f in (40, 24, 24, 40))
    att0 = torch.from_numpy(rng.standard_normal((g.num_nodes, 2)).astype(np.float32))
    ev = torch.from_numpy(g.val)
    before = (cuda_bcsr.launches, cuda_gat.launches, cuda_rowmax.launches, cuda_sddmm.launches)
    for mode in (None, "f16_split2", "bf16_split2", torch.bfloat16, torch.float16):
        want = spmm_plain(cpu.plan, h0, gather_dtype=mode)
        _close(spmm_plain(card.plan, h0.to(cuda_dev), gather_dtype=mode).cpu(), want, f"spmm {sched} {mode}")
        for output in ("slots", "edges"):
            want = sddmm(cpu.plan, a0, b0, output=output, gather_dtype=mode)
            got = sddmm(card.plan, a0.to(cuda_dev), b0.to(cuda_dev), output=output, gather_dtype=mode)
            _close(got.cpu(), want, f"sddmm {output} {sched} {mode}")
    for stabilize in (False, True):
        want = gat_aggregate(cpu.plan, h0, att0, stabilize=stabilize)
        got = gat_aggregate(card.plan, h0.to(cuda_dev), att0.to(cuda_dev), stabilize=stabilize)
        _close(got.cpu(), want, f"gat_aggregate {sched} {stabilize}")
    # the gradients on the card and on the CPU (float32), each held to the
    # float64 oracle of the same function: CPU autograd in double over the
    # same plan.  Card against CPU would also compare two float32 sum orders
    # (index_add_'s atomics on the card sum a hub row in any order).
    grads = {}
    for agg, dev, dtype, key in (
        (cpu, "cpu", torch.float64, "oracle"), (cpu, "cpu", torch.float32, "cpu"), (card, cuda_dev, torch.float32, "card")
    ):
        h = h0.to(dev, dtype, copy=True).requires_grad_(True)
        val = agg.slot_values(ev.to(dev, dtype)).requires_grad_(True)
        ct = ct0.to(dev, dtype)
        (agg.run(h, val=val, val_t=agg.transposed_val(ev.to(dev, dtype))) * ct).sum().backward()
        dh, dval = h.grad.cpu(), val.grad.cpu()
        h.grad = None
        att = att0.to(dev, dtype, copy=True).requires_grad_(True)
        (agg.run_gat(h, att, stabilize=True) * ct).sum().backward()
        grads[key] = (dh, dval, h.grad.cpu(), att.grad.cpu())
    torch.cuda.synchronize()
    for key in ("card", "cpu"):
        for got, want, what in zip(grads[key], grads["oracle"], ("spmm_bidir dh", "dval", "run_gat dh", "datt")):
            _close(got.double(), want, f"{what} {sched} {key} vs float64")
    assert (cuda_bcsr.launches, cuda_gat.launches, cuda_rowmax.launches, cuda_sddmm.launches) == before


def _lstm_f64(params, x, nbr, gx_all=None):
    """The LSTM's step loop (slabs [i, f, o, c~]) in float64 on the CPU."""
    wx, wh, b = (p.detach().cpu().double() for p in params)
    x, nbr = x.cpu().double(), nbr.cpu().long()
    f = wh.shape[0]
    h = torch.zeros((nbr.shape[0], f), dtype=torch.float64)
    c = torch.zeros_like(h)
    gx_all = x @ wx if gx_all is None else gx_all.cpu().double()
    for t in range(nbr.shape[1]):
        z = gx_all[nbr[:, t]] + h @ wh + b
        i, fg, o = (torch.sigmoid(z[:, s * f : (s + 1) * f]) for s in range(3))
        c = fg * c + i * torch.tanh(z[:, 3 * f :])
        h = o * torch.tanh(c)
    return h


def _all_launches():
    return (cuda_bcsr.launches, cuda_gat.launches, cuda_rowmax.launches, cuda_sddmm.launches,
            cuda_gat_bwd.dad_launches, cuda_gat_bwd.dh_das_launches, cuda_residual.task_sums_launches,
            cuda_residual.fused_launches, cuda_residual.launches)


@pytest.mark.parametrize("strategy,gdt", [
    ("redundancy_bypass", None), ("redundancy_bypass", torch.float16), ("sparse_fetch", None), ("materialize", None),
], ids=["bypass", "bypass_f16", "sparse_fetch", "materialize"])
def test_sage_lstm_on_card_matches_cpu(cuda_dev, strategy, gdt):
    """chip_smoke phase 44 at a small size: lstm_aggregate on the card
    against the CPU (1e-5 * max|cpu|) and the float64 oracle (the gate, 0
    bad; float16 gates against the oracle of their rounding), the layer,
    gradients against the CPU's (1e-4 relative L2; float16 gates 1e-2, the
    two devices' gate rows may round apart), and cuDNN's LSTM (slabs
    permuted) within the gate of the port.  No kernel launches."""
    g = rmat_graph(1237, 20000, seed=3, with_val=False)
    nbr = torch.from_numpy(presample_fixed_neighbors(g, k=16, seed=2))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((g.num_nodes, 32)).astype(np.float32) * 0.1)
    sp = init_sage_lstm_params(32, 32, 32, torch.Generator().manual_seed(0), device="cpu")
    before = _all_launches()
    want = lstm_aggregate(sp.lstm, x, nbr, strategy, gate_gather_dtype=gdt)
    card = LSTMParams(*(t.to(cuda_dev) for t in sp.lstm))
    got = lstm_aggregate(card, x.to(cuda_dev), nbr.to(cuda_dev), strategy, gate_gather_dtype=gdt)
    if gdt is None:
        _close(got.cpu(), want, f"lstm {strategy}")
        gx = None
    else:
        # the card's and the CPU's float32 gate rows may round to
        # neighbouring float16 values: the gate against the CPU, 0 bad
        # against the oracle of the card's own rounding
        assert relative_error_count(got, want) == 0
        gx = (x.to(cuda_dev) @ card.wx).to(gdt)
    assert relative_error_count(got, _lstm_f64(sp.lstm, x, nbr, gx)) == 0
    layer = sage_lstm_layer(sp._replace(lstm=card, w_self=sp.w_self.to(cuda_dev), w_out=sp.w_out.to(cuda_dev)),
                            x.to(cuda_dev), nbr.to(cuda_dev), strategy)
    _close(layer.cpu(), sage_lstm_layer(sp, x, nbr, strategy), f"sage_lstm_layer {strategy}")
    grads = []
    for dev in ("cpu", cuda_dev):
        leaves = [t.to(dev, copy=True).requires_grad_(True) for t in sp.lstm]
        xd = x.to(dev, copy=True).requires_grad_(True)
        lstm_aggregate(LSTMParams(*leaves), xd, nbr.to(dev), strategy, gate_gather_dtype=gdt).square().sum().backward()
        grads.append([t.grad.cpu().double() for t in (*leaves, xd)])
    for a, b in zip(*grads):
        assert (a - b).norm() <= (1e-4 if gdt is None else 1e-2) * a.norm()
    if strategy == "redundancy_bypass" and gdt is None:
        f = 32
        idx = torch.cat([torch.arange(s * f, (s + 1) * f) for s in (0, 1, 3, 2)])
        lstm = torch.nn.LSTM(32, f, batch_first=True)
        with torch.no_grad():
            lstm.weight_ih_l0.copy_(sp.lstm.wx[:, idx].t())
            lstm.weight_hh_l0.copy_(sp.lstm.wh[:, idx].t())
            lstm.bias_ih_l0.copy_(sp.lstm.b[idx])
            lstm.bias_hh_l0.zero_()
            h_cudnn = lstm.to(cuda_dev)(x.to(cuda_dev)[nbr.to(cuda_dev).long()])[1][0][0]
        assert relative_error_count(h_cudnn, got) == 0
    torch.cuda.synchronize()
    assert _all_launches() == before


@pytest.mark.parametrize("sched,kw", [
    ("neighbor_grouping", dict(block_size=32)),
    ("locality_neighbor_grouping", dict(num_partitions=8, block_size=32)),
    ("nop", {}),
], ids=["ng32", "lasng32", "nop"])
def test_edge_mlp_on_card_matches_cpu(cuda_dev, sched, kw):
    """chip_smoke phase 45 at a small size: edge_mlp and edge_mlp_chunked
    (a chunk that does not divide the task count) on the card against the
    CPU and edge_mlp_dense (the gate, 0 bad), and their gradients against
    the CPU's.  No kernel launches."""
    g = _gather_graph(sched)
    plan = Aggregator.schedule(g, sched, with_transpose=False, device="cpu", **kw).plan
    card = plan.to(cuda_dev)
    rng = np.random.default_rng(4)
    h = torch.from_numpy(rng.standard_normal((g.num_nodes, 32)).astype(np.float32) * 0.1)
    w = torch.from_numpy(rng.standard_normal((32, 32)).astype(np.float32) * 0.1)
    ref = edge_mlp_dense(g, h.numpy(), w.numpy())
    before = _all_launches()
    for fn in (edge_mlp, functools.partial(edge_mlp_chunked, chunk_tasks=37)):
        want = fn(plan, h, w)
        got = fn(card, h.to(cuda_dev), w.to(cuda_dev))
        _close(got.cpu(), want, f"edge mlp {sched}")
        assert relative_error_count(got, ref) == 0
        grads = []
        for p, dev in ((plan, "cpu"), (card, cuda_dev)):
            hd, wd = h.to(dev, copy=True).requires_grad_(True), w.to(dev, copy=True).requires_grad_(True)
            fn(p, hd, wd).square().sum().backward()
            grads.append((hd.grad.cpu().double(), wd.grad.cpu().double()))
        for a, b in zip(*grads):
            assert (a - b).norm() <= 1e-4 * a.norm()
    torch.cuda.synchronize()
    assert _all_launches() == before


def test_cli_tune_on_card_launches_b1(cuda_dev, capsys):
    """The CLI's tune on the card (chip_smoke phase 49 at a small size): its
    table lists every gather and hybrid candidate in the JAX order, each
    with a positive time, and the hybrid candidates ran B1 (bfloat16 tiles:
    the graph is weighted, so int8 is skipped, as in the JAX package)."""
    import json

    from gnn_computing_tpu_torch.utils.cli import main as cli_main

    b1, b1_float = cuda_bcsr.launches, cuda_bcsr.float_launches
    cli_main(["tune", "--syn", "rmat:4096:60000", "--feature-len", "32", "--iters", "2"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    configs = [{k: v for k, v in r.items() if k != "seconds"} for r in out["table"]]
    assert configs == [{"block_size": b, "strategy": "gather"} for b in (8, 16, 32, 64)] + [
        {"tile_rows": r, "threshold": t, "tile_dtype": "bf16", "strategy": "hybrid"}
        for r in (256, 512) for t in (16, 24, 48)
    ]
    assert all(r["seconds"] > 0 for r in out["table"])
    assert cuda_bcsr.launches > b1 and cuda_bcsr.float_launches - b1_float == cuda_bcsr.launches - b1


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_decompose_on_card(cuda_dev, model):
    """profiling.decompose on the card over an int8 hybrid aggregator: every
    phase present with a finite positive time, B1 (GCN) or B2 (GAT) launched
    by the dense phase, and the analytic block equal to plan_cost and
    tile_cost."""
    from gnn_computing_tpu_torch.utils.profiling import decompose, plan_cost, tile_cost

    g = rmat_graph(4096, 60000, seed=5, with_val=False)
    g = g.reorder(degree_sort(g))
    agg = Aggregator.schedule_hybrid(g, tile_rows=64, tile_cols=128, threshold=8, residual_block=4,
                                     tile_dtype=np.int8, with_transpose=False, pack=1, device=cuda_dev)
    gen = torch.Generator(device=cuda_dev).manual_seed(1)
    h = torch.rand((g.num_nodes, 32), generator=gen, device=cuda_dev)
    att = torch.randn((g.num_nodes, 2), generator=gen, device=cuda_dev) * 0.1
    before = (cuda_bcsr.launches, cuda_gat.launches)
    out = decompose(agg, h, model=model, att=att, iters=2, reps=2)
    phases = ("dense", "residual", "residual_floor", "transform") + (("total",) if model == "gcn" else ())
    for phase in phases:
        assert np.isfinite(out[phase]["ms"]) and out[phase]["ms"] > 0, phase
    launched = (cuda_bcsr.launches - before[0], cuda_gat.launches - before[1])
    assert launched[0 if model == "gcn" else 1] > 0 and launched[1 if model == "gcn" else 0] == 0
    assert out["analytic"] == {"plan": plan_cost(agg.plan, 32), "tile": [tile_cost(agg.tile, 32)]}


def test_allgather_bodies_on_card_match_cpu(cuda_dev):
    """The all-gather hybrid's D = 4 rank bodies (parallel.allgather_tiles)
    on the card against the same bodies on the CPU (plain versions): the
    GCN forward within 1e-5 * max|cpu| and the weight gradients (B1 over the
    groups' transposes in the backward) within 1e-4 relative L2; B1
    launched once a non-empty (rank, group) view and layer each way."""
    from gnn_computing_tpu_torch.graph import normal_features
    from gnn_computing_tpu_torch.models.gcn import glorot_weights
    from gnn_computing_tpu_torch.parallel.allgather_tiles import (
        allgather_hybrid_gcn_forward_bodies,
        build_allgather_hybrid,
    )

    g = rmat_graph(3000, 80000, seed=9, with_val=False)
    plan, gp = build_allgather_hybrid(g, 4, tile_rows=64, tile_cols=128, threshold=4, with_transpose=True)
    h = np.zeros((gp.num_nodes, 16), np.float32)
    h[: g.num_nodes] = normal_features(g.num_nodes, 16, seed=5) * 0.1
    ct = np.random.default_rng(3).standard_normal((gp.num_nodes, 8)).astype(np.float32)
    res = {}
    for dev in ("cpu", cuda_dev):
        views = [plan.shard(r, dev) for r in range(4)]
        ws = [torch.from_numpy(w).to(dev).requires_grad_(True) for w in glorot_weights((16, 16, 8), seed=4)]
        before = (cuda_bcsr.launches, cuda_bcsr.bits_launches)
        out = allgather_hybrid_gcn_forward_bodies(views, ws, torch.from_numpy(h).to(dev))
        (out * torch.from_numpy(ct).to(dev)).sum().backward()
        torch.cuda.synchronize()
        res[str(dev)] = out.detach().cpu(), [w.grad.cpu() for w in ws]
        launched = (cuda_bcsr.launches - before[0], cuda_bcsr.bits_launches - before[1])
        groups = sum(len(v.groups) for v in views)
        bits = sum(tp.bits for v in views for tp, _, _ in v.groups)
        assert launched == ((0, 0) if dev == "cpu" else (2 * 2 * groups, 2 * 2 * bits))
    (out_c, g_c), (out_d, g_d) = res["cpu"], res["cuda"]
    assert (out_d - out_c).abs().max() <= 1e-5 * out_c.abs().max()
    for a, b in zip(g_d, g_c):
        assert float((a.double() - b.double()).norm() / b.double().norm()) <= 1e-4


def test_dryrun_in_an_nccl_world_of_one(cuda_dev):
    """multichip.dryrun_multichip(1): a spawned NCCL world of one runs the
    dry run's training step through every distributed path on the card;
    its loss and weight gradients against the D = 1 step's rank bodies on
    the CPU (1e-5 relative, 1e-4 relative L2)."""
    from gnn_computing_tpu_torch import multichip

    out = multichip.dryrun_multichip(1, device="cuda", arxiv=False, timeout=600)[0]
    prob = multichip.toy_problem(1)
    params = multichip.toy_params("cpu")
    loss = multichip.toy_loss_bodies(prob, params, "cpu")
    loss.backward()
    assert abs(out["loss"] - float(loss)) <= 1e-5 * abs(float(loss))
    for p, g in zip(params, out["grads"]):
        assert float(np.linalg.norm(g - p.grad.numpy()) / np.linalg.norm(p.grad.numpy())) <= 1e-4


def test_fig7_main_on_card(cuda_dev, tmp_path):
    """The figure harness's fig7 (gnn_computing_tpu_torch/benchmarks) at
    --quick on the card: its three rows name the card, hold finite times >
    0, and its timed forwards ran B1 3 times and B2 3 times a call (the
    chained harness: 9 iters calls each), and R1 once a GCN call for each
    layer whose residual rows are float32 (fast_layer_opts: the others
    keep the ATen loop), no other kernel."""
    import json
    import math

    from gnn_computing_tpu_torch.benchmarks import fig7_models
    from gnn_computing_tpu_torch.models.gcn import BENCH_DIMS, fast_layer_opts
    from gnn_computing_tpu_torch.ops.spmm import kernel_takes

    before = _all_launches()
    b1, b2, r0 = cuda_bcsr.launches, cuda_gat.launches, cuda_residual.launches
    iters = 2
    fig7_models.main(["--quick", "--iters", str(iters), "--results-dir", str(tmp_path)])
    torch.cuda.synchronize()
    rows = [json.loads(line) for line in (tmp_path / "fig7.jsonl").read_text().splitlines()]
    assert [r["model"] for r in rows] == ["GCN", "GAT", "SAGE-LSTM"]
    for r in rows:
        assert r["dataset"] == "rmat_quick" and r["device"].startswith(torch.cuda.get_device_name(0))
        assert math.isfinite(r["seconds"]) and r["seconds"] > 0 and r["edges_per_s"] > 0
    calls = 9 * iters
    r1 = sum(kernel_takes(cuda_dev, o.residual_gather_dtype) for o in fast_layer_opts(BENCH_DIMS))
    assert r1 == 1
    assert (cuda_bcsr.launches - b1, cuda_gat.launches - b2, cuda_residual.launches - r0) == (
        3 * calls, 3 * calls, r1 * calls)
    assert sum(_all_launches()) - sum(before) == (6 + r1) * calls
