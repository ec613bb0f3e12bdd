#!/usr/bin/env python3
"""Chip check of the PyTorch port (gnn_computing_tpu_torch) on one CUDA card.

Run from the repository root:  python3 chip_smoke.py [--scale quick|reddit]

Phases (any failure exits non-zero; nothing is caught):
  1. card name and power limit; build every kernel with nvcc (sm_90a), one
     nvcc per source, all at once (B1 bcsr_spmm, B2 gat_bcsr, B5 rowmax_bcsr,
     B3 gat_bwd_dad, B4 gat_bwd_dh_das, B6 sddmm_bcsr).
  2. kernel phase: the B1 kernel against its plain PyTorch version on the
     card, at the main path's shapes (f = 128, 64, 32; 'split' and float32
     operands; pack 1 and 16), plus a ragged n with runs made only of filler
     tiles and a factored plan.  Check: max|kernel - plain| <= 1e-5 *
     max|plain| on nonnegative and signed operands, and the ops/validate
     gate on the nonnegative ones.
  3. slice phase: the main path of bench.py — RMAT graph (seed 123, degree
     sorted), int8 [512, 256] tiles at threshold 48, 4-slot residual, the
     3-layer 512 -> 128 -> 64 -> 32 GCN forward with fast_layer_opts and
     Glorot weights (numpy seed 0) carried through convert.py.  Five
     forwards; B1 must launch 3 times per forward.  Each layer's
     aggregation must pass the gate against a float64 edge-list oracle
     (index_add_) of the function its numeric modes define, from the same
     transform output; against the
     unrounded oracle, per layer and for the whole chain, at most
     PURE_BAD_FRACTION of the elements may miss the gate.
  4. timing (CUDA events, median): forward and per-layer ms; per layer
     shape B1 ms, its bound, the plain version's ms and torch.sparse.mm of
     the same tile edges (library_ms, a yardstick the port never calls).
  5. GAT kernel phase: on the GAT plan (threshold 32; pack 1 and 16) at
     f = 128, 64, 32, B2 against gat_bcsr_plain with att at scale 0.1
     (unshifted and with the exact row shift) and 15 (shifted), and B5
     against bcsr_rowmax_plain; plus a ragged raw-count plan with a
     filler-only run.  Check: num max|d| <= 1e-5 * max|plain|, den the same
     and the gate, B5 exactly equal (-inf rows included).
  6. GAT slice phase: bench.py --model gat's path — the same graph, int8
     [512, 256] tiles at threshold 32, 4-slot residual, the 3-layer
     512 -> 128 -> 64 -> 32 GAT forward (fast=True, dot_mode='split2',
     un-stabilized) with glorot_gat_weights (seed 0) through convert.py.
     Five forwards; B2 must launch 3 times per forward and B5 never.  Each
     layer, from its own float32 input, passes the gate against a float64
     edge-list oracle with 0 bad elements; the whole chain is bounded as the
     GCN's.  Then one stabilize=True forward (its own path: B5 must launch 3
     times) and one stabilize='bound' forward; both pass the gate against
     the un-stabilized output.
  7. GAT timing: forward, stabilized forward and per-layer ms; per layer B2
     and B5 ms per launch, bound, plain ms and a library yardstick (B2:
     torch.sparse.mm of the tile cells' score CSR, built outside the timed
     call, against [h | 1]; B5: index_select + scatter_reduce 'amax' over
     the cell list).
  8. training kernel phase (quick scale): on bench.py --train's plan — the
     same graph, int8 [256, 256] tiles at threshold 24, 4-slot residual,
     pack 1 and 16, with its transposed plan — at f = 128, 64, 32: B3
     (gat_bwd_dad) against gat_bwd_dad_plain and B4 (gat_bwd_dh_das)
     against gat_bwd_dh_das_plain with att at scale 0.1 unshifted and at
     scale 15 with the 'bound' shift; B1 over the transposed plan and B2 at
     [256, 256] against their plain versions; a ragged raw-count plan with a
     filler-only run, and its transpose.  Check: max|d| <= 1e-5 * max|ref|.
  9. GCN training: make_train_step over the exact GCN forward
     (512 -> 128 -> 64 -> 32, glorot_weights through convert.py, bench.py's
     features and labels, torch.optim.Adam(1e-3)).  At the initial weights,
     per layer from its own float32 input and a cos(arange) cotangent, the
     aggregation's input gradient passes the gate against float64 autograd
     through an index_add_ edge-list oracle (at most PURE_BAD_FRACTION bad),
     and each weight gradient of the whole step is within GRAD_REL_L2
     (relative L2) of the float64 edge-list chain's.  Five steps: B1 must
     launch 6 times per step (3 forward, 3 backward), no GAT kernel; the
     loss stays finite.
 10. GAT training: the same with gat_forward(fast=False, stabilize='bound',
     dot_mode='split2') and glorot_gat_weights; the per-layer check is on
     (dh, datt) against float64 autograd of the edge-list GAT oracle; for
     edges within KINK of leaky-relu's kink (where float32 and float64 may
     take different sides) the oracles take the port's side.  Five
     steps: B2, B3 and B4 must launch 3 times per step each, B5 never.
 11. training timing: train-step, forward and backward + Adam ms, per layer
     forward and backward ms; B3 and B4 ms per launch at each f against
     their bound, plain ms and a library yardstick (B3:
     torch.sparse.sampled_addmm of gbar h^T on the cells' CSR, then the
     weighted row sum; B4: torch.sparse.mm of the transposed score CSR
     against gbar plus the same sampled product on the transposed pattern;
     the CSRs are built outside the timed call); B1 over the transposed
     plan and B2 at [256, 256], the same four numbers.
 12. SDDMM kernel phase: on bench.py --model sddmm's plan (the same graph,
     [256, 128] tiles at threshold 24 split into a 1-bit and an int8 part,
     4-slot residual), at pack 1 and 16 and f = 128, 64, 32, B6 against
     sddmm_bcsr_plain on N(0, 1) a and b, float32 and bfloat16 cells; plus a
     ragged raw-count plan with a filler-only run (whole and split), a
     1-bit plan with R = 200, and a non-edge whose dot is inf.  Check:
     float32 max|d| <= 1e-5 * max|plain|, bfloat16 at most one ulp apart,
     cells without an edge exactly +0.
 13. SDDMM slice phase: bench.py's path — hybrid_sddmm at f = 32 with
     a = normal_features(seed 3) * 0.1, b = (seed 4) * 0.1, split23 dots,
     a f16_split2 residual, bfloat16 cells.  Five calls; B6 must launch once
     per part per call.  Every edge maps through its part's (row-tile,
     col-tile) -> tile index to a cell whose value passes the gate against
     the float64 dot; every cell without an edge is +0; every residual edge
     passes the gate; dense + residual edges = m (checked in chunks).
 14. 1-bit GCN phase: phase 3's plan split by split_bit_tiles; B1 over the
     1-bit part against its plain version (pack 1 and 16, a ragged factored
     plan's 1-bit part), then five forwards: B1 must launch 6 times per
     forward (3 layers x 2 parts); phase 3's per-layer gates, and the output
     passes the gate against phase 3's int8 forward.
 15. timing: the SDDMM path's ms and edges/s (bench.py's metric m / t), B6
     ms per launch per part (pack 1 and 16) against its bound, its plain
     version and torch.sparse.sampled_addmm of b a^T on the nonzero cells'
     CSR (built outside the timed call), the residual's ms; the 1-bit GCN
     forward, and per layer B1 over the 1-bit part against its bound, plain
     version and torch.sparse.mm, beside B1 over the int8 part and over the
     unsplit plan.
 16. one "kernels" JSON line, the card line, then {"ok": true, ...}.

Launch counts: every count is set to 0 just before a path is driven and
read just after it (the GCN forward for B1, the GAT forward for B2, the
stabilized GAT forward for B5, five GCN training steps for B1, five GAT
training steps for B2, B3 and B4, five SDDMM calls for B6, five 1-bit GCN
forwards for B1); launches made to compare a kernel with its plain version
are not counted.  The training phases run at the quick scale only (their
float64 oracles hold the whole edge list in memory).

The port schedules with pack=1: the CUDA kernels take runs of any length,
so the TPU kernel's filler tiles would only add work (their cost is printed).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

from gnn_computing_tpu_torch.aggregator import Aggregator
from gnn_computing_tpu_torch.convert import gat_params_from_jax, gcn_params_from_jax
from gnn_computing_tpu_torch.graph import CSRGraph, degree_sort, normal_features, rmat_graph
from gnn_computing_tpu_torch.models.gat import gat_forward, glorot_gat_weights
from gnn_computing_tpu_torch.models.gcn import BENCH_DIMS, fast_layer_opts, gcn_layer, glorot_weights
from gnn_computing_tpu_torch.models.training import make_train_step, softmax_xent
from gnn_computing_tpu_torch.ops import cuda_bcsr, cuda_build, cuda_gat, cuda_gat_bwd, cuda_rowmax, cuda_sddmm
from gnn_computing_tpu_torch.ops.bcsr import bcsr_rowmax, bcsr_rowmax_plain, bcsr_spmm, bcsr_spmm_plain, round_h
from gnn_computing_tpu_torch.ops.bcsr_gat import (
    _branch_factors,
    _global_bound_shift,
    _hybrid_row_shift,
    gat_bcsr,
    gat_bcsr_plain,
    gat_bwd_dad,
    gat_bwd_dad_plain,
    gat_bwd_dh_das,
    gat_bwd_dh_das_plain,
)
from gnn_computing_tpu_torch.ops.bcsr_sddmm import hybrid_sddmm, sddmm_bcsr, sddmm_bcsr_plain
from gnn_computing_tpu_torch.ops.gat import DEFAULT_SLOPE
from gnn_computing_tpu_torch.ops.spmm import sddmm_slots
from gnn_computing_tpu_torch.ops.validate import relative_error_count
from gnn_computing_tpu_torch.schedule.tiles import densify, split_bit_tiles
from gnn_computing_tpu_torch.utils.timing import cuda_time_ms

SCALES = {"quick": (1 << 16, 1 << 22), "reddit": (232_965, 114_615_891)}
SCHEDULE = dict(tile_rows=512, tile_cols=256, threshold=48)  # bench.py defaults
GAT_SCHEDULE = dict(tile_rows=512, tile_cols=256, threshold=32)  # bench.py --model gat
TRAIN_SCHEDULE = dict(tile_rows=256, tile_cols=256, threshold=24)  # bench.py --train (--bit-tiles off)
# bench.py --model sddmm (strategy hybrid): [256, 128] tiles at t24, 1-bit
# tiles on, f = 32, split23 tile dots, f16_split2 residual, bf16 cells
SDDMM_SCHEDULE = dict(tile_rows=256, tile_cols=128, threshold=24)
SDDMM_F = 32
SDDMM_CALLS = 5
CHECK_TILES = 16384  # tiles a kernel-vs-plain comparison or a cell check takes at once
CHECK_EDGES = 1 << 22  # edges an edge-to-cell check takes at once
RESIDUAL_BLOCK = 4
TRAIN_STEPS = 5
GRAD_REL_L2 = 1e-4  # whole-step weight gradients against the float64 chain
# leaky-relu's derivative jumps by (1 - slope) * the attention weight at a
# zero logit, and for an edge within ~1e-7 of it float32 and float64 may
# take different sides: for edges within KINK of it the float64 oracles
# take the side the port's float32 branch test takes
KINK = 1e-5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
KERNEL_TOL = 1e-5  # max|kernel - plain| / max|plain|: float32 sum order only
# 'split' tiles round z to 16 mantissa bits (as the JAX package does); where a
# row's sum cancels to near zero that rounding alone misses the gate against
# the unrounded f64 oracle (the JAX package's own layer 1 at this scale: 6 of
# 8,388,608 elements).  Against the oracle of the modes the gate is exact.
PURE_BAD_FRACTION = 1e-5


def log(*a):
    print(*a, flush=True)


def check(ok: bool, what: str):
    if not ok:
        raise SystemExit(f"FAILED: {what}")


def compare(got: torch.Tensor, want: torch.Tensor, what: str, gate: bool) -> float:
    check(got.shape == want.shape, f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    err = (got - want).abs().max().item() if got.numel() else 0.0
    scale = want.abs().max().item() if want.numel() else 0.0
    bad = relative_error_count(got, want)
    log(f"  {what}: max|d|={err:.3e} max|ref|={scale:.3e} gate_bad={bad}{'' if gate else ' (not gated)'}")
    check(err <= KERNEL_TOL * scale and (bad == 0 or not gate), f"{what} disagrees with the plain version")
    return err


def kernel_vs_plain(tp, f: int, mode: str, gen: torch.Generator, what: str) -> float:
    """Kernel against the plain version on the same rounded operand, twice:
    nonnegative h (like post-ReLU activations) under the gate and the max
    bound; signed N(0, 1) h under the max bound only — there, sums of
    hundreds of terms up to 127*|h| cancel to near zero, where two float32
    summation orders differ by more than the gate's 1e-5 floor."""
    err = 0.0
    for signed in (False, True):
        shape = (tp.n_src, f)
        h = (torch.randn if signed else torch.rand)(shape, generator=gen, device="cuda")
        got = bcsr_spmm(tp, h, h_mode=mode)
        want = bcsr_spmm_plain(tp, round_h(h, mode))
        torch.cuda.synchronize()
        label = f"{what} f={f} {mode} {'signed' if signed else 'nonneg'}"
        err = max(err, compare(got, want, label, gate=not signed))
    return err


def tile_cells(tp):
    """(dst, src, count) of every nonzero cell of the plan's tiles."""
    cnt = tp.counts()
    t, i, j = cnt.nonzero(as_tuple=True)
    rows = tp.tile_row.long()[t] * tp.tile_rows + i
    cols = tp.tile_col.long()[t] * tp.tile_cols + j
    return rows, cols, cnt[t, i, j].double()


def tile_csr(tp) -> torch.Tensor:
    """The plan's tile edges as one [n, n_src] float32 CSR matrix."""
    rows, cols, vals = tile_cells(tp)
    coo = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals.float(), (tp.num_nodes, tp.n_src))
    return coo.coalesce().to_sparse_csr()


def edge_sum(z: torch.Tensor, dst, src, weight=None) -> torch.Tensor:
    """out[dst[e]] += weight[e] * z[src[e]] in z's dtype, in chunks of edges."""
    out = torch.zeros_like(z)
    step = 1 << 23
    for s in range(0, src.shape[0], step):
        msg = z.index_select(0, src[s : s + step])
        if weight is not None:
            msg *= weight[s : s + step, None]
        out.index_add_(0, dst[s : s + step], msg)
    return out


def reset_counts():
    """Every kernel's launch count to 0, just before a path is driven."""
    cuda_bcsr.launches = cuda_gat.launches = cuda_rowmax.launches = cuda_sddmm.launches = 0
    cuda_gat_bwd.dad_launches = cuda_gat_bwd.dh_das_launches = 0


def counts() -> dict:
    return dict(
        B1=cuda_bcsr.launches, B2=cuda_gat.launches, B3=cuda_gat_bwd.dad_launches,
        B4=cuda_gat_bwd.dh_das_launches, B5=cuda_rowmax.launches, B6=cuda_sddmm.launches,
    )


def only(name: str) -> bool:
    """No kernel other than ``name`` launched since the counts were reset."""
    return all(v == 0 for k, v in counts().items() if k != name)


def ragged_graph():
    """n = 5,037 (not a multiple of R) whose last row-tile is too sparse for
    any tile, so after pad_runs(16) its run is 16 filler tiles."""
    rng = np.random.default_rng(1)
    rg = rmat_graph(5000 + 37, 400_000, seed=7, with_val=False)
    rg = rg.reorder(degree_sort(rg))
    rd, rs = rg.dst_per_edge, rg.indices
    keep = (rd < 9 * SCHEDULE["tile_rows"]) | (rng.random(rg.num_edges) < 0.002)
    return CSRGraph.from_edges(rd[keep], rs[keep], rg.num_nodes), rng


def filler_only_runs(tp) -> list:
    """Row-tile runs that hold tiles, none of them with an edge."""
    lens = np.diff(tp.run_start)
    return [
        r for r in range(tp.num_row_tiles)
        if lens[r] and not tp.a[tp.run_start[r] : tp.run_start[r + 1]].any()
    ]


def gcn_edges(g, res_host, tp) -> tuple:
    """The float64 oracles' edge lists on the card: the graph's (dst, src),
    the residual's, and the tile cells' (dst, src, count) of ``tp``; checks
    that the tile cells and the residual partition the graph's edges (the
    tile/residual split comes from the host densify)."""
    dev = tp.a.device

    def edge_list(gr):
        return (
            torch.from_numpy(gr.dst_per_edge.astype(np.int64)).to(dev),
            torch.from_numpy(gr.indices.astype(np.int64)).to(dev),
        )

    g_dst, g_src = edge_list(g)
    r_dst, r_src = edge_list(res_host)
    c_dst, c_src, c_cnt = tile_cells(tp)
    n = g.num_nodes
    per_row = torch.bincount(c_dst, weights=c_cnt, minlength=n) + torch.bincount(r_dst, minlength=n)
    check(
        torch.equal(per_row.long().cpu(), torch.from_numpy(g.degrees.astype(np.int64))),
        "tile cells + residual edges do not partition the graph's edges",
    )
    return g_dst, g_src, r_dst, r_src, c_dst, c_src, c_cnt


def gcn_gates(agg, weights, opts, h0, out, edges, what: str) -> list:
    """Phase 3's checks of a GCN forward over ``agg``: float64 oracles over
    edge lists, the whole graph from the layer input ("pure") and the
    aggregation the numeric modes define ("mode": from the layer's own
    float32 transform z, tile edges take the tile_h_mode rounding of z,
    residual edges z exactly).  Each layer, from the same float32 input,
    passes the gate against its modes' oracle with 0 bad elements and misses
    the pure one on at most PURE_BAD_FRACTION; so does the whole chain
    ``out``.  Returns the layer inputs and outputs."""
    g_dst, g_src, r_dst, r_src, c_dst, c_src, c_cnt = edges
    limit = PURE_BAD_FRACTION
    xs, chain = [h0], h0.double()
    for i, w in enumerate(weights):
        xs.append(gcn_layer(agg, xs[i], w, opts[i]))
        z32 = xs[i] @ w  # the layer's own float32 transform
        zt = round_h(z32, opts[i].tile_h_mode).double()
        mode_ref = (edge_sum(zt, c_dst, c_src, c_cnt) + edge_sum(z32.double(), r_dst, r_src)).clamp_min_(0.0)
        z = xs[i].double() @ w.double()
        pure_ref = edge_sum(z, g_dst, g_src).clamp_min_(0.0)
        bad = relative_error_count(xs[-1], mode_ref)
        bad_pure = relative_error_count(xs[-1], pure_ref)
        log(
            f"  {what}layer {i + 1} (same input) vs f64 oracle: mode gate_bad={bad}, "
            f"pure gate_bad={bad_pure} of {z.numel()}"
        )
        check(bad == 0, f"{what}layer {i + 1} fails the gate against its modes' f64 oracle")
        check(bad_pure <= limit * z.numel(), f"{what}layer {i + 1}: too many elements off the pure oracle")
        chain = edge_sum(chain @ w.double(), g_dst, g_src).clamp_min_(0.0)
    bad = relative_error_count(out, chain)
    log(f"  {what}forward vs f64 pure oracle chain: gate_bad={bad} of {chain.numel()}")
    check(bad <= limit * chain.numel(), f"{what}forward: too many elements off the pure oracle chain")
    return xs


def gat_kernel_vs_plain(tp, f: int, gen: torch.Generator, what: str) -> float:
    """B2 against gat_bcsr_plain on signed N(0, 1) h: att at scale 0.1
    unshifted and with the exact row shift, att at scale 15 (wide logits)
    shifted only.  num is signed (max bound only), den nonnegative (max
    bound and the gate).  B5 against bcsr_rowmax_plain on each att's src
    half: exactly equal.  Returns max|d| of num."""
    err = 0.0
    h = torch.randn((tp.n_src, f), generator=gen, device="cuda")
    for scale, shifts in ((0.1, (False, True)), (15.0, (True,))):
        att = torch.randn((tp.num_nodes, 2), generator=gen, device="cuda") * scale
        rmax = bcsr_rowmax(tp, att[:, 1].contiguous())
        want = bcsr_rowmax_plain(tp, att[:, 1].contiguous())
        torch.cuda.synchronize()
        check(torch.equal(rmax, want), f"{what} B5 differs from bcsr_rowmax_plain (scale {scale})")
        if f == BENCH_DIMS[1]:
            log(f"  {what} B5 scale {scale}: equal, {int(torch.isneginf(rmax).sum())} rows -inf")
        for shift in shifts:
            row_shift = _hybrid_row_shift(tp, None, att, DEFAULT_SLOPE) if shift else None
            num, den = gat_bcsr(tp, h, att, row_shift=row_shift, dot_mode="split2")
            ref_num, ref_den = gat_bcsr_plain(tp, h, att, row_shift=row_shift)
            torch.cuda.synchronize()
            label = f"{what} f={f} scale {scale}{' shifted' if shift else ''}"
            err = max(err, compare(num, ref_num, f"{label} num", gate=False))
            compare(den, ref_den, f"{label} den", gate=True)
    return err


def gat_edge_oracle(feat, att, dst, src, slope=DEFAULT_SLOPE):
    """float64 GAT aggregation over the edge list (index_add_): softmax over
    each row's in-edges of exp(leaky_relu(att[dst, 0] + att[src, 1]))."""
    z = att[dst, 0] + att[src, 1]
    score = torch.exp(torch.maximum(z, slope * z))
    num = edge_sum(feat, dst, src, score)
    den = torch.zeros(feat.shape[0], dtype=feat.dtype, device=feat.device).index_add_(0, dst, score)
    return num / torch.where(den == 0, 1.0, den)[:, None]


def gat_phases(args, g, h0, gen, forwards, libs) -> list:
    """Phases 5-7: the GAT kernels and the GAT forward.  Returns the B2 and
    B5 entries of the kernels line."""
    dev = h0.device
    n = g.num_nodes
    t0 = time.perf_counter()
    agg = Aggregator.schedule_hybrid(g, residual_block=RESIDUAL_BLOCK, pack=1, device=dev, **GAT_SCHEDULE)
    tile_host, _ = densify(g, **GAT_SCHEDULE)
    tile16 = tile_host.pad_runs(16).to(dev)
    tp = agg.tile
    log(
        f"GAT plan ({args.scale}): tiles={tp.num_tiles} (pack16: {tile16.num_tiles}) "
        f"dense_edges={tp.num_dense_edges} residual_edges={agg.plan.num_edges} "
        f"tasks={agg.plan.num_tasks} longest run={int(np.diff(tile_host.run_start).max())} "
        f"built in {time.perf_counter() - t0:.1f} s"
    )

    # ---- phase 5: B2 and B5 against their plain versions
    log("phase 5: B2 kernel vs gat_bcsr_plain, B5 kernel vs bcsr_rowmax_plain")
    max_err = 0.0
    with torch.no_grad():
        for plan, label in ((tp, "pack1"), (tile16, "pack16")):
            for f in BENCH_DIMS[1:]:
                err = gat_kernel_vs_plain(plan, f, gen, label)
                if plan is tp:
                    max_err = max(max_err, err)
        ng, _ = ragged_graph()
        ragged = densify(ng, **GAT_SCHEDULE)[0].pad_runs(16)
        filler_runs = filler_only_runs(ragged)
        check(ng.num_nodes % GAT_SCHEDULE["tile_rows"] != 0 and filler_runs, "GAT ragged case lacks a filler-only run")
        log(f"  ragged raw-count plan: n={ng.num_nodes} tiles={ragged.num_tiles} filler-only runs={filler_runs}")
        ragged = ragged.to(dev)
        for f in (BENCH_DIMS[1], BENCH_DIMS[3]):
            gat_kernel_vs_plain(ragged, f, gen, "ragged")
        del ragged

    # ---- phase 6: the GAT forward
    log("phase 6: 3-layer GAT forward, fast=True, dot_mode='split2'")
    model = gat_params_from_jax(glorot_gat_weights(BENCH_DIMS, seed=0), device=dev)
    params = model.layer_params()

    def fwd(**kw):
        return model(agg, h0, fast=True, dot_mode="split2", **kw)

    with torch.no_grad():
        reset_counts()
        for _ in range(forwards):
            out = fwd()
        torch.cuda.synchronize()
        launches = cuda_gat.launches
        log(f"  B2 launches in {forwards} forwards: {launches}; B5: {cuda_rowmax.launches}; B1: {cuda_bcsr.launches}")
        check(launches == 3 * forwards, "B2 did not launch 3 times per forward")
        check(only("B2"), "the GAT forward launched another kernel")
        check(out.shape == (n, BENCH_DIMS[-1]) and bool(torch.isfinite(out).all()), "GAT forward output")

        g_dst = torch.from_numpy(g.dst_per_edge.astype(np.int64)).to(dev)
        g_src = torch.from_numpy(g.indices.astype(np.int64)).to(dev)
        xs, chain = [h0], h0.double()
        for i, p in enumerate(params):
            xs.append(gat_forward(agg, [p], xs[i], fast=True, dot_mode="split2"))
            feat = xs[i].double() @ p.w.double()
            ref = gat_edge_oracle(feat, feat @ p.w_att.double(), g_dst, g_src)
            bad = relative_error_count(xs[-1], ref)
            log(f"  layer {i + 1} (same input) vs f64 oracle: gate_bad={bad} of {ref.numel()}")
            check(bad == 0, f"GAT layer {i + 1} fails the gate against the f64 oracle")
            feat = chain @ p.w.double()
            chain = gat_edge_oracle(feat, feat @ p.w_att.double(), g_dst, g_src)
        bad = relative_error_count(out, chain)
        log(f"  forward vs f64 oracle chain: gate_bad={bad} of {chain.numel()}")
        check(bad <= PURE_BAD_FRACTION * chain.numel(), "GAT forward: too many elements off the f64 oracle chain")
        del g_dst, g_src, chain, feat, ref

        # the stabilized forward is its own path: B5 runs only there
        reset_counts()
        out_exact = fwd(stabilize=True)
        torch.cuda.synchronize()
        rowmax_launches = cuda_rowmax.launches
        log(f"  stabilize=True forward: B5 launches {rowmax_launches}, B2 {cuda_gat.launches}")
        check(rowmax_launches == 3 and cuda_gat.launches == 3, "stabilized forward: B5 or B2 not launched 3 times")
        reset_counts()
        out_bound = fwd(stabilize="bound")
        torch.cuda.synchronize()
        check(cuda_rowmax.launches == 0 and cuda_gat.launches == 3, "stabilize='bound' forward launches")
        for label, o in (("stabilize=True", out_exact), ("stabilize='bound'", out_bound)):
            bad = relative_error_count(o, out)
            log(f"  {label} vs un-stabilized: gate_bad={bad}")
            check(bool(torch.isfinite(o).all()) and bad == 0, f"{label} forward differs from the un-stabilized one")

        # ---- phase 7: timing
        log("phase 7: GAT timing (CUDA events, median of 10 after 3 warm-up)")
        fwd_ms = cuda_time_ms(fwd)
        stab_ms = cuda_time_ms(lambda: fwd(stabilize=True))
        bound_fwd_ms = cuda_time_ms(lambda: fwd(stabilize="bound"))
        log(f"  forward: {fwd_ms:.3f} ms; stabilize=True {stab_ms:.3f} ms; stabilize='bound' {bound_fwd_ms:.3f} ms")
        c_dst, c_src, c_cnt = tile_cells(tp)
        nnz = c_cnt.numel()
        move_plan = tp.a.numel() + 4 * (tp.num_tiles + tp.num_row_tiles + 1)
        b2_rows, b5_rows = [], []
        for i, p in enumerate(params):
            layer_ms = cuda_time_ms(lambda: gat_forward(agg, [p], xs[i], fast=True, dot_mode="split2"))
            feat = (xs[i] @ p.w).contiguous()
            att = feat @ p.w_att
            f = feat.shape[1]
            u12, v12 = _branch_factors(att, DEFAULT_SLOPE)
            ms = cuda_time_ms(lambda: cuda_gat.gat_bcsr_cuda(tp, feat, u12, v12))
            ms16 = cuda_time_ms(lambda: cuda_gat.gat_bcsr_cuda(tile16, feat, u12, v12))
            plain_ms = cuda_time_ms(lambda: gat_bcsr_plain(tp, feat, att))
            # library yardstick: the cells' scores as one CSR, built outside
            # the timed call, times [h | 1]
            z = att[c_dst, 0] + att[c_src, 1]
            score = c_cnt.float() * torch.exp(torch.maximum(z, DEFAULT_SLOPE * z))
            csr = torch.sparse_coo_tensor(torch.stack([c_dst, c_src]), score, (n, tp.n_src)).coalesce().to_sparse_csr()
            hx = torch.cat([feat, torch.ones((feat.shape[0], 1), device=dev)], dim=1)
            library_ms = cuda_time_ms(lambda: torch.sparse.mm(csr, hx))
            bytes_ms = (move_plan + 4 * f * tp.n_src + 8 * (n + tp.n_src) + 4 * (f + 1) * n) / HBM_BYTES_PER_S * 1e3
            ops_ms = 2.0 * nnz * (f + 1) / FP32_FLOPS * 1e3
            b2_rows.append(dict(
                f=f, layer_ms=layer_ms, ms=ms, ms_pack16=ms16, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=max(bytes_ms, ops_ms), bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                tiles=tp.num_tiles, nnz_cells=nnz,
            ))
            asrc = att[:, 1].contiguous()
            r_ms = cuda_time_ms(lambda: cuda_rowmax.rowmax_bcsr_cuda(tp, asrc))
            r_ms16 = cuda_time_ms(lambda: cuda_rowmax.rowmax_bcsr_cuda(tile16, asrc))
            r_plain = cuda_time_ms(lambda: bcsr_rowmax_plain(tp, asrc))
            r_lib = cuda_time_ms(
                lambda: torch.full((n,), float("-inf"), device=dev).scatter_reduce_(
                    0, c_dst, asrc.index_select(0, c_src), "amax"
                )
            )
            r_bytes_ms = (move_plan + 4 * (tp.n_src + n)) / HBM_BYTES_PER_S * 1e3
            r_ops_ms = nnz / FP32_FLOPS * 1e3
            b5_rows.append(dict(
                layer=i + 1, ms=r_ms, ms_pack16=r_ms16, plain_ms=r_plain, library_ms=r_lib,
                bound_ms=max(r_bytes_ms, r_ops_ms), bound_by="bytes" if r_bytes_ms >= r_ops_ms else "operations",
            ))
            log(
                f"  layer {i + 1} f={f}: layer {layer_ms:.3f} ms | B2 {ms:.3f} ms/launch (pack16 {ms16:.3f}) "
                f"bound {b2_rows[-1]['bound_ms']:.4f} ms ({b2_rows[-1]['bound_by']}) | plain {plain_ms:.3f} | "
                f"torch.sparse.mm {library_ms:.3f} || B5 {r_ms:.3f} ms/launch (pack16 {r_ms16:.3f}) bound "
                f"{b5_rows[-1]['bound_ms']:.4f} | plain {r_plain:.3f} | scatter_reduce {r_lib:.3f}"
            )
            del csr, hx, z, score

    def total(rows, k):
        return sum(r[k] for r in rows)

    def entry(name, replaces, rows, launches, max_abs_err, **extra):
        return dict(
            name=name, route="cuda", source=f"gnn_computing_tpu_torch/csrc/{name}.cu",
            replaces=replaces, launches=launches, max_abs_err=max_abs_err,
            # times summed over the three launches of one forward
            ms=total(rows, "ms"), plain_ms=total(rows, "plain_ms"), bound_ms=total(rows, "bound_ms"),
            bound_by="bytes" if all(r["bound_by"] == "bytes" for r in rows) else "operations",
            library_ms=total(rows, "library_ms"), scale=args.scale, shapes=rows, **extra,
        )

    return [
        entry("gat_bcsr", "gnn_computing_tpu/ops/pallas_bcsr.py:436", b2_rows, launches, max_err,
              path="GAT forward (fast, split2)", forward_ms=fwd_ms, build_s=libs["gat_bcsr"][1]),
        entry("rowmax_bcsr", "gnn_computing_tpu/ops/pallas_bcsr.py:1251", b5_rows, rowmax_launches, 0.0,
              path="GAT forward (fast, split2, stabilize=True)", forward_ms=stab_ms,
              bound_forward_ms=bound_fwd_ms, build_s=libs["rowmax_bcsr"][1]),
    ]


def edge_sum_ad(z: torch.Tensor, dst, src, weight=None) -> torch.Tensor:
    """out[dst[e]] += weight[e] * z[src[e]], differentiable (no in-place on
    a tensor autograd keeps)."""
    msg = z.index_select(0, src)
    if weight is not None:
        msg = msg * weight[:, None]
    return torch.zeros_like(z).index_add(0, dst, msg)


def gat_edge_oracle_ad(feat, att, dst, src, kink_pos=None, slope=DEFAULT_SLOPE):
    """gat_edge_oracle in a differentiable form (float64 autograd oracle).
    ``kink_pos`` (per edge) gives the side of leaky-relu's kink for the
    edges whose logit lies within KINK of it."""
    z = att[dst, 0] + att[src, 1]
    pos = z > 0
    if kink_pos is not None:
        pos = torch.where(z.abs() < KINK, kink_pos, pos)
    score = torch.exp(torch.where(pos, z, slope * z))
    den = torch.zeros(feat.shape[0], dtype=feat.dtype, device=feat.device).index_add(0, dst, score)
    return edge_sum_ad(feat, dst, src, score) / torch.where(den == 0, 1.0, den)[:, None]


def cotangent(shape, device) -> torch.Tensor:
    """An O(1) signed float64 cotangent, cos(arange), as
    tests/test_gat_streaming_bwd.py uses."""
    numel = int(np.prod(shape))
    return torch.cos(torch.arange(numel, dtype=torch.float64, device=device)).reshape(shape)


def port_kink_sides(att, tp, dst, src) -> torch.Tensor:
    """For the edges (dst, src): whether the port's float32 branch test puts
    them on the z > 0 side, with the 'bound' shift of ``att``: the tile
    cells' test u1 v1 >= u2 v2 and the residual's exp(lrelu(z) - M) >
    exp(-M), the same operations on the same device.  Where the two tests
    differ, the edge's place (a tile cell with a count, else the residual)
    decides; a cell at the int8 cap, whose edges lie on both sides, raises."""
    shift = _global_bound_shift(att, DEFAULT_SLOPE)
    u12, v12 = _branch_factors(att, DEFAULT_SLOPE, shift)
    pos_tile = u12[dst, 0] * v12[src, 0] >= u12[dst, 1] * v12[src, 1]
    z = att[:, 0].index_select(0, dst) + att[:, 1].index_select(0, src)
    sh = shift.index_select(0, dst)
    pos_res = torch.exp(torch.maximum(z, z * DEFAULT_SLOPE) - sh) > torch.exp(-sh)
    differ = pos_tile != pos_res
    if not bool(differ.any()):
        return pos_tile
    tile_map = torch.full((tp.num_row_tiles, tp.num_col_tiles), -1, dtype=torch.long, device=dst.device)
    tile_map[tp.tile_row.long(), tp.tile_col.long()] = torch.arange(tp.num_tiles, device=dst.device)
    d, s_ = dst[differ], src[differ]
    t = tile_map[d // tp.tile_rows, s_ // tp.tile_cols]
    cnt = torch.where(t >= 0, tp.a[t.clamp_min(0), d % tp.tile_rows, s_ % tp.tile_cols].long(), 0)
    check(not bool((cnt == 127).any()), "a near-kink edge lies in a cell at the int8 cap")
    pos = pos_tile.clone()
    pos[differ] = torch.where(cnt > 0, pos_tile[differ], pos_res[differ])
    return pos


def grad_gate(got, want, what: str):
    """At most PURE_BAD_FRACTION of the elements may miss the gate."""
    bad = relative_error_count(got, want)
    err = (got.double() - want).abs().max().item()
    log(f"  {what}: gate_bad={bad} of {want.numel()} max|d|={err:.3e} max|ref|={want.abs().max().item():.3e}")
    check(bad <= PURE_BAD_FRACTION * want.numel(), f"{what}: too many elements off the float64 autograd oracle")


def rel_l2(got, want) -> float:
    return ((got.double() - want).norm() / want.norm()).item()


def bwd_inputs(n, f, scale, shift, gen, dev):
    """(h, gbar, c, u12, v12) for the backward kernels: N(0, 1) h, gbar and
    c; att at ``scale``, with the 'bound' shift folded into u12 if asked."""
    h = torch.randn((n, f), generator=gen, device=dev)
    gbar = torch.randn((n, f), generator=gen, device=dev)
    c = torch.randn(n, generator=gen, device=dev)
    att = torch.randn((n, 2), generator=gen, device=dev) * scale
    u12, v12 = _branch_factors(att, DEFAULT_SLOPE, _global_bound_shift(att, DEFAULT_SLOPE) if shift else None)
    return h, gbar, c, u12, v12


def bwd_kernels_vs_plain(tp, tp_t, f, gen, what) -> float:
    """B3 over ``tp`` and B4 over ``tp_t`` against their plain versions, att
    at scale 0.1 unshifted and at scale 15 with the 'bound' shift.  Returns
    max|d| over the three outputs."""
    err = 0.0
    for scale, shift in ((0.1, False), (15.0, True)):
        args = bwd_inputs(tp.num_nodes, f, scale, shift, gen, tp.a.device) + (DEFAULT_SLOPE,)
        dad = gat_bwd_dad(tp, *args)
        dh, das = gat_bwd_dh_das(tp_t, *args)
        want_dad = gat_bwd_dad_plain(tp, *args)
        want_dh, want_das = gat_bwd_dh_das_plain(tp_t, *args)
        torch.cuda.synchronize()
        label = f"{what} f={f} scale {scale}{' bound-shifted' if shift else ''}"
        for got, want, out in ((dad, want_dad, "d_ad"), (dh, want_dh, "dh"), (das, want_das, "d_as")):
            err = max(err, compare(got, want, f"{label} {out}", gate=False))
    return err


def bound(nbytes, flops) -> dict:
    """The least time for ``nbytes`` moved and ``flops`` float32 operations."""
    b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return dict(bound_ms=max(b_ms, o_ms), bound_by="bytes" if b_ms >= o_ms else "operations")


def cells_csr(rows, cols, vals, shape) -> torch.Tensor:
    return torch.sparse_coo_tensor(torch.stack([rows, cols]), vals, shape).coalesce().to_sparse_csr()


def csr_rows(m: torch.Tensor) -> torch.Tensor:
    """The row of every stored value of a CSR matrix."""
    crow = m.crow_indices()
    return torch.repeat_interleave(torch.arange(crow.numel() - 1, device=crow.device), crow.diff())


def train_kernel_times(tp, tp_t, tile16, tile_t16, gen) -> dict:
    """Phase 11's kernel rows: B3, B4, B1 over tp_t and B2 at each f, ms per
    launch (pack 1 and 16), bound, plain ms and library yardstick ms."""
    dev = tp.a.device
    n = tp.num_nodes
    c_dst, c_src, c_cnt = tile_cells(tp)
    nnz = c_cnt.numel()
    idx = 4 * (tp.num_tiles + tp.num_row_tiles + 1)
    idx_t = 4 * (tp_t.num_tiles + tp_t.num_row_tiles + 1)
    csr_t = tile_csr(tp_t)
    rows = {"B3": [], "B4": [], "B1_t": [], "B2": []}
    for f in BENCH_DIMS[1:]:
        h, gbar, c, u12, v12 = bwd_inputs(n, f, 1.0, True, gen, dev)
        args = (h, gbar, c, u12, v12, DEFAULT_SLOPE)
        # the cells' scores and lrelu' * score, as CSRs in the forward and the
        # transposed orientation, built outside the timed calls
        b1 = u12[c_dst, 0] * v12[c_src, 0]
        b2 = u12[c_dst, 1] * v12[c_src, 1]
        score = c_cnt.float() * torch.maximum(b1, b2)
        wgt = torch.where(b1 >= b2, 1.0, DEFAULT_SLOPE) * score
        pat, pat_t = cells_csr(c_dst, c_src, wgt, (n, n)), cells_csr(c_src, c_dst, wgt, (n, n))
        s_fwd, s_t = cells_csr(c_dst, c_src, score, (n, n)), cells_csr(c_src, c_dst, score, (n, n))
        rows_f, rows_t = csr_rows(pat), csr_rows(pat_t)
        c_f, c_t = c.index_select(0, rows_f), c.index_select(0, pat_t.col_indices())
        ht, gbart = h.t().contiguous(), gbar.t().contiguous()
        h1 = torch.cat([h, torch.ones((n, 1), device=dev)], dim=1)

        def lib_dad():
            p = torch.sparse.sampled_addmm(pat, gbar, ht, beta=0.0)
            return torch.zeros(n, device=dev).index_add_(0, rows_f, pat.values() * (p.values() - c_f))

        def lib_dh_das():
            p = torch.sparse.sampled_addmm(pat_t, h, gbart, beta=0.0)
            d_as = torch.zeros(n, device=dev).index_add_(0, rows_t, pat_t.values() * (p.values() - c_t))
            return torch.sparse.mm(s_t, gbar), d_as

        # the yardsticks compute the kernels' functions
        want_dad = gat_bwd_dad_plain(tp, *args)
        want_dh, want_das = gat_bwd_dh_das_plain(tp_t, *args)
        got_dh, got_das = lib_dh_das()
        for got, want, what in ((lib_dad(), want_dad, "B3"), (got_dh, want_dh, "B4 dh"), (got_das, want_das, "B4 d_as")):
            check((got - want).abs().max() <= 1e-4 * want.abs().max(), f"{what} library yardstick disagrees at f={f}")
        io = 4 * f * 2 * n + 8 * 2 * n + 4 * n  # h, gbar, u12, v12, c
        r3 = dict(
            f=f, ms=cuda_time_ms(lambda: gat_bwd_dad(tp, *args)),
            ms_pack16=cuda_time_ms(lambda: gat_bwd_dad(tile16, *args)),
            plain_ms=cuda_time_ms(lambda: gat_bwd_dad_plain(tp, *args)),
            library_ms=cuda_time_ms(lib_dad), nnz_cells=nnz,
            **bound(tp.a.numel() + idx + io + 4 * n, 2.0 * nnz * f),
        )
        r4 = dict(
            f=f, ms=cuda_time_ms(lambda: gat_bwd_dh_das(tp_t, *args)),
            ms_pack16=cuda_time_ms(lambda: gat_bwd_dh_das(tile_t16, *args)),
            plain_ms=cuda_time_ms(lambda: gat_bwd_dh_das_plain(tp_t, *args)),
            library_ms=cuda_time_ms(lib_dh_das), nnz_cells=nnz,
            **bound(tp_t.a.numel() + idx_t + io + 4 * n * (f + 1), 4.0 * nnz * f),
        )
        r1 = dict(
            f=f, ms=cuda_time_ms(lambda: cuda_bcsr.bcsr_spmm_cuda(tp_t, gbar)),
            ms_pack16=cuda_time_ms(lambda: cuda_bcsr.bcsr_spmm_cuda(tile_t16, gbar)),
            plain_ms=cuda_time_ms(lambda: bcsr_spmm_plain(tp_t, gbar)),
            library_ms=cuda_time_ms(lambda: torch.sparse.mm(csr_t, gbar)), nnz_cells=nnz,
            **bound(tp_t.a.numel() + idx_t + 8 * f * n, 2.0 * nnz * f),
        )
        att = torch.randn((n, 2), generator=gen, device=dev)
        u12a, v12a = _branch_factors(att, DEFAULT_SLOPE)
        r2 = dict(
            f=f, ms=cuda_time_ms(lambda: cuda_gat.gat_bcsr_cuda(tp, h, u12a, v12a)),
            ms_pack16=cuda_time_ms(lambda: cuda_gat.gat_bcsr_cuda(tile16, h, u12a, v12a)),
            plain_ms=cuda_time_ms(lambda: gat_bcsr_plain(tp, h, att)),
            library_ms=cuda_time_ms(lambda: torch.sparse.mm(s_fwd, h1)), nnz_cells=nnz,
            **bound(tp.a.numel() + idx + 4 * f * n + 16 * n + 4 * (f + 1) * n, 2.0 * nnz * (f + 1)),
        )
        for k, r in (("B3", r3), ("B4", r4), ("B1_t", r1), ("B2", r2)):
            r["tiles"] = (tp_t if k in ("B4", "B1_t") else tp).num_tiles
            rows[k].append(r)
        for k, r in (("B3", r3), ("B4", r4), ("B1 transposed", r1), ("B2 [256, 256]", r2)):
            log(
                f"  f={f} {k}: {r['ms']:.3f} ms/launch (pack16 {r['ms_pack16']:.3f}) bound {r['bound_ms']:.4f} "
                f"({r['bound_by']}) | plain {r['plain_ms']:.3f} | library {r['library_ms']:.3f}"
            )
        del pat, pat_t, s_fwd, s_t, b1, b2, score, wgt, h1
    return rows


def train_phases(args, g, h0, gen) -> dict:
    """Phases 8-11: the backward kernels, then the GCN and GAT training
    steps.  Returns the kernel rows, launch counts, losses and times."""
    dev = h0.device
    n = g.num_nodes
    t0 = time.perf_counter()
    agg = Aggregator.schedule_hybrid(
        g, residual_block=RESIDUAL_BLOCK, pack=1, with_transpose=True, device=dev, **TRAIN_SCHEDULE
    )
    build_s = time.perf_counter() - t0
    tile_host, _ = densify(g, **TRAIN_SCHEDULE)
    tile_t_host = tile_host.transpose()
    tile16, tile_t16 = tile_host.pad_runs(16).to(dev), tile_t_host.pad_runs(16).to(dev)
    tp, tp_t = agg.tile, agg.tile_t
    log(
        f"training plan ({args.scale}): tiles={tp.num_tiles} (pack16: {tile16.num_tiles}), transposed "
        f"{tp_t.num_tiles} ({tp_t.num_tiles - tp.num_tiles} coverage fillers; pack16: {tile_t16.num_tiles}) "
        f"dense_edges={tp.num_dense_edges} residual_edges={agg.plan.num_edges} tasks={agg.plan.num_tasks} "
        f"(transposed {agg.plan_t.num_tasks}) longest run={int(np.diff(tile_host.run_start).max())} "
        f"(transposed {int(np.diff(tile_t_host.run_start).max())}) built in {build_s:.1f} s"
    )
    del tile_host, tile_t_host

    # ---- phase 8: the kernels of the training path against their plain versions
    log("phase 8: B3 vs gat_bwd_dad_plain, B4 vs gat_bwd_dh_das_plain, B1 transposed, B2 at [256, 256]")
    max_err = {"B3": 0.0, "B1_t": 0.0, "B2": 0.0}
    with torch.no_grad():
        for (p, p_t), label in (((tp, tp_t), "pack1"), ((tile16, tile_t16), "pack16")):
            for f in BENCH_DIMS[1:]:
                errs = (
                    bwd_kernels_vs_plain(p, p_t, f, gen, label),
                    kernel_vs_plain(p_t, f, "native", gen, f"{label} transposed"),
                    gat_kernel_vs_plain(p, f, gen, f"{label} [256, 256]"),
                )
                if p is tp:
                    for k, e in zip(("B3", "B1_t", "B2"), errs):
                        max_err[k] = max(max_err[k], e)
        ng, _ = ragged_graph()
        ragged_host = densify(ng, **TRAIN_SCHEDULE)[0]
        ragged, ragged_t = ragged_host.pad_runs(16), ragged_host.transpose().pad_runs(16)
        fillers, fillers_t = filler_only_runs(ragged), filler_only_runs(ragged_t)
        check(bool(fillers) and bool(fillers_t), "training ragged case lacks a filler-only run")
        log(
            f"  ragged raw-count plan: n={ng.num_nodes} tiles={ragged.num_tiles} filler-only runs={fillers}; "
            f"transposed tiles={ragged_t.num_tiles} filler-only runs={fillers_t}"
        )
        ragged, ragged_t = ragged.to(dev), ragged_t.to(dev)
        for f in (BENCH_DIMS[1], BENCH_DIMS[3]):
            bwd_kernels_vs_plain(ragged, ragged_t, f, gen, "ragged")
            kernel_vs_plain(ragged_t, f, "native", gen, "ragged transposed")
        del ragged, ragged_t

    g_dst = torch.from_numpy(g.dst_per_edge.astype(np.int64)).to(dev)
    g_src = torch.from_numpy(g.indices.astype(np.int64)).to(dev)
    labels = torch.from_numpy(np.random.default_rng(7).integers(0, BENCH_DIMS[-1], n)).to(dev)

    # ---- phase 9: GCN training
    log(f"phase 9: GCN training, {TRAIN_STEPS} steps of make_train_step (exact modes, Adam 1e-3)")
    gcn = gcn_params_from_jax(glorot_weights(BENCH_DIMS, seed=0), device=dev)

    def gcn_fwd(h):
        return gcn(agg, h)

    with torch.no_grad():
        xs = [h0]
        for w in gcn.weights:
            xs.append(gcn_layer(agg, xs[-1], w))
    for i, w in enumerate(gcn.weights):
        with torch.no_grad():
            z = xs[i] @ w
        z.requires_grad_(True)
        ct = cotangent(tuple(z.shape), dev)
        (agg.run(z) * ct.float()).sum().backward()
        z64 = z.detach().double().requires_grad_(True)
        (edge_sum_ad(z64, g_dst, g_src) * ct).sum().backward()
        grad_gate(z.grad, z64.grad, f"GCN layer {i + 1} aggregation input gradient vs f64 autograd")
        del z, z64, ct
    loss = softmax_xent(gcn_fwd(h0), labels)
    loss.backward()
    ws = [w.detach().double().requires_grad_(True) for w in gcn.weights]
    x = h0.double()
    for w in ws:
        x = torch.relu(edge_sum_ad(x @ w, g_dst, g_src))
    loss64 = torch.nn.functional.cross_entropy(x, labels)
    loss64.backward()
    log(f"  one step's loss {loss.item():.7f}, f64 chain {loss64.item():.7f}")
    for i, (w, w64) in enumerate(zip(gcn.weights, ws)):
        r = rel_l2(w.grad, w64.grad)
        log(f"  GCN w{i + 1} gradient vs f64 chain: relative L2 {r:.3e}")
        check(r <= GRAD_REL_L2, f"GCN w{i + 1} gradient off the float64 chain")
    del ws, x, loss64
    gcn.zero_grad(set_to_none=True)
    step = make_train_step(gcn_fwd, torch.optim.Adam(gcn.parameters(), lr=1e-3), device=dev)
    reset_counts()
    losses = [step((h0,), labels) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    gcn_counts = counts()
    losses = [float(v) for v in losses]
    log(f"  losses {losses}; launches in {TRAIN_STEPS} steps: {gcn_counts}")
    check(gcn_counts["B1"] == 6 * TRAIN_STEPS, "GCN training: B1 did not launch 6 times per step")
    check(all(v == 0 for k, v in gcn_counts.items() if k != "B1"), "GCN training launched a GAT kernel")
    check(all(np.isfinite(losses)), "GCN training loss not finite")

    # ---- phase 10: GAT training
    log(f"phase 10: GAT training, {TRAIN_STEPS} steps (fast=False, stabilize='bound', dot_mode='split2')")
    gat = gat_params_from_jax(glorot_gat_weights(BENCH_DIMS, seed=0), device=dev)

    def gat_fwd(h):
        return gat(agg, h, fast=False, stabilize="bound", dot_mode="split2")

    def gat_one(h, p):
        return gat_forward(agg, [p], h, fast=False, stabilize="bound", dot_mode="split2")

    with torch.no_grad():
        gxs = [h0]
        for p in gat.layer_params():
            gxs.append(gat_one(gxs[-1], p))
    kink_pos = []  # per layer, the port's side of the kink for every edge
    for i, p in enumerate(gat.layer_params()):
        with torch.no_grad():
            feat = gxs[i] @ p.w
            att = feat @ p.w_att
            kink_pos.append(port_kink_sides(att, tp, g_dst, g_src))
            z = att[g_dst, 0].double() + att[g_src, 1].double()
        log(f"  GAT layer {i + 1}: {int((z.abs() < KINK).sum())} edges within {KINK} of leaky-relu's kink")
        feat.requires_grad_(True)
        att.requires_grad_(True)
        ct = cotangent(tuple(feat.shape), dev)
        (agg.run_gat(feat, att, stabilize="bound", dot_mode="split2") * ct.float()).sum().backward()
        f64 = feat.detach().double().requires_grad_(True)
        a64 = att.detach().double().requires_grad_(True)
        (gat_edge_oracle_ad(f64, a64, g_dst, g_src, kink_pos[i]) * ct).sum().backward()
        grad_gate(feat.grad, f64.grad, f"GAT layer {i + 1} dh vs f64 autograd")
        grad_gate(att.grad, a64.grad, f"GAT layer {i + 1} datt vs f64 autograd")
        del feat, att, f64, a64, ct, z
    loss = softmax_xent(gat_fwd(h0), labels)
    loss.backward()
    ps = [(p.w.detach().double().requires_grad_(True), p.w_att.detach().double().requires_grad_(True))
          for p in gat.layer_params()]
    x = h0.double()
    for (w, a), pos in zip(ps, kink_pos):
        feat = x @ w
        x = gat_edge_oracle_ad(feat, feat @ a, g_dst, g_src, pos)
    loss64 = torch.nn.functional.cross_entropy(x, labels)
    loss64.backward()
    log(f"  one step's loss {loss.item():.7f}, f64 chain {loss64.item():.7f}")
    for i, (p, (w64, a64)) in enumerate(zip(gat.layer_params(), ps)):
        rw, ra = rel_l2(p.w.grad, w64.grad), rel_l2(p.w_att.grad, a64.grad)
        log(f"  GAT layer {i + 1} gradient vs f64 chain: w relative L2 {rw:.3e}, w_att {ra:.3e}")
        check(rw <= GRAD_REL_L2 and ra <= GRAD_REL_L2, f"GAT layer {i + 1} gradient off the float64 chain")
    del ps, x, feat, loss64, g_dst, g_src, kink_pos
    gat.zero_grad(set_to_none=True)
    gat_step = make_train_step(gat_fwd, torch.optim.Adam(gat.parameters(), lr=1e-3), device=dev)
    reset_counts()
    glosses = [gat_step((h0,), labels) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    gat_counts = counts()
    glosses = [float(v) for v in glosses]
    log(f"  losses {glosses}; launches in {TRAIN_STEPS} steps: {gat_counts}")
    for k in ("B2", "B3", "B4"):
        check(gat_counts[k] == 3 * TRAIN_STEPS, f"GAT training: {k} did not launch 3 times per step")
    check(gat_counts["B1"] == 0 and gat_counts["B5"] == 0, "GAT training launched B1 or B5")
    check(all(np.isfinite(glosses)), "GAT training loss not finite")

    # ---- phase 11: timing
    log("phase 11: training timing (CUDA events, median of 10 after 3 warm-up)")
    times = dict(
        gcn_step_ms=cuda_time_ms(lambda: step((h0,), labels)),
        gcn_forward_ms=cuda_time_ms(lambda: gcn_fwd(h0)),
        gat_step_ms=cuda_time_ms(lambda: gat_step((h0,), labels)),
        gat_forward_ms=cuda_time_ms(lambda: gat_fwd(h0)),
    )
    for m in ("gcn", "gat"):
        times[f"{m}_backward_adam_ms"] = times[f"{m}_step_ms"] - times[f"{m}_forward_ms"]
        log(
            f"  {m.upper()} step {times[f'{m}_step_ms']:.3f} ms = forward {times[f'{m}_forward_ms']:.3f} "
            f"+ backward and Adam {times[f'{m}_backward_adam_ms']:.3f}"
        )
    layers = []
    for i, (w, p) in enumerate(zip(gcn.weights, gat.layer_params())):
        ct = cotangent((n, w.shape[1]), dev).float()
        row = dict(layer=i + 1, f=int(w.shape[1]))
        row["gcn_forward_ms"] = cuda_time_ms(lambda: gcn_layer(agg, xs[i], w))
        row["gcn_fwd_bwd_ms"] = cuda_time_ms(lambda: (gcn_layer(agg, xs[i], w) * ct).sum().backward())
        row["gat_forward_ms"] = cuda_time_ms(lambda: gat_one(gxs[i], p))
        row["gat_fwd_bwd_ms"] = cuda_time_ms(lambda: (gat_one(gxs[i], p) * ct).sum().backward())
        for m in ("gcn", "gat"):
            row[f"{m}_backward_ms"] = row[f"{m}_fwd_bwd_ms"] - row[f"{m}_forward_ms"]
        layers.append(row)
        log(
            f"  layer {i + 1} f={row['f']}: GCN forward {row['gcn_forward_ms']:.3f} backward "
            f"{row['gcn_backward_ms']:.3f} ms | GAT forward {row['gat_forward_ms']:.3f} backward "
            f"{row['gat_backward_ms']:.3f} ms"
        )
    del xs, gxs
    with torch.no_grad():
        rows = train_kernel_times(tp, tp_t, tile16, tile_t16, gen)
    return dict(
        rows=rows, max_err=max_err, times=times, layers=layers,
        gcn_counts=gcn_counts, gat_counts=gat_counts, gcn_losses=losses, gat_losses=glosses,
    )


def tile_slice(tp, start: int, stop: int):
    """Tiles start..stop of a plan, for B6 and its plain version (which read
    neither run_start nor the runs' order)."""
    if start == 0 and stop >= tp.num_tiles:
        return tp
    return dataclasses.replace(
        tp, a=tp.a[start:stop], tile_row=tp.tile_row[start:stop], tile_col=tp.tile_col[start:stop],
        num_tiles=min(stop, tp.num_tiles) - start,
    )


def host_plan(tp):
    """A card plan back on the host (numpy), for pad_runs."""
    return dataclasses.replace(
        tp, a=tp.a.cpu().numpy(), tile_row=tp.tile_row.cpu().numpy(), tile_col=tp.tile_col.cpu().numpy(),
        run_start=tp.run_start.cpu().numpy(),
    )


def part_name(tp) -> str:
    return "1-bit" if tp.bits else "int8"


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bfloat16 ulp at |x| (8 significant bits)."""
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(torch.finfo(torch.float32).tiny))) - 7)


def cells_agree(got, want, cnt, what: str) -> float:
    """B6's cells against the plain version's: cells without an edge are
    exactly +0; float32 cells within KERNEL_TOL * max|plain|, bfloat16 cells
    at most one bfloat16 ulp apart.  Returns max|d|."""
    check(got.shape == want.shape and got.dtype == want.dtype, f"{what}: shape or dtype")
    raw = got.view(torch.int16) if got.dtype == torch.bfloat16 else got.view(torch.int32)
    check(not bool(((raw != 0) & (cnt == 0)).any()), f"{what}: a cell without an edge is not +0")
    g, w = got.float(), want.float()
    check(bool(torch.isfinite(g).all()), f"{what}: non-finite cell")
    err = (g - w).abs().max().item()
    scale = w.abs().max().item()
    if got.dtype == torch.bfloat16:
        ulp_bad = int(((g - w).abs() > bf16_ulp(torch.maximum(g.abs(), w.abs()))).sum())
        check(ulp_bad == 0, f"{what}: {ulp_bad} bfloat16 cells more than one ulp from the plain version")
    else:
        check(err <= KERNEL_TOL * scale, f"{what}: disagrees with the plain version")
    return err


def sddmm_vs_plain(tp, f: int, gen, what: str) -> float:
    """B6 against sddmm_bcsr_plain on N(0, 1) a and b, float32 and bfloat16
    cells, CHECK_TILES tiles at a time.  Returns max|d| of the float32
    cells."""
    a = torch.randn((tp.n_src, f), generator=gen, device="cuda")
    b = torch.randn((tp.num_nodes, f), generator=gen, device="cuda")
    err, worst = 0.0, {}
    for s in range(0, tp.num_tiles, CHECK_TILES):
        sub = tile_slice(tp, s, s + CHECK_TILES)
        cnt = sub.counts()
        for out in (torch.float32, torch.bfloat16):
            got = sddmm_bcsr(sub, a, b, out_dtype=out, dot_mode="split23")
            want = sddmm_bcsr_plain(sub, a, b, out)
            torch.cuda.synchronize()
            e = cells_agree(got, want, cnt, f"{what} f={f} {out}")
            worst[out] = max(worst.get(out, 0.0), e)
            if out == torch.float32:
                err = max(err, e)
            del got, want
    log(
        f"  {what} f={f}: tiles={tp.num_tiles} float32 max|d|={worst[torch.float32]:.3e}, "
        f"bfloat16 max|d|={worst[torch.bfloat16]:.3e} (<= 1 ulp), zero cells +0"
    )
    return err


def sddmm_inf_non_edge(tp, gen):
    """A non-edge cell whose dot overflows to inf must come out +0: its
    column neighbour holds an edge, so the lane computes both dots, and B6
    must select on the count; the other cells of up to CHECK_TILES tiles
    from its tile on agree with the plain version."""
    r, c = tp.tile_rows, tp.tile_cols
    t = i = j = None
    for t in range(tp.num_tiles):
        # non-edges whose pair neighbour (column j ^ 1) is an edge
        cnt = tp.counts(t, t + 1)[0]
        pair = cnt.reshape(r, c // 2, 2).flip(-1).reshape(r, c)
        cand = ((cnt == 0) & (pair > 0)).nonzero()
        if cand.shape[0]:
            i, j = (int(x) for x in cand[0])
            break
    check(i is not None, "no non-edge beside an edge")
    row, col = tp.tile_row[t].item() * tp.tile_rows + i, tp.tile_col[t].item() * tp.tile_cols + j
    tp = tile_slice(tp, t, t + CHECK_TILES)  # the chosen tile is now tile 0
    cnt, t = tp.counts(), 0
    a = torch.randn((tp.n_src, SDDMM_F), generator=gen, device="cuda")
    b = torch.randn((tp.num_nodes, SDDMM_F), generator=gen, device="cuda")
    a[col] = 1e30
    b[row] = 1e30
    check(bool(torch.isinf((a[col] * b[row]).sum())), "the chosen non-edge's dot does not overflow")
    for out in (torch.float32, torch.bfloat16):
        got = sddmm_bcsr(tp, a, b, out_dtype=out)
        want = sddmm_bcsr_plain(tp, a, b, out)
        torch.cuda.synchronize()
        check(got[t, i, j].float().item() == 0.0, f"a non-edge with an inf dot gave {got[t, i, j].item()}")
        cells_agree(got, want, cnt, f"{part_name(tp)} inf non-edge {out}")
    log(f"  {part_name(tp)} non-edge cell ({row}, {col}) with an inf dot: +0")


def cell_counts(tp, t, i, j) -> torch.Tensor:
    """Counts of cells (t, i, j) of a plan, either format."""
    if not tp.bits:
        return tp.a[t, i, j].long()
    r8 = tp.tile_rows // 8
    return (tp.a[t, i % r8, j].long() >> (i // r8)) & 1


def sddmm_path_checks(g, agg, cells, res, a, b):
    """Phase 13's checks: every cell without an edge is +0; every edge of
    the graph maps through its part's (row-tile, col-tile) -> tile index to
    a cell with an edge whose value passes the gate against the float64
    dot, or is a residual edge; every residual slot passes the gate and pad
    slots are 0; dense edges + residual edges = m."""
    dev = a.device
    m = g.num_edges
    a64, b64 = a.double(), b.double()
    parts = agg.tile_parts()
    maps, dense_edges = [], 0
    for p, c in zip(parts, cells):
        check(c.dtype == torch.bfloat16 and c.shape == (p.num_tiles, p.tile_rows, p.tile_cols), "cell array shape")
        real = torch.zeros(p.num_tiles, dtype=torch.bool, device=dev)
        in_cells = 0
        for s in range(0, p.num_tiles, CHECK_TILES):
            cnt = p.counts(s, s + CHECK_TILES)
            cs = c[s : s + CHECK_TILES]
            check(
                not bool(((cs.view(torch.int16) != 0) & (cnt == 0)).any()),
                f"{part_name(p)}: a cell without an edge is not +0",
            )
            check(bool(torch.isfinite(cs.float()).all()), f"{part_name(p)}: non-finite cell")
            real[s : s + CHECK_TILES] = cnt.reshape(cnt.shape[0], -1).any(dim=1)
            in_cells += int(cnt.sum(dtype=torch.int64))
        check(in_cells == p.num_dense_edges, f"{part_name(p)}: cell counts do not sum to its dense edges")
        dense_edges += p.num_dense_edges
        tmap = torch.full((p.num_row_tiles, p.num_col_tiles), -1, dtype=torch.long, device=dev)
        idx = real.nonzero().squeeze(1)
        tmap[p.tile_row.long()[idx], p.tile_col.long()[idx]] = idx
        maps.append(tmap)
    check(dense_edges + agg.plan.num_edges == m, "dense edges + residual edges != m")

    g_dst = torch.from_numpy(g.dst_per_edge.astype(np.int64)).to(dev)
    g_src = torch.from_numpy(g.indices.astype(np.int64)).to(dev)
    in_tiles, bad = 0, 0
    for s in range(0, m, CHECK_EDGES):
        d, sr = g_dst[s : s + CHECK_EDGES], g_src[s : s + CHECK_EDGES]
        ref = (a64.index_select(0, sr) * b64.index_select(0, d)).sum(dim=1)
        hit_any = torch.zeros(d.shape[0], dtype=torch.bool, device=dev)
        for p, c, tmap in zip(parts, cells, maps):
            t = tmap[d // p.tile_rows, sr // p.tile_cols]
            hit = t >= 0
            th, i, j = t[hit], d[hit] % p.tile_rows, sr[hit] % p.tile_cols
            check(bool((cell_counts(p, th, i, j) > 0).all()), "an edge of a tile lies in a cell without an edge")
            bad += relative_error_count(c[th, i, j].float(), ref[hit])
            hit_any |= hit
        in_tiles += int(hit_any.sum())
    log(f"  dense edges vs f64 dots: gate_bad={bad} of {in_tiles} (edges in tiles; {dense_edges} in cell counts)")
    check(bad == 0, "dense edges fail the gate against the f64 dots")
    # edges outside every tile, and those past a cell's int8 cap, are the residual
    check(m - in_tiles + (in_tiles - dense_edges) == agg.plan.num_edges, "the residual is not the edges left outside the cells")

    plan = agg.plan
    bsz = plan.block_size
    valid = torch.arange(bsz, device=dev)[None, :] < plan.count.long()[:, None]
    valid = valid.reshape(-1)
    check(int(valid.sum()) == plan.num_edges, "residual slots != residual edges")
    check(bool((res[~valid] == 0).all()), "a residual pad slot is not 0")
    src, dst = plan.src_flat(), plan.dst.repeat_interleave(bsz)
    bad = 0
    for s in range(0, src.shape[0], CHECK_EDGES):
        v = valid[s : s + CHECK_EDGES]
        ref = (a64.index_select(0, src[s : s + CHECK_EDGES]) * b64.index_select(0, dst[s : s + CHECK_EDGES])).sum(dim=1)
        bad += relative_error_count(res[s : s + CHECK_EDGES][v], ref[v])
    log(f"  residual edges vs f64 dots: gate_bad={bad} of {plan.num_edges}")
    check(bad == 0, "residual edges fail the gate against the f64 dots")


def sddmm_phases(args, g, gen) -> dict:
    """Phases 12-13: B6 against its plain version, then bench.py's SDDMM
    path.  Returns what phase 15 times."""
    dev = gen.device
    n, m = g.num_nodes, g.num_edges
    t0 = time.perf_counter()
    agg = Aggregator.schedule_hybrid(
        g, residual_block=RESIDUAL_BLOCK, pack=1, bit_tiles=True, device=dev, **SDDMM_SCHEDULE
    )
    build_s = time.perf_counter() - t0
    parts = agg.tile_parts()
    check(len(parts) == 2, "the SDDMM plan did not split into a 1-bit and an int8 part")
    parts16 = [host_plan(p).pad_runs(16).to(dev) for p in parts]
    nnz = [
        sum(int((p.counts(s, s + CHECK_TILES) > 0).sum()) for s in range(0, p.num_tiles, CHECK_TILES))
        for p in parts
    ]
    log(
        f"SDDMM plan ({args.scale}): " + "; ".join(
            f"{part_name(p)} part tiles={p.num_tiles} (pack16: {p16.num_tiles}) nonzero cells={z} "
            f"dense edges={p.num_dense_edges} A bytes={p.a.numel()} longest run={int(p.run_start.diff().max())}"
            for p, p16, z in zip(parts, parts16, nnz)
        )
        + f"; residual edges={agg.plan.num_edges} tasks={agg.plan.num_tasks}; cell bytes (bf16)="
        f"{sum(2 * p.num_tiles * p.tile_rows * p.tile_cols for p in parts)}; built in {build_s:.1f} s"
    )

    # ---- phase 12: B6 against its plain version
    log("phase 12: B6 kernel vs sddmm_bcsr_plain")
    max_err = 0.0
    with torch.no_grad():
        for plans, label in ((parts, "pack1"), (parts16, "pack16")):
            for p in plans:
                for f in BENCH_DIMS[1:]:
                    err = sddmm_vs_plain(p, f, gen, f"{label} {part_name(p)}")
                    if label == "pack1":
                        max_err = max(max_err, err)
        ng, _ = ragged_graph()
        rhost = densify(ng, **SDDMM_SCHEDULE)[0]
        ragged = [rhost.pad_runs(16)] + [p.pad_runs(16) for p in split_bit_tiles(rhost) if p is not None]
        fillers = [filler_only_runs(p) for p in ragged]
        check(ng.num_nodes % SDDMM_SCHEDULE["tile_rows"] != 0 and all(fillers), "SDDMM ragged case lacks a filler-only run")
        log(f"  ragged raw-count plan: n={ng.num_nodes}, int8 / 1-bit / int8 parts tiles "
            f"{[p.num_tiles for p in ragged]}, filler-only runs {fillers}")
        for p in ragged:
            for f in (BENCH_DIMS[1], BENCH_DIMS[3]):
                sddmm_vs_plain(p.to(dev), f, gen, f"ragged {'' if p is ragged[0] else 'part '}{part_name(p)}")
        odd, _ = split_bit_tiles(densify(ng, tile_rows=200, tile_cols=128, threshold=24)[0])
        check(odd is not None, "no 1-bit part at R = 200")
        sddmm_vs_plain(odd.to(dev), SDDMM_F, gen, "1-bit R=200")
        for p in parts:
            sddmm_inf_non_edge(p, gen)
        del ragged, odd

    # ---- phase 13: the SDDMM path
    log(f"phase 13: bench.py --model sddmm path, {SDDMM_CALLS} hybrid_sddmm calls (split23, f16_split2)")
    a = torch.from_numpy(normal_features(n, SDDMM_F, seed=3) * 0.1).to(dev)
    b = torch.from_numpy(normal_features(n, SDDMM_F, seed=4) * 0.1).to(dev)
    plan = agg.plan if agg.plan.num_edges else None

    def path():
        return hybrid_sddmm(parts, plan, a, b, gather_dtype="f16_split2", dot_mode="split23")

    with torch.no_grad():
        reset_counts()
        for _ in range(SDDMM_CALLS):
            cells, res = path()
        torch.cuda.synchronize()
        launches = cuda_sddmm.launches
        log(f"  B6 launches in {SDDMM_CALLS} calls: {launches} ({len(parts)} parts)")
        check(launches == SDDMM_CALLS * len(parts), "B6 did not launch once per part per call")
        check(only("B6"), "the SDDMM path launched another kernel")
        sddmm_path_checks(g, agg, cells, res, a, b)
        del cells, res
    return dict(agg=agg, parts16=parts16, nnz=nnz, a=a, b=b, path=path, launches=launches, max_err=max_err)


def bits_gcn_phase(g, h0, tile_host, res_host, res_plan, gcn_out, forwards, gen) -> dict:
    """Phase 14: B1 over 1-bit tiles against its plain version, then the GCN
    forward over phase 3's plan split by split_bit_tiles.  Returns what
    phase 15 times."""
    dev = h0.device
    n = g.num_nodes
    tb, ti = split_bit_tiles(tile_host)
    check(tb is not None and ti is not None, "the GCN plan did not split into a 1-bit and an int8 part")
    tb, ti = tb.to(dev), ti.to(dev)
    agg = Aggregator(plan=res_plan, num_nodes=n, n_src=g.n_src, num_edges=g.num_edges, tile=ti, tile_bits=tb)
    log(
        f"phase 14: GCN forward over 1-bit tiles: phase 3's plan split into a 1-bit part (tiles={tb.num_tiles}, "
        f"dense edges={tb.num_dense_edges}, A bytes={tb.a.numel()}) and an int8 part (tiles={ti.num_tiles}, "
        f"dense edges={ti.num_dense_edges}, A bytes={ti.a.numel()}); unsplit A bytes={tile_host.a.nbytes}"
    )
    tb16 = host_plan(tb).pad_runs(16).to(dev)
    max_err = 0.0
    with torch.no_grad():
        for plan, label in ((tb, "1-bit pack1"), (tb16, "1-bit pack16")):
            for f in BENCH_DIMS[1:]:
                for mode in ("split", "native"):
                    err = kernel_vs_plain(plan, f, mode, gen, label)
                    if plan is tb:
                        max_err = max(max_err, err)
        ng, rng = ragged_graph()
        sd = rng.uniform(0.2, 2.0, ng.num_nodes).astype(np.float32)
        ss = rng.uniform(0.2, 2.0, ng.n_src).astype(np.float32)
        ragged, _ = densify(ng, val=sd[ng.dst_per_edge] * ss[ng.indices], scale_dst=sd, scale_src=ss, **SCHEDULE)
        rbits = split_bit_tiles(ragged)[0].pad_runs(16)
        check(bool(filler_only_runs(rbits)), "1-bit ragged case lacks a filler-only run")
        rbits = rbits.to(dev)
        for f in (BENCH_DIMS[1], BENCH_DIMS[3]):
            for mode in ("split", "native"):
                kernel_vs_plain(rbits, f, mode, gen, "ragged factored 1-bit part")
        del rbits, ragged

        model = gcn_params_from_jax(glorot_weights(BENCH_DIMS, seed=0), device=dev)
        opts = fast_layer_opts(BENCH_DIMS)
        reset_counts()
        for _ in range(forwards):
            out = model(agg, h0, opts)
        torch.cuda.synchronize()
        launches = cuda_bcsr.launches
        log(f"  B1 launches in {forwards} forwards: {launches} (3 layers x 2 parts)")
        check(launches == 6 * forwards, "B1 did not launch 6 times per forward")
        check(only("B1"), "the 1-bit GCN forward launched another kernel")
        check(out.shape == (n, BENCH_DIMS[-1]) and bool(torch.isfinite(out).all()), "1-bit forward output")
        tp = tile_host.to(dev)  # the unsplit plan: its cells are the two parts' cells
        edges = gcn_edges(g, res_host, tp)
        xs = gcn_gates(agg, model.weights, opts, h0, out, edges, "1-bit ")
        del edges
        bad = relative_error_count(out, gcn_out)
        log(f"  1-bit forward vs phase 3's int8 forward: gate_bad={bad} max|d|={(out - gcn_out).abs().max().item():.3e}")
        check(bad == 0, "the 1-bit forward differs from the int8 forward")
    return dict(agg=agg, model=model, opts=opts, xs=xs, tp=tp, launches=launches, max_err=max_err)


def timing_phase(g, sd, bt) -> tuple:
    """Phase 15: the SDDMM path and B6, then the 1-bit GCN forward and B1
    over 1-bit tiles.  Returns (B6 entry fields, B1 1-bit entry fields)."""
    log("phase 15: SDDMM and 1-bit timing (CUDA events, median of 10 after 3 warm-up)")
    n, m = g.num_nodes, g.num_edges
    agg, a, b = sd["agg"], sd["a"], sd["b"]
    with torch.no_grad():
        path_ms = cuda_time_ms(sd["path"])
        plan = agg.plan
        res_ms = cuda_time_ms(lambda: sddmm_slots(plan, a, b, gather_dtype="f16_split2")) if plan.num_edges else 0.0
        log(f"  SDDMM path: {path_ms:.3f} ms, {m / (path_ms / 1e3):.4e} edges/s; residual {res_ms:.3f} ms")
        at = a.t().contiguous()
        rows6 = []
        for p, p16, nnz in zip(agg.tile_parts(), sd["parts16"], sd["nnz"]):
            c_dst, c_src, _ = tile_cells(p)
            csr = cells_csr(c_dst, c_src, torch.ones(c_dst.shape[0], device=a.device), (n, p.n_src))
            lib = torch.sparse.sampled_addmm(csr, b, at, beta=0.0)
            r, c = csr_rows(lib), lib.col_indices()
            ref = (b.index_select(0, r) * a.index_select(0, c)).sum(dim=1)
            check((lib.values() - ref).abs().max() <= 1e-4 * ref.abs().max(), "sampled_addmm yardstick disagrees")
            t, f = p.num_tiles, SDDMM_F
            row = dict(
                part=part_name(p), f=f, tiles=t, tiles_pack16=p16.num_tiles, nnz_cells=nnz,
                ms=cuda_time_ms(lambda: cuda_sddmm.sddmm_bcsr_cuda(p, a, b)),
                ms_pack16=cuda_time_ms(lambda: cuda_sddmm.sddmm_bcsr_cuda(p16, a, b)),
                plain_ms=cuda_time_ms(lambda: sddmm_bcsr_plain(p, a, b)),
                library_ms=cuda_time_ms(lambda: torch.sparse.sampled_addmm(csr, b, at, beta=0.0)),
                **bound(p.a.numel() + 2 * t * p.tile_rows * p.tile_cols + 8 * t + 4 * f * (p.n_src + n), 2.0 * nnz * f),
            )
            rows6.append(row)
            log(
                f"  B6 {row['part']}: {row['ms']:.3f} ms/launch (pack16 {row['ms_pack16']:.3f}) bound "
                f"{row['bound_ms']:.4f} ms ({row['bound_by']}) | plain {row['plain_ms']:.3f} | "
                f"sampled_addmm {row['library_ms']:.3f}"
            )
            del csr, lib, ref

        bagg, model, opts, xs, tp = bt["agg"], bt["model"], bt["opts"], bt["xs"], bt["tp"]
        fwd_ms = cuda_time_ms(lambda: model(bagg, xs[0], opts))
        log(f"  1-bit GCN forward: {fwd_ms:.3f} ms")
        tb, ti = bagg.tile_bits, bagg.tile
        csr = tile_csr(tb)
        nnz = csr.values().numel()
        rows1 = []
        for i, w in enumerate(model.weights):
            x = round_h((xs[i] @ w).contiguous(), opts[i].tile_h_mode)
            f = x.shape[1]
            row = dict(
                f=f, tiles=tb.num_tiles, nnz_cells=nnz,
                ms=cuda_time_ms(lambda: cuda_bcsr.bcsr_spmm_cuda(tb, x)),
                int8_part_ms=cuda_time_ms(lambda: cuda_bcsr.bcsr_spmm_cuda(ti, x)),
                unsplit_int8_ms=cuda_time_ms(lambda: cuda_bcsr.bcsr_spmm_cuda(tp, x)),
                plain_ms=cuda_time_ms(lambda: bcsr_spmm_plain(tb, x)),
                library_ms=cuda_time_ms(lambda: torch.sparse.mm(csr, x)),
                **bound(tb.a.numel() + 4 * (tb.num_tiles + tb.num_row_tiles + 1) + 4 * f * (tb.n_src + n), 2.0 * nnz * f),
            )
            rows1.append(row)
            log(
                f"  layer {i + 1} f={f}: B1 1-bit part {row['ms']:.3f} ms/launch + int8 part {row['int8_part_ms']:.3f} "
                f"(unsplit int8 {row['unsplit_int8_ms']:.3f}) bound {row['bound_ms']:.4f} ({row['bound_by']}) | "
                f"plain {row['plain_ms']:.3f} | torch.sparse.mm {row['library_ms']:.3f}"
            )
    return (
        dict(rows=rows6, path_ms=path_ms, edges_per_s=m / (path_ms / 1e3), residual_ms=res_ms),
        dict(rows=rows1, forward_ms=fwd_ms),
    )


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", choices=sorted(SCALES), default="quick")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing to check", file=sys.stderr)
        return 1
    dev = torch.device("cuda")

    # ---- phase 1: card and build
    name = torch.cuda.get_device_name(0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    log(f"device: {name}  ({card})  torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    libs = cuda_build.build_all()
    log(f"build: {len(libs)} kernel libraries in {time.perf_counter() - t0:.2f} s (parallel nvcc)")
    for lib, secs in libs.values():
        log(f"  {lib.name}: {secs:.2f} s")
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"    ptxas: {line.strip()}")
    build_s = libs["bcsr_spmm"][1]

    # ---- graph and plans
    n, m = SCALES[args.scale]
    t0 = time.perf_counter()
    g = rmat_graph(n, m, seed=123, with_val=False)
    g = g.reorder(degree_sort(g))
    agg = Aggregator.schedule_hybrid(g, residual_block=RESIDUAL_BLOCK, pack=1, device=dev, **SCHEDULE)
    tile_host, res_host = densify(g, **SCHEDULE)
    tile16 = tile_host.pad_runs(16).to(dev)
    tp = agg.tile
    log(
        f"plan ({args.scale}): n={n} m={m} tiles={tp.num_tiles} (pack16: {tile16.num_tiles}) "
        f"dense_edges={tp.num_dense_edges} residual_edges={agg.plan.num_edges} "
        f"tasks={agg.plan.num_tasks} built in {time.perf_counter() - t0:.1f} s"
    )

    # ---- phase 2: kernel against its plain version
    log("phase 2: B1 kernel vs bcsr_spmm_plain")
    gen = torch.Generator(device=dev).manual_seed(0)
    max_err = 0.0
    for plan, label in ((tp, "pack1"), (tile16, "pack16")):
        for f in (BENCH_DIMS[1], BENCH_DIMS[2], BENCH_DIMS[3]):
            for mode in ("split", "native"):
                err = kernel_vs_plain(plan, f, mode, gen, label)
                if plan is tp:
                    max_err = max(max_err, err)
    # n not a multiple of R, and a last row-tile too sparse for any tile:
    # after pad_runs(16) its run is 16 filler tiles
    ng, rng = ragged_graph()
    sd = rng.uniform(0.2, 2.0, ng.num_nodes).astype(np.float32)
    ss = rng.uniform(0.2, 2.0, ng.n_src).astype(np.float32)
    ragged, _ = densify(
        ng, val=sd[ng.dst_per_edge] * ss[ng.indices], scale_dst=sd, scale_src=ss, **SCHEDULE
    )
    ragged = ragged.pad_runs(16)
    filler_runs = filler_only_runs(ragged)
    check(ng.num_nodes % SCHEDULE["tile_rows"] != 0 and filler_runs, "ragged case lacks a filler-only run")
    log(f"  ragged factored plan: n={ng.num_nodes} tiles={ragged.num_tiles} filler-only runs={filler_runs}")
    ragged = ragged.to(dev)
    for f in (BENCH_DIMS[1], BENCH_DIMS[3]):
        for mode in ("split", "native"):
            kernel_vs_plain(ragged, f, mode, gen, "ragged factored")

    # ---- phase 3: the slice's main path
    log("phase 3: 3-layer GCN forward, fast_layer_opts")
    model = gcn_params_from_jax(glorot_weights(BENCH_DIMS, seed=0), device=dev)
    opts = fast_layer_opts(BENCH_DIMS)
    h0 = torch.from_numpy(normal_features(n, BENCH_DIMS[0], seed=123) * 0.1).to(dev)
    forwards = 5
    with torch.no_grad():
        reset_counts()
        for _ in range(forwards):
            out = model(agg, h0, opts)
        torch.cuda.synchronize()
        launches = cuda_bcsr.launches
        check(only("B1"), "the GCN forward launched another kernel")
        log(f"  B1 launches in {forwards} forwards: {launches}")
        check(launches == 3 * forwards, "B1 did not launch 3 times per forward")
        check(out.shape == (n, BENCH_DIMS[-1]) and bool(torch.isfinite(out).all()), "forward output")

        edges = gcn_edges(g, res_host, tp)
        xs = gcn_gates(agg, model.weights, opts, h0, out, edges, "")
        del edges
        gcn_out = out

        # ---- phase 4: timing
        log("phase 4: timing (CUDA events, median of 10 after 3 warm-up)")
        fwd_ms = cuda_time_ms(lambda: model(agg, h0, opts))
        log(f"  forward: {fwd_ms:.3f} ms")
        csr = tile_csr(tp)
        nnz = csr.values().numel()
        shapes = []
        for i, w in enumerate(model.weights):
            layer_ms = cuda_time_ms(lambda: gcn_layer(agg, xs[i], w, opts[i]))
            x = round_h((xs[i] @ w).contiguous(), opts[i].tile_h_mode)
            f = x.shape[1]
            ms = cuda_time_ms(lambda: cuda_bcsr.bcsr_spmm_cuda(tp, x))
            ms16 = cuda_time_ms(lambda: cuda_bcsr.bcsr_spmm_cuda(tile16, x))
            plain_ms = cuda_time_ms(lambda: bcsr_spmm_plain(tp, x))
            library_ms = cuda_time_ms(lambda: torch.sparse.mm(csr, x))
            move = tp.a.numel() + 4 * (tp.num_tiles + tp.num_row_tiles + 1) + 4 * f * (tp.n_src + tp.num_nodes)
            bytes_ms = move / HBM_BYTES_PER_S * 1e3
            ops_ms = 2.0 * nnz * f / FP32_FLOPS * 1e3
            stream_ms = (tp.a.numel() + 4.0 * tp.num_tiles * tp.tile_cols * f) / HBM_BYTES_PER_S * 1e3
            row = dict(
                f=f, layer_ms=layer_ms, ms=ms, ms_pack16=ms16, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=max(bytes_ms, ops_ms), bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                tile_stream_ms=stream_ms, tiles=tp.num_tiles, nnz_cells=nnz,
            )
            shapes.append(row)
            log(
                f"  layer {i + 1} f={f}: layer {layer_ms:.3f} ms | B1 {ms:.3f} ms/launch "
                f"(pack16 {ms16:.3f}) bound {row['bound_ms']:.4f} ms ({row['bound_by']}; tile stream "
                f"{stream_ms:.4f}) | plain {plain_ms:.3f} | torch.sparse.mm {library_ms:.3f}"
            )

    res_plan = agg.plan
    del agg, tp, tile16, model, xs, csr
    torch.cuda.empty_cache()
    gat_kernels = gat_phases(args, g, h0, gen, forwards, libs)
    torch.cuda.empty_cache()
    train = None
    if args.scale == "quick":
        train = train_phases(args, g, h0, gen)
    else:
        log("phases 8-11 (training) run at the quick scale only")
    torch.cuda.empty_cache()
    sdd = sddmm_phases(args, g, gen)
    torch.cuda.empty_cache()
    bt = bits_gcn_phase(g, h0, tile_host, res_host, res_plan, gcn_out, forwards, gen)
    b6, b1_bits = timing_phase(g, sdd, bt)

    # ---- phase 16: report
    total = lambda k: sum(r[k] for r in shapes)  # noqa: E731
    kernels = [dict(
        name="bcsr_spmm",
        route="cuda",
        source="gnn_computing_tpu_torch/csrc/bcsr_spmm.cu",
        replaces="gnn_computing_tpu/ops/pallas_bcsr.py:180",
        launches=launches,
        max_abs_err=max_err,
        # times summed over the three launches of one forward (f=128, 64, 32)
        ms=total("ms"), plain_ms=total("plain_ms"), bound_ms=total("bound_ms"),
        bound_by="bytes" if all(r["bound_by"] == "bytes" for r in shapes) else "operations",
        library_ms=total("library_ms"),
        forward_ms=fwd_ms, build_s=build_s, scale=args.scale, shapes=shapes,
    )] + gat_kernels

    def summed(rows, **extra):
        # times summed over the rows' launches (the three layers of one step
        # or forward; the parts of one SDDMM call)
        return dict(
            ms=sum(r["ms"] for r in rows), plain_ms=sum(r["plain_ms"] for r in rows),
            bound_ms=sum(r["bound_ms"] for r in rows),
            bound_by="bytes" if all(r["bound_by"] == "bytes" for r in rows) else "operations",
            library_ms=sum(r["library_ms"] for r in rows), shapes=rows, **extra,
        )

    kernels[0]["bits"] = dict(
        path="GCN forward over phase 3's plan split into 1-bit and int8 parts (fast_layer_opts)",
        launches=bt["launches"], launches_per_forward=6, max_abs_err=bt["max_err"],
        forward_ms=b1_bits["forward_ms"], **summed(b1_bits["rows"], over="the 1-bit part, f=128, 64, 32"),
    )
    if train is not None:
        rows, tt = train["rows"], train["times"]
        kernels[0]["training"] = dict(
            path=f"GCN training step (B1 forward and over the transposed plan), {TRAIN_STEPS} steps",
            launches=train["gcn_counts"]["B1"], launches_per_step=6, max_abs_err=train["max_err"]["B1_t"],
            step_ms=tt["gcn_step_ms"], **summed(rows["B1_t"], over="transposed [256, 256] plan"),
        )
        kernels[1]["training"] = dict(
            path=f"GAT training step, {TRAIN_STEPS} steps", launches=train["gat_counts"]["B2"], launches_per_step=3,
            max_abs_err=train["max_err"]["B2"], step_ms=tt["gat_step_ms"], **summed(rows["B2"], over="[256, 256] plan"),
        )
        for kname, key, replaces in (
            ("gat_bwd_dad", "B3", "gnn_computing_tpu/ops/pallas_bcsr.py:869"),
            ("gat_bwd_dh_das", "B4", "gnn_computing_tpu/ops/pallas_bcsr.py:1045"),
        ):
            kernels.append(dict(
                name=kname, route="cuda", source=f"gnn_computing_tpu_torch/csrc/{kname}.cu", replaces=replaces,
                launches=train["gat_counts"][key], launches_per_step=3, max_abs_err=train["max_err"]["B3"],
                **summed(rows[key]), path=f"GAT training step (fast=False, stabilize='bound', split2), {TRAIN_STEPS} steps",
                step_ms=tt["gat_step_ms"], build_s=libs[kname][1], scale=args.scale,
            ))
        print(json.dumps({"training": dict(
            times=tt, layers=train["layers"], gcn_losses=train["gcn_losses"], gat_losses=train["gat_losses"],
        )}), flush=True)
    kernels.append(dict(
        name="sddmm_bcsr", route="cuda", source="gnn_computing_tpu_torch/csrc/sddmm_bcsr.cu",
        replaces="gnn_computing_tpu/ops/bcsr_sddmm.py:100", launches=sdd["launches"],
        launches_per_call=len(sdd["agg"].tile_parts()), max_abs_err=sdd["max_err"],
        **summed(b6["rows"]), path=(
            f"bench.py --model sddmm (hybrid): [256, 128] t24, 1-bit tiles, residual {RESIDUAL_BLOCK}, "
            f"f={SDDMM_F}, split23, f16_split2, bf16 cells; {SDDMM_CALLS} calls"
        ),
        path_ms=b6["path_ms"], edges_per_s=b6["edges_per_s"], residual_ms=b6["residual_ms"],
        build_s=libs["sddmm_bcsr"][1], scale=args.scale,
    ))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
