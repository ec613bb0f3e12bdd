#!/usr/bin/env python3
"""Chip check of the PyTorch port (gnn_computing_tpu_torch) on one CUDA card.

Run from the repository root:  python3 chip_smoke.py [--scale quick|reddit]

Phases (any failure exits non-zero; nothing is caught):
  1. card name and power limit; build every kernel with nvcc (sm_90a), one
     nvcc per source, all at once (B1 bcsr_spmm, B2 gat_bcsr, B5 rowmax_bcsr).
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
  8. one "kernels" JSON line, the card line, then {"ok": true, ...}.

Launch counts: every count is set to 0 just before a path is driven and
read just after it (the GCN forward for B1, the GAT forward for B2, the
stabilized GAT forward for B5); launches made to compare a kernel with its
plain version are not counted.

The port schedules with pack=1: the CUDA kernels take runs of any length,
so the TPU kernel's filler tiles would only add work (their cost is printed).
"""

from __future__ import annotations

import argparse
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
from gnn_computing_tpu_torch.ops import cuda_bcsr, cuda_build, cuda_gat, cuda_rowmax
from gnn_computing_tpu_torch.ops.bcsr import bcsr_rowmax, bcsr_rowmax_plain, bcsr_spmm, bcsr_spmm_plain, round_h
from gnn_computing_tpu_torch.ops.bcsr_gat import _branch_factors, _hybrid_row_shift, gat_bcsr, gat_bcsr_plain
from gnn_computing_tpu_torch.ops.gat import DEFAULT_SLOPE
from gnn_computing_tpu_torch.ops.validate import relative_error_count
from gnn_computing_tpu_torch.schedule.tiles import densify
from gnn_computing_tpu_torch.utils.timing import cuda_time_ms

SCALES = {"quick": (1 << 16, 1 << 22), "reddit": (232_965, 114_615_891)}
SCHEDULE = dict(tile_rows=512, tile_cols=256, threshold=48)  # bench.py defaults
GAT_SCHEDULE = dict(tile_rows=512, tile_cols=256, threshold=32)  # bench.py --model gat
RESIDUAL_BLOCK = 4
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
    t, i, j = tp.a.nonzero(as_tuple=True)
    rows = tp.tile_row.long()[t] * tp.tile_rows + i
    cols = tp.tile_col.long()[t] * tp.tile_cols + j
    return rows, cols, tp.a[t, i, j].double()


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
    cuda_bcsr.launches = cuda_gat.launches = cuda_rowmax.launches = 0


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
        check(cuda_rowmax.launches == 0 and cuda_bcsr.launches == 0, "the GAT forward launched another kernel")
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
        check(cuda_gat.launches == 0 and cuda_rowmax.launches == 0, "the GCN forward launched a GAT kernel")
        log(f"  B1 launches in {forwards} forwards: {launches}")
        check(launches == 3 * forwards, "B1 did not launch 3 times per forward")
        check(out.shape == (n, BENCH_DIMS[-1]) and bool(torch.isfinite(out).all()), "forward output")

        # float64 oracles over edge lists: the whole graph from the layer
        # input ("pure"), and the aggregation the numeric modes define
        # ("mode"): from the layer's own float32 transform z, tile edges
        # take the tile_h_mode rounding of z, residual edges z exactly.  The
        # tile/residual split comes from the host densify, checked here to
        # partition the graph's edges.
        def edges(gr):
            return (
                torch.from_numpy(gr.dst_per_edge.astype(np.int64)).to(dev),
                torch.from_numpy(gr.indices.astype(np.int64)).to(dev),
            )

        g_dst, g_src = edges(g)
        r_dst, r_src = edges(res_host)
        c_dst, c_src, c_cnt = tile_cells(tp)
        per_row = torch.bincount(c_dst, weights=c_cnt, minlength=n) + torch.bincount(r_dst, minlength=n)
        check(
            torch.equal(per_row.long().cpu(), torch.from_numpy(g.degrees.astype(np.int64))),
            "tile cells + residual edges do not partition the graph's edges",
        )
        limit = PURE_BAD_FRACTION
        xs, chain = [h0], h0.double()
        for i, w in enumerate(model.weights):
            xs.append(gcn_layer(agg, xs[i], w, opts[i]))
            z32 = xs[i] @ w  # the layer's own float32 transform
            zt = round_h(z32, opts[i].tile_h_mode).double()
            mode_ref = (edge_sum(zt, c_dst, c_src, c_cnt) + edge_sum(z32.double(), r_dst, r_src)).clamp_min_(0.0)
            z = xs[i].double() @ w.double()
            pure_ref = edge_sum(z, g_dst, g_src).clamp_min_(0.0)
            bad = relative_error_count(xs[-1], mode_ref)
            bad_pure = relative_error_count(xs[-1], pure_ref)
            log(
                f"  layer {i + 1} (same input) vs f64 oracle: mode gate_bad={bad}, "
                f"pure gate_bad={bad_pure} of {z.numel()}"
            )
            check(bad == 0, f"layer {i + 1} fails the gate against its modes' f64 oracle")
            check(bad_pure <= limit * z.numel(), f"layer {i + 1}: too many elements off the pure oracle")
            chain = edge_sum(chain @ w.double(), g_dst, g_src).clamp_min_(0.0)
        bad = relative_error_count(out, chain)
        log(f"  forward vs f64 pure oracle chain: gate_bad={bad} of {chain.numel()}")
        check(bad <= limit * chain.numel(), "forward: too many elements off the pure oracle chain")
        del g_dst, g_src, r_dst, r_src, c_dst, c_src, c_cnt, chain, z, z32, zt, mode_ref, pure_ref

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

    del agg, tile16, model, xs
    torch.cuda.empty_cache()
    gat_kernels = gat_phases(args, g, h0, gen, forwards, libs)

    # ---- phase 8: report
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
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
