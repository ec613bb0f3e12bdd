"""Probe: the residual gather overlapped with the dense tile walk.

Counterpart of the JAX package's ``probes/overlap_dma_residual.py``.  Its
question: does one kernel that gathers the residual plan's rows while the
dense tiles are multiplied beat the two passes in sequence?  On the TPU
the answer was no: the per-row DMAs are sub-tile and the gather is as
bandwidth-bound as the tiles.  Here the two kernels are hand-written CUDA:

  dma_task_sums (P1, csrc/task_sums.cu): the residual's per-task sums,
      task_sums[t] = sum_b val[t, b] * h[src[t, b]];
  fused_hybrid (P2, csrc/fused_hybrid.cu): B1's cell walk and P1's task
      rows in one grid, the residual blocks after the walk's.

On CPU tensors both run their plain versions (``weighted_task_sums``;
``bcsr_spmm_plain`` plus ``weighted_task_sums``).  ``main`` builds the
probe's plan (RMAT seed 123, degree-sorted, int8 [256, 128] tiles at
threshold 24, residual block 4, as bench.build_hybrid builds it), checks
the kernels against the plain residual (``spmm_plain``) and hybrid
(``hybrid_spmm``), and times the fused pass against the sequential one:

  python -m gnn_computing_tpu_torch.probes.overlap_dma_residual --small --mode fused
  python -m gnn_computing_tpu_torch.probes.overlap_dma_residual --device cpu --nodes 4096 --edges 60000

It runs on the card unless ``--device cpu`` is given; timings are taken
only on the card (CUDA events), the CPU run prints the errors alone.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import numpy as np
import torch

from gnn_computing_tpu_torch.aggregator import Aggregator
from gnn_computing_tpu_torch.device import resolve_device
from gnn_computing_tpu_torch.graph import degree_sort, normal_features, rmat_graph
from gnn_computing_tpu_torch.ops import cuda_residual
from gnn_computing_tpu_torch.ops.bcsr import _pre_scale, bcsr_spmm, bcsr_spmm_plain, hybrid_spmm, round_h
from gnn_computing_tpu_torch.ops.spmm import spmm_plain, weighted_task_sums

SMALL = (1 << 16, 1 << 22)  # --small
REDDIT = (232_965, 114_615_891)  # the default: bench.py's reddit scale
SCHEDULE = dict(tile_rows=256, tile_cols=128, threshold=24, residual_block=4)
H_MODES = ("split", "split3")  # the TPU probe's two bf16 chunks, or three


def dma_task_sums(plan, h: torch.Tensor) -> torch.Tensor:
    """[num_tasks_p, f] residual task sums over the plan's own slots: the P1
    kernel on CUDA tensors, ``weighted_task_sums`` on CPU tensors."""
    if h.device.type == "cuda":
        return cuda_residual.task_sums_cuda(plan, h.contiguous())
    if h.device.type == "cpu":
        return weighted_task_sums(plan, h, plan.val)
    raise ValueError(f"no task sums for device {h.device}")


def fused_hybrid_plain(tp, plan, h: torch.Tensor, h_mode: str = "split"):
    """Plain (dense_out, task_sums): the tile product of the h_mode-rounded
    h with the plan's scales (``bcsr_spmm_plain``) and the residual task
    sums of the raw h (``weighted_task_sums``)."""
    return bcsr_spmm_plain(tp, round_h(h, h_mode)), weighted_task_sums(plan, h, plan.val)


def fused_hybrid(tp, plan, h: torch.Tensor, h_mode: str = "split"):
    """(dense_out [num_nodes, f], task_sums [num_tasks_p, f]) in one pass,
    the TPU probe's meaning: the dense part over the h_mode-rounded (and
    scale_src-scaled, then scale_dst-scaled) h, the task sums over the raw
    h; the caller adds the task sums into their rows.  P2 on CUDA tensors,
    ``fused_hybrid_plain`` on CPU tensors.  A 1-bit plan raises ValueError;
    float32 tiles are read as float32 (the TPU probe rounds them to bf16)."""
    if h_mode not in H_MODES:
        raise ValueError(f"h_mode must be one of {H_MODES}, got {h_mode!r}")
    if tp.bits:
        raise ValueError("fused_hybrid takes int8, float32 or bfloat16 tiles, not a 1-bit plan")
    if h.device.type == "cuda":
        x = _pre_scale(tp, round_h(h, h_mode))
        return cuda_residual.fused_hybrid_cuda(tp, plan, x.contiguous(), h.contiguous())
    if h.device.type == "cpu":
        return fused_hybrid_plain(tp, plan, h, h_mode)
    raise ValueError(f"no fused hybrid pass for device {h.device}")


def add_tasks(plan, task_sums: torch.Tensor, dense: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The task sums added into their destination rows (onto ``dense``)."""
    out = torch.zeros((plan.num_nodes, task_sums.shape[1]), dtype=task_sums.dtype, device=task_sums.device)
    if dense is not None:
        out += dense
    return out.index_add_(0, plan.dst, task_sums)


def _errors(got: torch.Tensor, ref: torch.Tensor) -> dict:
    err = (got - ref).abs()
    return dict(max_abs=err.max().item(), rel=(err / (ref.abs() + 1e-6)).max().item(),
                max_abs_over_max_ref=err.max().item() / max(ref.abs().max().item(), 1e-30))


def schedule(g, device) -> Aggregator:
    """The probe's plan (module doc) of a degree-sorted graph on ``device``."""
    return Aggregator.schedule_hybrid(g, tile_dtype=np.int8, with_transpose=False, pack=1, device=device, **SCHEDULE)


def build(n: int, m: int, device) -> Aggregator:
    """The probe's graph (RMAT seed 123, degree-sorted) and plan."""
    g = rmat_graph(n, m, seed=123, with_val=False)
    return schedule(g.reorder(degree_sort(g)), device)


def measure(agg: Aggregator, h: torch.Tensor, mode: str, h_mode: str = "split", iters: int = 8) -> dict:
    """The probe's run over ``agg``: the kernels' (or, on the CPU, the plain
    versions') result against the plain residual (standalone) or hybrid
    (fused) pass, and on the card the times (ms, CUDA events, median of
    ``iters``): the task sums and the plain residual (standalone); the
    fused pass, the sequential hybrid_spmm and B1 then P1 (fused)."""
    plan, tile = agg.plan, agg.tile
    nt, blk = plan.num_tasks_padded, plan.block_size
    slots = nt * blk
    on_card = h.device.type == "cuda"
    result = dict(mode=mode, nodes=agg.num_nodes, edges=agg.num_edges, f=h.shape[1], tiles=tile.num_tiles, tasks=nt,
                  block=blk, slots=slots, device=torch.cuda.get_device_name(h.device) if on_card else "cpu")
    print(f"plan: n={agg.num_nodes} m={agg.num_edges} tiles={tile.num_tiles} nt_p={nt} blk={blk} "
          f"slots={slots / 1e6:.2f}M", flush=True)

    def timed(fn):
        if not on_card:
            return None
        from gnn_computing_tpu_torch.utils.timing import cuda_time_ms

        return cuda_time_ms(fn, iters=iters)

    with torch.no_grad():
        if mode == "standalone":
            ref = spmm_plain(plan, h)
            result["error"] = _errors(add_tasks(plan, dma_task_sums(plan, h)), ref)
            print(f"task sums vs spmm_plain: max abs err {result['error']['max_abs']:.3e} "
                  f"rel {result['error']['rel']:.3e}", flush=True)
            result["task_sums_ms"] = timed(lambda: dma_task_sums(plan, h))
            result["residual_ms"] = timed(lambda: spmm_plain(plan, h))
        elif mode == "fused":
            ref = hybrid_spmm(tile, plan, h, tile_h_mode=h_mode)
            dense, ts = fused_hybrid(tile, plan, h, h_mode)
            result["error"] = _errors(add_tasks(plan, ts, dense), ref)
            print(f"fused vs hybrid_spmm: max abs err {result['error']['max_abs']:.3e} "
                  f"rel {result['error']['rel']:.3e}", flush=True)

            def fused_pass():
                d, t = fused_hybrid(tile, plan, h, h_mode)
                return add_tasks(plan, t, d)

            def sequential_kernels():
                return add_tasks(plan, dma_task_sums(plan, h), bcsr_spmm(tile, h, h_mode=h_mode))

            result["fused_ms"] = timed(fused_pass)
            result["sequential_ms"] = timed(lambda: hybrid_spmm(tile, plan, h, tile_h_mode=h_mode))
            result["b1_p1_ms"] = timed(sequential_kernels)
        else:
            raise ValueError(f"mode must be 'standalone' or 'fused', got {mode!r}")
    if on_card:
        for k in ("task_sums_ms", "residual_ms", "fused_ms", "sequential_ms", "b1_p1_ms"):
            if k in result:
                per_slot = f" = {result[k] / slots * 1e6:.3f} ns/slot" if k in ("task_sums_ms", "residual_ms") else ""
                print(f"{k}: {result[k]:.4f}{per_slot}", flush=True)
    else:
        print("timing: not measured on the CPU", flush=True)
    return result


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--f", type=int, default=128)
    ap.add_argument("--iters", type=int, default=8, help="timed calls (CUDA events, median)")
    ap.add_argument("--small", action="store_true", help=f"{SMALL[0]} nodes, {SMALL[1]} edges")
    ap.add_argument("--nodes", type=int, help="graph size, overriding --small")
    ap.add_argument("--edges", type=int)
    ap.add_argument("--mode", default="standalone", choices=["standalone", "fused"])
    ap.add_argument("--h-mode", default="split", choices=H_MODES)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n, m = SMALL if args.small else REDDIT
    n, m = args.nodes or n, args.edges or m
    agg = build(n, m, dev)
    h = torch.from_numpy(normal_features(n, args.f, seed=1) * 0.1).to(dev)
    result = measure(agg, h, args.mode, args.h_mode, args.iters)
    print(json.dumps({"probe": result}), flush=True)
    return result


if __name__ == "__main__":
    main()
