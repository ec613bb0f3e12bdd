"""Fig10 analog: kernel fusion ablations.

10a (reference Figure10/main_a.cu:79-113) — the GAT attention pipeline:
  base    = separate ops: u_add_v -> exp(leakyrelu) -> add_to_center ->
            div_each -> weighted SpMM (aggr_gat.h:33-92 + updateval chain)
  adapter = fused attention scalar op (attGat) + weighted SpMM
  fused   = single attention+softmax+aggregate (aggr_gat_fine)

10b (reference Figure10/main_b.cu:84-103) — aggregation+GEMM:
  split = SpMM, then a sync, then a separate float32 transform
  fused = spmm_nn (reference aggr_gcn_nn run_with_nn)

Counterpart of ``benchmarks/fig10_fusion.py``.  10a's and 10b's rows run
on the gather path over an NG plan (plain PyTorch, no kernel of the port):
"base" is five separate calls, each intermediate written to device memory,
timed by the host clock with a synchronize after each pipeline (the JAX
harness's block_until_ready loop).  The ``fig10b_pallas`` row keeps its
JAX tag so it matches its counterpart; on the card it is B1's fused
epilogue: hybrid_spmm_nn over the hybrid schedule (int8 tiles, the
w_epilogue launch a part) against the same schedule's run() then the
float32 matmul.

Run: python -m gnn_computing_tpu_torch.benchmarks.fig10_fusion [--quick] [--device cpu]
"""

import numpy as np
import torch

from gnn_computing_tpu_torch.aggregator import Aggregator
from gnn_computing_tpu_torch.benchmarks import common
from gnn_computing_tpu_torch.ops import gat as gat_ops
from gnn_computing_tpu_torch.ops.fused_nn import hybrid_spmm_nn, spmm_nn
from gnn_computing_tpu_torch.ops.spmm import spmm
from gnn_computing_tpu_torch.schedule import neighbor_grouping_plan


def _base(plan, h, att):
    """10a's un-fused pipeline: five separate calls."""
    e = gat_ops.u_add_v(plan, att)
    e = torch.where(plan.slot_mask(), torch.exp(gat_ops.leaky_relu(e)), 0.0)
    s = gat_ops.add_to_center(plan, e)
    v = gat_ops.div_each(plan, e, s)
    return spmm(plan, h, val=v)


def _split(plan, h, w):
    """10b's split: the SpMM, a sync, then the transform."""
    agg = spmm(plan, h)
    if agg.is_cuda:
        torch.cuda.synchronize()
    return agg @ w


def run(name, g, args) -> None:
    """fig10a's, fig10b's and fig10b_pallas's rows for one dataset."""
    plan = neighbor_grouping_plan(g, args.nei).to(args.device)
    f = args.feature_len
    h = common.features(g.num_nodes, f, 1, args)
    att = common.features(g.num_nodes, 2, 2, args)
    ctx = dict(graph=g)

    # ---- 10a
    base_s = common.host_timed(args, "fig10a.base", lambda x, p, a: _base(p, x, a), h, plan, att, ctx=ctx)
    r_ad = common.bench(
        args, "fig10a.adapter", lambda x, p, a: gat_ops.gat_split_forward(p, x, a, use_adapter=True),
        h, plan, att, ctx=ctx,
    )
    r_f = common.bench(args, "fig10a.fused", lambda x, p, a: gat_ops.gat_aggregate(p, x, a), h, plan, att, ctx=ctx)
    common.emit(
        "fig10a",
        dict(dataset=name, base_s=base_s, adapter_s=r_ad.min_s, fused_s=r_f.min_s, speedup=base_s / r_f.min_s),
        args,
    )

    # ---- 10b: SpMM -> GEMM split vs fused
    w = common.features(f, args.outfea, 3, args)
    split_s = common.host_timed(args, "fig10b.split", lambda x, p, ww: _split(p, x, ww), h, plan, w, ctx=ctx)
    r_fused = common.bench(args, "fig10b.fused", lambda x, p, ww: spmm_nn(p, x, ww)[1], h, plan, w, ctx=ctx)
    common.emit(
        "fig10b",
        dict(dataset=name, split_s=split_s, fused_s=r_fused.min_s, speedup=split_s / r_fused.min_s),
        args,
    )

    # ---- fig10b_pallas: hybrid tiles with the W GEMM fused into B1's
    # run-final accumulator write vs the same hybrid schedule split in two
    sched = Aggregator.schedule_hybrid(
        g, tile_rows=256, threshold=24, residual_block=4, tile_dtype=np.int8, with_transpose=False,
        device=args.device,
    )
    if sched.tile_parts():
        ctx = dict(graph=g, agg=sched)
        r_split_h = common.bench(args, "fig10b_pallas.split", lambda x, s, ww: s.run(x) @ ww, h, sched, w, ctx=ctx)
        r_fused_h = common.bench(
            args, "fig10b_pallas.fused", lambda x, s, ww: hybrid_spmm_nn(s, x, ww)[1], h, sched, w, ctx=ctx
        )
        common.emit(
            "fig10b_pallas",
            dict(dataset=name, split_s=r_split_h.min_s, fused_s=r_fused_h.min_s,
                 speedup=r_split_h.min_s / r_fused_h.min_s),
            args,
        )


def arg_parser():
    return common.parser(__doc__)


def main(argv=None, check=None):
    args = common.parse_args(arg_parser(), argv, check)
    for name, g in common.datasets(args):
        run(name, g, args)


if __name__ == "__main__":
    main()
