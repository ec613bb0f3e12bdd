"""Fused aggregation + dense transform (the reference's ``aggr_gcn_nn``).

Port of ``hybrid_spmm_nn`` from ``gnn_computing_tpu/ops/fused_nn.py``: over a
hybrid Aggregator it returns the reference's (aggregated, aggregated @ W)
pair, the Figure 10b fusion subject.  Each tile part runs B1 with its
``w_epilogue`` (``bcsr_spmm_nn``: the aggregate and its product with W from
one launch, ops.cuda_bcsr) on CUDA tensors, and its plain version
(``bcsr_spmm_plain`` + ``torch.matmul``) on CPU tensors; there is no
fallback between the two.  The residual aggregates (``spmm_plain``) and then
transforms; the partial transforms sum, as the matmul distributes over the
partial aggregates.  Dense products are float32 with TF32 off (the JAX
package's Precision.HIGHEST).

Two faults of the JAX function are not copied: an empty schedule returns
zeros (not ``(None, None)``), and a factored plan applies ``scale_dst`` to
the accumulator before both outputs (the TPU kernel asserts instead).

The op is forward-only, as the TPU kernel is (it has no VJP): on either
device it raises on an input that requires grad while grad is enabled.
``spmm_nn`` is the same pair over a gather plan: ops.spmm.spmm, then the
matmul (differentiable, as the JAX op is).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from gnn_computing_tpu_torch.ops import cuda_bcsr
from gnn_computing_tpu_torch.ops.bcsr import _pre_scale, bcsr_spmm_plain, round_h
from gnn_computing_tpu_torch.ops.bcsr_sddmm import check_forward_only
from gnn_computing_tpu_torch.ops.spmm import spmm, spmm_plain
from gnn_computing_tpu_torch.schedule.plan import AggregationPlan
from gnn_computing_tpu_torch.schedule.tiles import TilePlan


def spmm_nn(
    plan: AggregationPlan, h: torch.Tensor, w: torch.Tensor, val: Optional[torch.Tensor] = None,
    strategy: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(agg, agg @ w) with agg = A_plan @ h over a gather plan: the
    reference run_with_nn's (vout, transformed) pair; float32 products,
    TF32 off."""
    agg = spmm(plan, h, val=val, strategy=strategy)
    return agg, agg @ w


def bcsr_spmm_nn_plain(tp: TilePlan, h: torch.Tensor, w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch (agg, agg @ w) over one tile plan: bcsr_spmm_plain,
    then a float32 matmul.  ``h`` is used as given (no h_mode rounding)."""
    agg = bcsr_spmm_plain(tp, h)
    return agg, agg @ w


def bcsr_spmm_nn(tp: TilePlan, h: torch.Tensor, w: torch.Tensor, h_mode: str = "auto"):
    """(agg, agg @ w) over one tile plan after the ``h_mode`` rounding (see
    ops.bcsr.round_h): the B1 w_epilogue kernel on CUDA tensors, the plain
    version on CPU tensors."""
    check_forward_only("the fused aggregate+GEMM", h, w)
    x = round_h(h, h_mode)
    if x.device.type == "cuda":
        if x.dtype != torch.float32:
            raise ValueError(f"the CUDA tile kernel takes float32 h, got {x.dtype}")
        return cuda_bcsr.bcsr_spmm_nn_cuda(tp, _pre_scale(tp, x).contiguous(), w.float().contiguous())
    if x.device.type == "cpu":
        return bcsr_spmm_nn_plain(tp, x, w)
    raise ValueError(f"no tile product for device {x.device}")


def hybrid_spmm_nn(
    sched, h: torch.Tensor, w: torch.Tensor, tile_h_mode: str = "auto", residual_gather_dtype=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused aggregate+GEMM over a hybrid Aggregator: returns (agg, agg @ w)
    with agg = (A_tiles + A_residual) @ h.  Tile parts run bcsr_spmm_nn (one
    w_epilogue launch each on the card), the residual aggregates then
    transforms, and the parts sum.  An empty schedule gives zeros."""
    check_forward_only("the fused aggregate+GEMM", h, w)
    agg = torch.zeros((sched.num_nodes, h.shape[-1]), dtype=h.dtype, device=h.device)
    trans = torch.zeros((sched.num_nodes, w.shape[-1]), dtype=torch.float32, device=h.device)
    for p in sched.tile_parts():
        a_p, t_p = bcsr_spmm_nn(p, h, w, h_mode=tile_h_mode)
        agg = agg + a_p.to(h.dtype)
        trans = trans + t_p
    if sched.plan is not None and sched.plan.num_edges:
        r = spmm_plain(sched.plan, h, gather_dtype=residual_gather_dtype)
        agg = agg + r
        trans = trans + r @ w
    return agg, trans
