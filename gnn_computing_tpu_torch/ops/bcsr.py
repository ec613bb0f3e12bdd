"""Block-sparse aggregation over dense count tiles + the hybrid op.

Port of ``gnn_computing_tpu/ops/bcsr.py``.  ``bcsr_spmm``
computes out = A_tiles @ h over int8, 1-bit, float32 or bfloat16 tiles
(schedule.tiles): on a CUDA tensor it
launches the hand-written kernel (ops.cuda_bcsr, the port of the TPU kernel
``bcsr_spmm_pallas``); on a CPU tensor it runs ``bcsr_spmm_plain``, the
counterpart of the JAX package's ``bcsr_spmm_xla``.  There is no fallback
between the two.  A 1-bit tile times a float32 or 'split' operand is exact,
as an int8 tile is (the TPU kernel's ``mxu_ladder`` bit path is not copied).

The ``h_mode`` rounding is applied here, outside the kernel, exactly as the
JAX package emulates it on its portable path: 'split' rounds h to hi + lo
bf16 chunks (16 mantissa bits), 'bf16' to one bf16 chunk; 'split3', 'auto'
and 'native' keep float32 as it is.  Integer count tiles times a split
operand are exact products, so only the float32 sums round.  Over float
tiles 'auto' is the JAX package's 'split3' for bfloat16 tiles and
'native' for float32 tiles; on the card both are float32 FFMA (a bf16
value widens exactly), the exactness class of both.  Factored
plans scale h by ``scale_src`` before the tiles and the result by
``scale_dst`` after them.

``bcsr_rowmax`` is the per-row max over the same tiles (the GAT softmax
stabilizer's dense part) over the cells whose value is nonzero (the GAT
scoring rule, ops.bcsr_gat): the B5 kernel (ops.cuda_rowmax) on a CUDA
tensor, ``bcsr_rowmax_plain`` on a CPU tensor; both read every format.

``hybrid_spmm`` is a ``torch.autograd.Function`` (the JAX op's custom VJP):
its backward aggregates the cotangent over the transposed plans, B1 over
the transposed tiles (of the forward's format) plus the transposed
residual.  Each residual is added into the tile output in place
(ops.spmm.residual_spmm_: the residual kernel R1 on a card, the ATen chunk
loop on the CPU and in the gather modes that round rows).  The kernel wrappers
refuse tensors that require grad with grad enabled, so no kernel output
ever stands in a graph without its Function's backward.
"""

from __future__ import annotations

from typing import Optional

import torch

from gnn_computing_tpu_torch.ops import cuda_bcsr, cuda_rowmax
from gnn_computing_tpu_torch.ops.spmm import bf16_residue_chunks, residual_spmm_
from gnn_computing_tpu_torch.schedule.plan import AggregationPlan
from gnn_computing_tpu_torch.schedule.tiles import TilePlan
from gnn_computing_tpu_torch.utils.profiling import count, span

H_MODES = ("auto", "native", "split3", "split", "bf16")


def round_h(h: torch.Tensor, h_mode: str) -> torch.Tensor:
    """The operand rounding of ``h_mode`` (see module doc)."""
    if h_mode == "split":
        hi, lo = bf16_residue_chunks(h.float(), 2)
        return (hi.float() + lo.float()).to(h.dtype)
    if h_mode == "bf16":
        return h.to(torch.bfloat16).to(h.dtype)
    if h_mode in ("split3", "auto", "native"):
        return h
    raise ValueError(f"h_mode must be one of {H_MODES}, got {h_mode!r}")


def _pre_scale(tp: TilePlan, h: torch.Tensor) -> torch.Tensor:
    return h if tp.scale_src is None else h * tp.scale_src.to(h.dtype)[:, None]


def _post_scale(tp: TilePlan, out: torch.Tensor) -> torch.Tensor:
    return out if tp.scale_dst is None else out * tp.scale_dst.to(out.dtype)[:, None]


def _tiles_plain(tp: TilePlan, h: torch.Tensor, chunk: int) -> torch.Tensor:
    tr, tc = tp.tile_rows, tp.tile_cols
    f = h.shape[-1]
    nct, nrt = tp.num_col_tiles, tp.num_row_tiles
    h_t = torch.zeros((nct * tc, f), dtype=h.dtype, device=h.device)
    h_t[: h.shape[0]] = h
    h_t = h_t.reshape(nct, tc, f)
    out_t = torch.zeros((nrt, tr, f), dtype=h.dtype, device=h.device)
    for s in range(0, tp.num_tiles, chunk):
        a_c = tp.counts(s, s + chunk).to(h.dtype)
        g = h_t.index_select(0, tp.tile_col[s : s + chunk].long())
        out_t.index_add_(0, tp.tile_row[s : s + chunk].long(), torch.bmm(a_c, g))
    return out_t.reshape(nrt * tr, f)[: tp.num_nodes]


def bcsr_spmm_plain(tp: TilePlan, h: torch.Tensor, chunk: int = 256) -> torch.Tensor:
    """Plain PyTorch tile product, the counterpart of ``bcsr_spmm_xla``:
    per chunk of tiles, gather the H tiles, batched matmul, add each tile's
    [R, f] product into its destination row-tile.  ``h`` is used as given
    (no h_mode rounding); the plan's scales apply."""
    return _post_scale(tp, _tiles_plain(tp, _pre_scale(tp, h), chunk))


def bcsr_spmm(tp, h: torch.Tensor, h_mode: str = "auto") -> torch.Tensor:
    """out = A_tiles @ h.  ``tp`` is a TilePlan or a sequence of them whose
    partial outputs add.  CUDA tensors go through the kernel, CPU tensors
    through the plain version."""
    if isinstance(tp, (tuple, list)):
        parts = [p for p in tp if p is not None and p.num_tiles]
        out = bcsr_spmm(parts[0], h, h_mode)
        for p in parts[1:]:
            out = out + bcsr_spmm(p, h, h_mode)
        return out
    x = _pre_scale(tp, round_h(h, h_mode))
    if x.device.type == "cuda":
        if x.dtype != torch.float32:
            raise ValueError(f"the CUDA tile kernel takes float32 h, got {x.dtype}")
        out = cuda_bcsr.bcsr_spmm_cuda(tp, x.contiguous())
    elif x.device.type == "cpu":
        out = _tiles_plain(tp, x, 256)
    else:
        raise ValueError(f"no tile product for device {x.device}")
    return _post_scale(tp, out)


def bcsr_rowmax_plain(tp: TilePlan, col_vals: torch.Tensor, chunk: int = 256) -> torch.Tensor:
    """Plain PyTorch per-row max, the counterpart of the JAX package's
    ``_bcsr_rowmax_xla``: out[i] = max of col_vals[j] over tile cells (i, j)
    with a nonzero value (for counts the same as count > 0, the JAX rule;
    a signed float plan's negative cells count too, as GAT scores them);
    -inf where the tiles give row i no edge.  A 1-bit plan is read through
    ``counts`` a chunk at a time."""
    tr, tc = tp.tile_rows, tp.tile_cols
    nct, nrt = tp.num_col_tiles, tp.num_row_tiles
    v = torch.full((nct * tc,), float("-inf"), dtype=torch.float32, device=col_vals.device)
    v[: col_vals.shape[0]] = col_vals
    v = v.reshape(nct, 1, tc)
    out_t = torch.full((nrt, tr), float("-inf"), dtype=torch.float32, device=col_vals.device)
    for s in range(0, tp.num_tiles, chunk):
        vc = v.index_select(0, tp.tile_col[s : s + chunk].long())
        tmax = torch.where(tp.counts(s, s + chunk) != 0, vc, float("-inf")).amax(dim=2)
        rows = tp.tile_row[s : s + chunk].long()[:, None].expand(-1, tr)
        out_t.scatter_reduce_(0, rows, tmax, "amax")
    return out_t.reshape(nrt * tr)[: tp.num_nodes]


def bcsr_rowmax(tp: TilePlan, col_vals: torch.Tensor) -> torch.Tensor:
    """Per-destination-row max of ``col_vals`` [n_src] over the tile cells
    with a nonzero value (-inf for rows without one).  CUDA tensors go
    through the B5 kernel, CPU tensors through the plain version."""
    v = col_vals.float().contiguous()
    if v.device.type == "cuda":
        return cuda_rowmax.rowmax_bcsr_cuda(tp, v)
    if v.device.type == "cpu":
        return bcsr_rowmax_plain(tp, v)
    raise ValueError(f"no tile row max for device {v.device}")


def count_residual(plan: AggregationPlan):
    """The counters ``residual.edges`` and ``residual.slots`` of one pass over
    a residual plan (host ints: no device read)."""
    count("residual.edges", plan.num_edges)
    count("residual.slots", plan.num_tasks_padded * plan.block_size)


class HybridSpmm(torch.autograd.Function):
    """out = (A_tiles + A_residual) @ h; dh = (A_tiles^T + A_residual^T) @ ct
    over the transposed plans, in the exact modes whatever the forward's
    (cotangents are signed and cancel).  Spans ``gnn.agg.tiles`` and
    ``gnn.agg.residual`` (forward), ``gnn.agg_t.*`` (backward)."""

    @staticmethod
    def forward(ctx, h, tp, plan, tp_t, plan_t, residual_gather_dtype, tile_h_mode):
        ctx.plans_t = (tp_t, plan_t, plan is not None)
        with span("gnn.agg.tiles"):
            out = bcsr_spmm(tp, h, h_mode=tile_h_mode)
        if plan is not None:
            with span("gnn.agg.residual"):
                count_residual(plan)
                out = residual_spmm_(out, plan, h, gather_dtype=residual_gather_dtype)
        return out

    @staticmethod
    def backward(ctx, ct):
        tp_t, plan_t, has_residual = ctx.plans_t
        if tp_t is None or (has_residual and plan_t is None):
            raise RuntimeError(
                "hybrid_spmm backward needs the transposed plans: build the "
                "aggregator with schedule_hybrid(..., with_transpose=True)"
            )
        with span("gnn.agg_t.tiles"):
            dh = bcsr_spmm(tp_t, ct)
        if has_residual:
            with span("gnn.agg_t.residual"):
                count_residual(plan_t)
                dh = residual_spmm_(dh, plan_t, ct)
        return dh, None, None, None, None, None, None


def hybrid_spmm(
    tp,
    plan: Optional[AggregationPlan],
    h: torch.Tensor,
    residual_gather_dtype=None,
    tile_h_mode: str = "auto",
    tp_t=None,
    plan_t: Optional[AggregationPlan] = None,
) -> torch.Tensor:
    """out = (A_tiles + A_residual) @ h.  Edge values live inside the plans
    (constants here).  Differentiable in h through HybridSpmm, whose
    backward needs the transposed tile parts ``tp_t`` and, where there is a
    residual, its transposed plan ``plan_t`` (Aggregator.schedule_hybrid
    with_transpose=True)."""
    return HybridSpmm.apply(h, tp, plan, tp_t, plan_t, residual_gather_dtype, tile_h_mode)
