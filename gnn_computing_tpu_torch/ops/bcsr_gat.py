"""GAT attention aggregation over dense count tiles, hybrid with the residual.

Port of the forward of ``gnn_computing_tpu/ops/bcsr_gat.py``.  Leaky-relu is
piecewise linear, so each attention score factors into per-node
exponentials on each branch:

  exp(lrelu(ad_i + as_j) - M_i) = max(u1_i v1_j, u2_i v2_j)
  u12_i = (exp(ad_i - M_i), exp(s ad_i - M_i)),  v12_j = (exp(as_j), exp(s as_j))

(exp is monotone and lrelu(z) = max(z, s z)).  A tile cell with count c
scores c * max(u1 v1, u2 v2); num and den are the score-weighted sums of h
and of 1 over the tiles.  ``gat_bcsr`` launches the B2 kernel
(ops.cuda_gat) on a CUDA tensor and runs ``gat_bcsr_plain`` on a CPU
tensor; there is no fallback between the two.  ``hybrid_gat`` adds the
residual part (ops.gat.gat_aggregate_parts) and divides.

dot_mode: the TPU kernel offers 'exact' (a float32-grade MXU dot) and
'split2' (score and h as ~16-bit bf16 chunks, error ~2^-16, a speed trade of
the TPU's matrix unit).  The port computes both alike in float32: exact
integer counts times float32 scores, summed in float32, which meets both
error classes.  'default' (single-rounded bf16, timing-only on the TPU) is
not ported.

Stabilizers (one shift M shared by every part, so the partial
denominators still merge exactly; it cancels in num/den):
  stabilize=True / 'exact': M_i = lrelu(ad_i + max over in-neighbors of as_j),
      over the tiles (bcsr_rowmax, kernel B5) and the residual;
  stabilize='bound': M_i = max(ad_i + A, s (ad_i + A)), A = max_j as_j: O(n),
      no pass over the adjacency.
Forward only: the custom backward comes with training.
"""

from __future__ import annotations

from typing import Optional

import torch

from gnn_computing_tpu_torch.ops import cuda_gat
from gnn_computing_tpu_torch.ops.bcsr import bcsr_rowmax
from gnn_computing_tpu_torch.ops.gat import DEFAULT_SLOPE, gat_aggregate_parts, leaky_relu, slot_mask
from gnn_computing_tpu_torch.schedule.plan import AggregationPlan
from gnn_computing_tpu_torch.schedule.tiles import TilePlan

DOT_MODES = ("exact", "split2")


def _node_factors(att: torch.Tensor, slope: float, row_shift: Optional[torch.Tensor] = None):
    """(u1, u2, v1, v2): exponentials of the dst and src attention halves on
    both branches; ``row_shift`` folds into the dst side only."""
    ad = att[:, 0].float()
    asrc = att[:, 1].float()
    sh = 0.0 if row_shift is None else row_shift.float()
    return torch.exp(ad - sh), torch.exp(slope * ad - sh), torch.exp(asrc), torch.exp(slope * asrc)


def _branch_factors(att: torch.Tensor, slope: float, row_shift: Optional[torch.Tensor] = None):
    """([n, 2] dst-branch exponentials u12, [n, 2] src-branch v12)."""
    u1, u2, v1, v2 = _node_factors(att, slope, row_shift)
    return torch.stack([u1, u2], dim=1), torch.stack([v1, v2], dim=1)


def _pad_to(x: torch.Tensor, size: int) -> torch.Tensor:
    if x.shape[0] == size:
        return x
    out = x.new_zeros((size,) + tuple(x.shape[1:]))
    out[: x.shape[0]] = x
    return out


def gat_bcsr_plain(
    tp: TilePlan,
    h: torch.Tensor,
    att: torch.Tensor,
    relu_slope: float = DEFAULT_SLOPE,
    row_shift: Optional[torch.Tensor] = None,
    chunk: int = 256,
):
    """Plain PyTorch (num [n, f], den [n]) of the tile edges, the counterpart
    of ``gat_bcsr_xla``: per chunk of tiles, split each count tile by the
    branch test (ad + as) > 0, batched matmuls against the gathered
    [v*h | v] operands (den packed in as the last column), scale by the row
    exponentials and add into the destination row-tiles."""
    tr, tc = tp.tile_rows, tp.tile_cols
    f = h.shape[-1]
    nct, nrt = tp.num_col_tiles, tp.num_row_tiles
    u1, u2, v1, v2 = _node_factors(att, relu_slope, row_shift)
    ad = _pad_to(att[:, 0].float(), nrt * tr).reshape(nrt, tr)
    asrc = _pad_to(att[:, 1].float(), nct * tc).reshape(nct, tc)
    u1 = _pad_to(u1, nrt * tr).reshape(nrt, tr)
    u2 = _pad_to(u2, nrt * tr).reshape(nrt, tr)
    hp = _pad_to(h.float(), nct * tc)
    v1p, v2p = _pad_to(v1, nct * tc)[:, None], _pad_to(v2, nct * tc)[:, None]
    hv1 = torch.cat([hp * v1p, v1p], dim=1).reshape(nct, tc, f + 1)
    hv2 = torch.cat([hp * v2p, v2p], dim=1).reshape(nct, tc, f + 1)
    out_t = torch.zeros((nrt, tr, f + 1), dtype=torch.float32, device=h.device)
    for s in range(0, tp.num_tiles, chunk):
        col = tp.tile_col[s : s + chunk].long()
        row = tp.tile_row[s : s + chunk].long()
        a_c = tp.a[s : s + chunk].float()
        pos = (ad.index_select(0, row)[:, :, None] + asrc.index_select(0, col)[:, None, :]) > 0
        a1 = torch.where(pos, a_c, 0.0)
        a2 = a_c - a1
        p = u1.index_select(0, row)[:, :, None] * torch.bmm(a1, hv1.index_select(0, col))
        p += u2.index_select(0, row)[:, :, None] * torch.bmm(a2, hv2.index_select(0, col))
        out_t.index_add_(0, row, p)
    out = out_t.reshape(nrt * tr, f + 1)[: tp.num_nodes]
    return out[:, :f], out[:, f]


def gat_bcsr(
    tp,
    h: torch.Tensor,
    att: torch.Tensor,
    relu_slope: float = DEFAULT_SLOPE,
    row_shift: Optional[torch.Tensor] = None,
    dot_mode: str = "exact",
):
    """(num, den) of the tile edges.  ``tp`` is a TilePlan or a sequence of
    them whose partial sums add.  CUDA tensors go through the B2 kernel,
    CPU tensors through the plain version."""
    if dot_mode == "default":
        raise NotImplementedError("dot_mode 'default' (single-rounded bf16) is not ported")
    if dot_mode not in DOT_MODES:
        raise ValueError(f"dot_mode must be one of {DOT_MODES}, got {dot_mode!r}")
    if isinstance(tp, (tuple, list)):
        parts = [p for p in tp if p is not None and p.num_tiles]
        num, den = gat_bcsr(parts[0], h, att, relu_slope, row_shift, dot_mode)
        for p in parts[1:]:
            n2, d2 = gat_bcsr(p, h, att, relu_slope, row_shift, dot_mode)
            num, den = num + n2, den + d2
        return num, den
    if h.device.type == "cuda":
        if h.dtype != torch.float32:
            raise ValueError(f"the CUDA GAT tile kernel takes float32 h, got {h.dtype}")
        u12, v12 = _branch_factors(att, relu_slope, row_shift)
        return cuda_gat.gat_bcsr_cuda(tp, h.contiguous(), u12[: tp.num_nodes].contiguous(), v12[: tp.n_src].contiguous())
    if h.device.type == "cpu":
        return gat_bcsr_plain(tp, h, att, relu_slope, row_shift)
    raise ValueError(f"no GAT tile aggregation for device {h.device}")


def _hybrid_row_shift(tp, plan: Optional[AggregationPlan], att: torch.Tensor, relu_slope: float) -> torch.Tensor:
    """Exact per-destination stabilizer shared by every part:
    M_i = lrelu(ad_i + max over in-neighbors j of as_j), over the tiles
    (bcsr_rowmax) and the residual plan (a max per task, then per row);
    0 for rows without edges, so their exponentials stay finite."""
    asrc = att[:, 1].float()
    parts = tp if isinstance(tp, (tuple, list)) else (tp,)
    mx = None
    for p in parts:
        if p is None or not p.num_tiles:
            continue
        r = bcsr_rowmax(p, asrc)
        mx = r if mx is None else torch.maximum(mx, r)
    if plan is not None and plan.num_edges:
        nt, b = plan.num_tasks_padded, plan.block_size
        slots = torch.where(slot_mask(plan), asrc.index_select(0, plan.src_flat()), float("-inf"))
        task_max = slots.reshape(nt, b).amax(dim=1)
        rm = torch.full((plan.num_nodes,), float("-inf"), dtype=torch.float32, device=asrc.device)
        rm.scatter_reduce_(0, plan.dst, task_max, "amax")
        mx = rm if mx is None else torch.maximum(mx, rm)
    m = leaky_relu(att[:, 0].float() + mx, relu_slope)
    return torch.where(torch.isfinite(m), m, 0.0)


def _global_bound_shift(att: torch.Tensor, relu_slope: float) -> torch.Tensor:
    """O(n) overflow bound: M_i = max(ad_i + A, s (ad_i + A)), A = max_j as_j,
    keeps every branch product <= 1 without a pass over the adjacency.
    Rows whose own neighbor max lies far below A under-scale num and den
    alike (the shift cancels) until den underflows, at a logit gap of ~80."""
    ad = att[:, 0].float()
    a_max = att[:, 1].float().max()
    m = torch.maximum(ad + a_max, relu_slope * (ad + a_max))
    return torch.where(torch.isfinite(m), m, 0.0)


def _resolve_shift(tp, plan, att, relu_slope, stabilize) -> torch.Tensor:
    if stabilize == "bound":
        return _global_bound_shift(att, relu_slope)
    if stabilize is True or stabilize == "exact":
        return _hybrid_row_shift(tp, plan, att, relu_slope)
    raise ValueError(f"stabilize must be False, True, 'exact' or 'bound', got {stabilize!r}")


def hybrid_gat(
    tp,
    plan: Optional[AggregationPlan],
    h: torch.Tensor,
    att: torch.Tensor,
    relu_slope: float = DEFAULT_SLOPE,
    att_gather_dtype=None,
    h_gather_dtype=None,
    stabilize=False,
    dot_mode: str = "exact",
) -> torch.Tensor:
    """GAT forward over a hybrid schedule: (num, den) of the tiles plus those
    of the residual, then num / den (rows with den 0 give 0).  The tiles must
    hold raw counts (no factored scales): attention provides the edge
    weights.  stabilize=False is the reference's un-stabilized form, whose
    wide logits overflow as the reference's do."""
    for p in tp if isinstance(tp, (tuple, list)) else (tp,):
        if p.scale_dst is not None or p.scale_src is not None:
            raise ValueError("hybrid GAT needs raw count tiles (no factored scales)")
    row_shift = _resolve_shift(tp, plan, att, relu_slope, stabilize) if stabilize else None
    num, den = gat_bcsr(tp, h, att, relu_slope, row_shift=row_shift, dot_mode=dot_mode)
    if plan is not None and plan.num_edges:
        nr, dr, _ = gat_aggregate_parts(
            plan, h, att, relu_slope=relu_slope,
            att_gather_dtype=att_gather_dtype, h_gather_dtype=h_gather_dtype, row_shift=row_shift,
        )
        num = num + nr
        den = den + dr
    safe = torch.where(den == 0.0, 1.0, den)
    return (num / safe[:, None]).to(h.dtype)
