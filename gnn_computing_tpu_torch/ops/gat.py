"""GAT edge attention over a gather plan: the fused op and the split ops.

Port of ``gnn_computing_tpu/ops/gat.py``.  Per edge (j -> i)

    score_e = exp(leaky_relu(att[i, 0] + att[j, 1], slope) - shift_i)
    num[i]  = sum_e score_e * h[j]        den[i] = sum_e score_e
    out[i]  = num[i] / den[i]             (0 where den[i] is 0)

``gat_aggregate_parts`` returns (num, den, slot scores): with shift 0 (the
reference's un-stabilized form), a shift the caller gives (the hybrid op
shares one between its tile and residual parts, so their partial sums stay
commensurate), or with ``stabilize`` the exact per-destination max logit
over the row's edges (0 for a row without any).  ``gat_aggregate`` divides;
over a gather plan any truthy ``stabilize`` means the exact row max, as in
the JAX package.  The split ops (``u_add_v``, ``add_to_center``,
``div_each``, ``att_gat``, ``gat_split_forward``) are the reference's
un-fused pipelines of Figure 10a, over [num_tasks_p, B] slot arrays.
Gradients flow through PyTorch's autograd; the row shift cancels in the
softmax and is detached.
"""

from __future__ import annotations

from typing import Optional

import torch

from gnn_computing_tpu_torch.ops.spmm import gather_rows, gather_table, spmm, weighted_task_sums
from gnn_computing_tpu_torch.schedule.plan import AggregationPlan

DEFAULT_SLOPE = 0.2  # the reference's run() calls, aggr_gat.h:339,347


def leaky_relu(x: torch.Tensor, slope: float = DEFAULT_SLOPE) -> torch.Tensor:
    """max(x, slope * x), the reference's inner form (aggr_gat.h:143)."""
    return torch.maximum(x, x * slope)


def slot_mask(plan: AggregationPlan) -> torch.Tensor:
    """bool[num_tasks_p * B]: slots that hold an edge (flat)."""
    return plan.slot_mask().reshape(-1)


def _att_slots_flat(plan: AggregationPlan, att: torch.Tensor, gather_dtype=None) -> torch.Tensor:
    """z[t*B + s] = att[dst_t, 0] + att[src_{t,s}, 1] over the flat slots
    (pad slots too).  The src half is gathered in ``gather_dtype``: None,
    'f16_split2' (an [n, 2] float16 table of residue chunks, 21 mantissa
    bits; a value beyond float16's range stored scaled, ops.spmm.gather_table)
    or a torch dtype, rebuilt in float32; 'bf16_split2' is no att mode in
    the JAX package either and raises."""
    a_dst = att[:, 0].index_select(0, plan.dst).repeat_interleave(plan.block_size)
    if gather_dtype == "bf16_split2":
        raise ValueError("'bf16_split2' is not an attention gather mode (None, 'f16_split2' or a dtype)")
    table, scale = gather_table(att[:, 1:2], gather_dtype)
    a_src = gather_rows(table, scale, plan.src_flat(), gather_dtype, 1)[:, 0]
    return a_dst + a_src.to(a_dst.dtype)


def _att_slots(plan: AggregationPlan, att: torch.Tensor, gather_dtype=None) -> torch.Tensor:
    """_att_slots_flat in the [num_tasks_p, B] layout."""
    return _att_slots_flat(plan, att, gather_dtype).reshape(plan.num_tasks_padded, plan.block_size)


def _dst_sums(plan: AggregationPlan, task: torch.Tensor) -> torch.Tensor:
    """Task rows (or values) added into their destination rows."""
    out = torch.zeros((plan.num_nodes,) + tuple(task.shape[1:]), dtype=task.dtype, device=task.device)
    return out.index_add_(0, plan.dst, task)


def _row_max(plan: AggregationPlan, z: torch.Tensor) -> torch.Tensor:
    """Per destination the max of z [num_tasks_p, B] over its valid slots,
    0 for a row without any (the JAX package's isfinite test)."""
    task_max = torch.where(plan.slot_mask(), z, float("-inf")).amax(dim=1)
    row_max = torch.full((plan.num_nodes,), float("-inf"), dtype=z.dtype, device=z.device)
    row_max.scatter_reduce_(0, plan.dst, task_max, "amax", include_self=False)
    return torch.where(torch.isfinite(row_max), row_max, 0.0)


def gat_aggregate_parts(
    plan: AggregationPlan,
    h: torch.Tensor,
    att: torch.Tensor,
    relu_slope: float = DEFAULT_SLOPE,
    stabilize=False,
    packed: Optional[bool] = None,
    att_gather_dtype=None,
    h_gather_dtype=None,
    row_shift: Optional[torch.Tensor] = None,
):
    """Un-normalized attention aggregation over the plan: (num [n, f],
    den [n], slot scores [num_tasks_p, B]).

    row_shift without stabilize: subtracted from every slot's logit.
    stabilize (any truthy value): the exact per-destination max logit is
    subtracted (``row_shift`` instead, where given).
    packed: one gather of an [n, f + 1] table [h | att_src] (the JAX
    package's measured-slower option, kept for the measurement); it
    ignores the gather modes, and stabilize wins over it.
    att_gather_dtype / h_gather_dtype: gather modes of the att src half (see
    _att_slots_flat) and of h (see ops.spmm.gather_table)."""
    nt, b = plan.num_tasks_padded, plan.block_size
    f = h.shape[-1]
    if packed and not stabilize and row_shift is None:
        g = torch.cat([h, att[:, 1:2].to(h.dtype)], dim=1).index_select(0, plan.src_flat())
        z = att[:, 0].index_select(0, plan.dst)[:, None] + g[:, f].reshape(nt, b).float()
        score = torch.where(plan.slot_mask(), torch.exp(leaky_relu(z, relu_slope)), 0.0)
        msg = g[:, :f].float() * score.reshape(-1, 1)
        both = _dst_sums(plan, torch.cat([msg.reshape(nt, b, f).sum(dim=1), score.sum(dim=1, keepdim=True)], dim=1))
        return both[:, :f].to(h.dtype), both[:, f], score
    z = leaky_relu(_att_slots_flat(plan, att, gather_dtype=att_gather_dtype), relu_slope)
    if stabilize and row_shift is None:
        row_shift = _row_max(plan, z.detach().reshape(nt, b))
    if row_shift is not None:
        z = z - row_shift.float().index_select(0, plan.dst).repeat_interleave(b)
    score = torch.where(slot_mask(plan), torch.exp(z), 0.0)
    num_task = weighted_task_sums(plan, h, score, gather_dtype=h_gather_dtype)
    den_task = score.reshape(nt, b).sum(dim=1)
    # [num | den] in one sum of tasks into their destination rows
    both = _dst_sums(plan, torch.cat([num_task, den_task[:, None].to(num_task.dtype)], dim=1))
    return both[:, :f], both[:, f], score.reshape(nt, b)


def gat_aggregate(
    plan: AggregationPlan,
    h: torch.Tensor,
    att: torch.Tensor,
    relu_slope: float = DEFAULT_SLOPE,
    stabilize=False,
    return_scores: bool = False,
):
    """Fused attention + softmax + aggregation over a gather plan (the
    reference's aggr_gat_fine); a row whose denominator is 0 outputs 0.
    With ``return_scores`` also the slot scores and the denominators."""
    num, den, score = gat_aggregate_parts(plan, h, att, relu_slope=relu_slope, stabilize=stabilize)
    out = num / torch.where(den == 0.0, 1.0, den)[:, None].to(num.dtype)
    return (out, score, den) if return_scores else out


# ------------------------------------------------- split-kernel GAT pipeline
def u_add_v(plan: AggregationPlan, att: torch.Tensor) -> torch.Tensor:
    """Slot score att[dst, 0] + att[src, 1], 0 in pad slots (the
    reference's ``u_add_v``, aggr_gat.h:33-48)."""
    return torch.where(plan.slot_mask(), _att_slots(plan, att), 0.0)


def add_to_center(plan: AggregationPlan, slot_val: torch.Tensor) -> torch.Tensor:
    """Per-destination sum of slot values (``add_to_center``,
    aggr_gat.h:50-74)."""
    sv = slot_val.reshape(plan.num_tasks_padded, plan.block_size)
    return _dst_sums(plan, torch.where(plan.slot_mask(), sv, 0.0).sum(dim=1))


def div_each(plan: AggregationPlan, slot_val: torch.Tensor, node_val: torch.Tensor) -> torch.Tensor:
    """Slot value / its destination's node value, 0 where that is 0
    (``each_div``, aggr_gat.h:76-92)."""
    d = node_val.index_select(0, plan.dst)[:, None]
    sv = slot_val.reshape(plan.num_tasks_padded, plan.block_size)
    return torch.where(plan.slot_mask(), sv / torch.where(d == 0.0, 1.0, d), 0.0)


def att_gat(plan: AggregationPlan, att: torch.Tensor, relu_slope: float = DEFAULT_SLOPE) -> torch.Tensor:
    """The adapter (``attGat``, aggr_gat.h:5-31): u_add_v, exp(leaky_relu),
    the row sum and the division in one op; normalized slot attention."""
    score = torch.where(plan.slot_mask(), torch.exp(leaky_relu(_att_slots(plan, att), relu_slope)), 0.0)
    return div_each(plan, score, add_to_center(plan, score))


def gat_split_forward(
    plan: AggregationPlan, h: torch.Tensor, att: torch.Tensor, relu_slope: float = DEFAULT_SLOPE,
    use_adapter: bool = False,
) -> torch.Tensor:
    """Figure 10a's "base" (split ops) or "adapter" (att_gat) pipeline:
    normalized slot attention, then the weighted SpMM with it as the edge
    values (the reference's gat_layer_our, our.py:138-157)."""
    if use_adapter:
        a = att_gat(plan, att, relu_slope)
    else:
        score = torch.where(plan.slot_mask(), torch.exp(leaky_relu(u_add_v(plan, att), relu_slope)), 0.0)
        a = div_each(plan, score, add_to_center(plan, score))
    return spmm(plan, h, val=a)
