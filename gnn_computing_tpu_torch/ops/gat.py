"""GAT edge attention over a neighbor-grouping plan (the residual part).

Port of the flat pipelines of ``gnn_computing_tpu/ops/gat.py``
(``gat_aggregate_parts``).  Per edge (j -> i)

    score_e = exp(leaky_relu(att[i, 0] + att[j, 1], slope) - shift_i)
    num[i]  = sum_e score_e * h[j]        den[i] = sum_e score_e

with shift 0 (the reference's un-stabilized form) or a per-destination
shift the caller gives (the hybrid op shares one shift between its tile and
residual parts, so their partial sums stay commensurate).  The hybrid op
divides num by den after merging the parts.

Not ported yet: the JAX function's 2-D internally stabilized branch
(``stabilize=True`` without a shift) and its ``packed`` gather, the
gather-only ``gat_aggregate`` and the split ops (``u_add_v``,
``add_to_center``, ``div_each``, ``att_gat``).
"""

from __future__ import annotations

from typing import Optional

import torch

from gnn_computing_tpu_torch.ops.spmm import f16_split2_rows, weighted_task_sums
from gnn_computing_tpu_torch.schedule.plan import AggregationPlan

DEFAULT_SLOPE = 0.2  # the reference's run() calls, aggr_gat.h:339,347


def leaky_relu(x: torch.Tensor, slope: float = DEFAULT_SLOPE) -> torch.Tensor:
    """max(x, slope * x), the reference's inner form (aggr_gat.h:143)."""
    return torch.maximum(x, x * slope)


def slot_mask(plan: AggregationPlan) -> torch.Tensor:
    """bool[num_tasks_p * B]: slots that hold an edge (flat)."""
    b = plan.block_size
    slot = torch.arange(plan.num_tasks_padded * b, device=plan.src.device) % b
    return slot < plan.count.long().repeat_interleave(b)


def _att_slots_flat(plan: AggregationPlan, att: torch.Tensor, gather_dtype=None) -> torch.Tensor:
    """z[t*B + s] = att[dst_t, 0] + att[src_{t,s}, 1] over the flat slots.

    gather_dtype 'f16_split2' gathers the src half from an [n, 2] float16
    table of (hi, lo) residue chunks (21 mantissa bits), as the JAX package
    does; a value beyond float16's range is stored scaled by a power of two
    (ops.spmm.f16_split2_rows), where the JAX package's table holds inf."""
    a_dst = att[:, 0].index_select(0, plan.dst).repeat_interleave(plan.block_size)
    src = plan.src_flat()
    if gather_dtype == "f16_split2":
        tbl, scale = f16_split2_rows(att[:, 1:2])  # [n, 2] float16, [n]
        g = tbl.index_select(0, src)
        a_src = (g[:, 0].float() + g[:, 1].float()) * scale.index_select(0, src)
    elif gather_dtype is None:
        a_src = att[:, 1].index_select(0, src)
    else:
        raise NotImplementedError(f"att gather_dtype {gather_dtype!r} is not ported")
    return a_dst + a_src


def gat_aggregate_parts(
    plan: AggregationPlan,
    h: torch.Tensor,
    att: torch.Tensor,
    relu_slope: float = DEFAULT_SLOPE,
    att_gather_dtype=None,
    h_gather_dtype=None,
    row_shift: Optional[torch.Tensor] = None,
):
    """Un-normalized attention aggregation over the plan: (num [n, f],
    den [n], slot scores [num_tasks_p, B]).  ``row_shift`` (per destination)
    is subtracted from every slot's logit; without it the scores are the
    un-stabilized exp.  att_gather_dtype / h_gather_dtype: gather modes of
    the att src half (see _att_slots_flat) and of h (see
    ops.spmm.weighted_task_sums)."""
    nt, b = plan.num_tasks_padded, plan.block_size
    f = h.shape[-1]
    z = leaky_relu(_att_slots_flat(plan, att, gather_dtype=att_gather_dtype), relu_slope)
    if row_shift is not None:
        z = z - row_shift.float().index_select(0, plan.dst).repeat_interleave(b)
    score = torch.where(slot_mask(plan), torch.exp(z), 0.0)
    num_task = weighted_task_sums(plan, h, score, gather_dtype=h_gather_dtype)
    den_task = score.reshape(nt, b).sum(dim=1)
    # [num | den] in one sum of tasks into their destination rows
    both = torch.zeros((plan.num_nodes, f + 1), dtype=num_task.dtype, device=h.device)
    both.index_add_(0, plan.dst, torch.cat([num_task, den_task[:, None].to(num_task.dtype)], dim=1))
    return both[:, :f], both[:, f], score.reshape(nt, b)
