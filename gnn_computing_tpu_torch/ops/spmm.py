"""SpMM over a gather plan, in plain PyTorch (port of
``gnn_computing_tpu/ops/spmm.py``).

out[i] = sum over edges (j -> i) of val[e] * h[j]: gather the slot rows of
h, weight them, sum each task's B slots, then add each task sum into its
destination row.  The JAX package leaves this to XLA ("deliberately NO
Pallas gather-path kernel"); the port leaves it to PyTorch's own gather
and scatter kernels.  It serves every gather schedule (schedule.make_plan)
and the residual of the hybrid op.  On CUDA ``index_add_`` accumulates with
atomics, so results match other implementations within a tolerance, never
bit for bit.

Slot values are flat ([num_tasks_p * B]) in a device plan; the helpers
take JAX's 2-D [num_tasks_p, B] layout too.  A locality plan permutes the
edges (``edge_perm``: scheduled edge -> CSR edge), and every per-edge value
goes in through it and comes back through its inverse.

``spmm`` is differentiable through PyTorch's autograd (the gather's
transpose is a scatter); ``spmm_bidir`` aggregates the cotangent over a
transposed plan instead, and its value gradient is the slot SDDMM
(``sddmm_slots``), as the JAX custom VJP.
"""

from __future__ import annotations

from typing import Optional

import torch

from gnn_computing_tpu_torch.schedule.plan import AggregationPlan
from gnn_computing_tpu_torch.utils.profiling import span

F16_MIN_NORMAL = 2.0**-14
F16_MAX = 65504.0
# slots one chunk of spmm_plain, spmm_transpose or sddmm_slots gathers: the
# gathered [slots, f] block is materialized (2 GB at f = 128 in float32)
CHUNK_SLOTS = 1 << 22
STRATEGIES = ("auto", "xla")  # the JAX package's names; both mean the gather


def f16_split2(h: torch.Tensor):
    """(hi, lo) float16 residue chunks with hi + lo == h to 21 mantissa bits.
    ``hi`` flushes values below float16's smallest normal to zero, as JAX's
    ``lax.reduce_precision(h, 5, 10)`` does; ``lo`` then carries them."""
    hf = h.float()
    hi = torch.where(hf.abs() < F16_MIN_NORMAL, torch.zeros_like(hf), hf).to(torch.float16)
    lo = (hf - hi.float()).to(torch.float16)
    return hi, lo


def f16_split2_rows(h: torch.Tensor):
    """([n, 2f] float16 table of (hi, lo) residue chunks, [n] float32 row
    scale) for gathering rows of 2-D ``h`` at 21 mantissa bits: row i is
    stored as h[i] / scale[i] and rebuilt as (hi + lo) * scale[i].  The
    scale is 1 for a row whose |h| <= 65504 (float16's range; the table is
    then the JAX package's) and a power of two that brings the row within
    range otherwise, so a value float16 cannot hold is never inf.  The
    choice is made on the device: no host sync."""
    hf = h.float()
    big = hf.abs().amax(dim=1) if hf.shape[1] else hf.new_zeros(hf.shape[0])
    e = torch.where(big > F16_MAX, torch.ceil(torch.log2(big / F16_MAX)) + 1.0, 0.0)
    scale = torch.exp2(e)
    return torch.cat(f16_split2(hf / scale[:, None]), dim=1), scale


def bf16_residue_chunks(x: torch.Tensor, n: int) -> list:
    """Decompose float32 ``x`` into ``n`` bf16 chunks whose sum equals x to
    n*8 mantissa bits (round to nearest even, as lax.reduce_precision)."""
    chunks = []
    rem = x
    for _ in range(n):
        c = rem.to(torch.bfloat16)
        chunks.append(c)
        rem = rem - c.float()
    return chunks


def check_strategy(strategy: str):
    if strategy not in STRATEGIES:
        raise ValueError(f"strategy must be one of {STRATEGIES}, got {strategy!r}")


# --------------------------------------------------------- the gather ladder
def gather_table(x: torch.Tensor, gather_dtype):
    """(table, row scale or None): the rows of 2-D ``x`` as ``gather_dtype``
    stores them for the gather.

      None           — x as it is.
      'f16_split2'   — an [n, 2f] float16 table of (hi, lo) residue chunks,
                       21 mantissa bits, exact for signed sums too; a row
                       beyond float16's range is stored scaled by a power
                       of two (f16_split2_rows), where the JAX package's
                       table holds inf and its sums NaN (deep unnormalized
                       GCN layers reach it: |z| up to 5.3e5 at the bench's
                       quick scale).
      'bf16_split2'  — an [n, 2f] bfloat16 table of residue chunks, 16
                       mantissa bits (misses the gate on cancelling dots,
                       as in the JAX package).
      a torch dtype  — x cast to it (torch.bfloat16 / torch.float16, the
                       JAX package's jnp.bfloat16 / jnp.float16): one
                       rounding, safe only for sums that do not cancel.
    Anything else raises, as the JAX package does."""
    if gather_dtype is None:
        return x, None
    if gather_dtype == "f16_split2":
        return f16_split2_rows(x)
    if gather_dtype == "bf16_split2":
        return torch.cat(bf16_residue_chunks(x.float(), 2), dim=1), None
    if isinstance(gather_dtype, torch.dtype) and gather_dtype.is_floating_point:
        return x.to(gather_dtype), None
    raise ValueError(
        f"gather_dtype must be None, 'f16_split2', 'bf16_split2' or a torch floating dtype, got {gather_dtype!r}"
    )


def gather_rows(table: torch.Tensor, scale, src: torch.Tensor, gather_dtype, f: int) -> torch.Tensor:
    """Rows ``src`` of a gather_table: the two residue chunks rebuilt as
    (hi + lo) * scale in float32, other modes as the table holds them."""
    g = table.index_select(0, src)
    if isinstance(gather_dtype, str):
        g = g[:, :f].float() + g[:, f:].float()
        if scale is not None:
            g = g * scale.index_select(0, src)[:, None]
    return g


def _task_sums(table, scale, src, v, b: int, f: int, gather_dtype, out_dtype) -> torch.Tensor:
    """Weighted sums of B-slot tasks: the row times the weight in the
    gather's dtype, the sum over the slots in ``out_dtype``."""
    g = gather_rows(table, scale, src, gather_dtype, f)
    return (g * v.to(g.dtype)[:, None]).reshape(-1, b, f).sum(dim=1, dtype=out_dtype)


def weighted_task_sums(
    plan: AggregationPlan, h: torch.Tensor, v: torch.Tensor, gather_dtype=None
) -> torch.Tensor:
    """[num_tasks_p, f] per-task weighted sums: sum_b v[t,b] * h[src[t,b]]
    (``v`` flat or [num_tasks_p, B]); ``gather_dtype`` as in gather_table."""
    table, scale = gather_table(h, gather_dtype)
    return _task_sums(table, scale, plan.src_flat(), v.reshape(-1), plan.block_size, h.shape[-1], gather_dtype, h.dtype)


def _chunks(plan: AggregationPlan, chunk_slots: int):
    """(first task, end task) of each chunk of at most ``chunk_slots``
    slots (at least one task)."""
    step = max(1, chunk_slots // plan.block_size)
    nt = plan.num_tasks_padded
    return [(t0, min(nt, t0 + step)) for t0 in range(0, nt, step)]


def spmm_plain(
    plan: AggregationPlan, h: torch.Tensor, gather_dtype=None, val=None, chunk_slots: int = CHUNK_SLOTS
) -> torch.Tensor:
    """Counterpart of ``gnn_computing_tpu.ops.spmm.spmm_xla``: gather ->
    per-task weighted sum -> sum of tasks into their destination rows,
    weighted by ``val`` (slot values, flat or [num_tasks_p, B]) or, without
    it, by the plan's own.  Tasks go in chunks of at most ``chunk_slots``
    slots, so the gathered block stays bounded at any plan size (the
    counterpart of ``_spmm_xla_chunked``); the result depends on the bound
    only through the float32 summation order."""
    v = _resolve_val(plan, val)
    b, f = plan.block_size, h.shape[-1]
    table, scale = gather_table(h, gather_dtype)
    src = plan.src_flat()
    out = torch.zeros((plan.num_nodes, f), dtype=h.dtype, device=h.device)
    for t0, t1 in _chunks(plan, chunk_slots):
        task = _task_sums(table, scale, src[t0 * b : t1 * b], v[t0 * b : t1 * b], b, f, gather_dtype, h.dtype)
        out.index_add_(0, plan.dst[t0:t1], task)
    return out


def spmm_transpose(
    plan: AggregationPlan, g_out: torch.Tensor, val=None, chunk_slots: int = CHUNK_SLOTS
) -> torch.Tensor:
    """A^T @ g_out over the forward plan (``spmm_transpose_xla``):
    out[s] = sum over slots (t, b) with src s of val[t, b] * g_out[dst[t]]."""
    v = _resolve_val(plan, val)
    b, f = plan.block_size, g_out.shape[-1]
    src = plan.src_flat()
    out = torch.zeros((plan.n_src, f), dtype=g_out.dtype, device=g_out.device)
    for t0, t1 in _chunks(plan, chunk_slots):
        rows = g_out.index_select(0, plan.dst[t0:t1])
        contrib = rows[:, None, :] * v[t0 * b : t1 * b].reshape(-1, b, 1).to(g_out.dtype)
        out.index_add_(0, src[t0 * b : t1 * b], contrib.reshape(-1, f))
    return out


# --------------------------------------------------------------- slot helpers
def _slot_pos_flat(plan: AggregationPlan):
    """(scheduled-edge position, task count, slot id) of every flat slot
    [num_tasks_p * B]: tasks tile the scheduled edge order in turn, so a
    task's first edge is the exclusive cumsum of the counts."""
    b = plan.block_size
    count = plan.count.long()
    cum = torch.cumsum(count, 0) - count
    slot = torch.arange(plan.num_tasks_padded * b, device=count.device) % b
    return cum.repeat_interleave(b) + slot, count.repeat_interleave(b), slot


def slot_positions(plan: AggregationPlan) -> torch.Tensor:
    """[num_tasks_p, B] scheduled edge position of every slot."""
    return _slot_pos_flat(plan)[0].reshape(plan.num_tasks_padded, plan.block_size)


def slots_from_edge_values_flat(plan: AggregationPlan, edge_val: torch.Tensor) -> torch.Tensor:
    """Per-edge values (CSR edge order) spread into the flat slot layout,
    0 in pad slots; through ``edge_perm`` where the plan has one."""
    pos, cnt, slot = _slot_pos_flat(plan)
    if plan.edge_perm is not None:
        edge_val = edge_val[plan.edge_perm]
    safe = pos.clamp(max=max(plan.num_edges - 1, 0))
    return torch.where(slot < cnt, edge_val[safe], torch.zeros((), dtype=edge_val.dtype, device=edge_val.device))


def slots_from_edge_values(plan: AggregationPlan, edge_val: torch.Tensor) -> torch.Tensor:
    """slots_from_edge_values_flat in JAX's [num_tasks_p, B] layout."""
    return slots_from_edge_values_flat(plan, edge_val).reshape(plan.num_tasks_padded, plan.block_size)


def edge_values_from_slots_flat(plan: AggregationPlan, slot_val: torch.Tensor) -> torch.Tensor:
    """Slot values (flat or [num_tasks_p, B]) collected back into CSR edge
    order, pad slots dropped; a permuted plan's slot lands on CSR edge
    edge_perm[scheduled position] (the inverse permutation)."""
    pos, cnt, slot = _slot_pos_flat(plan)
    valid = slot < cnt
    with span("gnn.sync", site="spmm.slot_pos"):  # a boolean mask's size is read on the host
        idx = pos[valid]
    if plan.edge_perm is not None:
        idx = plan.edge_perm[idx]
    out = torch.zeros((plan.num_edges,), dtype=slot_val.dtype, device=slot_val.device)
    with span("gnn.sync", site="spmm.slot_val"):
        out[idx] = slot_val.reshape(-1)[valid]
    return out


edge_values_from_slots = edge_values_from_slots_flat  # takes JAX's 2-D layout too


def _resolve_val(plan: AggregationPlan, val) -> torch.Tensor:
    """Slot values as a flat [num_tasks_p * B] vector: ``val`` flat or in
    [num_tasks_p, B], or the plan's own."""
    if val is None:
        if plan.val is None:
            raise ValueError("plan has no edge values")
        return plan.val.reshape(-1)
    want = (plan.num_tasks_padded, plan.block_size)
    if tuple(val.shape) not in (want, (want[0] * want[1],)):
        raise ValueError(
            f"val must be in slot layout {want} (or flat), got {tuple(val.shape)}; "
            "use slots_from_edge_values for per-edge values"
        )
    return val.reshape(-1)


def sddmm_slots(
    plan: AggregationPlan, a: torch.Tensor, b: torch.Tensor, gather_dtype=None, chunk_slots: int = CHUNK_SLOTS
) -> torch.Tensor:
    """Per-slot dot products, flat: out[t*B + s] = <a[src_{t,s}], b[dst_t]>,
    0 in pad slots (the counterpart of ``sddmm_slots_xla`` and
    ``sddmm_slots_chunked``, in chunks of whole tasks so the gathered
    [slots, f] block stays bounded).  ``gather_dtype`` as in gather_table,
    for the source rows; the dot is in b's dtype."""
    bsz, f = plan.block_size, a.shape[-1]
    src = plan.src_flat()
    cnt = plan.count.long()
    table, scale = gather_table(a, gather_dtype)
    out = torch.empty((plan.num_tasks_padded * bsz,), dtype=b.dtype, device=b.device)
    for t0, t1 in _chunks(plan, chunk_slots):
        ga = gather_rows(table, scale, src[t0 * bsz : t1 * bsz], gather_dtype, f).to(b.dtype)
        gb = b.index_select(0, plan.dst[t0:t1])
        dots = (ga.reshape(t1 - t0, bsz, f) * gb[:, None, :]).sum(dim=-1)
        mask = torch.arange(bsz, device=cnt.device)[None, :] < cnt[t0:t1, None]
        out[t0 * bsz : t1 * bsz] = torch.where(mask, dots, 0.0).reshape(-1)
    return out


# ------------------------------------------- transposed-plan backward
class SpmmBidir(torch.autograd.Function):
    """out = A_plan @ h; dh = A_plan_t @ ct over the transposed plan (its
    own values, or ``val_t``), dval = the slot SDDMM <h[src], ct[dst]> (0
    in pad slots).  ``val_t`` holds the same edge values as ``val`` in the
    transposed plan's layout and gets no gradient."""

    @staticmethod
    def forward(ctx, h, val, plan, plan_t, val_t):
        ctx.plans = (plan, plan_t, val_t)
        ctx.save_for_backward(h if val is not None else None, val)
        return spmm_plain(plan, h, val=val)

    @staticmethod
    def backward(ctx, ct):
        plan, plan_t, val_t = ctx.plans
        h, val = ctx.saved_tensors
        dh = spmm_plain(plan_t, ct, val=val_t) if ctx.needs_input_grad[0] else None
        dval = None
        if val is not None and ctx.needs_input_grad[1]:
            dval = sddmm_slots(plan, h, ct).reshape(val.shape).to(val.dtype)
        return dh, dval, None, None, None


def spmm_bidir(
    plan: AggregationPlan,
    plan_t: AggregationPlan,
    h: torch.Tensor,
    val: Optional[torch.Tensor] = None,
    val_t: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """SpMM whose backward aggregates over the transposed plan (see
    SpmmBidir); gradients flow to ``h`` and ``val``."""
    return SpmmBidir.apply(h, val, plan, plan_t, val_t)


def spmm(plan: AggregationPlan, h: torch.Tensor, val: Optional[torch.Tensor] = None, strategy: str = "auto") -> torch.Tensor:
    """out[n, f] = A_plan @ h, ``val`` (slot values, differentiable)
    overriding the plan's.  ``strategy`` 'auto' or 'xla' (the JAX names;
    both the gather).  It takes no gather mode, as the JAX op takes none."""
    check_strategy(strategy)
    return spmm_plain(plan, h, val=val)
