"""Residual aggregation over a neighbor-grouping plan, in plain PyTorch.

out[i] = sum over edges (j -> i) of val[e] * h[j]: gather the slot rows of
h, weight them, sum each task's B slots, then add each task sum into its
destination row.  The JAX package leaves this part to XLA; the port leaves
it to PyTorch's own gather and scatter kernels.  On CUDA ``index_add_``
accumulates with atomics, so results match other implementations within a
tolerance, never bit for bit.
"""

from __future__ import annotations

import torch

from gnn_computing_tpu_torch.schedule.plan import AggregationPlan

F16_MIN_NORMAL = 2.0**-14
F16_MAX = 65504.0


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


def weighted_task_sums(
    plan: AggregationPlan, h: torch.Tensor, v: torch.Tensor, gather_dtype=None
) -> torch.Tensor:
    """[num_tasks_p, f] per-task weighted sums: sum_b v[t,b] * h[src[t,b]].
    Mirrors ``gnn_computing_tpu.ops.spmm.weighted_task_sums``.

    gather_dtype:
      None         — gather h as it is.
      'f16_split2' — gather one [n, 2f] float16 table of residue chunks
                     (hi, lo) and rebuild hi + lo in float32: 21 mantissa
                     bits, exact for signed sums too.  A row beyond
                     float16's range is stored scaled by a power of two
                     (f16_split2_rows): the JAX package's table turns it
                     into inf and the sum into NaN; deep unnormalized GCN
                     layers reach it (at the bench's quick scale layer 3
                     sees |z| up to 5.3e5).
    """
    nt, b = plan.num_tasks_padded, plan.block_size
    f = h.shape[-1]
    src = plan.src_flat()
    v = v.reshape(-1)
    if gather_dtype == "f16_split2":
        table, scale = f16_split2_rows(h)
        g = table.index_select(0, src)
        msg = (g[:, :f].float() + g[:, f:].float()) * (scale.index_select(0, src) * v.float())[:, None]
    elif gather_dtype is None:
        msg = h.index_select(0, src) * v.to(h.dtype)[:, None]
    else:
        raise NotImplementedError(f"gather_dtype {gather_dtype!r} is not ported")
    return msg.reshape(nt, b, f).sum(dim=1, dtype=h.dtype)


def spmm_plain(plan: AggregationPlan, h: torch.Tensor, gather_dtype=None, val=None) -> torch.Tensor:
    """Counterpart of ``gnn_computing_tpu.ops.spmm.spmm_xla``: gather ->
    per-task weighted sum -> sum of tasks into their destination rows,
    weighted by ``val`` (flat [num_tasks_p * B] slot values) or, without
    it, by the plan's own."""
    task = weighted_task_sums(plan, h, plan.val if val is None else val, gather_dtype=gather_dtype)
    out = torch.zeros((plan.num_nodes, h.shape[-1]), dtype=h.dtype, device=h.device)
    return out.index_add_(0, plan.dst, task)


def _slot_pos_flat(plan: AggregationPlan):
    """(scheduled-edge position, task count, slot id) of every flat slot
    [num_tasks_p * B]."""
    b = plan.block_size
    count = plan.count.long()
    cum = torch.cumsum(count, 0) - count  # exclusive
    slot = torch.arange(plan.num_tasks_padded * b, device=count.device) % b
    return cum.repeat_interleave(b) + slot, count.repeat_interleave(b), slot


def _check_edge_order(plan: AggregationPlan):
    if plan.edge_perm is not None:
        raise NotImplementedError("plans with an edge permutation are not ported (neighbor grouping keeps CSR order)")


def slots_from_edge_values_flat(plan: AggregationPlan, edge_val: torch.Tensor) -> torch.Tensor:
    """Per-edge values (CSR edge order) spread into the flat slot layout,
    0 in pad slots."""
    _check_edge_order(plan)
    pos, cnt, slot = _slot_pos_flat(plan)
    safe = pos.clamp(max=max(plan.num_edges - 1, 0))
    return torch.where(slot < cnt, edge_val[safe], torch.zeros((), dtype=edge_val.dtype, device=edge_val.device))


def edge_values_from_slots_flat(plan: AggregationPlan, slot_val: torch.Tensor) -> torch.Tensor:
    """Flat slot values collected back into CSR edge order (pad slots
    dropped)."""
    _check_edge_order(plan)
    pos, cnt, slot = _slot_pos_flat(plan)
    valid = slot < cnt
    out = torch.zeros((plan.num_edges,), dtype=slot_val.dtype, device=slot_val.device)
    out[pos[valid]] = slot_val[valid]
    return out


def sddmm_slots(
    plan: AggregationPlan, a: torch.Tensor, b: torch.Tensor, gather_dtype=None, chunk_slots: int = 1 << 22
) -> torch.Tensor:
    """Per-slot dot products, flat: out[t*B + s] = <a[src_{t,s}], b[dst_t]>,
    0 in pad slots (the counterpart of ``sddmm_slots_xla`` and
    ``sddmm_slots_chunked``, in chunks of whole tasks so the gathered
    [slots, f] block stays bounded).  ``gather_dtype`` as in
    weighted_task_sums: 'f16_split2' gathers the [n, 2f] float16 (hi, lo)
    table and rebuilds (hi + lo) * scale in float32 before the dot
    (f16_split2_rows)."""
    bsz = plan.block_size
    f = a.shape[-1]
    src = plan.src_flat()
    dst = plan.dst
    cnt = plan.count.long()
    nt = plan.num_tasks_padded
    if gather_dtype == "f16_split2":
        table, scale = f16_split2_rows(a)
    elif gather_dtype is None:
        table = a
    else:
        raise NotImplementedError(f"gather_dtype {gather_dtype!r} is not ported")
    out = torch.empty((nt * bsz,), dtype=b.dtype, device=b.device)
    step = max(1, chunk_slots // bsz)
    for t0 in range(0, nt, step):
        t1 = min(nt, t0 + step)
        src_c = src[t0 * bsz : t1 * bsz]
        g = table.index_select(0, src_c)
        if gather_dtype == "f16_split2":
            g = (g[:, :f].float() + g[:, f:].float()) * scale.index_select(0, src_c)[:, None]
        ga = g.reshape(t1 - t0, bsz, f).to(b.dtype)
        gb = b.index_select(0, dst[t0:t1])
        dots = (ga * gb[:, None, :]).sum(dim=-1)
        mask = torch.arange(bsz, device=cnt.device)[None, :] < cnt[t0:t1, None]
        out[t0 * bsz : t1 * bsz] = torch.where(mask, dots, 0.0).reshape(-1)
    return out
