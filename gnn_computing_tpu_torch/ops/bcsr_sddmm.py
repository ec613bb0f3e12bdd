"""SDDMM over dense count tiles, hybrid with the residual slot gather.

Port of ``gnn_computing_tpu/ops/bcsr_sddmm.py``.  For every edge (src ->
dst) the value is <a[src], b[dst]>.  Edges inside a dense tile get it as one
cell of the tile's [R, C] block of dots, P = B_rows @ A_cols^T masked by
the tile's values: the output is per cell, [num_tiles, R, C] parallel to
``TilePlan.a``, 0 where the tile has no edge; duplicate edges of a cell
share its value.  A cell holds an edge where its value is > 0, the JAX
package's rule: a count > 0, or a float tile's value > 0 (so a negative
cell of a signed float plan gives +0 in both packages, unlike the GAT
scoring rule of ops.bcsr_gat, which scores every nonzero cell).  Residual edges get theirs in the neighbor-grouping plan's
flat slot layout (ops.spmm.sddmm_slots).

``sddmm_bcsr`` launches the B6 kernel (ops.cuda_sddmm, the port of the TPU
kernel ``sddmm_bcsr_pallas``) on CUDA tensors and runs ``sddmm_bcsr_plain``,
the counterpart of ``sddmm_bcsr_xla``, on CPU tensors; there is no fallback
between the two.  Both take int8, 1-bit, float32 and bfloat16 tiles.

dot_mode: the TPU kernel offers 'exact' (a HIGHEST f32 dot), 'split23' and
'split33' (bf16 residue chunks of both operands, 16 and 24 mantissa bits, a
trade of the TPU's matrix unit).  The port computes all three alike, as one
float32 dot of the float32 operands, which meets each mode's error class.

The op is forward-only, as the TPU kernel is (it has no VJP): on either
device it raises on an input that requires grad while grad is enabled.

``tileplan_with_values`` turns a part's cell values into float32 tile
weights (count x value), the hybrid analog of the reference's
``updateval``: the SDDMM's output becomes the edge weights of a following
weighted aggregation (B1 over float32 tiles).  The weighted plan walks the
count plan's cell-walk work list (ops.cell_walk.share_walk), so a chain
called again builds no list.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from gnn_computing_tpu_torch.ops import cell_walk, cuda_sddmm
from gnn_computing_tpu_torch.ops.bcsr_gat import _pad_to
from gnn_computing_tpu_torch.ops.spmm import sddmm_slots
from gnn_computing_tpu_torch.schedule.plan import AggregationPlan
from gnn_computing_tpu_torch.schedule.tiles import TilePlan

DOT_MODES = ("exact", "split23", "split33")


def check_forward_only(what: str, *tensors):
    """Raise if grad is enabled and a tensor requires it: ``what`` has no
    VJP, as its TPU kernel has none, on either device."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what} is forward-only (the TPU kernel has no VJP): call it under "
            "torch.no_grad() or on tensors that do not require grad"
        )


def sddmm_bcsr_plain(
    tp: TilePlan, a: torch.Tensor, b: torch.Tensor, out_dtype=torch.bfloat16, chunk: int = 256
) -> torch.Tensor:
    """Plain PyTorch per-cell dots [num_tiles, R, C] in ``out_dtype``, the
    counterpart of ``sddmm_bcsr_xla``: per chunk of tiles, gather the [R, f]
    b block and the [C, f] a block of each tile, bmm, then keep the cells
    whose value is > 0 (1-bit tiles unpacked a chunk at a time)."""
    tr, tc = tp.tile_rows, tp.tile_cols
    f = a.shape[-1]
    a_t = _pad_to(a.float(), tp.num_col_tiles * tc).reshape(-1, tc, f)
    b_t = _pad_to(b.float(), tp.num_row_tiles * tr).reshape(-1, tr, f)
    out = torch.empty((tp.num_tiles, tr, tc), dtype=out_dtype, device=a.device)
    for s in range(0, tp.num_tiles, chunk):
        gb = b_t.index_select(0, tp.tile_row[s : s + chunk].long())
        ga = a_t.index_select(0, tp.tile_col[s : s + chunk].long())
        p = torch.bmm(gb, ga.transpose(1, 2))
        out[s : s + chunk] = torch.where(tp.counts(s, s + chunk) > 0, p, 0.0).to(out_dtype)
    return out


def sddmm_bcsr(
    tp: TilePlan, a: torch.Tensor, b: torch.Tensor, out_dtype=torch.bfloat16, dot_mode: str = "exact"
) -> torch.Tensor:
    """Per-cell dots <b[row], a[col]> of the plan's tiles, +0 off the
    edges: the B6 kernel on CUDA tensors, the plain version on CPU
    tensors."""
    if dot_mode not in DOT_MODES:
        raise ValueError(f"dot_mode must be one of {DOT_MODES}, got {dot_mode!r}")
    if dot_mode == "split33" and 4 * a.shape[-1] > 128:
        dot_mode = "exact"  # as the JAX package demotes it (4f > 128); the port computes both alike
    check_forward_only("the SDDMM", a, b)
    if a.device.type == "cuda":
        return cuda_sddmm.sddmm_bcsr_cuda(tp, a.float().contiguous(), b.float().contiguous(), out_dtype)
    if a.device.type == "cpu":
        return sddmm_bcsr_plain(tp, a, b, out_dtype)
    raise ValueError(f"no tile SDDMM for device {a.device}")


def hybrid_sddmm(
    tp,
    plan: Optional[AggregationPlan],
    a: torch.Tensor,
    b: torch.Tensor,
    gather_dtype=None,
    out_dtype=torch.bfloat16,
    dot_mode: str = "exact",
) -> Tuple[tuple, Optional[torch.Tensor]]:
    """SDDMM over a hybrid schedule: (per-part cell values, residual slot
    values).  ``tp`` is one TilePlan or a sequence of them (the 1-bit and
    int8 parts of Aggregator.tile_parts); each cell array parallels its
    part's ``a``.  The residual values are flat [num_tasks_padded * B]
    (None without residual edges), gathered per ``gather_dtype`` (None or
    'f16_split2')."""
    check_forward_only("the SDDMM", a, b)
    parts = [p for p in (tp if isinstance(tp, (tuple, list)) else (tp,)) if p is not None and p.num_tiles]
    cells = tuple(sddmm_bcsr(p, a, b, out_dtype=out_dtype, dot_mode=dot_mode) for p in parts)
    res = None
    if plan is not None and plan.num_edges:
        res = sddmm_slots(plan, a, b, gather_dtype=gather_dtype)
    return cells, res


def tileplan_with_values(tp: TilePlan, cell_vals: torch.Tensor) -> TilePlan:
    """Weighted TilePlan from per-cell values: a'[t, i, j] = count[t, i, j] *
    cell_vals[t, i, j] as float32 tiles (a 1-bit plan's counts unpacked, so
    the result has ``bits=False``), on ``cell_vals``' device.  Duplicate
    edges of a cell share its value, so count * value is the cell's sum of
    per-edge weights."""
    cnt = torch.as_tensor(tp.counts()).to(cell_vals.device)
    if tuple(cnt.shape) != tuple(cell_vals.shape):
        raise ValueError(f"cell values {tuple(cell_vals.shape)} do not match the tiles {tuple(cnt.shape)}")
    out = dataclasses.replace(tp, a=cnt.float() * cell_vals.float(), bits=False)
    # the same tiles and runs, nonzero only where a count is: the count
    # plan's work list serves it
    if isinstance(tp.a, torch.Tensor):
        cell_walk.share_walk(tp, out)
    return out
