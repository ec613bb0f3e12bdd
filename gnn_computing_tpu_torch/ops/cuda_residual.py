"""Launch the residual-probe CUDA kernels (``csrc/task_sums.cu``,
``csrc/fused_hybrid.cu``).

``task_sums_cuda`` (P1) replaces ``probes/overlap_dma_residual.py:
dma_task_sums``: the residual plan's per-task weighted sums of gathered
rows.  ``fused_hybrid_cuda`` (P2) replaces the same probe's
``fused_hybrid``: B1's tile product and P1's task sums from one grid, whose
walk blocks walk the plan's work list (ops.cell_walk, as B1) and whose
residual blocks take 8 tasks each; a run of more than one chunk sums its
chunks' partials through a scratch buffer allocated here, in the walk's
finish pass.  ops.cuda_build compiles each at first use and binds it with
ctypes.

``task_sums_launches`` and ``fused_launches`` count the kernels' launches;
each rises only where its kernel is launched.
"""

from __future__ import annotations

import ctypes

import torch

from gnn_computing_tpu_torch.ops import cell_walk
from gnn_computing_tpu_torch.ops.cuda_build import check_no_grad, check_plan, check_tensor, load, stream_args

TASK_SUMS = "task_sums"
FUSED = "fused_hybrid"
_P, _I = ctypes.c_void_p, ctypes.c_int
TASK_SUMS_SIGNATURES = {"task_sums_f32": [_P] * 4 + [ctypes.c_longlong, _I, _I, _I, _P]}
FUSED_TAGS = ("i8", "f32", "bf16")  # a 1-bit plan is refused, as the TPU probe refuses one
FUSED_SIGNATURES = {
    f"fused_hybrid_{tag}_f32": [_P] * 11 + [_I] * 8 + [ctypes.c_longlong, _I, _I, _P] for tag in FUSED_TAGS
}

task_sums_launches = 0
fused_launches = 0


def _check_residual(plan, h: torch.Tensor, name: str):
    """The device, f and task count of a residual plan and its raw h."""
    check_no_grad(h)
    dev = h.device
    if dev.type != "cuda":
        raise ValueError(f"{name} takes CUDA tensors, got {dev}")
    if h.dim() != 2:
        raise ValueError(f"h must be [n_src, f], got {tuple(h.shape)}")
    f = h.shape[1]
    nt, b = plan.num_tasks_padded, plan.block_size
    check_tensor(h, "h", torch.float32, (plan.n_src, f), dev)
    check_tensor(plan.src, "plan.src", torch.int64, (nt * b,), dev)
    if plan.val is None:
        raise ValueError("the residual plan has no slot values")
    check_tensor(plan.val, "plan.val", torch.float32, (nt * b,), dev)
    return dev, f, nt, b


def task_sums_cuda(plan, h: torch.Tensor) -> torch.Tensor:
    """[num_tasks_p, f] task sums, sum_b val[t, b] * h[src[t, b]], over the
    plan's flat src / val (ops.spmm.weighted_task_sums's function).
    Launches the kernel or raises; it never falls back."""
    global task_sums_launches
    dev, f, nt, b = _check_residual(plan, h, "task_sums_cuda")
    out = torch.empty((nt, f), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    err = load(TASK_SUMS, TASK_SUMS_SIGNATURES).task_sums_f32(
        h.data_ptr(), plan.src.data_ptr(), plan.val.data_ptr(), out.data_ptr(), nt, b, f, *stream_args(dev),
    )
    if err != 0:
        raise RuntimeError(f"task_sums kernel launch failed: cudaError {err}")
    task_sums_launches += 1
    return out


def fused_hybrid_cuda(tp, plan, x: torch.Tensor, h: torch.Tensor):
    """(dense_out [num_nodes, f], task_sums [num_tasks_p, f]) from one
    launch: the tile product over ``x`` (h already rounded and scaled by the
    plan's ``scale_src``, as bcsr_spmm_cuda takes it; the kernel applies
    ``scale_dst``: dense_out is bitwise bcsr_spmm_cuda(tp, x) times
    scale_dst) and the residual task sums of the raw ``h`` (bitwise
    task_sums_cuda's).  int8, float32 and bfloat16 tiles; a 1-bit plan
    raises ValueError.  Launches the kernel (and, for a run of several
    chunks, the walk's finish pass after it) or raises; it never falls
    back."""
    global fused_launches
    if tp.bits:
        raise ValueError("fused_hybrid takes int8, float32 or bfloat16 tiles, not a 1-bit plan")
    dev, f, nt, b = _check_residual(plan, h, "fused_hybrid_cuda")
    check_no_grad(x)
    check_tensor(x, "x", torch.float32, (tp.n_src, f), dev)
    if plan.n_src != tp.n_src:
        raise ValueError(f"the plans disagree on n_src: tiles {tp.n_src}, residual {plan.n_src}")
    tag = check_plan(tp, dev)
    scale_dst = tp.scale_dst
    if scale_dst is not None:
        check_tensor(scale_dst, "scale_dst", torch.float32, (tp.num_nodes,), dev)
    out = torch.empty((tp.num_nodes, f), dtype=torch.float32, device=dev)
    ts = torch.empty((nt, f), dtype=torch.float32, device=dev)
    if f == 0:
        return out, ts
    scratch, work, scr, num_chunks, num_multi = cell_walk.walk_args(tp, f, dev)
    err = getattr(load(FUSED, FUSED_SIGNATURES), f"fused_hybrid_{tag}_f32")(
        tp.a.data_ptr(), tp.tile_col.data_ptr(), work, x.data_ptr(),
        None if scale_dst is None else scale_dst.data_ptr(), out.data_ptr(), scr, h.data_ptr(), plan.src.data_ptr(),
        plan.val.data_ptr(), ts.data_ptr(), num_chunks, num_multi, tp.num_row_tiles, tp.tile_rows, tp.tile_cols,
        tp.num_nodes, tp.n_src, f, nt, b, *stream_args(dev),
    )
    if err != 0:
        raise RuntimeError(f"fused_hybrid kernel launch failed: cudaError {err}")
    fused_launches += 1
    return out, ts
