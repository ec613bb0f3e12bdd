"""Launch the B1 CUDA kernel (``csrc/bcsr_spmm.cu``).

The kernel replaces ``gnn_computing_tpu/ops/pallas_bcsr.py:bcsr_spmm_pallas``
for int8 count tiles, 1-bit tiles, float32 and bfloat16 tiles (one template
on the A format) and a float32 operand, with or without its ``w_epilogue``
(``bcsr_spmm_nn_cuda``: the aggregate and its product with W from one
launch).  It walks the plan's nonzero cells in chunks of the plan's work
list (ops.cell_walk, built at the plan's first launch and cached), the
list's staged chunks of an int8 plan with the staged walk where their
blocks fill the card (``cell_walk.stages``); a run of more than one chunk
sums its chunks' partials through a scratch buffer allocated here.
ops.cuda_build compiles it at first use and binds it with ctypes.

``launches`` counts kernel launches; ``bits_launches``, ``float_launches``
(float32 or bfloat16 tiles) and ``epilogue_launches`` (the w_epilogue
variant) count those among them.  Each rises only where the kernel is
launched, so a run can show that its main path went through the kernel
and the variant it names.  Under ``utils.profiling.recording`` each launch
also adds the counters ``walk.cells`` (the plan's nonzero cells) and
``walk.staged_cells`` (those of the chunks the launch stages; 0 where it
walks every chunk by gathers), read from the list.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gnn_computing_tpu_torch.ops import cell_walk
from gnn_computing_tpu_torch.ops.cuda_build import TAGS, check_no_grad, check_plan, check_tensor, load, stream_args
from gnn_computing_tpu_torch.utils.profiling import count

NAME = "bcsr_spmm"
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    **{f"bcsr_spmm_{tag}_f32": [_P] * 6 + [_I] * 11 + [_P] for tag in TAGS},
    **{f"bcsr_spmm_nn_{tag}_f32": [_P] * 9 + [_I] * 12 + [_P] for tag in TAGS},
}
# the epilogue variant's block holds all f columns of its rows
MAX_EPILOGUE_F = 128

launches = 0
bits_launches = 0
float_launches = 0
epilogue_launches = 0


def _check_h(tp, h: torch.Tensor, name: str):
    check_no_grad(h)
    dev = h.device
    if dev.type != "cuda":
        raise ValueError(f"{name} takes CUDA tensors, got {dev}")
    if h.dim() != 2:
        raise ValueError(f"h must be [n_src, f], got {tuple(h.shape)}")
    check_tensor(h, "h", torch.float32, (tp.n_src, h.shape[1]), dev)
    return dev, h.shape[1], check_plan(tp, dev)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _staged(tp, walk, f: int, dev) -> tuple:
    """(staged chunks, their tiles) as the launch takes them: the list's
    where ``cell_walk.stages`` says their blocks fill the card, else (0, 0),
    every chunk by gathers."""
    if cell_walk.stageable(tp) and cell_walk.stages(walk, f, _sms(dev.index)):
        return walk.num_staged, walk.num_stage_tiles
    return 0, 0


def _count(tag: str, epilogue: bool, walk, staged: int):
    global launches, bits_launches, float_launches, epilogue_launches
    launches += 1
    bits_launches += tag == "b1"
    float_launches += tag in ("f32", "bf16")
    epilogue_launches += epilogue
    count("walk.cells", walk.total_cells)
    count("walk.staged_cells", walk.staged_cells if staged else 0)


def bcsr_spmm_cuda(tp, h: torch.Tensor) -> torch.Tensor:
    """out[num_nodes, f] = A @ h over the plan's tiles, with ``h`` already
    rounded and scaled (see ops.bcsr.bcsr_spmm).  Launches the kernel or
    raises; it never falls back."""
    dev, f, tag = _check_h(tp, h, "bcsr_spmm_cuda")
    out = torch.empty((tp.num_nodes, f), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    scratch, work, scr, num_chunks, num_multi = cell_walk.walk_args(tp, f, dev)
    walk = cell_walk.walk_for(tp)
    staged, stage_tiles = _staged(tp, walk, f, dev)
    err = getattr(load(NAME, SIGNATURES), f"bcsr_spmm_{tag}_f32")(
        tp.a.data_ptr(), tp.tile_col.data_ptr(), work, h.data_ptr(), out.data_ptr(), scr, num_chunks, num_multi,
        staged, stage_tiles, tp.num_row_tiles, tp.tile_rows, tp.tile_cols, tp.num_nodes, tp.n_src, f,
        *stream_args(dev),
    )
    if err != 0:
        raise RuntimeError(f"bcsr_spmm kernel launch failed: cudaError {err}")
    _count(tag, False, walk, staged)
    return out


def bcsr_spmm_nn_cuda(tp, h: torch.Tensor, w: torch.Tensor):
    """(agg [num_nodes, f], trans [num_nodes, f_out] = agg @ w) over the
    plan's tiles from one launch of the w_epilogue variant, with ``h``
    already rounded and scaled by the plan's ``scale_src``; the kernel
    applies ``scale_dst`` to the accumulator before both outputs.  f is at
    most MAX_EPILOGUE_F.  Launches the kernel or raises; it never falls
    back."""
    dev, f, tag = _check_h(tp, h, "bcsr_spmm_nn_cuda")
    check_no_grad(w)
    if f > MAX_EPILOGUE_F:
        raise ValueError(f"the w_epilogue kernel holds f <= {MAX_EPILOGUE_F} columns a row, got f = {f}")
    if w.dim() != 2:
        raise ValueError(f"w must be [f, f_out], got {tuple(w.shape)}")
    f_out = w.shape[1]
    if f_out == 0:
        raise ValueError("w must have at least one column")
    check_tensor(w, "w", torch.float32, (f, f_out), dev)
    scale_dst = tp.scale_dst
    if scale_dst is not None:
        check_tensor(scale_dst, "scale_dst", torch.float32, (tp.num_nodes,), dev)
    agg = torch.empty((tp.num_nodes, f), dtype=torch.float32, device=dev)
    trans = torch.empty((tp.num_nodes, f_out), dtype=torch.float32, device=dev)
    if tp.num_nodes == 0:
        return agg, trans
    if f == 0:
        return agg, trans.zero_()
    scratch, work, scr, num_chunks, num_multi = cell_walk.walk_args(tp, f, dev)
    walk = cell_walk.walk_for(tp)
    staged, stage_tiles = _staged(tp, walk, f, dev)
    err = getattr(load(NAME, SIGNATURES), f"bcsr_spmm_nn_{tag}_f32")(
        tp.a.data_ptr(), tp.tile_col.data_ptr(), work, h.data_ptr(), w.data_ptr(),
        None if scale_dst is None else scale_dst.data_ptr(), agg.data_ptr(), trans.data_ptr(), scr, num_chunks,
        num_multi, staged, stage_tiles, tp.num_row_tiles, tp.tile_rows, tp.tile_cols, tp.num_nodes, tp.n_src, f,
        f_out, *stream_args(dev),
    )
    if err != 0:
        raise RuntimeError(f"bcsr_spmm_nn kernel launch failed: cudaError {err}")
    _count(tag, True, walk, staged)
    return agg, trans
