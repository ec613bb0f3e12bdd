"""Launch the B1 CUDA kernel (``csrc/bcsr_spmm.cu``).

The kernel replaces ``gnn_computing_tpu/ops/pallas_bcsr.py:bcsr_spmm_pallas``
for int8 count tiles and 1-bit tiles (one template on the A format) and a
float32 operand.  ops.cuda_build compiles it at first use and binds it with
ctypes.

``launches`` counts kernel launches and ``bits_launches`` the 1-bit ones
among them; each rises only where the kernel is launched, so a run can show
that its main path went through the kernel and its 1-bit variant.
"""

from __future__ import annotations

import ctypes

import torch

from gnn_computing_tpu_torch.ops.cuda_build import check_no_grad, check_plan, check_tensor, load, stream_args

NAME = "bcsr_spmm"
SIGNATURES = {
    fn: [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    for fn in ("bcsr_spmm_i8_f32", "bcsr_spmm_b1_f32")
}

launches = 0
bits_launches = 0


def bcsr_spmm_cuda(tp, h: torch.Tensor) -> torch.Tensor:
    """out[num_nodes, f] = A @ h over the plan's tiles, with ``h`` already
    rounded and scaled (see ops.bcsr.bcsr_spmm).  Launches the kernel or
    raises; it never falls back."""
    global launches, bits_launches
    check_no_grad(h)
    dev = h.device
    if dev.type != "cuda":
        raise ValueError(f"bcsr_spmm_cuda takes CUDA tensors, got {dev}")
    if h.dim() != 2:
        raise ValueError(f"h must be [n_src, f], got {tuple(h.shape)}")
    f = h.shape[1]
    check_tensor(h, "h", torch.float32, (tp.n_src, f), dev)
    fmt = check_plan(tp, dev)
    out = torch.empty((tp.num_nodes, f), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    err = getattr(load(NAME, SIGNATURES), f"bcsr_spmm_{fmt}_f32")(
        tp.a.data_ptr(), tp.tile_col.data_ptr(), tp.run_start.data_ptr(),
        h.data_ptr(), out.data_ptr(), tp.num_row_tiles, tp.tile_rows, tp.tile_cols, tp.num_nodes, tp.n_src, f,
        *stream_args(dev),
    )
    if err != 0:
        raise RuntimeError(f"bcsr_spmm kernel launch failed: cudaError {err}")
    launches += 1
    bits_launches += tp.bits
    return out
