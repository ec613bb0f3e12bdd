"""Launch the B6 CUDA kernel (``csrc/sddmm_bcsr.cu``).

The kernel replaces ``gnn_computing_tpu/ops/bcsr_sddmm.py:sddmm_bcsr_pallas``
for int8 count tiles and 1-bit tiles, float32 operands and a float32 or
bfloat16 output.  ops.cuda_build compiles it at first use and binds it with
ctypes.

``launches`` counts kernel launches; it rises only where the kernel is
launched, so a run can show that its path went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from gnn_computing_tpu_torch.ops.cuda_build import check_no_grad, check_tensor, load, format_tag, stream_args

NAME = "sddmm_bcsr"
SIGNATURES = {"sddmm_bcsr_f32": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p]}
OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


def sddmm_bcsr_cuda(tp, a: torch.Tensor, b: torch.Tensor, out_dtype=torch.bfloat16) -> torch.Tensor:
    """Per-cell dots [num_tiles, R, C] in ``out_dtype``: <b[row], a[col]>
    where the cell holds an edge, +0 elsewhere.  Launches the kernel or
    raises; it never falls back."""
    global launches
    check_no_grad(a, b)
    dev = a.device
    if dev.type != "cuda":
        raise ValueError(f"sddmm_bcsr_cuda takes CUDA tensors, got {dev}")
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    if a.dim() != 2:
        raise ValueError(f"a must be [n_src, f], got {tuple(a.shape)}")
    f = a.shape[1]
    t, r, c = tp.num_tiles, tp.tile_rows, tp.tile_cols
    format_tag(tp, "B6 (sddmm_bcsr)")
    if tp.bits and r % 8:
        raise ValueError(f"1-bit tiles need R % 8 == 0, got R = {r}")
    check_tensor(a, "a", torch.float32, (tp.n_src, f), dev)
    check_tensor(b, "b", torch.float32, (tp.num_nodes, f), dev)
    if tp.bits:
        check_tensor(tp.a, "tiles", torch.uint8, (t, r // 8, c), dev)
    else:
        check_tensor(tp.a, "tiles", torch.int8, (t, r, c), dev)
    check_tensor(tp.tile_row, "tile_row", torch.int32, (t,), dev)
    check_tensor(tp.tile_col, "tile_col", torch.int32, (t,), dev)
    out = torch.empty((t, r, c), dtype=out_dtype, device=dev)
    if out.numel() == 0:
        return out
    err = load(NAME, SIGNATURES).sddmm_bcsr_f32(
        tp.a.data_ptr(), tp.tile_row.data_ptr(), tp.tile_col.data_ptr(), a.data_ptr(), b.data_ptr(),
        out.data_ptr(), t, r, c, tp.num_nodes, tp.n_src, f, int(tp.bits), OUT_DTYPES[out_dtype],
        *stream_args(dev),
    )
    if err != 0:
        raise RuntimeError(f"sddmm_bcsr kernel launch failed: cudaError {err}")
    launches += 1
    return out
