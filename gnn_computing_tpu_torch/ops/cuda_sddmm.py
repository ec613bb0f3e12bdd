"""Launch the B6 CUDA kernel (``csrc/sddmm_bcsr.cu``).

The kernel replaces ``gnn_computing_tpu/ops/bcsr_sddmm.py:sddmm_bcsr_pallas``
for int8 count tiles, 1-bit tiles and float32 and bfloat16 value tiles (one
template on the A format), float32 operands and a float32 or bfloat16
output.  ops.cuda_build compiles it at first use and binds it with ctypes.

``launches`` counts kernel launches; ``float_launches`` (float32 or
bfloat16 tiles) counts those among them.  Each rises only where the kernel
is launched, so a run can show that its path went through the kernel and
its float variants.
"""

from __future__ import annotations

import ctypes

import torch

from gnn_computing_tpu_torch.ops.cuda_build import FORMAT_TAGS, TAGS, check_no_grad, check_tensor, load, stream_args

NAME = "sddmm_bcsr"
SIGNATURES = {f"sddmm_bcsr_{tag}_f32": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p] for tag in TAGS}
OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TILE_DTYPES = {"i8": torch.int8, "f32": torch.float32, "bf16": torch.bfloat16}

launches = 0
float_launches = 0


def sddmm_bcsr_cuda(tp, a: torch.Tensor, b: torch.Tensor, out_dtype=torch.bfloat16) -> torch.Tensor:
    """Per-cell dots [num_tiles, R, C] in ``out_dtype``: <b[row], a[col]>
    where the cell holds an edge (its value > 0), +0 elsewhere.  Launches
    the kernel or raises; it never falls back."""
    global launches, float_launches
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
    tag = FORMAT_TAGS[tp.format]
    check_tensor(a, "a", torch.float32, (tp.n_src, f), dev)
    check_tensor(b, "b", torch.float32, (tp.num_nodes, f), dev)
    if tp.bits:
        if r % 8:
            raise ValueError(f"1-bit tiles need R % 8 == 0, got R = {r}")
        check_tensor(tp.a, "tiles", torch.uint8, (t, r // 8, c), dev)
    else:
        check_tensor(tp.a, "tiles", TILE_DTYPES[tag], (t, r, c), dev)
    check_tensor(tp.tile_row, "tile_row", torch.int32, (t,), dev)
    check_tensor(tp.tile_col, "tile_col", torch.int32, (t,), dev)
    out = torch.empty((t, r, c), dtype=out_dtype, device=dev)
    if out.numel() == 0:
        return out
    err = getattr(load(NAME, SIGNATURES), f"sddmm_bcsr_{tag}_f32")(
        tp.a.data_ptr(), tp.tile_row.data_ptr(), tp.tile_col.data_ptr(), a.data_ptr(), b.data_ptr(),
        out.data_ptr(), t, r, c, tp.num_nodes, tp.n_src, f, OUT_DTYPES[out_dtype], *stream_args(dev),
    )
    if err != 0:
        raise RuntimeError(f"sddmm_bcsr kernel launch failed: cudaError {err}")
    launches += 1
    float_launches += tag in ("f32", "bf16")
    return out
