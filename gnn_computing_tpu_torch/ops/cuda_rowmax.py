"""Launch the B5 CUDA kernel (``csrc/rowmax_bcsr.cu``).

The kernel replaces ``gnn_computing_tpu/ops/pallas_bcsr.py:rowmax_bcsr_pallas``
for int8 count tiles, 1-bit tiles and float32 and bfloat16 value tiles (one
template on the A format).  It walks the plan's nonzero cells in chunks of
its work list (ops.cell_walk.walk_for: the list the cell walk's kernels
share, built at the plan's first launch and cached).
ops.cuda_build compiles it at first use and binds it with ctypes.

``launches`` counts kernel launches; ``bits_launches`` (1-bit tiles) and
``float_launches`` (float32 or bfloat16 tiles) count those among them.
Each rises only where the kernel is launched, so a run can show that its
path went through the kernel and the variant it names.
"""

from __future__ import annotations

import ctypes

import torch

from gnn_computing_tpu_torch.ops import cell_walk
from gnn_computing_tpu_torch.ops.cuda_build import TAGS, check_no_grad, check_plan, check_tensor, load, stream_args

NAME = "rowmax_bcsr"
SIGNATURES = {
    fn: [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    for fn in (f"rowmax_bcsr_{tag}_f32" for tag in TAGS)
}

launches = 0
bits_launches = 0
float_launches = 0


def rowmax_bcsr_cuda(tp, col_vals: torch.Tensor) -> torch.Tensor:
    """out[num_nodes]: per destination row, the max of ``col_vals`` [n_src]
    over tile cells whose value is nonzero, -inf where there is none.  Launches the
    kernel or raises; it never falls back."""
    global launches, bits_launches, float_launches
    check_no_grad(col_vals)
    dev = col_vals.device
    if dev.type != "cuda":
        raise ValueError(f"rowmax_bcsr_cuda takes CUDA tensors, got {dev}")
    check_tensor(col_vals, "col_vals", torch.float32, (tp.n_src,), dev)
    fmt = check_plan(tp, dev)
    out = torch.empty((tp.num_nodes,), dtype=torch.float32, device=dev)
    if tp.num_nodes == 0:
        return out
    walk = cell_walk.walk_for(tp)
    err = getattr(load(NAME, SIGNATURES), f"rowmax_bcsr_{fmt}_f32")(
        tp.a.data_ptr(), tp.tile_col.data_ptr(), walk.work.data_ptr(), col_vals.data_ptr(), out.data_ptr(),
        walk.num_chunks, walk.num_multi, tp.num_row_tiles, tp.tile_rows, tp.tile_cols, tp.num_nodes, tp.n_src,
        *stream_args(dev),
    )
    if err != 0:
        raise RuntimeError(f"rowmax_bcsr kernel launch failed: cudaError {err}")
    launches += 1
    bits_launches += fmt == "b1"
    float_launches += fmt in ("f32", "bf16")
    return out
