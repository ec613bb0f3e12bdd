"""Launch the B2 CUDA kernel (``csrc/gat_bcsr.cu``).

The kernel replaces ``gnn_computing_tpu/ops/pallas_bcsr.py:gat_bcsr_pallas``
in mode 'maxdot' for int8 count tiles, 1-bit tiles and float32 and bfloat16
value tiles (one template on the A format), scoring each nonzero cell from
(ad, M) per destination and as per source.  ops.cuda_build compiles it at
first use and binds it with ctypes.

``launches`` counts kernel launches; ``bits_launches`` (1-bit tiles) and
``float_launches`` (float32 or bfloat16 tiles) count those among them.
Each rises only where the kernel is launched, so a run can show that its
main path went through the kernel and the variant it names.
"""

from __future__ import annotations

import ctypes

import torch

from gnn_computing_tpu_torch.ops.cuda_build import TAGS, check_no_grad, check_plan, check_tensor, load, stream_args

NAME = "gat_bcsr"
SIGNATURES = {
    fn: [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    for fn in (f"gat_bcsr_{tag}_f32" for tag in TAGS)
}

launches = 0
bits_launches = 0
float_launches = 0


def gat_bcsr_cuda(tp, h: torch.Tensor, dm: torch.Tensor, asrc: torch.Tensor, relu_slope: float):
    """(num [num_nodes, f], den [num_nodes]) over the plan's tiles, each cell
    scored from ``dm`` [num_nodes, 2] = (ad, row shift) and ``asrc``
    [n_src] (see ops.bcsr_gat._score_terms).  Launches the kernel or raises;
    it never falls back."""
    global launches, bits_launches, float_launches
    check_no_grad(h, dm, asrc)
    dev = h.device
    if dev.type != "cuda":
        raise ValueError(f"gat_bcsr_cuda takes CUDA tensors, got {dev}")
    if h.dim() != 2:
        raise ValueError(f"h must be [n_src, f], got {tuple(h.shape)}")
    f = h.shape[1]
    check_tensor(h, "h", torch.float32, (tp.n_src, f), dev)
    check_tensor(dm, "dm", torch.float32, (tp.num_nodes, 2), dev)
    check_tensor(asrc, "asrc", torch.float32, (tp.n_src,), dev)
    fmt = check_plan(tp, dev)
    num = torch.empty((tp.num_nodes, f), dtype=torch.float32, device=dev)
    den = torch.empty((tp.num_nodes,), dtype=torch.float32, device=dev)
    if tp.num_nodes == 0:
        return num, den
    err = getattr(load(NAME, SIGNATURES), f"gat_bcsr_{fmt}_f32")(
        tp.a.data_ptr(), tp.tile_col.data_ptr(), tp.run_start.data_ptr(),
        h.data_ptr(), dm.data_ptr(), asrc.data_ptr(), num.data_ptr(), den.data_ptr(),
        tp.num_row_tiles, tp.tile_rows, tp.tile_cols, tp.num_nodes, tp.n_src, f, float(relu_slope),
        *stream_args(dev),
    )
    if err != 0:
        raise RuntimeError(f"gat_bcsr kernel launch failed: cudaError {err}")
    launches += 1
    bits_launches += fmt == "b1"
    float_launches += fmt in ("f32", "bf16")
    return num, den
