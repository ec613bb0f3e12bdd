"""Launch the B2 CUDA kernels (``csrc/gat_bcsr.cu``,
``csrc/gat_bcsr_factored.cu``).

They replace ``gnn_computing_tpu/ops/pallas_bcsr.py:gat_bcsr_pallas`` for
int8 count tiles, 1-bit tiles and float32 and bfloat16 value tiles (one
template on the A format each): ``gat_bcsr_cuda`` its mode 'maxdot', which
scores each nonzero cell from (ad, M) per destination and as per source
(dot_mode 'exact' / 'split2', or 'default' with ``bf16_dot``), and
``gat_bcsr_factored_cuda`` its modes 'twodot' and 'merged' from per-node
factors (ops.bcsr_gat.factored_terms).  Both walk the plan's nonzero cells
in chunks of its work list (ops.cell_walk), as B1 does.  ops.cuda_build
compiles each at first use and binds it with ctypes.

``launches`` counts the maxdot kernel's launches; ``bits_launches`` (1-bit
tiles), ``float_launches`` (float32 or bfloat16 tiles) and
``default_launches`` (dot_mode 'default') count those among them.
``twodot_launches`` and ``merged_launches`` count the factored kernel's.
Each rises only where its kernel is launched, so a run can show that its
main path went through the kernel and the variant it names.
"""

from __future__ import annotations

import ctypes

import torch

from gnn_computing_tpu_torch.ops.cell_walk import walk_args
from gnn_computing_tpu_torch.ops.cuda_build import TAGS, check_no_grad, check_plan, check_tensor, load, stream_args

NAME = "gat_bcsr"
FACTORED_NAME = "gat_bcsr_factored"
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    f"gat_bcsr_{tag}_f32": [_P] * 9 + [_I] * 8 + [ctypes.c_float, _I, _I, _P] for tag in TAGS
}
FACTORED_SIGNATURES = {f"gat_bcsr_factored_{tag}_f32": [_P] * 10 + [_I] * 10 + [_P] for tag in TAGS}

launches = 0
bits_launches = 0
float_launches = 0
default_launches = 0
twodot_launches = 0
merged_launches = 0


def gat_bcsr_cuda(tp, h: torch.Tensor, dm: torch.Tensor, asrc: torch.Tensor, relu_slope: float,
                  bf16_dot: bool = False):
    """(num [num_nodes, f], den [num_nodes]) over the plan's tiles, each cell
    scored from ``dm`` [num_nodes, 2] = (ad, row shift) and ``asrc``
    [n_src] (see ops.bcsr_gat._score_terms); ``bf16_dot`` rounds the
    numerator's scores and h to bfloat16 (dot_mode 'default').  Launches
    the kernel or raises; it never falls back."""
    global launches, bits_launches, float_launches, default_launches
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
    scratch, work, scr, num_chunks, num_multi = walk_args(tp, f, dev, nb=1, den=True)
    err = getattr(load(NAME, SIGNATURES), f"gat_bcsr_{fmt}_f32")(
        tp.a.data_ptr(), tp.tile_col.data_ptr(), work, h.data_ptr(), dm.data_ptr(), asrc.data_ptr(),
        num.data_ptr(), den.data_ptr(), scr, num_chunks, num_multi, tp.num_row_tiles, tp.tile_rows, tp.tile_cols,
        tp.num_nodes, tp.n_src, f, float(relu_slope), int(bf16_dot), *stream_args(dev),
    )
    if err != 0:
        raise RuntimeError(f"gat_bcsr kernel launch failed: cudaError {err}")
    launches += 1
    bits_launches += fmt == "b1"
    float_launches += fmt in ("f32", "bf16")
    default_launches += bool(bf16_dot)
    return num, den


def gat_bcsr_factored_cuda(tp, mode: str, hv, rows: torch.Tensor, cols: torch.Tensor):
    """(num [num_nodes, f], den [num_nodes]) of mode 'twodot' or 'merged'
    over the plan's tiles from the per-node operands of
    ops.bcsr_gat.factored_terms: ``hv`` the [n_src, f] float32 operands
    (two for twodot, one for merged), ``rows`` [num_nodes, 4] = (ad, u1,
    u2, q) and ``cols`` [n_src, 4] = (as, v1, v2, r).  Rows the caller
    rescues may come out inf or NaN.  Launches the kernel or raises; it
    never falls back."""
    global twodot_launches, merged_launches
    if mode not in ("twodot", "merged"):
        raise ValueError(f"mode must be 'twodot' or 'merged', got {mode!r}")
    hv = tuple(hv)
    if len(hv) != (2 if mode == "twodot" else 1):
        raise ValueError(f"mode {mode!r} takes {2 if mode == 'twodot' else 1} hv operand(s), got {len(hv)}")
    check_no_grad(*hv, rows, cols)
    dev = rows.device
    if dev.type != "cuda":
        raise ValueError(f"gat_bcsr_factored_cuda takes CUDA tensors, got {dev}")
    if hv[0].dim() != 2:
        raise ValueError(f"hv must be [n_src, f], got {tuple(hv[0].shape)}")
    f = hv[0].shape[1]
    for i, x in enumerate(hv):
        check_tensor(x, f"hv{i + 1}", torch.float32, (tp.n_src, f), dev)
    check_tensor(rows, "rows", torch.float32, (tp.num_nodes, 4), dev)
    check_tensor(cols, "cols", torch.float32, (tp.n_src, 4), dev)
    fmt = check_plan(tp, dev)
    num = torch.empty((tp.num_nodes, f), dtype=torch.float32, device=dev)
    den = torch.empty((tp.num_nodes,), dtype=torch.float32, device=dev)
    if tp.num_nodes == 0:
        return num, den
    merged = mode == "merged"
    scratch, work, scr, num_chunks, num_multi = walk_args(tp, f, dev, nb=len(hv), den=True)
    err = getattr(load(FACTORED_NAME, FACTORED_SIGNATURES), f"gat_bcsr_factored_{fmt}_f32")(
        tp.a.data_ptr(), tp.tile_col.data_ptr(), work, hv[0].data_ptr(), None if merged else hv[1].data_ptr(),
        rows.data_ptr(), cols.data_ptr(), num.data_ptr(), den.data_ptr(), scr, num_chunks, num_multi,
        tp.num_row_tiles, tp.tile_rows, tp.tile_cols, tp.num_nodes, tp.n_src, f, int(merged), *stream_args(dev),
    )
    if err != 0:
        raise RuntimeError(f"gat_bcsr_factored kernel launch failed: cudaError {err}")
    if merged:
        merged_launches += 1
    else:
        twodot_launches += 1
    return num, den
