"""Launch the GAT backward CUDA kernels B3 (``csrc/gat_bwd_dad.cu``) and B4
(``csrc/gat_bwd_dh_das.cu``).

They replace ``gnn_computing_tpu/ops/pallas_bcsr.py:gat_bwd_dad_pallas`` and
``gat_bwd_dh_das_pallas`` for int8 count tiles, 1-bit tiles and float32 and
bfloat16 value tiles (each one template on the A format), scoring each
nonzero cell from (ad, M) per destination and as per source as the forward
does.  Both walk the plan's nonzero cells in chunks of its work list
(ops.cell_walk: the list B1 and B2 walk over the same plan; B4's is the
transposed plan's, the one B1's backward walks), as B2 does, into num and
den scratch allocated here, and form each row's dot from them.
ops.cuda_build compiles each at first use and binds it with ctypes.

``dad_launches`` and ``dh_das_launches`` count kernel launches (one per
wrapper call); ``dad_bits_launches`` / ``dh_das_bits_launches`` (1-bit
tiles) and ``dad_float_launches`` / ``dh_das_float_launches`` (float32 or
bfloat16 tiles) count those among them.  Each rises only where its kernel
is launched, so a run can show that its path went through the kernels and
the variant it names.
"""

from __future__ import annotations

import ctypes

import torch

from gnn_computing_tpu_torch.ops.cell_walk import walk_args
from gnn_computing_tpu_torch.ops.cuda_build import TAGS, check_no_grad, check_plan, check_tensor, load, stream_args

DAD = "gat_bwd_dad"
DH_DAS = "gat_bwd_dh_das"
_P, _I = ctypes.c_void_p, ctypes.c_int
DAD_SIGNATURES = {f"gat_bwd_dad_{fmt}_f32": [_P] * 12 + [_I] * 8 + [ctypes.c_float, _I, _P] for fmt in TAGS}
DH_DAS_SIGNATURES = {
    f"gat_bwd_dh_das_{fmt}_f32": [_P] * 12 + [_I] * 8 + [ctypes.c_float, _I, _P] for fmt in TAGS
}

dad_launches = 0
dh_das_launches = 0
dad_bits_launches = 0
dh_das_bits_launches = 0
dad_float_launches = 0
dh_das_float_launches = 0


def _check_inputs(name, tp, h, gbar, c, dm, asrc, rows_h, rows_gbar):
    """Device, dtype, shape and contiguity of the backward's inputs: h has
    ``rows_h`` rows, gbar, c and dm ``rows_gbar`` (the forward's
    destinations), asrc ``rows_h`` (its sources).  Returns (device, f, the
    A format's entry-point tag)."""
    check_no_grad(h, gbar, c, dm, asrc)
    dev = h.device
    if dev.type != "cuda":
        raise ValueError(f"{name} takes CUDA tensors, got {dev}")
    if h.dim() != 2:
        raise ValueError(f"h must be 2-D, got {tuple(h.shape)}")
    f = h.shape[1]
    check_tensor(h, "h", torch.float32, (rows_h, f), dev)
    check_tensor(gbar, "gbar", torch.float32, (rows_gbar, f), dev)
    check_tensor(c, "c", torch.float32, (rows_gbar,), dev)
    check_tensor(dm, "dm", torch.float32, (rows_gbar, 2), dev)
    check_tensor(asrc, "asrc", torch.float32, (rows_h,), dev)
    return dev, f, check_plan(tp, dev)


def gat_bwd_dad_cuda(tp, h, gbar, c, dm, asrc, relu_slope: float) -> torch.Tensor:
    """d_att_dst [num_nodes] over the forward plan ``tp`` from h [n_src, f],
    gbar [num_nodes, f], c [num_nodes], dm [num_nodes, 2] and asrc [n_src]
    (see ops.bcsr_gat._score_terms).  Launches the kernel or raises; it never
    falls back."""
    global dad_launches, dad_bits_launches, dad_float_launches
    dev, f, fmt = _check_inputs("gat_bwd_dad_cuda", tp, h, gbar, c, dm, asrc, tp.n_src, tp.num_nodes)
    out = torch.empty((tp.num_nodes,), dtype=torch.float32, device=dev)
    if tp.num_nodes == 0:
        return out
    num = torch.empty((tp.num_nodes, f), dtype=torch.float32, device=dev)
    den = torch.empty((tp.num_nodes,), dtype=torch.float32, device=dev)
    scratch, work, scr, num_chunks, num_multi = walk_args(tp, f, dev, nb=1, den=True)
    err = getattr(load(DAD, DAD_SIGNATURES), f"gat_bwd_dad_{fmt}_f32")(
        tp.a.data_ptr(), tp.tile_col.data_ptr(), work, h.data_ptr(), gbar.data_ptr(), c.data_ptr(),
        dm.data_ptr(), asrc.data_ptr(), num.data_ptr(), den.data_ptr(), scr, out.data_ptr(), num_chunks, num_multi,
        tp.num_row_tiles, tp.tile_rows, tp.tile_cols, tp.num_nodes, tp.n_src, f, float(relu_slope),
        *stream_args(dev),
    )
    if err != 0:
        raise RuntimeError(f"gat_bwd_dad kernel launch failed: cudaError {err}")
    dad_launches += 1
    dad_bits_launches += fmt == "b1"
    dad_float_launches += fmt in ("f32", "bf16")
    return out


def gat_bwd_dh_das_cuda(tp_t, h, gbar, c, dm, asrc, relu_slope: float):
    """(dh [num_nodes, f], d_att_src [num_nodes]) over the transposed plan
    ``tp_t`` (rows: the forward's sources) from h [num_nodes, f], gbar
    [n_src, f], c [n_src], dm [n_src, 2] and asrc [num_nodes].  One
    launch (the walk, its finish pass and the row dot) computes both.
    Launches the kernel or raises; it never falls back."""
    global dh_das_launches, dh_das_bits_launches, dh_das_float_launches
    dev, f, fmt = _check_inputs("gat_bwd_dh_das_cuda", tp_t, h, gbar, c, dm, asrc, tp_t.num_nodes, tp_t.n_src)
    n = tp_t.num_nodes
    dh = torch.empty((n, f), dtype=torch.float32, device=dev)
    d_as = torch.empty((n,), dtype=torch.float32, device=dev)
    if n == 0:
        return dh, d_as
    # (ad, M, c, 0) per destination: one 16-byte load a cell
    cols = torch.cat([dm, c[:, None], torch.zeros_like(c)[:, None]], dim=1)
    num1 = torch.empty((n, f), dtype=torch.float32, device=dev)
    den = torch.empty((n,), dtype=torch.float32, device=dev)
    scratch, work, scr, num_chunks, num_multi = walk_args(tp_t, f, dev, nb=2, den=True)
    err = getattr(load(DH_DAS, DH_DAS_SIGNATURES), f"gat_bwd_dh_das_{fmt}_f32")(
        tp_t.a.data_ptr(), tp_t.tile_col.data_ptr(), work, h.data_ptr(), gbar.data_ptr(), cols.data_ptr(),
        asrc.data_ptr(), dh.data_ptr(), num1.data_ptr(), den.data_ptr(), scr, d_as.data_ptr(), num_chunks,
        num_multi, tp_t.num_row_tiles, tp_t.tile_rows, tp_t.tile_cols, n, tp_t.n_src, f, float(relu_slope),
        *stream_args(dev),
    )
    if err != 0:
        raise RuntimeError(f"gat_bwd_dh_das kernel launch failed: cudaError {err}")
    dh_das_launches += 1
    dh_das_bits_launches += fmt == "b1"
    dh_das_float_launches += fmt in ("f32", "bf16")
    return dh, d_as
