"""GAT: dense transform -> 2-wide attention projection -> fused aggregation.

Port of ``gnn_computing_tpu/models/gat.py``: each
layer computes feat2 = h @ W and att = feat2 @ W_att (an [f, 2] projection
giving the dst and src attention halves; float32 matmuls, TF32 off — the JAX
code's Precision.HIGHEST), then ``Aggregator.run_gat`` (hybrid or gather)
or, over a bare AggregationPlan, ``ops.gat.gat_aggregate``.  There is no
nonlinearity between layers beyond the softmax-weighted aggregation, as in
the reference's our.py.  The benchmark model is the 3-layer
512 -> 128 -> 64 -> 32 stack.

The published multi-head GAT (Velickovic et al., ICLR 2018, section 3.3)
is ``gat_heads_forward``: each layer projects once to [n, heads * f_out]
(``GATHeadsLayerParams``), each head attends over its own slice with its
own attention halves through ``Aggregator.run_gat``, hidden layers
concatenate the heads, add their input where the layer has a skip and
apply ELU, and the output layer averages its heads.  ``gat_layer``'s
[heads, f_out, 2] attention weight is the JAX package's form instead: every
head attends over one shared feat2.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gnn_computing_tpu_torch.device import resolve_device
from gnn_computing_tpu_torch.ops.gat import DEFAULT_SLOPE, gat_aggregate
from gnn_computing_tpu_torch.utils.profiling import count, span

BENCH_DIMS = (512, 128, 64, 32)


class GATLayerParams(NamedTuple):
    w: torch.Tensor  # [f_in, f_out]
    w_att: torch.Tensor  # [f_out, 2] (dst half, src half) or [heads, f_out, 2]


def gat_layer(
    agg,
    h: torch.Tensor,
    p: GATLayerParams,
    relu_slope: float = DEFAULT_SLOPE,
    stabilize=False,
    att_gather_dtype=None,
    h_gather_dtype=None,
    dot_mode: str = "exact",
) -> torch.Tensor:
    """One GAT layer over an Aggregator or an AggregationPlan (whose
    gat_aggregate takes no gather mode or dot mode, as in the JAX package).
    With a [heads, f_out, 2] attention weight every head attends on its own
    over the shared feat2, and the heads' outputs lie side by side:
    [n, heads * f_out]."""
    feat2 = h @ p.w

    def aggregate(w_att):
        if not hasattr(agg, "run_gat"):
            return gat_aggregate(agg, feat2, feat2 @ w_att, relu_slope=relu_slope, stabilize=stabilize)
        return agg.run_gat(
            feat2, feat2 @ w_att, relu_slope=relu_slope, stabilize=stabilize,
            att_gather_dtype=att_gather_dtype, h_gather_dtype=h_gather_dtype, dot_mode=dot_mode,
        )

    if p.w_att.dim() == 2:
        return aggregate(p.w_att)
    heads = torch.stack([aggregate(w) for w in p.w_att], dim=1)  # [n, H, f_out]
    return heads.reshape(heads.shape[0], -1)


def gat_forward(
    agg,
    params: Sequence[GATLayerParams],
    h: torch.Tensor,
    relu_slope: float = DEFAULT_SLOPE,
    stabilize=False,
    fast: bool = False,
    dot_mode: str = "exact",
) -> torch.Tensor:
    """The benchmark forward.  fast=True takes the residual gather modes of
    the JAX package's main path, exact to 21 bits: the att src half through
    the [n, 2] f16_split2 table, h through f16_split2 where the layer's
    width is <= 64.  Recorded as the span ``gnn.forward``."""
    with span("gnn.forward"):
        for p in params:
            kw = {}
            if fast:
                kw = dict(
                    att_gather_dtype="f16_split2",
                    h_gather_dtype="f16_split2" if p.w.shape[-1] <= 64 else None,
                )
            h = gat_layer(agg, h, p, relu_slope=relu_slope, stabilize=stabilize, dot_mode=dot_mode, **kw)
        return h


class GATHeadsLayerParams(NamedTuple):
    w: torch.Tensor  # [f_in, heads * f_out]: every head's projection side by side
    a: torch.Tensor  # [heads, f_out, 2]: each head's (dst half, src half)


def gat_heads_layer(
    agg,
    h: torch.Tensor,
    p: GATHeadsLayerParams,
    output: bool,
    skip: bool = False,
    layer: int = 0,
    relu_slope: float = DEFAULT_SLOPE,
    stabilize=False,
) -> torch.Tensor:
    """One published multi-head GAT layer over a hybrid or gather
    Aggregator: z = h @ W in one GEMM, then head k aggregates its slice
    z[:, k f_out:(k + 1) f_out] with att_k = z_k @ a_k.  A hidden layer
    (``output`` False) concatenates the heads ([n, heads * f_out]), adds
    ``h`` where ``skip`` (an identity skip: the widths must agree) and
    applies ELU; the output layer averages the heads ([n, f_out]).

    The kernels read a head's rows contiguously, so the heads' slices are
    copied once into [heads, n, f_out] (counter ``gat.head_copy_bytes``).
    Spans: ``gnn.gat.head`` (``layer``, ``head``, ``f``) around each head's
    aggregation, ``gnn.gat.merge`` around the merge, skip and ELU; counter
    ``gat.heads``.  The heads run the exact score and float32 residual
    rows: no gather mode of ``gat_forward``'s ``fast``."""
    heads, f = p.a.shape[0], p.a.shape[1]
    n = h.shape[0]
    z = h @ p.w
    zh = z.view(n, heads, f).transpose(0, 1).contiguous()
    count("gat.heads", heads)
    count("gat.head_copy_bytes", zh.numel() * zh.element_size())
    att = torch.bmm(zh, p.a)  # [heads, n, 2]
    outs = []
    for k, (zk, ak) in enumerate(zip(zh.unbind(0), att.unbind(0))):
        with span("gnn.gat.head", layer=layer, head=k, f=f):
            outs.append(agg.run_gat(zk, ak, relu_slope=relu_slope, stabilize=stabilize))
    with span("gnn.gat.merge"):
        if output:
            return torch.stack(outs).mean(dim=0)
        out = torch.cat(outs, dim=1)
        if skip:
            out = out + h
        return F.elu(out)


def gat_heads_forward(
    agg,
    params: Sequence[GATHeadsLayerParams],
    h: torch.Tensor,
    skip: Sequence[bool],
    relu_slope: float = DEFAULT_SLOPE,
    stabilize=False,
) -> torch.Tensor:
    """The published multi-head GAT: ``gat_heads_layer`` per layer, every
    layer but the last hidden, ``skip[i]`` the identity skip of layer i.
    Recorded as the span ``gnn.forward``."""
    if len(skip) != len(params):
        raise ValueError(f"one skip flag a layer: {len(skip)} for {len(params)} layers")
    with span("gnn.forward"):
        for i, p in enumerate(params):
            h = gat_heads_layer(agg, h, p, output=i == len(params) - 1, skip=skip[i], layer=i,
                                relu_slope=relu_slope, stabilize=stabilize)
        return h


class GAT(nn.Module):
    """The benchmark GAT: a transform and an attention weight per layer."""

    def __init__(self, params: Sequence[tuple], device="cuda"):
        super().__init__()
        dev = resolve_device(device)

        def param(x):
            return nn.Parameter(torch.from_numpy(np.array(x, np.float32)).to(dev))

        self.w = nn.ParameterList(param(w) for w, _ in params)
        self.w_att = nn.ParameterList(param(w_att) for _, w_att in params)

    def layer_params(self) -> list:
        return [GATLayerParams(w, a) for w, a in zip(self.w, self.w_att)]

    def forward(
        self, agg, h: torch.Tensor, relu_slope: float = DEFAULT_SLOPE, stabilize=False,
        fast: bool = False, dot_mode: str = "exact",
    ) -> torch.Tensor:
        return gat_forward(agg, self.layer_params(), h, relu_slope, stabilize, fast, dot_mode)


def glorot_gat_weights(dims: Sequence[int] = BENCH_DIMS, seed: int = 0, heads: int = 1) -> list:
    """[(w, w_att)] float32 numpy weights from a numpy seed, normal with the
    Glorot scale sqrt(2 / (f_in + f_out)) of the JAX package's
    ``init_gat_params`` for both (which draws its own from jax.random; tests
    and the chip check hand these to both packages)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(len(dims) - 1):
        scale = np.sqrt(2.0 / (dims[i] + dims[i + 1]))
        w = (rng.standard_normal((dims[i], dims[i + 1])) * scale).astype(np.float32)
        att_shape = (dims[i + 1], 2) if heads == 1 else (heads, dims[i + 1], 2)
        w_att = (rng.standard_normal(att_shape) * scale).astype(np.float32)
        out.append((w, w_att))
    return out


def init_gat_params(
    dims: Sequence[int], generator: torch.Generator, device="cuda", heads: int = 1
) -> list:
    """[GATLayerParams] of Glorot-scaled normal float32 leaves on ``device``
    (w [f_in, f_out], w_att [f_out, 2] or [heads, f_out, 2], both at the
    scale sqrt(2 / (f_in + f_out))), drawn from the seeded ``generator`` on
    its own device (the JAX package's ``init_gat_params`` draws from a
    jax.random key)."""
    dev = resolve_device(device)
    out = []
    for i in range(len(dims) - 1):
        scale = (2.0 / (dims[i] + dims[i + 1])) ** 0.5
        att_shape = (dims[i + 1], 2) if heads == 1 else (heads, dims[i + 1], 2)
        w, w_att = (
            (torch.randn(shape, generator=generator, device=generator.device) * scale).to(dev).requires_grad_(True)
            for shape in ((dims[i], dims[i + 1]), att_shape)
        )
        out.append(GATLayerParams(w, w_att))
    return out
