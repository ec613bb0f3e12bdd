"""GAT: dense transform -> 2-wide attention projection -> fused aggregation.

Port of ``gnn_computing_tpu/models/gat.py``: each
layer computes feat2 = h @ W and att = feat2 @ W_att (an [f, 2] projection
giving the dst and src attention halves; float32 matmuls, TF32 off — the JAX
code's Precision.HIGHEST), then ``Aggregator.run_gat`` (hybrid or gather)
or, over a bare AggregationPlan, ``ops.gat.gat_aggregate``.  There is no
nonlinearity between layers beyond the softmax-weighted aggregation, as in
the reference's our.py.  The benchmark model is the 3-layer
512 -> 128 -> 64 -> 32 stack.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch
from torch import nn

from gnn_computing_tpu_torch.device import resolve_device
from gnn_computing_tpu_torch.ops.gat import DEFAULT_SLOPE, gat_aggregate

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
    width is <= 64."""
    for p in params:
        kw = {}
        if fast:
            kw = dict(
                att_gather_dtype="f16_split2",
                h_gather_dtype="f16_split2" if p.w.shape[-1] <= 64 else None,
            )
        h = gat_layer(agg, h, p, relu_slope=relu_slope, stabilize=stabilize, dot_mode=dot_mode, **kw)
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
