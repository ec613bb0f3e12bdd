"""GCN: dense transform -> aggregation -> ReLU.

Port of ``gnn_computing_tpu/models/gcn.py``: each layer transforms first (a
float32 matmul, TF32 off — the JAX code's Precision.HIGHEST), aggregates
over the scheduled graph, then applies ReLU; ``LayerOpts.aggregate_first``
aggregates first and transforms after.  The graph is a hybrid Aggregator
(with the layer's numeric modes), a gather Aggregator or a bare
AggregationPlan (ops.spmm.spmm); the gather paths take no numeric mode,
as in the JAX package.  The benchmark model is the 3-layer
512 -> 128 -> 64 -> 32 stack.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from gnn_computing_tpu_torch.device import resolve_device
from gnn_computing_tpu_torch.ops.spmm import spmm

BENCH_DIMS = (512, 128, 64, 32)


@dataclasses.dataclass(frozen=True)
class LayerOpts:
    """Per-layer numeric modes for hybrid aggregators (defaults are exact).

    aggregate_first: relu(agg(h) @ W) instead of relu(agg(h @ W)), equal by
      the aggregation's linearity; the aggregation then runs on the previous
      layer's (nonnegative, post-ReLU) activations at the layer's input
      width, so 16-bit operand modes do not cancel there.
    residual_gather_dtype: see ops.spmm.weighted_task_sums.
    tile_h_mode: see ops.bcsr.round_h.
    """

    aggregate_first: bool = False
    residual_gather_dtype: object = None
    tile_h_mode: str = "auto"


def fast_layer_opts(dims: Sequence[int] = BENCH_DIMS) -> list:
    """The main path's modes: 'split' tiles on every layer; 'f16_split2'
    residual rows where the aggregation width is <= 64, float32 rows
    above it."""
    return [
        LayerOpts(
            residual_gather_dtype="f16_split2" if dims[i + 1] <= 64 else None,
            tile_h_mode="split",
        )
        for i in range(len(dims) - 1)
    ]


def gcn_layer(
    agg, h: torch.Tensor, w: torch.Tensor, opts: Optional[LayerOpts] = None, *, val=None,
    activation=torch.relu, strategy: str = "auto", residual_gather_dtype=None,
) -> torch.Tensor:
    """activation(aggregate(h @ w)), or activation(aggregate(h) @ w) with
    ``opts.aggregate_first``.  ``agg`` a hybrid Aggregator (run with the
    opts' numeric modes), a gather Aggregator (its ``run``) or an
    AggregationPlan (spmm with the slot values ``val``).  Without ``opts``
    the layer takes ``residual_gather_dtype``, which only a hybrid
    aggregator uses."""
    if opts is None:
        opts = LayerOpts(residual_gather_dtype=residual_gather_dtype)

    def aggregate(x):
        if hasattr(agg, "run"):  # an Aggregator without tiles ignores the modes
            return agg.run(x, opts.residual_gather_dtype, opts.tile_h_mode, strategy=strategy)
        return spmm(agg, x, val=val, strategy=strategy)

    z = aggregate(h) @ w if opts.aggregate_first else aggregate(h @ w)
    return activation(z) if activation is not None else z


def gcn_forward(agg, params: Sequence[torch.Tensor], h: torch.Tensor, strategy: str = "auto") -> torch.Tensor:
    """Multi-layer GCN forward, ReLU between layers and the last layer
    linear (logits)."""
    for i, w in enumerate(params):
        h = gcn_layer(agg, h, w, activation=torch.relu if i < len(params) - 1 else None, strategy=strategy)
    return h


def gcn_forward_bench(
    agg, params: Sequence[torch.Tensor], h: torch.Tensor,
    layer_opts: Optional[Sequence[LayerOpts]] = None, *, strategy: str = "auto", residual_gather_dtype=None,
) -> torch.Tensor:
    """The benchmark forward: ReLU after every layer.  ``agg`` may be one
    aggregator or plan, or one per layer."""
    aggs = list(agg) if isinstance(agg, (list, tuple)) else [agg] * len(params)
    for i, w in enumerate(params):
        h = gcn_layer(
            aggs[i], h, w, None if layer_opts is None else layer_opts[i], strategy=strategy,
            residual_gather_dtype=residual_gather_dtype,
        )
    return h


class GCN(nn.Module):
    """The benchmark GCN: one weight per layer, ReLU after every layer."""

    def __init__(self, weights: Sequence[np.ndarray], device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.weights = nn.ParameterList(
            nn.Parameter(torch.as_tensor(np.asarray(w, np.float32)).to(dev)) for w in weights
        )

    def forward(self, agg, h: torch.Tensor, layer_opts: Optional[Sequence[LayerOpts]] = None) -> torch.Tensor:
        return gcn_forward_bench(agg, list(self.weights), h, layer_opts)


def glorot_weights(dims: Sequence[int] = BENCH_DIMS, seed: int = 0) -> list:
    """Glorot-scaled normal float32 weights from a numpy seed (the JAX
    package draws its own from jax.random; tests and the chip check hand
    these to both packages)."""
    rng = np.random.default_rng(seed)
    return [
        (rng.standard_normal((dims[i], dims[i + 1])) * np.sqrt(2.0 / (dims[i] + dims[i + 1]))).astype(np.float32)
        for i in range(len(dims) - 1)
    ]


def init_gcn_params(dims: Sequence[int], generator: torch.Generator, device="cuda") -> list:
    """Glorot-scaled normal float32 weights, one leaf tensor per layer on
    ``device``, drawn from the seeded ``generator`` on its own device (the
    JAX package's ``init_gcn_params`` draws from a jax.random key)."""
    dev = resolve_device(device)
    return [
        (torch.randn((dims[i], dims[i + 1]), generator=generator, device=generator.device)
         * (2.0 / (dims[i] + dims[i + 1])) ** 0.5).to(dev).requires_grad_(True)
        for i in range(len(dims) - 1)
    ]
