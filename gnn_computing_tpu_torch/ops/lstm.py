"""LSTM neighbor aggregation (GraphSAGE-LSTM), plain PyTorch.

Port of ``gnn_computing_tpu/ops/lstm.py``: aggregate each vertex's fixed-k
sampled neighbor sequence with an LSTM and return the final hidden state.
Three strategies compute the same function with different data movement:

  * ``redundancy_bypass`` — the x-side gate GEMM runs once over all source
    vertices; each step gathers the gate rows of every vertex's t-th
    neighbor (no per-edge feature tensor).
  * ``sparse_fetch`` — each step gathers raw feature rows and runs the x
    GEMM again.
  * ``materialize`` — the [n, k, f_in] neighbor features are gathered up
    front.

Gate layout is the JAX package's: four slabs ``[i, f, o, c~]`` along the
last axis of ``wx`` [f_in, 4f], ``wh`` [f, 4f] and ``b`` [4f] (not
``torch.nn.LSTM``'s ``[i, f, g, o]`` on [4f, f_in]).  The JAX package
leaves the step to XLA (no Pallas kernel); so does the port: each step is
an ``index_select``, a float32 matmul (TF32 off, JAX's
``Precision.HIGHEST``) and the elementwise gate math, and autograd
supplies the gradient.  ``torch.nn.LSTM`` cannot gather a step's input by
index, and is not used.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from gnn_computing_tpu_torch.device import resolve_device

STRATEGIES = ("redundancy_bypass", "sparse_fetch", "materialize")


class LSTMParams(NamedTuple):
    wx: torch.Tensor  # [f_in, 4f]
    wh: torch.Tensor  # [f, 4f]
    b: torch.Tensor  # [4f]


def _uniform(shape, bound: float, generator: torch.Generator, dev: torch.device) -> torch.Tensor:
    """U(-bound, bound) float32, drawn on the generator's device."""
    x = torch.empty(shape, dtype=torch.float32, device=generator.device)
    return x.uniform_(-bound, bound, generator=generator).to(dev)


def init_lstm_params(f_in: int, f: int, generator: torch.Generator, device="cuda") -> LSTMParams:
    """U(-1/sqrt(f_in), 1/sqrt(f_in)) ``wx``, U(-1/sqrt(f), 1/sqrt(f))
    ``wh`` (the JAX package's bounds) and a zero bias."""
    dev = resolve_device(device)
    return LSTMParams(
        wx=_uniform((f_in, 4 * f), (1.0 / f_in) ** 0.5, generator, dev),
        wh=_uniform((f, 4 * f), (1.0 / f) ** 0.5, generator, dev),
        b=torch.zeros(4 * f, dtype=torch.float32, device=dev),
    )


def lstm_cell(
    gx: torch.Tensor, gh: torch.Tensor, b: torch.Tensor, h: torch.Tensor, c: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gate step: z = gx + gh + b split into [i, f, o, c~];
    c' = sigmoid(f) c + sigmoid(i) tanh(c~), h' = sigmoid(o) tanh(c')."""
    f = h.shape[-1]
    z = gx + gh + b
    i = torch.sigmoid(z[..., 0 * f : 1 * f])
    fg = torch.sigmoid(z[..., 1 * f : 2 * f])
    o = torch.sigmoid(z[..., 2 * f : 3 * f])
    ct = torch.tanh(z[..., 3 * f : 4 * f])
    c = fg * c + i * ct
    return o * torch.tanh(c), c


def lstm_aggregate(
    params: LSTMParams,
    x: torch.Tensor,
    nbr: torch.Tensor,
    strategy: str = "redundancy_bypass",
    gate_gather_dtype=None,
    unroll: int = 1,
) -> torch.Tensor:
    """Run the k-step neighbor LSTM over ``x`` [n_src, f_in] and the
    neighbor matrix ``nbr`` [n, k] (integer, on x's device); returns the
    final hidden state [n, f] (zeros for k = 0).

    gate_gather_dtype (redundancy_bypass only): None or a floating torch
    dtype (torch.float16 / torch.bfloat16 for jnp.float16 / jnp.bfloat16).
    The gate rows x @ wx are rounded once to it, the rounded rows gathered
    and cast back to x's dtype, as the JAX package does.

    unroll: the JAX scan's unroll factor; eager PyTorch has no counterpart,
    so it is accepted for the same signature and has no effect."""
    del unroll
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; one of {STRATEGIES}")
    if gate_gather_dtype is not None and not (
        isinstance(gate_gather_dtype, torch.dtype) and gate_gather_dtype.is_floating_point
    ):
        raise ValueError(f"gate_gather_dtype must be None or a torch floating dtype, got {gate_gather_dtype!r}")
    n, k = nbr.shape
    f = params.wh.shape[0]
    h = torch.zeros((n, f), dtype=x.dtype, device=x.device)
    c = torch.zeros_like(h)
    steps = nbr.long().t().contiguous()  # [k, n]: step t's neighbors in a row

    if strategy == "redundancy_bypass":
        gx_all = x @ params.wx  # the one gate GEMM
        if gate_gather_dtype is not None:
            gx_all = gx_all.to(gate_gather_dtype)
        xg = lambda t: gx_all.index_select(0, steps[t]).to(x.dtype)  # noqa: E731
    elif strategy == "sparse_fetch":
        xg = lambda t: x.index_select(0, steps[t]) @ params.wx  # noqa: E731
    else:
        xs = x.index_select(0, nbr.reshape(-1).long()).reshape(n, k, x.shape[1])
        xg = lambda t: xs[:, t] @ params.wx  # noqa: E731
    for t in range(k):
        h, c = lstm_cell(xg(t), h @ params.wh, params.b, h, c)
    return h
