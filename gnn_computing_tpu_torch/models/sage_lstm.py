"""GraphSAGE-LSTM model.

Port of ``gnn_computing_tpu/models/sage_lstm.py``: each vertex's fixed-k
sampled neighbor sequence is aggregated by an LSTM (ops/lstm.py), and the
layer combines it with a self branch, relu([x @ Ws ; h_agg] @ Wo).  The
benchmark contract is the reference's: feature length 32 and k = 16
sampled neighbors, timing the LSTM aggregation alone
(``sage_lstm_aggregate_bench``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from gnn_computing_tpu_torch.device import resolve_device
from gnn_computing_tpu_torch.ops.lstm import LSTMParams, _uniform, init_lstm_params, lstm_aggregate

BENCH_FEATURE_LEN = 32  # the reference's --feature-len 32
BENCH_NUM_NEIGHBORS = 16  # --nei 16 / <dset>_sample_16


class SageLSTMParams(NamedTuple):
    lstm: LSTMParams
    w_self: torch.Tensor  # [f_in, f] self branch
    w_out: torch.Tensor  # [2f, f_out] combine


def init_sage_lstm_params(
    f_in: int, f: int, f_out: int, generator: torch.Generator, device="cuda"
) -> SageLSTMParams:
    """The LSTM's params (init_lstm_params), then U(-1/sqrt(f_in),
    1/sqrt(f_in)) ``w_self`` and U(-1/sqrt(2f), 1/sqrt(2f)) ``w_out``, the
    JAX package's bounds, all from ``generator``."""
    dev = resolve_device(device)
    return SageLSTMParams(
        lstm=init_lstm_params(f_in, f, generator, device=dev),
        w_self=_uniform((f_in, f), (1.0 / f_in) ** 0.5, generator, dev),
        w_out=_uniform((2 * f, f_out), (1.0 / (2 * f)) ** 0.5, generator, dev),
    )


def sage_lstm_layer(
    params: SageLSTMParams, x: torch.Tensor, nbr: torch.Tensor, strategy: str = "redundancy_bypass"
) -> torch.Tensor:
    """h_agg = the LSTM over the neighbor sequence; out = relu([x @ Ws ;
    h_agg] @ Wo) (float32 matmuls, TF32 off)."""
    h_nbr = lstm_aggregate(params.lstm, x, nbr, strategy=strategy)
    return torch.relu(torch.cat([x @ params.w_self, h_nbr], dim=-1) @ params.w_out)


def sage_lstm_aggregate_bench(
    params: LSTMParams, x: torch.Tensor, nbr: torch.Tensor, strategy: str = "redundancy_bypass"
) -> torch.Tensor:
    """The computation the reference times: the LSTM aggregation alone."""
    return lstm_aggregate(params, x, nbr, strategy=strategy)


class SageLSTM(nn.Module):
    """One SAGE-LSTM layer holding the LSTM's ``wx``, ``wh``, ``b`` and the
    ``w_self`` and ``w_out`` weights as parameters."""

    def __init__(self, params: SageLSTMParams, device="cuda"):
        super().__init__()
        dev = resolve_device(device)

        def param(a):  # a copy: the module never shares the caller's memory
            t = a.detach() if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a, np.float32))
            return nn.Parameter(t.to(dev, torch.float32, copy=True))

        self.wx, self.wh, self.b = (param(a) for a in params.lstm)
        self.w_self = param(params.w_self)
        self.w_out = param(params.w_out)

    def params(self) -> SageLSTMParams:
        return SageLSTMParams(LSTMParams(self.wx, self.wh, self.b), self.w_self, self.w_out)

    def forward(self, x: torch.Tensor, nbr: torch.Tensor, strategy: str = "redundancy_bypass") -> torch.Tensor:
        return sage_lstm_layer(self.params(), x, nbr, strategy=strategy)
