"""Carry weights from the JAX package into the port, so both compute the
same function (the JAX GCN's params are a list of [f_in, f_out] arrays; the
JAX GAT's a list of GATLayerParams(w, w_att); the JAX LSTM's
LSTMParams(wx, wh, b) and SAGE-LSTM's SageLSTMParams(lstm, w_self, w_out),
in the same [i, f, o, c~] gate layout as the port's), in memory or through
a checkpoint file of the JAX package's ``save_checkpoint``."""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from gnn_computing_tpu_torch.device import resolve_device
from gnn_computing_tpu_torch.models.gat import GAT
from gnn_computing_tpu_torch.models.gcn import GCN
from gnn_computing_tpu_torch.models.sage_lstm import SageLSTM, SageLSTMParams
from gnn_computing_tpu_torch.models.training import load_checkpoint
from gnn_computing_tpu_torch.ops.lstm import LSTMParams


def gcn_params_from_jax(params: Sequence[np.ndarray], device="cuda") -> GCN:
    """JAX GCN params (arrays convertible with np.asarray) -> GCN module."""
    return GCN([np.asarray(w, np.float32) for w in params], device=device)


def gat_params_from_jax(params: Sequence[tuple], device="cuda") -> GAT:
    """JAX GAT params, a sequence of (w, w_att) pairs such as
    GATLayerParams -> GAT module."""
    return GAT([(np.asarray(w, np.float32), np.asarray(a, np.float32)) for w, a in params], device=device)


def lstm_params_from_jax(params, device="cuda") -> LSTMParams:
    """JAX LSTMParams (wx [f_in, 4f], wh [f, 4f], b [4f]; arrays
    convertible with np.asarray) -> the port's LSTMParams of float32
    tensors on ``device``."""
    dev = resolve_device(device)
    return LSTMParams(*(torch.tensor(np.asarray(a, np.float32), device=dev) for a in params))


def sage_lstm_params_from_jax(params, device="cuda") -> SageLSTM:
    """JAX SageLSTMParams (lstm, w_self, w_out) -> SageLSTM module."""
    lstm, w_self, w_out = params
    return SageLSTM(
        SageLSTMParams(LSTMParams(*(np.asarray(a, np.float32) for a in lstm)), np.asarray(w_self, np.float32),
                       np.asarray(w_out, np.float32)),
        device=device,
    )


def params_from_checkpoint(path: str, model):
    """Load an .npz checkpoint written by the JAX package's
    ``save_checkpoint`` (or the port's) into a GCN or GAT module of the same
    widths, in place.  Returns (model, step)."""
    return load_checkpoint(path, model)
