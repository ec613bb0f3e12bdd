"""Carry weights from the JAX package into the port, so both compute the
same function (the JAX GCN's params are a list of [f_in, f_out] arrays; the
JAX GAT's a list of GATLayerParams(w, w_att)), in memory or through a
checkpoint file of the JAX package's ``save_checkpoint``."""

from __future__ import annotations

from typing import Sequence

import numpy as np

from gnn_computing_tpu_torch.models.gat import GAT
from gnn_computing_tpu_torch.models.gcn import GCN
from gnn_computing_tpu_torch.models.training import load_checkpoint


def gcn_params_from_jax(params: Sequence[np.ndarray], device="cuda") -> GCN:
    """JAX GCN params (arrays convertible with np.asarray) -> GCN module."""
    return GCN([np.asarray(w, np.float32) for w in params], device=device)


def gat_params_from_jax(params: Sequence[tuple], device="cuda") -> GAT:
    """JAX GAT params, a sequence of (w, w_att) pairs such as
    GATLayerParams -> GAT module."""
    return GAT([(np.asarray(w, np.float32), np.asarray(a, np.float32)) for w, a in params], device=device)


def params_from_checkpoint(path: str, model):
    """Load an .npz checkpoint written by the JAX package's
    ``save_checkpoint`` (or the port's) into a GCN or GAT module of the same
    widths, in place.  Returns (model, step)."""
    return load_checkpoint(path, model)
