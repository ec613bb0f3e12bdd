"""Full-graph training: a train-step factory, accuracy and checkpoints.

Port of ``gnn_computing_tpu/models/training.py``.  optax's Adam becomes
``torch.optim.Adam``; the step is eager (no jit).  Checkpoints keep the JAX
package's ``.npz`` layout: ``leaf_{i}`` in pytree-leaf order, ``__step__``,
and a ``__treedef__`` byte string that JAX's loader ignores, so a
checkpoint written by either package loads into the other.  The leaf order
of the models: GCN [w_1, w_2, ...]; GAT [w_1, w_att_1, w_2, w_att_2, ...]
(a list of GATLayerParams(w, w_att) flattens that way).
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from gnn_computing_tpu_torch.device import resolve_device
from gnn_computing_tpu_torch.utils.profiling import span


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean softmax cross-entropy with integer labels; with a bool ``mask``
    the mean over the masked nodes (0 when none is)."""
    per_node = F.cross_entropy(logits, labels, reduction="none")
    if mask is None:
        return per_node.mean()
    per_node = torch.where(mask, per_node, 0.0)
    return per_node.sum() / mask.sum().clamp_min(1)


def make_train_step(forward: Callable, optimizer: torch.optim.Optimizer, loss: str = "softmax_xent", device="cuda"):
    """Build ``step(inputs, labels, mask=None) -> loss``: zero the grads,
    ``logits = forward(*inputs)`` ([n, num_classes]), masked mean
    cross-entropy, backward, ``optimizer.step()``.  ``labels`` (int [n]) and
    ``mask`` (optional bool [n] of labeled nodes) may be numpy arrays; they
    go to ``device``, which must be where the optimizer's parameters
    live.  Returns the loss before the update, detached.  Spans (recorded
    under utils.profiling.recording): ``gnn.step`` around the step, and in
    it ``gnn.loss``, ``gnn.backward`` and ``gnn.optimizer`` (the forward
    records its own ``gnn.forward``)."""
    if loss != "softmax_xent":
        raise ValueError(f"loss must be 'softmax_xent', got {loss!r}")
    dev = resolve_device(device)
    for group in optimizer.param_groups:
        for p in group["params"]:
            if p.device.type != dev.type:
                raise ValueError(f"parameter on {p.device}, train step on {dev}")

    def step(inputs, labels, mask=None):
        with span("gnn.step"):
            labels = torch.as_tensor(labels, device=dev).long()
            mask = None if mask is None else torch.as_tensor(mask, device=dev).bool()
            optimizer.zero_grad(set_to_none=True)
            logits = forward(*inputs)
            with span("gnn.loss"):
                lval = softmax_xent(logits, labels, mask)
            del logits  # freed before the backward, as the loss keeps what it needs
            with span("gnn.backward"):
                lval.backward()
            with span("gnn.optimizer"):
                optimizer.step()
            return lval.detach()

    return step


def accuracy(logits: torch.Tensor, labels: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Share of (masked) nodes whose arg-max logit is the label."""
    hit = (logits.argmax(dim=-1) == labels).float()
    if mask is None:
        return hit.mean()
    hit = torch.where(mask, hit, 0.0)
    return hit.sum() / mask.sum().clamp_min(1)


# ------------------------------------------------------------- checkpointing
def param_leaves(params) -> list:
    """Parameters in the JAX package's pytree-leaf order: a GAT module (it
    has ``layer_params``) as [w, w_att] per layer, a GCN module as its
    weights, a (nested) sequence in order."""
    if hasattr(params, "layer_params"):
        params = params.layer_params()
    elif isinstance(params, torch.nn.Module):
        params = list(params.weights)
    if isinstance(params, (list, tuple)):
        return [leaf for p in params for leaf in param_leaves(p)]
    return [params]


def save_checkpoint(path: str, params, step: int = 0) -> None:
    """Write ``params`` (a GCN/GAT module or a sequence of tensors) to an
    .npz checkpoint in the JAX package's layout."""
    leaves = param_leaves(params)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    desc = f"gnn_computing_tpu_torch {len(leaves)} leaves"
    np.savez(
        path,
        __step__=np.int64(step),
        __treedef__=np.frombuffer(desc.encode(), dtype=np.uint8),
        **{f"leaf_{i}": leaf.detach().cpu().numpy() for i, leaf in enumerate(leaves)},
    )


def load_checkpoint(path: str, params_like):
    """Restore a checkpoint into the structure of ``params_like``.  A module
    is updated in place and returned; a sequence of tensors gives a list of
    new tensors on the same devices.  Returns (params, step)."""
    with np.load(path) as z:
        leaves_like = param_leaves(params_like)
        got = [z[f"leaf_{i}"] for i in range(len(leaves_like))]
        step = int(z["__step__"])
    for g, like in zip(got, leaves_like):
        if tuple(g.shape) != tuple(like.shape):
            raise ValueError(f"checkpoint shape {tuple(g.shape)} != model {tuple(like.shape)}")
    if isinstance(params_like, torch.nn.Module):
        with torch.no_grad():
            for g, like in zip(got, leaves_like):
                like.copy_(torch.from_numpy(np.asarray(g, np.float32)))
        return params_like, step
    return [torch.from_numpy(np.asarray(g)).to(like.device, like.dtype) for g, like in zip(got, leaves_like)], step
