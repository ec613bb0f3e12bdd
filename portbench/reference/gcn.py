"""Plain reference of the GCN configurations: z = A (h W), h' = relu(z) per
layer (ReLU after every layer), A the adjacency with a duplicate edge
counted as often as it is drawn; the forward and the backward written out."""

from __future__ import annotations

import torch

from portbench.reference.common import aggregate, matmul_rows, softmax_xent, t_matmul_rows


def forward(cfg: dict, edges, x: torch.Tensor, weights: list, dtype=torch.float64, keep: bool = False):
    """The output [n, f_L]; with ``keep`` also each layer's (input, z) for
    the backward."""
    h, kept = x, []
    for w in weights:
        z = aggregate(edges, matmul_rows(h, w, dtype))
        if keep:
            kept.append((h, z))
        h = torch.relu(z)
    return (h, kept) if keep else h


def forward_backward(cfg: dict, edges, x, labels, weights: list, dtype=torch.float64):
    """(mean cross-entropy, [dL/dW_l]) of one full-graph step."""
    out, kept = forward(cfg, edges, x, weights, dtype, keep=True)
    loss, g = softmax_xent(out, labels)
    grads = [None] * len(weights)
    for i in reversed(range(len(weights))):
        h, z = kept[i]
        dt = aggregate(edges, g * (z > 0), reverse=True)
        grads[i] = t_matmul_rows(h, dt, dtype)
        if i:
            g = dt @ weights[i].to(dtype).T
    return loss, grads
