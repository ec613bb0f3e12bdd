"""Plain reference of the published multi-head GAT over an edge list.

GAT, Velickovic et al., "Graph Attention Networks", ICLR 2018
(arXiv:1710.10903), section 3.3, the inductive model.  Per layer and head k:

  z_k = h W_k,  e_ij = LeakyReLU_slope(a_k . [z_k,i || z_k,j]),
  alpha_ij = softmax over j in N(i) of e_ij,  out_k,i = sum_j alpha_ij z_k,j;

hidden layers concatenate the heads, add their input where the layer has
an identity skip, and apply ELU; the output layer averages its heads.  The
loss is the mean softmax cross-entropy, and its gradients come from
autograd.

Plain ``torch`` only: no kernel, plan or table of the port.  The stated
precision is float32 with TF32 off (``forward`` turns it off); the same
functions run in float64 on float64 inputs.  Departures from the paper:

- N(i) is the graph's in-edges as given: no self-loops are added (the
  paper's N(i) includes i); a row without in-edges gives 0.
- a_k is held as [f_out, 2], its dst half a_k[:, 0] and its src half
  a_k[:, 1], so e_ij = LeakyReLU(z_k,i . a_k[:, 0] + z_k,j . a_k[:, 1]).
- The skip is the identity across the layers that ask for it (the
  paper's and DGL's PPI model); the authors' TF code projects a skip per
  head.
- Softmax cross-entropy over the output's classes; the paper trains PPI
  with a sigmoid per label.  No dropout, no L2.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def attention(src: torch.Tensor, dst: torch.Tensor, num_nodes: int, z: torch.Tensor, a: torch.Tensor,
              relu_slope: float) -> torch.Tensor:
    """One head: sum over the in-edges (src -> dst) of i of alpha_ij z_j,
    with ``a`` [f, 2] the (dst, src) halves of the attention vector."""
    att = z @ a
    e = F.leaky_relu(att[dst, 0] + att[src, 1], relu_slope)
    top = torch.full((num_nodes,), -torch.inf, dtype=z.dtype, device=z.device)
    top = top.scatter_reduce(0, dst, e.detach(), "amax")  # a shift that cancels in the softmax
    p = torch.exp(e - top[dst])
    den = torch.zeros(num_nodes, dtype=z.dtype, device=z.device).index_add(0, dst, p)
    alpha = p / den[dst]
    return torch.zeros((num_nodes, z.shape[1]), dtype=z.dtype, device=z.device).index_add(
        0, dst, alpha[:, None] * z[src])


def forward(src: torch.Tensor, dst: torch.Tensor, num_nodes: int, x: torch.Tensor, weights: Sequence[torch.Tensor],
            skip: Sequence[bool], relu_slope: float = 0.2) -> torch.Tensor:
    """The logits [n, f_L].  ``weights`` = [W_1, a_1, ..., W_L, a_L], W_l
    [f_in, heads * f_out] (head k's columns k f_out:(k + 1) f_out), a_l
    [heads, f_out, 2]; ``skip[l]`` adds layer l's input to its
    concatenated heads.  Every layer but the last is hidden."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    layers = len(weights) // 2
    h = x
    for i in range(layers):
        w, a = weights[2 * i], weights[2 * i + 1]
        heads, f = a.shape[0], a.shape[1]
        z = h @ w
        outs = [attention(src, dst, num_nodes, z[:, k * f:(k + 1) * f], a[k], relu_slope) for k in range(heads)]
        if i == layers - 1:
            return torch.stack(outs).mean(dim=0)
        out = torch.cat(outs, dim=1)
        h = F.elu(out + h if skip[i] else out)
    return h


def loss_and_grads(src, dst, num_nodes: int, x, labels, weights: Sequence[torch.Tensor], skip: Sequence[bool],
                   relu_slope: float = 0.2) -> tuple:
    """(mean softmax cross-entropy, [dL/dW_1, dL/da_1, ...]) by autograd."""
    leaves = [w.detach().clone().requires_grad_(True) for w in weights]
    loss = F.cross_entropy(forward(src, dst, num_nodes, x, leaves, skip, relu_slope), labels)
    return loss.detach(), list(torch.autograd.grad(loss, leaves))
