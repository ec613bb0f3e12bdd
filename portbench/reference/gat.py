"""Plain reference of the GAT configurations, per layer:

  feat = h W,  (ad, as) = feat W_att,  s_e = ad[dst] + as[src],
  alpha_e = softmax over the in-edges of dst of lrelu(s_e),
  out[i] = sum over the in-edges e of i of alpha_e feat[src_e]

(a row without in-edges gives 0), no nonlinearity between layers; the
forward and the backward written out, lrelu'(s) = 1 for s >= 0, else the
slope."""

from __future__ import annotations

import torch

from portbench.reference.common import aggregate, edge_dots, matmul_rows, softmax_xent, t_matmul_rows


def _layer(edges, h, w, w_att, slope: float, dtype):
    feat = matmul_rows(h, w, dtype)
    att = feat @ w_att.to(dtype)
    s = att[:, 0].index_select(0, edges.dst) + att[:, 1].index_select(0, edges.src)
    e = torch.where(s >= 0, s, slope * s)
    top = torch.full((edges.num_nodes,), -torch.inf, dtype=dtype, device=h.device)
    top.scatter_reduce_(0, edges.dst, e, "amax")
    p = torch.exp(e - top.index_select(0, edges.dst))
    del e
    den = torch.zeros(edges.num_nodes, dtype=dtype, device=h.device).index_add_(0, edges.dst, p)
    alpha = p / den.index_select(0, edges.dst)
    del p
    return feat, s, alpha, aggregate(edges, feat, alpha)


def forward(cfg: dict, edges, x: torch.Tensor, weights: list, dtype=torch.float64, keep: bool = False):
    """The output [n, f_L]; with ``keep`` also each layer's saved values."""
    slope = cfg["gat"]["relu_slope"]
    h, kept = x, []
    for i in range(0, len(weights), 2):
        feat, s, alpha, out = _layer(edges, h, weights[i], weights[i + 1], slope, dtype)
        if keep:
            kept.append((h, feat, s, alpha, out))
        h = out
    return (h, kept) if keep else h


def forward_backward(cfg: dict, edges, x, labels, weights: list, dtype=torch.float64):
    """(mean cross-entropy, [dL/dW_1, dL/dWa_1, ...]) of one full-graph step."""
    slope = cfg["gat"]["relu_slope"]
    out, kept = forward(cfg, edges, x, weights, dtype, keep=True)
    loss, g = softmax_xent(out, labels)
    grads = [None] * len(weights)
    for li in reversed(range(len(kept))):
        h, feat, s, alpha, out = kept[li]
        w, w_att = weights[2 * li].to(dtype), weights[2 * li + 1].to(dtype)
        c = (g * out).sum(1)
        ds = alpha * (edge_dots(edges, g, feat) - c.index_select(0, edges.dst))
        ds *= torch.where(s >= 0, 1.0, slope)
        d_att = torch.stack([
            torch.zeros(edges.num_nodes, dtype=dtype, device=h.device).index_add_(0, edges.dst, ds),
            torch.zeros(edges.num_nodes, dtype=dtype, device=h.device).index_add_(0, edges.src, ds),
        ], dim=1)
        del ds
        d_feat = aggregate(edges, g, alpha, reverse=True) + d_att @ w_att.T
        grads[2 * li] = t_matmul_rows(h, d_feat, dtype)
        grads[2 * li + 1] = feat.T @ d_att
        if li:
            g = d_feat @ w.T
    return loss, grads
