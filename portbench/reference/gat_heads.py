"""Plain reference of the published multi-head GAT configurations, per layer:

  z_k = h W_k,  (ad, as) = z_k a_k,  s_e = ad[dst] + as[src],
  alpha_e = softmax over the in-edges of dst of lrelu(s_e),
  out_k[i] = sum over the in-edges e of i of alpha_e z_k[src_e]

for every head k (W_k the k-th block of W's columns); hidden layers
concatenate the heads, add their input where the configuration's ``skip``
says and apply ELU, the last layer averages its heads.  Each head is
reference/gat.py's layer; the forward and the backward are written out
(lrelu'(s) = 1 for s >= 0, else the slope; ELU'(u) = 1 for u > 0, else
ELU(u) + 1).  A head keeps its alpha and the sign of its logits per edge
for the backward, so the fourteen heads of gat-ppi's step fit beside the graph."""

from __future__ import annotations

import torch

from portbench.reference.common import aggregate, edge_dots, softmax_xent, t_matmul_rows
from portbench.reference.gat import _layer


def _block(w: torch.Tensor, k: int, f: int) -> torch.Tensor:
    return w[:, k * f:(k + 1) * f]


def forward(cfg: dict, edges, x: torch.Tensor, weights: list, dtype=torch.float64, keep: bool = False):
    """The output [n, F_L]; with ``keep`` also each layer's saved values:
    (input, [(z_k, s_k >= 0, alpha_k, out_k)], output)."""
    g = cfg["gat"]
    slope, skip = g["relu_slope"], g["skip"]
    layers = len(weights) // 2
    h, kept = x, []
    for i in range(layers):
        w, a = weights[2 * i], weights[2 * i + 1]
        heads, f = a.shape[0], a.shape[1]
        saved, outs = [], []
        for k in range(heads):
            z, s, alpha, out = _layer(edges, h, _block(w, k, f), a[k], slope, dtype)
            pos = s >= 0
            del s
            outs.append(out)
            if keep:
                saved.append((z, pos, alpha, out))
            del z, pos, alpha
        if i == layers - 1:
            y = torch.stack(outs).mean(dim=0)
        else:
            y = torch.cat(outs, dim=1)
            if skip[i]:
                y = y + h.to(dtype)
            y = torch.nn.functional.elu(y)
        del outs
        if keep:
            kept.append((h, saved, y))
        h = y
    return (h, kept) if keep else h


def forward_backward(cfg: dict, edges, x, labels, weights: list, dtype=torch.float64):
    """(mean cross-entropy, [dL/dW_1, dL/da_1, ...]) of one full-graph step."""
    g_cfg = cfg["gat"]
    slope, skip = g_cfg["relu_slope"], g_cfg["skip"]
    out, kept = forward(cfg, edges, x, weights, dtype, keep=True)
    loss, g = softmax_xent(out, labels)
    grads = [None] * len(weights)
    for li in reversed(range(len(kept))):
        h, saved, y = kept[li]
        w, a = weights[2 * li].to(dtype), weights[2 * li + 1].to(dtype)
        heads, f = a.shape[0], a.shape[1]
        last = li == len(kept) - 1
        g_in = None
        if not last:
            g = g * torch.where(y > 0, 1.0, y + 1.0)  # through ELU
            if skip[li]:
                g_in = g
        dw = torch.empty((w.shape[0], heads * f), dtype=dtype, device=w.device)
        da = torch.empty((heads, f, 2), dtype=dtype, device=w.device)
        for k, (z, pos, alpha, out_k) in enumerate(saved):
            gk = (g / heads if last else g[:, k * f:(k + 1) * f]).contiguous()
            c = (gk * out_k).sum(1)
            ds = alpha * (edge_dots(edges, gk, z) - c.index_select(0, edges.dst))
            ds *= torch.where(pos, 1.0, slope)
            d_att = torch.stack([
                torch.zeros(edges.num_nodes, dtype=dtype, device=w.device).index_add_(0, edges.dst, ds),
                torch.zeros(edges.num_nodes, dtype=dtype, device=w.device).index_add_(0, edges.src, ds),
            ], dim=1)
            del ds
            d_z = aggregate(edges, gk, alpha, reverse=True) + d_att @ a[k].T
            dw[:, k * f:(k + 1) * f] = t_matmul_rows(h, d_z, dtype)
            da[k] = z.T @ d_att
            if li:
                g_h = d_z @ _block(w, k, f).T
                g_in = g_h if g_in is None else g_in + g_h
            del d_z, d_att
        grads[2 * li], grads[2 * li + 1] = dw, da
        kept[li] = None
        g = g_in
    return loss, grads
