"""The GAT configurations on the port: weights, the program's forward, and counts.

A layer is feat = h W, att = feat W_att (the [f, 2] dst and src halves),
then the fused attention aggregation (softmax over each row's in-edges of
lrelu(ad_dst + as_src)), with no nonlinearity between layers:
``models.gat.gat_forward`` over a hybrid ``Aggregator`` with the
configuration's ``fast``, ``dot_mode`` and ``stabilize``.
"""

from __future__ import annotations

from portbench import inputs


def weights(cfg: dict, seed: int, device) -> list:
    """[W_1, Wa_1, ..., W_L, Wa_L]: W float32 [f_in, f_out], Wa [f_out, 2],
    both normals of the layer's Glorot scale sqrt(2 / (f_in + f_out))."""
    d = cfg["dims"]
    shapes, fan = [], []
    for i in range(len(d) - 1):
        shapes += [(d[i], d[i + 1]), (d[i + 1], 2)]
        fan += [(d[i], d[i + 1])] * 2
    return inputs.glorot(shapes, fan, seed, device)


def program(cfg: dict, agg, leaves: list):
    """forward(h) -> [n, f_L] through the port's benchmark GAT."""
    from gnn_computing_tpu_torch.models import gat

    params = [gat.GATLayerParams(leaves[i], leaves[i + 1]) for i in range(0, len(leaves), 2)]
    g = cfg["gat"]

    def forward(h):
        return gat.gat_forward(
            agg, params, h, relu_slope=g["relu_slope"], stabilize=g["stabilize"], fast=g["fast"],
            dot_mode=g["dot_mode"],
        )

    return forward


def tile_launches(cfg: dict, train: bool) -> list:
    """The tile-kernel launches of one pass, as in models/gcn.py: B2 over
    the forward parts per layer; the backward adds B3 (d_ad) over the
    forward parts and B4 (dh, d_as) over the transposed ones."""
    fs = cfg["dims"][1:]
    out = [("B2", "fwd", f) for f in fs]
    if train:
        out += [("B3", "fwd", f) for f in fs] + [("B4", "t", f) for f in fs]
    return out


def useful_flops(cfg: dict, n: int, m: int, train: bool) -> float:
    """Multiply-adds counted 2, other arithmetic 1, per layer (f_in -> f):
    forward 2 n f_in f (feat), 4 n f (att), per edge the score (add, lrelu,
    exp: 3), den (1) and the weighted row (2 f), then num / den (n f);
    backward per edge the dot <g_dst, feat_src> (2 f), the softmax's and
    lrelu's backward (3), d_ad and d_as (2) and the transposed weighted
    row (2 f), per row <g, out> (2 f), d_att W_att^T and dW_att (8 f), dW
    (2 f_in f) and, past the first layer, the input's gradient (2 f_in f)."""
    d = cfg["dims"]
    total = 0.0
    for i in range(len(d) - 1):
        fi, f = d[i], d[i + 1]
        total += 2.0 * n * fi * f + 4.0 * n * f + m * (2.0 * f + 4.0) + n * f
        if train:
            total += m * (4.0 * f + 5.0) + n * (10.0 * f + 2.0 * fi * f) + (2.0 * n * fi * f if i else 0.0)
    return total
