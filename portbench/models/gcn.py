"""The GCN configurations on the port: weights, the program's forward, and counts.

A layer is transform, aggregation, ReLU (ReLU after every layer, the last
included): ``models.gcn.gcn_forward_bench`` over a hybrid ``Aggregator``,
in the exact modes (no layer options: float32 residual rows, tile operands
as they are; TF32 off, as the port sets it).
"""

from __future__ import annotations

from portbench import inputs


def weights(cfg: dict, seed: int, device) -> list:
    """[W_1, ..., W_L], float32 [f_in, f_out] Glorot normals: the leaves in
    the optimizer's order."""
    d = cfg["dims"]
    fan = [(d[i], d[i + 1]) for i in range(len(d) - 1)]
    return inputs.glorot(fan, fan, seed, device)


def program(cfg: dict, agg, leaves: list):
    """forward(h) -> [n, f_L] through the port's benchmark GCN."""
    from gnn_computing_tpu_torch.models import gcn

    def forward(h):
        return gcn.gcn_forward_bench(agg, leaves, h)

    return forward


def tile_launches(cfg: dict, train: bool) -> list:
    """The tile-kernel launches of one pass: (counter, "fwd" or "t", f) per
    tile part, "fwd" over the forward parts and "t" over the transposed
    ones.  B1 runs once per part and layer forward, and once per
    transposed part and layer in the backward (the input's gradient of
    every layer's aggregation, which dW needs)."""
    out = [("B1", "fwd", f) for f in cfg["dims"][1:]]
    if train:
        out += [("B1", "t", f) for f in cfg["dims"][1:]]
    return out


def useful_flops(cfg: dict, n: int, m: int, train: bool) -> float:
    """Multiply-adds counted 2: per layer 2 n f_in f_out (transform) and
    2 m f_out (aggregation); the backward adds per layer the aggregation
    over the transposed graph and dW (2 m f_out + 2 n f_in f_out), and the
    input's gradient (2 n f_in f_out) of every layer but the first.  No
    filler tile, padded slot or recomputation counts."""
    d = cfg["dims"]
    total = 0.0
    for i in range(len(d) - 1):
        fi, fo = d[i], d[i + 1]
        total += 2.0 * n * fi * fo + 2.0 * m * fo
        if train:
            total += 2.0 * m * fo + 2.0 * n * fi * fo + (2.0 * n * fi * fo if i else 0.0)
    return total
