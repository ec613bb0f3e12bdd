"""The published multi-head GAT on the port: weights, the program's forward, and counts.

A layer is z = h W (one GEMM to [n, heads * F]), then per head k the fused
attention aggregation of z's k-th slice with its own attention halves a_k
(``Aggregator.run_gat`` with the configuration's ``stabilize``, the exact
score and float32 residual rows: the only ``dot_mode`` and ``fast`` the
configuration may state); hidden layers concatenate the heads, add an
identity skip where the configuration's ``skip`` says, and apply ELU; the
last layer averages its heads: ``models.gat.gat_heads_forward`` over a
hybrid ``Aggregator``.  The port's function is imported with this module,
so a program without it fails before any set-up.
"""

from __future__ import annotations

from gnn_computing_tpu_torch.models.gat import GATHeadsLayerParams, gat_heads_forward
from portbench import inputs


def layers(cfg: dict) -> list:
    """(f_in, heads, F, output) per layer: a hidden layer's output is
    heads * F wide, the last layer's F."""
    d, heads = cfg["dims"], cfg["gat"]["heads"]
    out, f_in = [], d[0]
    for i, (f, k) in enumerate(zip(d[1:], heads)):
        last = i == len(heads) - 1
        out.append((f_in, k, f, last))
        f_in = k * f
    return out


def weights(cfg: dict, seed: int, device) -> list:
    """[W_1, a_1, ..., W_L, a_L]: W float32 [f_in, heads * F], a [heads, F,
    2], both normals of the Glorot scale sqrt(2 / (f_in + F)) of one head's
    projection."""
    shapes, fan = [], []
    for f_in, k, f, _ in layers(cfg):
        shapes += [(f_in, k * f), (k, f, 2)]
        fan += [(f_in, f)] * 2
    return inputs.glorot(shapes, fan, seed, device)


def program(cfg: dict, agg, leaves: list):
    """forward(h) -> [n, F_L] through the port's published GAT."""
    params = [GATHeadsLayerParams(leaves[i], leaves[i + 1]) for i in range(0, len(leaves), 2)]
    g = cfg["gat"]
    if g["fast"] or g["dot_mode"] != "exact":
        raise ValueError(f"the published GAT runs fast false and dot_mode 'exact', not {g['fast']}, {g['dot_mode']!r}")

    def forward(h):
        return gat_heads_forward(agg, params, h, skip=g["skip"], relu_slope=g["relu_slope"], stabilize=g["stabilize"])

    return forward


def tile_launches(cfg: dict, train: bool) -> list:
    """The tile-kernel launches of one pass, as in models/gat.py, once a
    head: B2 over the forward parts per head at the head's width F; the
    backward adds B3 (d_ad) over the forward parts and B4 (dh, d_as) over
    the transposed ones, per head."""
    out = []
    for _, k, f, _ in layers(cfg):
        out += [("B2", "fwd", f)] * k
        if train:
            out += [("B3", "fwd", f)] * k + [("B4", "t", f)] * k
    return out


def useful_flops(cfg: dict, n: int, m: int, train: bool) -> float:
    """Multiply-adds counted 2, other arithmetic 1.  Per layer (f_in,
    heads k, width F): the projection 2 n f_in k F once; per head
    models/gat.py's count without its feat GEMM: 4 n F (att), per edge the
    score (3), den (1) and the weighted row (2 F), then num / den (n F);
    the merge 1 a value of the n k F it reads: the mean (output layer),
    the skip and ELU (hidden layers, the skip where the layer has one).
    The backward adds per head per edge 4 F + 5 and per row 10 F; per layer
    dW (2 n f_in k F), past the first layer the input's gradient (2 n f_in
    k F), and 1 a value for each merge operation's backward."""
    skip = cfg["gat"]["skip"]
    total = 0.0
    for i, (f_in, k, f, last) in enumerate(layers(cfg)):
        gemm = 2.0 * n * f_in * k * f
        merge = n * k * f * (1 if last else 1 + int(skip[i]))
        total += gemm + k * (4.0 * n * f + m * (2.0 * f + 4.0) + n * f) + merge
        if train:
            total += k * (m * (4.0 * f + 5.0) + 10.0 * n * f) + gemm + (gemm if i else 0.0) + merge
    return total
