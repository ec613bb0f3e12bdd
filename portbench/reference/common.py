"""Pieces shared by the plain references: the edge list, aggregation in blocks
of edges, the loss and Adam.

Everything here is plain PyTorch over the harness's own edge list (CSR by
destination, in the vertex order drawn), in the dtype the caller asks for
(float64 for the reference).  Nothing is taken from the program: no plan,
tile, permutation or table.
"""

from __future__ import annotations

import dataclasses

import torch

BLOCK_BYTES = 1 << 31  # the gathered rows of one block of edges


@dataclasses.dataclass
class Edges:
    """Edge e goes from ``src[e]`` to ``dst[e]`` (int64 on the device)."""

    src: torch.Tensor
    dst: torch.Tensor
    num_nodes: int

    @classmethod
    def from_graph(cls, graph, device) -> "Edges":
        return cls(
            src=torch.from_numpy(graph.src).to(device, torch.int64),
            dst=torch.from_numpy(graph.dst()).to(device, torch.int64),
            num_nodes=graph.num_nodes,
        )

    @property
    def num_edges(self) -> int:
        return int(self.src.numel())

    def blocks(self, width: int):
        """Edge ranges [e0, e1) whose gathered rows of ``width`` float64
        values fill at most BLOCK_BYTES."""
        step = max(1, BLOCK_BYTES // (8 * max(width, 1)))
        for e0 in range(0, self.num_edges, step):
            yield e0, min(e0 + step, self.num_edges)


def aggregate(edges: Edges, x: torch.Tensor, weight: torch.Tensor | None = None, reverse: bool = False):
    """out[dst] += weight[e] * x[src] over every edge (with ``reverse``,
    out[src] += weight[e] * x[dst]); a duplicate edge counts as often as it
    is listed."""
    frm, to = (edges.dst, edges.src) if reverse else (edges.src, edges.dst)
    out = torch.zeros((edges.num_nodes, x.shape[1]), dtype=x.dtype, device=x.device)
    for e0, e1 in edges.blocks(x.shape[1]):
        rows = x.index_select(0, frm[e0:e1])
        if weight is not None:
            rows *= weight[e0:e1, None]
        out.index_add_(0, to[e0:e1], rows)
        del rows
    return out


def edge_dots(edges: Edges, g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """<g[dst], x[src]> for every edge."""
    out = torch.empty(edges.num_edges, dtype=x.dtype, device=x.device)
    for e0, e1 in edges.blocks(x.shape[1]):
        out[e0:e1] = (g.index_select(0, edges.dst[e0:e1]) * x.index_select(0, edges.src[e0:e1])).sum(1)
    return out


def matmul_rows(x: torch.Tensor, w: torch.Tensor, dtype) -> torch.Tensor:
    """x @ w in ``dtype``, converting x a block of rows at a time (the
    input features stay float32 and are never held whole in float64)."""
    w = w.to(dtype)
    step = max(1, BLOCK_BYTES // (8 * x.shape[1]))
    return torch.cat([x[r:r + step].to(dtype) @ w for r in range(0, x.shape[0], step)])


def t_matmul_rows(x: torch.Tensor, g: torch.Tensor, dtype) -> torch.Tensor:
    """x^T @ g in ``dtype``, a block of rows at a time."""
    step = max(1, BLOCK_BYTES // (8 * x.shape[1]))
    out = torch.zeros((x.shape[1], g.shape[1]), dtype=dtype, device=x.device)
    for r in range(0, x.shape[0], step):
        out += x[r:r + step].to(dtype).T @ g[r:r + step].to(dtype)
    return out


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor):
    """(mean cross-entropy over every row, its gradient in the logits)."""
    lse = torch.logsumexp(logits, dim=1)
    loss = (lse - logits.gather(1, labels[:, None])[:, 0]).mean()
    grad = torch.softmax(logits, dim=1)
    grad[torch.arange(len(labels), device=labels.device), labels] -= 1.0
    return loss, grad / logits.shape[0]


class Adam:
    """torch.optim.Adam's update (no weight decay, no amsgrad), written out."""

    def __init__(self, params: list, lr: float, betas=(0.9, 0.999), eps: float = 1e-8):
        self.params, self.lr, self.betas, self.eps = params, lr, betas, eps
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    def step(self, grads: list) -> None:
        b1, b2 = self.betas
        self.t += 1
        c1, c2 = 1.0 - b1 ** self.t, 1.0 - b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(b1).add_(g, alpha=1.0 - b1)
            v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            p.sub_(self.lr / c1 * m / (v.sqrt() / c2 ** 0.5 + self.eps))


def train(model, cfg: dict, edges: Edges, x: torch.Tensor, labels: torch.Tensor, weights: list,
          steps: int, dtype=torch.float64) -> dict:
    """``steps`` full-graph steps of ``model`` (a reference module with
    ``forward_backward``) under Adam from ``weights``: each step's loss, the
    first step's gradient of every leaf, and every leaf's change after the
    last step."""
    t = cfg["train"]
    params = [w.to(dtype).clone() for w in weights]
    opt = Adam(params, lr=t["lr"], betas=tuple(t["betas"]), eps=t["eps"])
    losses, first = [], None
    for _ in range(steps):
        loss, grads = model.forward_backward(cfg, edges, x, labels, params, dtype)
        losses.append(float(loss))
        first = grads if first is None else first
        opt.step(grads)
    return dict(losses=losses, grads=first, changes=[p - w.to(dtype) for p, w in zip(params, weights)])
