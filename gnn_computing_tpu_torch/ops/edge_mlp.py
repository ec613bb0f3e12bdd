"""Per-edge MLP aggregation (GraphSAGE-MLP style), plain PyTorch.

Port of ``gnn_computing_tpu/ops/edge_mlp.py``: for every edge (j -> i),
out[i] += relu((h[i] + h[j]) @ W).  The GEMM distributes over the add,
relu((h_i + h_j) W) = relu(u_i + u_j) with u = h W computed once a call in
float32 (TF32 off), so per-edge work is a gather, an add, a relu and a sum
over each task's slots, then each task sum goes into its destination row.
The JAX package leaves this to XLA (no MXU, no Pallas kernel); the port
leaves it to PyTorch's gather and scatter kernels, over any gather plan
(neighbor grouping, locality, locality + NG, nop).  ``plan.val`` is
ignored, as in the JAX package.

A padding slot gathers u[0], and relu(u[0] + u[dst]) is not zero, so pad
slots are masked out (a zero weight would not silence them, unlike the
SpMM's).  Tasks go in chunks so the gathered [slots, f_out] block never
lives whole (≈15 GB at reddit scale); the result depends on the chunking
only through float32 summation order.
"""

from __future__ import annotations

import torch

from gnn_computing_tpu_torch.ops.spmm import CHUNK_SLOTS
from gnn_computing_tpu_torch.schedule.plan import AggregationPlan


def _edge_mlp_tasks(plan: AggregationPlan, u: torch.Tensor, step: int) -> torch.Tensor:
    """sum_e relu(u[dst] + u[src_e]) into each destination row, tasks
    ``step`` at a time."""
    b, fo = plan.block_size, u.shape[-1]
    src, dst = plan.src_flat(), plan.dst
    cnt = plan.count.long()
    slot = torch.arange(b, device=u.device)
    out = torch.zeros((plan.num_nodes, fo), dtype=u.dtype, device=u.device)
    for t0 in range(0, plan.num_tasks_padded, step):
        t1 = min(plan.num_tasks_padded, t0 + step)
        g = u.index_select(0, src[t0 * b : t1 * b]).reshape(t1 - t0, b, fo)
        d = dst[t0:t1]
        z = torch.relu(g + u.index_select(0, d)[:, None, :])
        mask = slot[None, :] < cnt[t0:t1, None]
        out.index_add_(0, d, torch.where(mask[:, :, None], z, 0.0).sum(dim=1))
    return out


def edge_mlp(plan: AggregationPlan, h: torch.Tensor, w: torch.Tensor, chunk_slots: int = CHUNK_SLOTS) -> torch.Tensor:
    """out[i] = sum over edges e = (j -> i) of relu((h[i] + h[j]) @ W), in
    chunks of at most ``chunk_slots`` slots (at least one task)."""
    return _edge_mlp_tasks(plan, h @ w, max(1, chunk_slots // plan.block_size))


def edge_mlp_chunked(plan: AggregationPlan, h: torch.Tensor, w: torch.Tensor, chunk_tasks: int = 1 << 19) -> torch.Tensor:
    """edge_mlp in chunks of ``chunk_tasks`` tasks (the JAX package's
    reddit-scale form, which scans over task chunks)."""
    return _edge_mlp_tasks(plan, h @ w, chunk_tasks)
