"""Multi-device graph partitioning: destination-owned shards + a ring schedule.

Port of ``gnn_computing_tpu/parallel/partition.py`` (host numpy, array-equal
to the JAX package's plans):

  * vertices are split into D contiguous shards; rank d owns the feature and
    output rows of shard d (destination-owned edges);
  * rank d's edges are scheduled with the locality schedule whose source
    partitions are the shards (``schedule.locality.locality_plan``);
  * aggregation runs as a D-step ring: at step s rank d holds feature shard
    (d + s) mod D and aggregates the edge group whose sources live there.

Every per-(rank, step) plan is padded to one task count, so the stacked
arrays split evenly over the ranks.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from gnn_computing_tpu_torch.graph.csr import CSRGraph
from gnn_computing_tpu_torch.schedule.locality import locality_plan


@dataclasses.dataclass
class RingShard:
    """One rank's part of a RingPlan, as tensors on its device: per ring
    step s, src/val [D, nt * B] (flat slots, src local to the step's source
    shard), dst [D, nt] (local to the rank's shard), count [D, nt]."""

    src: torch.Tensor
    count: torch.Tensor
    dst: torch.Tensor
    val: torch.Tensor
    num_devices: int
    shard_size: int
    block_size: int


@dataclasses.dataclass
class RingPlan:
    """Stacked per-(rank, ring-step) aggregation plans.

    src/val: [D, D, nt, B] — src ids LOCAL to the step's source shard.
    count:   [D, D, nt]
    dst:     [D, D, nt]    — dst ids LOCAL to the owning rank's shard.
    Axis 0 is the owning rank; axis 1 is the ring step.
    """

    src: np.ndarray
    count: np.ndarray
    dst: np.ndarray
    val: np.ndarray
    num_devices: int
    shard_size: int
    block_size: int
    num_edges: int

    @property
    def tasks_per_step(self) -> int:
        return self.src.shape[2]

    def shard(self, rank: int, device) -> RingShard:
        """Rank ``rank``'s part on ``device``."""
        d = self.num_devices
        return RingShard(
            src=torch.as_tensor(self.src[rank]).to(device, torch.int64).reshape(d, -1),
            count=torch.as_tensor(self.count[rank]).to(device, torch.int32),
            dst=torch.as_tensor(self.dst[rank]).to(device, torch.int64),
            val=torch.as_tensor(self.val[rank]).to(device, torch.float32).reshape(d, -1),
            num_devices=d,
            shard_size=self.shard_size,
            block_size=self.block_size,
        )

    def stats(self) -> dict:
        counts = np.asarray(self.count)
        d = self.num_devices
        per_cell_edges = counts.sum(axis=2)  # [D, D]
        local = np.trace(per_cell_edges)
        return {
            "num_devices": d,
            "shard_size": self.shard_size,
            "tasks_per_step": self.tasks_per_step,
            "edges": int(per_cell_edges.sum()),
            "local_edge_fraction": float(local) / max(per_cell_edges.sum(), 1),
            "max_cell_edges": int(per_cell_edges.max()),
            "mean_cell_edges": float(per_cell_edges.mean()),
            "slot_occupancy": float(counts.sum()) / (counts.size * self.block_size),
        }


def pad_to_shards(g: CSRGraph, num_devices: int) -> CSRGraph:
    """Pad the vertex set so n is a multiple of D (extra isolated rows)."""
    n = g.num_nodes
    n_pad = -(-n // num_devices) * num_devices
    if n_pad == n:
        return g
    indptr = np.concatenate([g.indptr, np.full(n_pad - n, g.indptr[-1], dtype=np.int32)])
    return CSRGraph(indptr=indptr, indices=g.indices, val=g.val, n_src=n_pad)


def build_ring_plan(
    g: CSRGraph,
    num_devices: int,
    block_size: int = 32,
    val: Optional[np.ndarray] = None,
    shuffle_seed: Optional[int] = None,
) -> tuple:
    """Partition + schedule a graph for ring aggregation.

    Returns (ring_plan, padded_graph, perm) where ``perm`` is the vertex
    shuffle applied for load balance (None if shuffle_seed is None): output
    row i of the distributed run is original vertex perm[i]."""
    perm = None
    if shuffle_seed is not None:
        perm = np.random.default_rng(shuffle_seed).permutation(g.num_nodes)
        if val is not None:
            g = CSRGraph(g.indptr, g.indices, val=np.asarray(val, np.float32), n_src=g.n_src)
            val = None
        g = g.reorder(perm)

    d = num_devices
    g = pad_to_shards(g, d)
    if val is None:
        val = g.val if g.val is not None else np.ones(g.num_edges, np.float32)
    n_pad = g.num_nodes
    ns = n_pad // d

    # per rank: schedule its destination rows with shard-aligned source
    # partitions (locality, one partition a shard)
    per_rank = []
    nt_max = 8
    for dev in range(d):
        lo, hi = dev * ns, (dev + 1) * ns
        sub = CSRGraph(
            indptr=(g.indptr[lo : hi + 1] - g.indptr[lo]).astype(np.int32),
            indices=g.indices[g.indptr[lo] : g.indptr[hi]],
            n_src=n_pad,
        )
        plan = locality_plan(sub, d, block_size, val=val[g.indptr[lo] : g.indptr[hi]], pad_multiple=1)
        per_rank.append(plan)
        starts = np.asarray(plan.partition_starts)
        nt_max = max(nt_max, int(np.diff(starts).max()) if len(starts) > 1 else 0)

    src = np.zeros((d, d, nt_max, block_size), np.int32)
    valm = np.zeros((d, d, nt_max, block_size), np.float32)
    count = np.zeros((d, d, nt_max), np.int32)
    dst = np.zeros((d, d, nt_max), np.int32)
    for dev, plan in enumerate(per_rank):
        starts = plan.partition_starts
        for k in range(d):
            a, b = starts[k], starts[k + 1]
            nt = b - a
            if nt == 0:
                continue
            # at ring step s rank dev holds shard (dev + s) % d
            s = (k - dev) % d
            # localized to shard k; pad slots stay in range (index 0, value 0)
            localized = plan.src[a:b].astype(np.int64) - k * ns
            mask = np.arange(block_size, dtype=np.int64)[None, :] < plan.count[a:b][:, None]
            src[dev, s, :nt] = np.where(mask, localized, 0)
            valm[dev, s, :nt] = plan.val[a:b]
            count[dev, s, :nt] = plan.count[a:b]
            dst[dev, s, :nt] = plan.dst[a:b]

    ring = RingPlan(
        src=src, count=count, dst=dst, val=valm, num_devices=d, shard_size=ns, block_size=block_size,
        num_edges=g.num_edges,
    )
    return ring, g, perm
