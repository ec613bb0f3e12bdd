"""Aggregation plans: irregular CSR -> fixed-shape padded task grids.

Port of ``gnn_computing_tpu/schedule/plan.py`` without pytree registration:

  src   int32[num_tasks_p, B]  source vertex per (task, slot); pad slots -> 0
  count int32[num_tasks_p]     valid slots per task
  dst   int32[num_tasks_p]     destination row per task
  val   f32 [num_tasks_p, B]   edge values, 0.0 in pad slots

A task holds at most B edges of one destination.  Aggregation gathers rows
of H by ``src``, weights them by ``val``, sums over the B slots and adds
each task sum into its destination row.

Host plans hold numpy arrays; ``to(device)`` returns a copy holding tensors,
with ``src`` and ``val`` stored flat ([num_tasks_p * B]), the only form the
aggregation reads.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from gnn_computing_tpu_torch.device import resolve_device


@dataclasses.dataclass
class AggregationPlan:
    """A scheduled graph: dense padded tasks."""

    src: object  # int32[num_tasks_p, B] (host) or int64[num_tasks_p * B] (tensor)
    count: object  # int32[num_tasks_p]
    dst: object  # int32[num_tasks_p] (host) or int64 (tensor)
    val: Optional[object]  # f32[num_tasks_p, B] (host) or flat f32 (tensor)
    # scheduled edge order -> original edge id; None when the schedule keeps
    # CSR edge order (neighbor grouping does)
    edge_perm: Optional[object]

    num_nodes: int
    n_src: int
    block_size: int
    num_tasks: int  # valid tasks (before padding)
    num_edges: int
    sorted_by_dst: bool
    partition_starts: Tuple[int, ...]

    @property
    def num_tasks_padded(self) -> int:
        if self.src.ndim == 1:  # flat tensor storage
            return self.src.shape[0] // self.block_size
        return self.src.shape[0]

    def src_flat(self):
        """Slot sources as a flat [num_tasks_p * B] vector."""
        return self.src.reshape(-1)

    @property
    def num_partitions(self) -> int:
        return len(self.partition_starts) - 1

    def slot_mask(self) -> torch.Tensor:
        """bool[num_tasks_p, B]: slots that hold an edge, on the plan's
        device (the CPU for a host plan)."""
        count = torch.as_tensor(self.count).long()
        return torch.arange(self.block_size, device=count.device)[None, :] < count[:, None]

    def stats(self) -> dict:
        """Task-size diagnostics (the JAX package's ``stats``)."""
        count = self.count.cpu().numpy() if isinstance(self.count, torch.Tensor) else np.asarray(self.count)
        counts = count[: self.num_tasks]
        b = self.block_size
        total_slots = self.num_tasks * b
        return {
            "num_tasks": int(self.num_tasks),
            "num_tasks_padded": int(self.num_tasks_padded),
            "block_size": int(b),
            "num_edges": int(self.num_edges),
            "min_task": int(counts.min()) if len(counts) else 0,
            "max_task": int(counts.max()) if len(counts) else 0,
            "mean_task": float(counts.mean()) if len(counts) else 0.0,
            "under_half_full": int((counts < b / 2).sum()),
            "zero_tasks": int((counts == 0).sum()),
            "slot_occupancy": float(counts.sum()) / total_slots if total_slots else 0.0,
            "pad_overhead": float(self.num_tasks_padded * b) / max(self.num_edges, 1),
        }

    def to(self, device) -> "AggregationPlan":
        dev = resolve_device(device)

        def put(x, dtype):
            return torch.as_tensor(x).to(device=dev, dtype=dtype)

        return dataclasses.replace(
            self,
            src=put(self.src, torch.int64).reshape(-1),
            count=put(self.count, torch.int32),
            dst=put(self.dst, torch.int64),
            val=None if self.val is None else put(self.val, torch.float32).reshape(-1),
            edge_perm=None if self.edge_perm is None else put(self.edge_perm, torch.int64),
        )


def _pad_tasks(arrs: dict, num_tasks: int, multiple: int) -> dict:
    """Pad the task axis of every array to a multiple (pad tasks have count
    0, destination 0 and value 0, so they add exact zeros to row 0)."""
    padded = -(-num_tasks // multiple) * multiple
    if padded == num_tasks:
        return arrs
    extra = padded - num_tasks
    return {
        k: None if v is None else np.pad(v, [(0, extra)] + [(0, 0)] * (v.ndim - 1))
        for k, v in arrs.items()
    }


def build_plan(
    src: np.ndarray,
    count: np.ndarray,
    dst: np.ndarray,
    val: Optional[np.ndarray],
    edge_perm: Optional[np.ndarray],
    num_nodes: int,
    n_src: int,
    block_size: int,
    num_edges: int,
    sorted_by_dst: bool,
    partition_starts: Tuple[int, ...],
    pad_multiple: int = 8,
) -> AggregationPlan:
    num_tasks = src.shape[0]
    arrs = _pad_tasks(dict(src=src, count=count, dst=dst, val=val), num_tasks, pad_multiple)
    return AggregationPlan(
        src=arrs["src"].astype(np.int32),
        count=arrs["count"].astype(np.int32),
        dst=arrs["dst"].astype(np.int32),
        val=None if arrs["val"] is None else arrs["val"].astype(np.float32),
        edge_perm=None if edge_perm is None else np.asarray(edge_perm, np.int32),
        num_nodes=num_nodes,
        n_src=n_src,
        block_size=block_size,
        num_tasks=num_tasks,
        num_edges=num_edges,
        sorted_by_dst=sorted_by_dst,
        partition_starts=tuple(int(x) for x in partition_starts),
    )
