"""Neighbor-grouping schedule: split every CSR row into tasks of at most B
edges, and ``nop_plan``, one task per row (port of
``gnn_computing_tpu/schedule/neighbor_grouping.py``)."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from gnn_computing_tpu_torch.graph.csr import CSRGraph
from gnn_computing_tpu_torch.schedule.plan import AggregationPlan, build_plan


def chunk_runs(
    run_start: np.ndarray,
    run_len: np.ndarray,
    run_dst: np.ndarray,
    block_size: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Split runs of consecutive edges sharing one destination into tasks of
    <= block_size edges.  Returns (task_start, task_count, task_dst,
    first_task_of_run); zero-length runs emit no tasks."""
    run_start = np.asarray(run_start, dtype=np.int64)
    run_len = np.asarray(run_len, dtype=np.int64)
    run_dst = np.asarray(run_dst, dtype=np.int64)

    keep = run_len > 0
    run_start, run_len, run_dst = run_start[keep], run_len[keep], run_dst[keep]

    tasks_per_run = -(-run_len // block_size)
    total = int(tasks_per_run.sum())
    first_task = np.zeros(len(run_len) + 1, dtype=np.int64)
    np.cumsum(tasks_per_run, out=first_task[1:])

    task_run = np.repeat(np.arange(len(run_len), dtype=np.int64), tasks_per_run)
    k = np.arange(total, dtype=np.int64) - first_task[task_run]
    task_start = run_start[task_run] + k * block_size
    task_count = np.minimum(block_size, run_len[task_run] - k * block_size)
    return task_start, task_count, run_dst[task_run], first_task


def gather_task_slots(
    edge_arr: np.ndarray,
    task_start: np.ndarray,
    task_count: np.ndarray,
    block_size: int,
    fill,
) -> np.ndarray:
    """Materialize [num_tasks, B] slots from a flat per-edge array."""
    num_edges = len(edge_arr)
    pos = task_start[:, None] + np.arange(block_size, dtype=np.int64)[None, :]
    valid = pos < (task_start + task_count)[:, None]
    pos = np.minimum(pos, max(num_edges - 1, 0))
    out = edge_arr[pos]
    out[~valid] = fill
    return out


def neighbor_grouping_plan(
    g: CSRGraph,
    block_size: int = 32,
    val: Optional[np.ndarray] = None,
    pad_multiple: int = 8,
) -> AggregationPlan:
    """Neighbor-grouping plan; edges without values weigh 1.0."""
    if val is None:
        val = g.val
    if val is None:
        val = np.ones(g.num_edges, np.float32)
    task_start, task_count, task_dst, _ = chunk_runs(
        g.indptr[:-1], g.degrees, np.arange(g.num_nodes), block_size
    )
    src = gather_task_slots(
        g.indices.astype(np.int64), task_start, task_count, block_size, 0
    ).astype(np.int32)
    vmat = gather_task_slots(
        np.asarray(val, np.float32), task_start, task_count, block_size, 0.0
    )
    return build_plan(
        src=src,
        count=task_count.astype(np.int32),
        dst=task_dst.astype(np.int32),
        val=vmat,
        edge_perm=None,
        num_nodes=g.num_nodes,
        n_src=g.n_src,
        block_size=block_size,
        num_edges=g.num_edges,
        sorted_by_dst=True,
        partition_starts=(0, len(task_start)),
        pad_multiple=pad_multiple,
    )


def nop_plan(g: CSRGraph, val: Optional[np.ndarray] = None, pad_multiple: int = 8) -> AggregationPlan:
    """One task per row, padded to the largest in-degree (B = max degree,
    at least 1): the reference's unscheduled row-per-warp path.  Only sane
    on bounded-degree graphs (fixed-size neighbor samples)."""
    return neighbor_grouping_plan(g, max(g.max_degree(), 1), val=val, pad_multiple=pad_multiple)
