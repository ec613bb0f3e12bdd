"""Locality-aware schedule (port of ``gnn_computing_tpu/schedule/locality.py``).

Edges are visited in partitions of the source id space, so the rows one
partition gathers stay in cache: the edges are permuted partition-major by
a stable sort (row-major within a partition, the reference's par -> row ->
edge loop order), cut into runs of one (partition, destination), and each
run into tasks of at most B edges.  ``block_size=None`` is plain locality
scheduling: one task per run, B the longest run.  The plan carries the
permutation (``edge_perm``: scheduled edge -> CSR edge) and the task index
where each partition starts (``partition_starts``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from gnn_computing_tpu_torch.graph.csr import CSRGraph
from gnn_computing_tpu_torch.schedule.neighbor_grouping import chunk_runs, gather_task_slots
from gnn_computing_tpu_torch.schedule.plan import AggregationPlan, build_plan


def source_partition_of(src: np.ndarray, n_src: int, num_partitions: int) -> np.ndarray:
    """Partition id per edge: equal ranges of the source ids, the last
    partition taking the remainder."""
    width = max(n_src // num_partitions, 1)
    return np.minimum(src // width, num_partitions - 1).astype(np.int32)


def locality_plan(
    g: CSRGraph,
    num_partitions: int,
    block_size: Optional[int] = 32,
    val: Optional[np.ndarray] = None,
    pad_multiple: int = 8,
) -> AggregationPlan:
    """Locality schedule; an int ``block_size`` caps the task size
    (locality + neighbor grouping), None takes the longest run."""
    if val is None:
        val = g.val
    m = g.num_edges
    src_all = g.indices.astype(np.int64)
    dst_all = g.dst_per_edge.astype(np.int64)

    part = source_partition_of(src_all, g.n_src, num_partitions)
    perm = np.argsort(part, kind="stable").astype(np.int64)
    s_src, s_dst, s_part = src_all[perm], dst_all[perm], part[perm]
    s_val = np.ones(m, np.float32) if val is None else np.asarray(val, np.float32)[perm]

    # runs: maximal spans of one (partition, destination)
    if m == 0:
        boundaries = np.zeros(1, dtype=np.int64)
    else:
        change = np.flatnonzero((np.diff(s_dst) != 0) | (np.diff(s_part) != 0))
        boundaries = np.concatenate(([0], change + 1, [m])).astype(np.int64)
    run_start = boundaries[:-1]
    run_len = np.diff(boundaries)
    run_dst = s_dst[run_start] if m else np.zeros(0, dtype=np.int64)

    if block_size is None:
        block_size = int(run_len.max()) if len(run_len) else 1

    task_start, task_count, task_dst, _ = chunk_runs(run_start, run_len, run_dst, block_size)
    src = gather_task_slots(s_src, task_start, task_count, block_size, 0).astype(np.int32)
    vmat = gather_task_slots(s_val, task_start, task_count, block_size, 0.0)

    # tasks are partition-major: partition boundaries in task space
    task_part = (
        source_partition_of(src[:, 0].astype(np.int64), g.n_src, num_partitions)
        if len(task_start)
        else np.zeros(0, np.int32)
    )
    starts = np.searchsorted(task_part, np.arange(num_partitions + 1), side="left")
    return build_plan(
        src=src,
        count=task_count.astype(np.int32),
        dst=task_dst.astype(np.int32),
        val=vmat,
        edge_perm=perm.astype(np.int32),
        num_nodes=g.num_nodes,
        n_src=g.n_src,
        block_size=block_size,
        num_edges=m,
        sorted_by_dst=False,  # sorted within partitions only
        partition_starts=tuple(int(x) for x in starts),
        pad_multiple=pad_multiple,
    )


def locality_neighbor_grouping_plan(
    g: CSRGraph,
    num_partitions: int,
    block_size: int = 32,
    val: Optional[np.ndarray] = None,
    pad_multiple: int = 8,
) -> AggregationPlan:
    """locality_plan under the reference's combined-schedule name."""
    return locality_plan(g, num_partitions, block_size, val=val, pad_multiple=pad_multiple)
