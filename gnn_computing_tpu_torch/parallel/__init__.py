"""Multi-device execution on torch.distributed (port of
``gnn_computing_tpu/parallel``): meshes of processes, ring and all-gather
graph parallelism, feature parallelism, and a launcher for worlds of
processes (``parallel.launch.spawn_world``)."""

from gnn_computing_tpu_torch.parallel.mesh import (
    FEATURE_AXIS,
    GRAPH_AXIS,
    Mesh,
    make_mesh,
    replicated,
    shard_ring_plan,
    shard_rows,
)
from gnn_computing_tpu_torch.parallel.partition import RingPlan, build_ring_plan, pad_to_shards
from gnn_computing_tpu_torch.parallel.ring import ring_gcn_forward, ring_gcn_layer, ring_spmm

__all__ = [
    "make_mesh",
    "shard_rows",
    "shard_ring_plan",
    "replicated",
    "GRAPH_AXIS",
    "FEATURE_AXIS",
    "Mesh",
    "RingPlan",
    "build_ring_plan",
    "pad_to_shards",
    "ring_spmm",
    "ring_gcn_layer",
    "ring_gcn_forward",
]
