"""Ring-overlap distributed aggregation (one rank a process, ring shifts).

Port of ``gnn_computing_tpu/parallel/ring.py``.  out = A @ H over a
destination-sharded graph as a D-step ring: at step s each rank aggregates
the edge group sourced from the feature shard it holds, (r + s) mod D, while
``mesh.ring_shift`` passes the buffer on to rank r - 1.  Step 0 aggregates
the rank's own edges, so most work needs no communication.  The JAX package
leaves the aggregation to XLA; here it is plain PyTorch (gather, per-task
sum, ``index_add``), differentiable through autograd and the shift's
reverse shift.

Each function exists in two forms: over a world (``mesh`` and this rank's
rows ``h_local``) and as ``*_bodies``, the D rank bodies run one after
another in one process on the full ``h``, each handed the shard the shift
would have brought at each step; they take every rank's plan part, made
once (``mesh.shard_all``).
"""

from __future__ import annotations

import torch

from gnn_computing_tpu_torch.parallel.mesh import GRAPH_AXIS, Mesh, ring_shift, shard_ring_plan
from gnn_computing_tpu_torch.parallel.partition import RingPlan, RingShard


def _local_ring_spmm(ring: RingShard, h_local: torch.Tensor, next_buffer) -> torch.Tensor:
    """One rank's body.  ``next_buffer(s, buf)`` returns the shard held at
    step s + 1 (the ring shift of ``buf``)."""
    d, b = ring.num_devices, ring.block_size
    f = h_local.shape[1]
    out = torch.zeros_like(h_local)
    buf = h_local
    for s in range(d):
        nxt = next_buffer(s, buf) if s + 1 < d else None
        msg = buf.index_select(0, ring.src[s]) * ring.val[s][:, None].to(buf.dtype)
        out = out.index_add(0, ring.dst[s], msg.reshape(-1, b, f).sum(dim=1))
        buf = nxt
    return out


def ring_spmm(mesh: Mesh, ring, h_local: torch.Tensor) -> torch.Tensor:
    """Distributed SpMM: ``h_local`` is this rank's [n_pad / D, f] rows;
    returns its rows of the output.  ``ring``: a RingPlan or this rank's
    RingShard."""
    if isinstance(ring, RingPlan):
        ring = shard_ring_plan(mesh, ring)
    return _local_ring_spmm(ring, h_local, lambda s, buf: ring_shift(mesh, buf, GRAPH_AXIS))


def ring_spmm_bodies(rings, h: torch.Tensor) -> torch.Tensor:
    """The D rank bodies of ring_spmm in one process over the full ``h``.
    ``rings``: every rank's RingShard in rank order (``mesh.shard_all``)."""
    d = len(rings)
    shards = h.split(rings[0].shard_size)
    return torch.cat([
        _local_ring_spmm(ring, shards[r], lambda s, buf, r=r: shards[(r + s + 1) % d]) for r, ring in enumerate(rings)
    ])


def gcn_layers(aggregate, params, h: torch.Tensor) -> torch.Tensor:
    """transform -> ``aggregate`` -> ReLU per layer, the last layer linear."""
    for i, w in enumerate(params):
        z = aggregate(h @ w)
        h = torch.relu(z) if i < len(params) - 1 else z
    return h


def ring_gcn_layer(mesh: Mesh, ring, h_local: torch.Tensor, w: torch.Tensor, activation=torch.relu) -> torch.Tensor:
    """Distributed GCN layer: the dense transform on this rank's rows (the
    weight replicated), ring aggregation, activation."""
    z = ring_spmm(mesh, ring, h_local @ w)
    return activation(z) if activation is not None else z


def ring_gcn_forward(mesh: Mesh, ring, params, h_local: torch.Tensor) -> torch.Tensor:
    if isinstance(ring, RingPlan):
        ring = shard_ring_plan(mesh, ring)
    return gcn_layers(lambda z: ring_spmm(mesh, ring, z), params, h_local)


def ring_gcn_forward_bodies(rings, params, h: torch.Tensor) -> torch.Tensor:
    return gcn_layers(lambda z: ring_spmm_bodies(rings, z), params, h)
