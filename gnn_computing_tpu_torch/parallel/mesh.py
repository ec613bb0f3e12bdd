"""Process meshes for graph-parallel (+ optional feature-parallel) execution.

Port of ``gnn_computing_tpu/parallel/mesh.py`` on ``torch.distributed``: one
process per rank, each holding its own shard.  ``make_mesh`` lays the world
out as the JAX package lays out its devices, a [num_graph, num_feature]
grid in rank order (rank = g * num_feature + f), and creates one process
group per axis line:

  "graph"   — vertex/edge shards: rank (g, f) owns rows g of the node
              features and outputs (the all-gather, ring shifts and the
              weight-gradient sum run along this axis);
  "feature" — feature-dimension tensor parallelism (``psum`` runs here).

``shard_rows``, ``shard_ring_plan`` and ``replicated`` replace the JAX
``NamedSharding``s: they return the rank's own part on the mesh's device.

The collectives carry their gradients as the JAX transposes do:
``all_gather_rows`` (``lax.all_gather(tiled=True)``) sums the cotangent's
rows over the ranks in its backward (a reduce-scatter, written as an
all-reduce and the rank's slice so gloo runs it too); ``ring_shift``
(``lax.ppermute`` to rank - 1) shifts the cotangent back to rank + 1;
``psum`` (``lax.psum``) sums the cotangents over the ranks, or passes
each through where every rank uses the sum alike (a replicated output
that each rank takes the same loss over).  Replicated weights
used on every rank get their gradient summed once over the graph axis
(``all_reduce_grads``), with each rank's loss taken over the rows it owns.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from gnn_computing_tpu_torch.device import resolve_device

GRAPH_AXIS = "graph"
FEATURE_AXIS = "feature"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place on a [num_graph, num_feature] grid of processes."""

    groups: dict  # axis -> process group of this rank's line along it
    ranks: dict  # axis -> this rank's index along it
    sizes: dict  # axis -> the axis' length
    device: torch.device

    def rank(self, axis: str = GRAPH_AXIS) -> int:
        return self.ranks[axis]

    def size(self, axis: str = GRAPH_AXIS) -> int:
        return self.sizes[axis]

    def group(self, axis: str = GRAPH_AXIS):
        return self.groups[axis]

    def peer(self, axis: str, index: int) -> int:
        """The global rank of index ``index`` along ``axis`` (as seen from
        this rank's line)."""
        return dist.get_global_rank(self.groups[axis], index % self.sizes[axis])


def make_mesh(
    num_graph: Optional[int] = None,
    num_feature: int = 1,
    device="cuda",
    backend: Optional[str] = None,
) -> Optional[Mesh]:
    """The mesh over the first num_graph * num_feature ranks of the
    initialized world (every rank of the world must call it: group creation
    is collective).  Ranks outside the mesh get None.  ``backend`` gives
    the axis groups another backend than the world's (a gloo mesh for CPU
    tensors inside an NCCL world)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed.init_process_group first (see parallel.launch)")
    world = dist.get_world_size()
    if num_graph is None:
        num_graph = world // num_feature
    if num_graph < 1 or num_graph * num_feature > world:
        raise ValueError(f"a [{num_graph}, {num_feature}] mesh does not fit a world of {world}")
    dev = resolve_device(device)
    me = dist.get_rank()
    mine = {}
    lines = {
        GRAPH_AXIS: [[g * num_feature + f for g in range(num_graph)] for f in range(num_feature)],
        FEATURE_AXIS: [[g * num_feature + f for f in range(num_feature)] for g in range(num_graph)],
    }
    for axis, axis_lines in lines.items():
        for ranks in axis_lines:
            if len(ranks) == world and backend is None:
                group = dist.group.WORLD
            else:
                group = dist.new_group(ranks, backend=backend)
            if me in ranks:
                mine[axis] = (group, ranks.index(me), len(ranks))
    if len(mine) < 2:
        return None
    return Mesh(
        groups={a: v[0] for a, v in mine.items()},
        ranks={a: v[1] for a, v in mine.items()},
        sizes={a: v[2] for a, v in mine.items()},
        device=dev,
    )


def shard_rows(mesh: Mesh, x: torch.Tensor, axis: str = GRAPH_AXIS) -> torch.Tensor:
    """Rows of ``x`` [n, ...] that this rank owns along ``axis`` (n must
    split evenly), on the mesh's device."""
    d = mesh.size(axis)
    if x.shape[0] % d:
        raise ValueError(f"{x.shape[0]} rows do not split over {d} ranks")
    ns = x.shape[0] // d
    r = mesh.rank(axis)
    return x[r * ns : (r + 1) * ns].to(mesh.device)


def shard_ring_plan(mesh: Mesh, plan):
    """This rank's part of a plan stacked over the graph axis (a RingPlan,
    RingTilePlan or AllGatherHybrid), on the mesh's device."""
    return plan.shard(mesh.rank(GRAPH_AXIS), mesh.device)


def shard_all(plan, device) -> list:
    """Every rank's part of a plan stacked over the graph axis, all on one
    ``device``: what the ``*_bodies`` forms take.  Shard once and reuse the
    parts: a shard is a copy to the device."""
    return [plan.shard(r, device) for r in range(plan.num_devices)]


def replicated(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    return x.to(mesh.device)


# ------------------------------------------------------------- collectives
class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, rank):
        ctx.group, ctx.rank, ctx.rows = group, rank, x.shape[0]
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, ct):
        ct = ct.contiguous().clone()
        dist.all_reduce(ct, group=ctx.group)
        return ct[ctx.rank * ctx.rows : (ctx.rank + 1) * ctx.rows], None, None, None


def all_gather_rows(mesh: Mesh, x: torch.Tensor, axis: str = GRAPH_AXIS) -> torch.Tensor:
    """``lax.all_gather(x, axis, axis=0, tiled=True)``: every rank's rows in
    rank order; its backward sums the cotangent over the ranks and keeps
    this rank's rows."""
    return _AllGatherRows.apply(x, mesh.group(axis), mesh.size(axis), mesh.rank(axis))


def _shift(x: torch.Tensor, to: int, frm: int, group) -> torch.Tensor:
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x.contiguous(), to, group), dist.P2POp(dist.irecv, out, frm, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        r = mesh.rank(axis)
        return _shift(x, mesh.peer(axis, r - 1), mesh.peer(axis, r + 1), mesh.group(axis))

    @staticmethod
    def backward(ctx, ct):
        mesh, axis = ctx.mesh, ctx.axis
        r = mesh.rank(axis)
        return _shift(ct, mesh.peer(axis, r + 1), mesh.peer(axis, r - 1), mesh.group(axis)), None, None


def ring_shift(mesh: Mesh, x: torch.Tensor, axis: str = GRAPH_AXIS) -> torch.Tensor:
    """``lax.ppermute`` with perm [(i, i - 1)]: this rank sends ``x`` to rank
    r - 1 and returns what rank r + 1 sent (so at ring step s it holds
    shard (r + s) mod D); the backward shifts the cotangent the other way.
    On one rank it returns ``x``."""
    if mesh.size(axis) == 1:
        return x
    return _RingShift.apply(x, mesh, axis)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, same_use):
        ctx.group, ctx.same_use = group, same_use
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, ct):
        if ctx.same_use:
            return ct, None, None
        ct = ct.contiguous().clone()
        dist.all_reduce(ct, group=ctx.group)
        return ct, None, None


def psum(mesh: Mesh, x: torch.Tensor, axis: str = FEATURE_AXIS, same_use: bool = False) -> torch.Tensor:
    """``lax.psum`` of per-rank partials.  The backward sums the cotangents
    over the ranks: each rank may use the sum differently downstream (its
    own column slice, say), so the sum's cotangent is the sum of the
    ranks' parts.  ``same_use=True`` is for a sum every rank then uses
    alike, such as the replicated output that each rank takes the same loss
    over: there each rank's cotangent already is the whole one and passes
    through unchanged."""
    return _Psum.apply(x, mesh.group(axis), same_use)


def all_reduce_sum(mesh: Mesh, x: torch.Tensor, axis: str = GRAPH_AXIS) -> torch.Tensor:
    """Sum of a (non-differentiated) tensor over the ranks of ``axis``."""
    out = x.detach().contiguous().clone()
    dist.all_reduce(out, group=mesh.group(axis))
    return out


def all_reduce_grads(mesh: Mesh, params, axis: str = GRAPH_AXIS) -> None:
    """Sum the gradients of replicated parameters over the ranks of ``axis``
    in place, once (each rank's backward gave the part of its own rows)."""
    for p in params:
        if p.grad is not None:
            dist.all_reduce(p.grad, group=mesh.group(axis))
