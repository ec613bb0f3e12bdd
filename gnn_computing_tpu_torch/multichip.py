"""The multi-device dry run: one training step through every distributed
path, then the all-gather forward at ogbn-arxiv scale.

Port of ``__graft_entry__.dryrun_multichip``:

  (a) one full training step (forward, backward, Adam) of a 3-layer GCN,
      dims (32, 16, 8), whose loss differentiates through all three graph-
      parallel paths at toy scale (RMAT 64·D vertices / 512·D edges, seed
      7): the all-gather hybrid (its own padded graph and features), the
      ring hybrid and the gather ring (the shuffled ring graph's rows);
      loss = xent(all-gather logits) + 0.1 xent(ring-hybrid logits) +
      1e-3 mean(ring output²), each a mean over all (padded) rows;
  (b) the all-gather hybrid forward with the updated weights over RMAT at
      arxiv scale (169,343 v, 1,166,243 e, seed 11; [256, 128] tiles t16,
      residual 4, pack 8, f = 32).

Each rank computes its part of the loss over the rows it owns, divided by
the global row count, and the replicated weights' gradients are summed
over the graph axis once (``mesh.all_reduce_grads``); the step then equals
``jax.value_and_grad`` of the JAX dry run's loss.  ``dryrun_multichip``
spawns the world (gloo on the CPU, NCCL on cards, one rank a card);
``toy_problem``, ``train_step`` and ``arxiv_forward`` run inside any
world, and the ``*_bodies`` forms run all D rank bodies in one process
(what a one-card host can run at D > 1).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from gnn_computing_tpu_torch.device import resolve_device
from gnn_computing_tpu_torch.graph import normal_features, rmat_graph
from gnn_computing_tpu_torch.models.gcn import init_gcn_params
from gnn_computing_tpu_torch.parallel.allgather_tiles import (
    AllGatherHybrid,
    allgather_hybrid_gcn_forward,
    allgather_hybrid_gcn_forward_bodies,
    build_allgather_hybrid,
)
from gnn_computing_tpu_torch.parallel.launch import spawn_world
from gnn_computing_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce_grads,
    all_reduce_sum,
    make_mesh,
    shard_all,
    shard_rows,
)
from gnn_computing_tpu_torch.parallel.partition import RingPlan, build_ring_plan
from gnn_computing_tpu_torch.parallel.ring import ring_gcn_forward, ring_gcn_forward_bodies
from gnn_computing_tpu_torch.parallel.ring_tiles import (
    RingTilePlan,
    build_ring_hybrid,
    ring_hybrid_gcn_forward,
    ring_hybrid_gcn_forward_bodies,
)

TOY_DIMS = (32, 16, 8)
ARXIV = (169_343, 1_166_243)  # ogbn-arxiv's vertices and edges
ARXIV_PLAN = dict(tile_rows=256, tile_cols=128, threshold=16, residual_block=4, pack=8)
LR = 1e-3


@dataclasses.dataclass
class ToyProblem:
    """The dry run's training inputs over D shards (host arrays)."""

    ring: RingPlan  # gather ring over the shuffled graph
    rtp: RingTilePlan  # ring hybrid: tiles and residual ring
    hring: RingPlan
    tplan: AllGatherHybrid  # all-gather hybrid over its own padded graph
    h: np.ndarray  # [n, 32] rows of the ring graphs
    ht: np.ndarray  # [n_t, 32] rows of the all-gather graph
    labels: np.ndarray
    labels_t: np.ndarray
    num_devices: int


def toy_problem(d: int, graph_devices: Optional[int] = None) -> ToyProblem:
    """Plans and inputs of step (a) over ``d`` shards, the graph sized for
    ``graph_devices`` (default d): RMAT 64·D v / 512·D e, seed 7."""
    gd = graph_devices or d
    g = rmat_graph(64 * gd, 512 * gd, seed=7, with_val=False)
    ring, gp, _ = build_ring_plan(g, d, block_size=8, shuffle_seed=3)
    rtp, hring, gph = build_ring_hybrid(g, d, tile_rows=16, tile_cols=16, threshold=2)
    assert gph.num_nodes == gp.num_nodes
    tplan, tgp = build_allgather_hybrid(
        g, d, tile_rows=64, tile_cols=128, threshold=4, residual_block=4, pack=4, with_transpose=True
    )
    f = TOY_DIMS[0]
    return ToyProblem(
        ring=ring, rtp=rtp, hring=hring, tplan=tplan,
        h=normal_features(gp.num_nodes, f, seed=1), ht=normal_features(tgp.num_nodes, f, seed=2) * 0.1,
        labels=np.random.default_rng(0).integers(0, TOY_DIMS[-1], gp.num_nodes),
        labels_t=np.random.default_rng(1).integers(0, TOY_DIMS[-1], tgp.num_nodes),
        num_devices=d,
    )


def toy_params(device, weights=None) -> list:
    """The step's weights: copies of ``weights`` (numpy, e.g. the JAX dry
    run's; the optimizer updates the copies in place) or Glorot normals
    from a seeded generator."""
    dev = resolve_device(device)
    if weights is not None:
        return [torch.tensor(np.asarray(w, np.float32), device=dev, requires_grad=True) for w in weights]
    return init_gcn_params(TOY_DIMS, torch.Generator().manual_seed(0), device=dev)


def _loss_terms(logits_a, logits_r, ring_out, prob: ToyProblem, rows_a, rows_r, dev):
    """This rank's (or all ranks') part of the loss: sums over the given
    rows divided by the global counts."""
    n_t, n = prob.labels_t.shape[0], prob.labels.shape[0]
    lab_t = torch.as_tensor(prob.labels_t[rows_a]).to(dev)
    lab = torch.as_tensor(prob.labels[rows_r]).to(dev)
    xent = F.cross_entropy(logits_a, lab_t, reduction="sum") / n_t
    xent_r = F.cross_entropy(logits_r, lab, reduction="sum") / n
    aux = (ring_out**2).sum() / (n * ring_out.shape[1])
    return xent + 1e-1 * xent_r + 1e-3 * aux


def toy_forwards(mesh: Mesh, prob: ToyProblem, params, shards=None) -> tuple:
    """(all-gather logits, ring-hybrid logits, ring output) of this rank's
    rows.  ``shards``: this rank's plan parts (toy_shards), else made here."""
    tv, rt, hr, rg = shards or toy_shards(mesh, prob)
    h = shard_rows(mesh, torch.from_numpy(prob.h))
    ht = shard_rows(mesh, torch.from_numpy(prob.ht))
    return (
        allgather_hybrid_gcn_forward(mesh, tv, params, ht),
        ring_hybrid_gcn_forward(mesh, rt, hr, params, h),
        ring_gcn_forward(mesh, rg, params, h),
    )


def toy_shards(mesh: Mesh, prob: ToyProblem) -> tuple:
    r, dev = mesh.rank(), mesh.device
    return prob.tplan.shard(r, dev), prob.rtp.shard(r, dev), prob.hring.shard(r, dev), prob.ring.shard(r, dev)


def train_step(mesh: Mesh, prob: ToyProblem, params, opt: torch.optim.Optimizer, shards=None) -> tuple:
    """One Adam step of the dry run's loss; returns (global loss, this
    rank's copy of the summed weight gradients)."""
    opt.zero_grad(set_to_none=True)
    r, d = mesh.rank(), mesh.size()
    ns, nst = prob.labels.shape[0] // d, prob.labels_t.shape[0] // d
    logits_a, logits_r, ring_out = toy_forwards(mesh, prob, params, shards)
    local = _loss_terms(logits_a, logits_r, ring_out, prob, slice(r * nst, (r + 1) * nst), slice(r * ns, (r + 1) * ns),
                        mesh.device)
    local.backward()
    all_reduce_grads(mesh, params)
    grads = [p.grad.detach().clone() for p in params]
    opt.step()
    return float(all_reduce_sum(mesh, local)), grads


def toy_forwards_bodies(prob: ToyProblem, params, device) -> tuple:
    """toy_forwards over all rows, the D rank bodies in one process."""
    views, tiles, hrings, rings = (shard_all(p, device) for p in (prob.tplan, prob.rtp, prob.hring, prob.ring))
    h, ht = torch.from_numpy(prob.h).to(device), torch.from_numpy(prob.ht).to(device)
    return (
        allgather_hybrid_gcn_forward_bodies(views, params, ht),
        ring_hybrid_gcn_forward_bodies(tiles, hrings, params, h),
        ring_gcn_forward_bodies(rings, params, h),
    )


def toy_loss_bodies(prob: ToyProblem, params, device) -> torch.Tensor:
    """The dry run's global loss from the D rank bodies in one process."""
    a, r, g = toy_forwards_bodies(prob, params, device)
    return _loss_terms(a, r, g, prob, slice(None), slice(None), device)


def arxiv_forward(mesh: Mesh, params) -> torch.Tensor:
    """Step (b): this rank's rows of the all-gather forward at arxiv scale."""
    aplan = arxiv_plan(mesh.size())[0]
    ha = torch.from_numpy(arxiv_features(aplan.n_pad))
    with torch.no_grad():
        return allgather_hybrid_gcn_forward(mesh, aplan.shard(mesh.rank(), mesh.device), params,
                                            shard_rows(mesh, ha))


def arxiv_plan(d: int) -> tuple:
    """(plan, padded graph) of step (b) over d shards."""
    ga = rmat_graph(*ARXIV, seed=11, with_val=False)
    return build_allgather_hybrid(ga, d, **ARXIV_PLAN)


def arxiv_features(n_pad: int) -> np.ndarray:
    return normal_features(n_pad, TOY_DIMS[0], seed=3) * 0.1


def dryrun_rank(rank: int, world: int, device: str = "cpu", arxiv: bool = True) -> dict:
    """One rank of the dry run (module doc); returns its loss, summed
    weight gradients and, with ``arxiv``, its rows of step (b)."""
    dev = f"cuda:{rank}" if device == "cuda" else device
    if torch.device(dev).type == "cuda":
        torch.cuda.set_device(torch.device(dev))
    mesh = make_mesh(num_graph=world, device=dev)
    prob = toy_problem(world)
    params = toy_params(dev)
    opt = torch.optim.Adam(params, lr=LR)
    loss, grads = train_step(mesh, prob, params, opt)
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite dry-run loss {loss}")
    out = dict(loss=loss, grads=[g.cpu().numpy() for g in grads], params=[p.detach().cpu().numpy() for p in params])
    if arxiv:
        rows = arxiv_forward(mesh, params)
        if not bool(torch.isfinite(rows).all()):
            raise RuntimeError("non-finite all-gather forward at arxiv scale")
        out["arxiv_rows"] = rows.shape[0]
    return out


def dryrun_multichip(n_devices: int, device: str = "cuda", arxiv: bool = True, timeout: float = 900.0) -> list:
    """Spawn a world of ``n_devices`` processes (gloo on the CPU; NCCL over
    one card a rank) and run the dry run there; returns each rank's
    result (dryrun_rank)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and n_devices > torch.cuda.device_count():
        raise ValueError(f"NCCL runs one rank a card: {n_devices} ranks, {torch.cuda.device_count()} cards")
    backend = "nccl" if dev.type == "cuda" else "gloo"
    out = spawn_world(dryrun_rank, n_devices, dev.type, arxiv, backend=backend, timeout=timeout,
                      threads=None if dev.type == "cuda" else max(1, (torch.get_num_threads() // n_devices)))
    print(f"dryrun_multichip({n_devices}): {backend} world, loss={out[0]['loss']:.4f} OK", flush=True)
    return out


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_devices", type=int, nargs="?", default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--no-arxiv", action="store_true")
    a = ap.parse_args()
    dryrun_multichip(a.n_devices, a.device, arxiv=not a.no_arxiv)
