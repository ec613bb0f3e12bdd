"""Rank bodies of the port's multi-device tests, run inside gloo worlds
(``parallel.launch.spawn_world``).  This module imports torch, numpy and
the port only: the spawned ranks import it by name, never a test module
(those import JAX).

Each ``*_cases(rank, world)`` runs every case of one test module on one
world of 4 ranks (D = 2 cases on a mesh of its first two ranks) and
returns {case: this rank's rows (numpy), or gradients}; the test modules
stack the ranks' rows and hold them against the JAX package.  Inputs are
numpy-seeded, the same the tests give the JAX side."""

from __future__ import annotations

import os

import numpy as np
import torch

from gnn_computing_tpu_torch.aggregator import Aggregator
from gnn_computing_tpu_torch.graph import normal_features, rmat_graph
from gnn_computing_tpu_torch.models.gcn import glorot_weights
from gnn_computing_tpu_torch.parallel import make_mesh, shard_rows
from gnn_computing_tpu_torch.parallel.allgather_tiles import (
    allgather_hybrid_gcn_forward,
    allgather_hybrid_spmm,
    build_allgather_hybrid,
)
from gnn_computing_tpu_torch.parallel.feature_parallel import (
    feature_sharded_gcn_forward,
    shard_features,
    shard_w_rows,
)
from gnn_computing_tpu_torch.parallel.mesh import FEATURE_AXIS, all_reduce_grads
from gnn_computing_tpu_torch.parallel.partition import build_ring_plan
from gnn_computing_tpu_torch.parallel.ring import ring_gcn_forward, ring_spmm
from gnn_computing_tpu_torch.parallel.ring_tiles import (
    build_ring_hybrid,
    ring_hybrid_gat,
    ring_hybrid_gcn_forward,
    ring_hybrid_spmm,
)

RING_DIMS = (24, 16, 8)
AG_DIMS = (16, 16, 8)
FP_DIMS = (64, 32, 16)


def cotangent(n: int, f: int, seed: int) -> np.ndarray:
    """The fixed output cotangent of a gradient case: loss = sum(out * ct)."""
    return np.random.default_rng(seed).standard_normal((n, f)).astype(np.float32)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def _grads(mesh, out_local, ct, inputs, weights, sum_weights=True) -> list:
    """d(sum(out * ct)) of this rank's inputs and the weights (summed over
    the graph axis when they are replicated)."""
    (out_local * shard_rows(mesh, _t(ct))).sum().backward()
    if sum_weights:
        all_reduce_grads(mesh, weights)
    return [x.grad.numpy() for x in inputs] + [w.grad.numpy() for w in weights]


def _leaf(x: np.ndarray) -> torch.Tensor:
    return _t(x).clone().requires_grad_(True)


def ring_cases(rank: int, world: int) -> dict:
    out = {}
    g = rmat_graph(200, 2000, seed=7)  # tests/conftest.py small_rmat
    gu = rmat_graph(200, 2000, seed=7, with_val=False)
    for d in (2, 4):
        mesh = make_mesh(num_graph=d, device="cpu")
        if mesh is None:
            continue
        ring, gp, _ = build_ring_plan(g, d, block_size=8)
        out[f"ring_spmm{d}"] = ring_spmm(mesh, ring, shard_rows(mesh, _t(normal_features(gp.num_nodes, 16, seed=1)))).numpy()
        rtp, hring, gph = build_ring_hybrid(g, d, tile_rows=16, tile_cols=16, threshold=2, residual_block=8)
        h = shard_rows(mesh, _t(normal_features(gph.num_nodes, 16, seed=4)))
        out[f"ring_hybrid_spmm{d}"] = ring_hybrid_spmm(mesh, rtp, hring, h).numpy()
        if d != 4:
            continue
        ring, gp, _ = build_ring_plan(g, d, block_size=8, shuffle_seed=9)
        out["ring_shuffled"] = ring_spmm(mesh, ring, shard_rows(mesh, _t(normal_features(gp.num_nodes, 8, seed=2)))).numpy()
        # GCN forwards and gradients
        ring, gp, _ = build_ring_plan(g, d, block_size=8)
        n = gp.num_nodes
        ws = [_leaf(w) for w in glorot_weights(RING_DIMS, seed=0)]
        x = _leaf(shard_rows(mesh, _t(normal_features(n, RING_DIMS[0], seed=3) * 0.1)).numpy())
        y = ring_gcn_forward(mesh, ring, ws, x)
        out["ring_gcn"] = y.detach().numpy()
        out["ring_gcn_grads"] = _grads(mesh, y, cotangent(n, RING_DIMS[-1], 31), [x], ws)
        ws = [_leaf(w) for w in glorot_weights(RING_DIMS, seed=0)]
        x = _leaf(shard_rows(mesh, _t(normal_features(gph.num_nodes, RING_DIMS[0], seed=5) * 0.1)).numpy())
        y = ring_hybrid_gcn_forward(mesh, rtp, hring, ws, x)
        out["ring_hybrid_gcn"] = y.detach().numpy()
        out["ring_hybrid_gcn_grads"] = _grads(mesh, y, cotangent(gph.num_nodes, RING_DIMS[-1], 32), [x], ws)
        # GAT over count tiles, with the gradients of h and att
        rtp, hring, gpu = build_ring_hybrid(gu, d, tile_rows=16, tile_cols=16, threshold=2)
        hh = _leaf(shard_rows(mesh, _t(normal_features(gpu.num_nodes, 16, seed=6))).numpy())
        att = _leaf(shard_rows(mesh, _t(normal_features(gpu.num_nodes, 2, seed=7) * 0.3)).numpy())
        y = ring_hybrid_gat(mesh, rtp, hring, hh, att)
        out["ring_hybrid_gat"] = y.detach().numpy()
        out["ring_hybrid_gat_grads"] = _grads(mesh, y, cotangent(gpu.num_nodes, 16, 33), [hh, att], [])
    return out


def allgather_cases(rank: int, world: int) -> dict:
    out = {}
    g = rmat_graph(3000, 60000, seed=7, with_val=False)
    for d in (2, 4):
        mesh = make_mesh(num_graph=d, device="cpu")
        if mesh is None:
            continue
        plan, gp = build_allgather_hybrid(g, d, tile_rows=64, tile_cols=128, threshold=4, residual_block=4)
        h = np.zeros((gp.num_nodes, 16), np.float32)
        h[: g.num_nodes] = normal_features(g.num_nodes, 16, seed=1) * 0.1
        out[f"spmm{d}"] = allgather_hybrid_spmm(mesh, plan, shard_rows(mesh, _t(h))).numpy()
        if d != 4:
            continue
        gb = rmat_graph(3000, 80000, seed=9, with_val=False)  # a multigraph: 1-bit and int8 groups
        plan, gp = build_allgather_hybrid(gb, d, tile_rows=64, tile_cols=128, threshold=4, bit_tiles=True)
        h = np.zeros((gp.num_nodes, 32), np.float32)
        h[: gb.num_nodes] = normal_features(gb.num_nodes, 32, seed=2) * 0.1
        out["bits"] = allgather_hybrid_spmm(mesh, plan, shard_rows(mesh, _t(h))).numpy()
        # GCN forward and gradients through the collective, B1's transposes
        gg = rmat_graph(2000, 40000, seed=3, with_val=False)
        plan, gp = build_allgather_hybrid(gg, d, tile_rows=64, tile_cols=128, threshold=4, with_transpose=True)
        h = np.zeros((gp.num_nodes, AG_DIMS[0]), np.float32)
        h[: gg.num_nodes] = normal_features(gg.num_nodes, AG_DIMS[0], seed=5) * 0.1
        ws = [_leaf(w) for w in glorot_weights(AG_DIMS, seed=4)]
        x = _leaf(shard_rows(mesh, _t(h)).numpy())
        y = allgather_hybrid_gcn_forward(mesh, plan, ws, x)
        out["gcn"] = y.detach().numpy()
        out["gcn_grads"] = _grads(mesh, y, cotangent(gp.num_nodes, AG_DIMS[-1], 34), [x], ws)
    return out


def feature_cases(rank: int, world: int) -> dict:
    out = {}
    g = rmat_graph(1536, 30000, seed=3, with_val=False)
    agg = Aggregator.schedule_hybrid(g, tile_rows=256, threshold=8, residual_block=4, tile_dtype=np.int8,
                                     with_transpose=True, device="cpu")
    h = normal_features(g.num_nodes, FP_DIMS[0], seed=1) * 0.1
    for d in (2, 4):
        mesh = make_mesh(num_graph=1, num_feature=d, device="cpu")
        if mesh is None:
            continue
        ws = [_leaf(shard_w_rows(mesh, _t(w)).numpy()) for w in glorot_weights(FP_DIMS, seed=2)]
        x = _leaf(shard_features(mesh, _t(h)).numpy())
        y = feature_sharded_gcn_forward(mesh, agg, ws, x)
        out[f"forward{d}"] = y.detach().numpy()
        # every rank holds the full output: the loss is taken once, alike
        (y * _t(cotangent(g.num_nodes, FP_DIMS[-1], 35))).sum().backward()
        out[f"grads{d}"] = [x.grad.numpy()] + [w.grad.numpy() for w in ws]
        out[f"feature_rank{d}"] = mesh.rank(FEATURE_AXIS)
    return out


def multichip_cases(rank: int, world: int, weights) -> dict:
    from gnn_computing_tpu_torch import multichip
    from gnn_computing_tpu_torch.parallel.mesh import all_gather_rows

    out = {}
    for d in (2, 4):
        mesh = make_mesh(num_graph=d, device="cpu")
        if mesh is None:
            continue
        prob = multichip.toy_problem(d)
        params = multichip.toy_params("cpu", weights)
        shards = multichip.toy_shards(mesh, prob)
        # the sides of 0 the step's first-layer pre-activations take (the
        # same ops on the same inputs as the step's forward)
        tv, rt, hr, rg = shards
        w1 = params[0].detach()
        h, ht = shard_rows(mesh, _t(prob.h)), shard_rows(mesh, _t(prob.ht))
        with torch.no_grad():
            sides = [
                allgather_hybrid_spmm(mesh, tv, ht @ w1), ring_hybrid_spmm(mesh, rt, hr, h @ w1),
                ring_spmm(mesh, rg, h @ w1),
            ]
            sides = [all_gather_rows(mesh, z).numpy() > 0 for z in sides]
        opt = torch.optim.Adam(params, lr=multichip.LR)
        loss, grads = multichip.train_step(mesh, prob, params, opt, shards)
        out[f"step{d}"] = dict(loss=loss, grads=[g.numpy() for g in grads], relu_sides=sides)
    return out


def rank_one_exits(rank: int, world: int) -> int:
    """Rank 1 ends its process without a result; the others return theirs."""
    if rank == 1:
        os._exit(3)
    return rank
