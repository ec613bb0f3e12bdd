"""The port's all-gather hybrid (``parallel.allgather_tiles``: one
all-gather, then B1 over each rank's tile groups and the residual gather)
against the JAX package's on its 8-device virtual CPU mesh.

The port runs in one gloo world of 4 spawned processes for the module
(``torch_parallel_ranks.allgather_cases``; D = 2 on its first two ranks),
where B1 is its plain version (CPU tensors).  Tolerances: host plans
array-equal (groups, local/halo split, 1-bit groups, pack padding, the
residual's buckets); forwards within 1e-5 * max|jax| and under the repo
gate against the float64 oracle; gradients (through the all-gather and B1
over the groups' transposes) within 1e-4 relative L2 of ``jax.grad``; the
D rank bodies in one process within 1e-6 * max|world| of the world.  The
JAX package's million-edge case (tests/test_allgather_tiles.py) runs on
the card only (chip_smoke.py phase 53)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_computing_tpu.graph.synthetic import rmat_graph as j_rmat_graph
from gnn_computing_tpu.parallel.allgather_tiles import allgather_hybrid_gcn_forward as j_gcn_forward
from gnn_computing_tpu.parallel.allgather_tiles import allgather_hybrid_spmm as j_spmm
from gnn_computing_tpu.parallel.allgather_tiles import build_allgather_hybrid as j_build
from gnn_computing_tpu.parallel.mesh import make_mesh as j_make_mesh
from gnn_computing_tpu.parallel.mesh import shard_ring_plan as j_shard_ring_plan

from gnn_computing_tpu_torch.graph import normal_features, rmat_graph
from gnn_computing_tpu_torch.models.gcn import glorot_weights
from gnn_computing_tpu_torch.ops.reference import spmm_dense
from gnn_computing_tpu_torch.parallel.allgather_tiles import (
    allgather_hybrid_gcn_forward_bodies,
    allgather_hybrid_spmm_bodies,
    build_allgather_hybrid,
)
from gnn_computing_tpu_torch.parallel.launch import spawn_world

import torch_parallel_ranks as ranks
from test_torch_parallel import _check_grads, _jax_forward_and_grads, eq, gcn_oracle, grads, rows, sharded
from test_torch_spmm import jax_native_from_port  # noqa: F401
from test_torch_spmm_gather import close

# (graph, build keywords) of the plan-equality cases: 1-bit and int8 groups
# over a multigraph, no local split at pack 4, int8 tiles alone
PLAN_CASES = [
    ((3000, 80000, 9), dict(tile_rows=64, tile_cols=128, threshold=4)),
    ((3000, 80000, 9), dict(tile_rows=64, tile_cols=128, threshold=4, local_split=False, pack=4)),
    ((3000, 60000, 7), dict(tile_rows=64, tile_cols=128, threshold=4, bit_tiles=False)),
]


@pytest.fixture(scope="module")
def world():
    return spawn_world(ranks.allgather_cases, 4, timeout=600)


def padded_h(g, gp, f, seed):
    h = np.zeros((gp.num_nodes, f), np.float32)
    h[: g.num_nodes] = normal_features(g.num_nodes, f, seed=seed) * 0.1
    return h


@pytest.mark.parametrize("d", [1, 2, 4])
@pytest.mark.parametrize("case", range(len(PLAN_CASES)))
def test_plans_equal_jax(d, case):
    (n, m, seed), kw = PLAN_CASES[case]
    plan, gp = build_allgather_hybrid(rmat_graph(n, m, seed=seed, with_val=False), d, **kw)
    jplan, jgp = j_build(j_rmat_graph(n, m, seed=seed, with_val=False), d, **kw)
    assert len(plan.groups) == len(jplan.groups)
    for grp, jgrp in zip(plan.groups, jplan.groups):
        assert (grp.bits, grp.local, grp.pack, grp.tile_rows, grp.tile_cols) == (
            jgrp.bits, jgrp.local, jgrp.pack, jgrp.tile_rows, jgrp.tile_cols)
        for f in ("a", "row", "col"):
            eq(getattr(grp, f), getattr(jgrp, f), f"group {f}")
    for f in ("rsrc", "rcnt", "rdst", "rval", "lsrc", "lcnt", "ldst", "lval"):
        if getattr(jplan, f) is None:
            assert getattr(plan, f) is None, f
        else:
            eq(getattr(plan, f), getattr(jplan, f), f)
    for f in ("num_devices", "shard_size", "n_pad", "block_size", "num_edges", "num_res_edges"):
        assert getattr(plan, f) == getattr(jplan, f), f
    assert plan.stats() == jplan.stats() and gp.num_nodes == jgp.num_nodes
    if case == 0:
        assert any(g.bits for g in plan.groups) and any(not g.bits for g in plan.groups)


def test_transposed_groups_are_the_groups_transposed():
    """with_transpose: each owner's transposed plan holds the owner's
    group's cells with rows and columns swapped (the 1-bit format kept);
    neither holds an all-zero tile."""
    plan, _ = build_allgather_hybrid(rmat_graph(3000, 80000, seed=9, with_val=False), 2, tile_rows=64,
                                     tile_cols=128, threshold=4, with_transpose=True)
    for grp in plan.groups:
        for r in range(2):
            fwd, tr = grp.owner_plan(r, plan.shard_size, plan.n_pad), grp.transposed[r]
            assert tr.bits == grp.bits and (tr.num_nodes, tr.n_src) == (fwd.n_src, fwd.num_nodes)
            for p in (fwd, tr):  # the plans the port runs: no all-zero tile, pack 1
                assert p.pack == 1 and np.asarray(p.a).reshape(p.num_tiles, -1).any(axis=1).all()
            dense = np.zeros((fwd.num_nodes, fwd.n_src), np.int64)
            dense_t = np.zeros((tr.num_nodes, tr.n_src), np.int64)
            for p, out in ((fwd, dense), (tr, dense_t)):
                c = np.asarray(p.counts()).astype(np.int64)
                for t in range(p.num_tiles):
                    r0, c0 = p.tile_row[t] * p.tile_rows, p.tile_col[t] * p.tile_cols
                    out[r0 : r0 + p.tile_rows, c0 : c0 + p.tile_cols] += c[t]
            assert np.array_equal(dense.T, dense_t)


@pytest.mark.parametrize("d", [2, 4])
def test_spmm_matches_jax(world, d):
    g, gj = rmat_graph(3000, 60000, seed=7, with_val=False), j_rmat_graph(3000, 60000, seed=7, with_val=False)
    _, gp = build_allgather_hybrid(g, d, tile_rows=64, tile_cols=128, threshold=4, residual_block=4)
    h = padded_h(g, gp, 16, 1)
    mesh = j_make_mesh(num_graph=d)
    jplan, _ = j_build(gj, d, tile_rows=64, tile_cols=128, threshold=4, residual_block=4)
    want = jax.jit(lambda p, x: j_spmm(mesh, p, x))(jplan.device_put(j_shard_ring_plan(mesh)), *sharded(mesh, h))
    close(rows(world, f"spmm{d}", d), want, f"all-gather spmm d={d}", ref=spmm_dense(gp, h))


def test_bit_tile_groups_match_jax(world):
    g, gj = rmat_graph(3000, 80000, seed=9, with_val=False), j_rmat_graph(3000, 80000, seed=9, with_val=False)
    _, gp = build_allgather_hybrid(g, 4, tile_rows=64, tile_cols=128, threshold=4, bit_tiles=True)
    h = padded_h(g, gp, 32, 2)
    mesh = j_make_mesh(num_graph=4)
    jplan, _ = j_build(gj, 4, tile_rows=64, tile_cols=128, threshold=4, bit_tiles=True)
    want = j_spmm(mesh, jplan.device_put(j_shard_ring_plan(mesh)), *sharded(mesh, h))
    close(rows(world, "bits", 4), want, "all-gather bit tiles", ref=spmm_dense(gp, h))


def test_gcn_forward_and_grads_match_jax(world):
    g, gj = rmat_graph(2000, 40000, seed=3, with_val=False), j_rmat_graph(2000, 40000, seed=3, with_val=False)
    _, gp = build_allgather_hybrid(g, 4, tile_rows=64, tile_cols=128, threshold=4)
    h = padded_h(g, gp, ranks.AG_DIMS[0], 5)
    ws = glorot_weights(ranks.AG_DIMS, seed=4)
    mesh = j_make_mesh(num_graph=4)
    jplan, _ = j_build(gj, 4, tile_rows=64, tile_cols=128, threshold=4)
    jplan = jplan.device_put(j_shard_ring_plan(mesh))
    ct = jnp.asarray(ranks.cotangent(gp.num_nodes, ranks.AG_DIMS[-1], 34))
    want, jg = jax.jit(lambda w, x: _jax_forward_and_grads(
        lambda ww, xx: j_gcn_forward(mesh, jplan, ww, xx), w, [x], ct))([jnp.asarray(w) for w in ws], *sharded(mesh, h))
    close(rows(world, "gcn", 4), want, "all-gather gcn", ref=gcn_oracle(gp, h, ws))
    _check_grads(grads(world, "gcn_grads", 4, 1), jg, "all-gather gcn")


def test_bodies_equal_world(world):
    def same(got, key, d):
        want = rows(world, key, d)
        got = got.detach().numpy()
        assert got.shape == want.shape and np.abs(got - want).max() <= 1e-6 * np.abs(want).max(), key

    g = rmat_graph(3000, 60000, seed=7, with_val=False)
    for d in (2, 4):
        plan, gp = build_allgather_hybrid(g, d, tile_rows=64, tile_cols=128, threshold=4, residual_block=4)
        views = [plan.shard(r, "cpu") for r in range(d)]
        same(allgather_hybrid_spmm_bodies(views, torch.from_numpy(padded_h(g, gp, 16, 1))), f"spmm{d}", d)
    g = rmat_graph(2000, 40000, seed=3, with_val=False)
    plan, gp = build_allgather_hybrid(g, 4, tile_rows=64, tile_cols=128, threshold=4)
    ws = [torch.from_numpy(w) for w in glorot_weights(ranks.AG_DIMS, seed=4)]
    views = [plan.shard(r, "cpu") for r in range(4)]
    same(allgather_hybrid_gcn_forward_bodies(views, ws, torch.from_numpy(padded_h(g, gp, ranks.AG_DIMS[0], 5))),
         "gcn", 4)
