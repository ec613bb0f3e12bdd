"""The port's mesh, partition, gather ring and hybrid ring
(``gnn_computing_tpu_torch.parallel``: mesh, partition, ring, ring_tiles)
against the JAX package's ``parallel`` on its 8-device virtual CPU mesh.

The port runs in one gloo world of 4 spawned processes for the whole
module (``torch_parallel_ranks.ring_cases``; D = 2 on its first two
ranks); the JAX side runs here.  Tolerances: host plans array-equal;
forwards within 1e-5 * max|jax| (float32 summation order) and under the
repo gate (|y - ref| <= 1e-2*|ref| + 1e-5) against the float64 oracle;
gradients within 1e-4 relative L2 of ``jax.grad``; the D rank bodies run
in one process within 1e-6 * max|world| of the world (the same ops a rank,
in the same order)."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from gnn_computing_tpu.graph.synthetic import rmat_graph as j_rmat_graph
from gnn_computing_tpu.parallel import build_ring_plan as j_build_ring_plan
from gnn_computing_tpu.parallel import make_mesh as j_make_mesh
from gnn_computing_tpu.parallel import pad_to_shards as j_pad_to_shards
from gnn_computing_tpu.parallel import ring_gcn_forward as j_ring_gcn_forward
from gnn_computing_tpu.parallel import ring_spmm as j_ring_spmm
from gnn_computing_tpu.parallel import shard_ring_plan as j_shard_ring_plan
from gnn_computing_tpu.parallel import shard_rows as j_shard_rows
from gnn_computing_tpu.parallel.ring_tiles import build_ring_hybrid as j_build_ring_hybrid
from gnn_computing_tpu.parallel.ring_tiles import ring_hybrid_gat as j_ring_hybrid_gat
from gnn_computing_tpu.parallel.ring_tiles import ring_hybrid_gcn_forward as j_ring_hybrid_gcn_forward
from gnn_computing_tpu.parallel.ring_tiles import ring_hybrid_spmm as j_ring_hybrid_spmm

from gnn_computing_tpu_torch.graph import normal_features, rmat_graph
from gnn_computing_tpu_torch.models.gcn import glorot_weights
from gnn_computing_tpu_torch.ops.reference import dense_adjacency, gat_aggregate_dense, spmm_dense
from gnn_computing_tpu_torch.parallel import make_mesh, pad_to_shards
from gnn_computing_tpu_torch.parallel.launch import spawn_world
from gnn_computing_tpu_torch.parallel.mesh import shard_all
from gnn_computing_tpu_torch.parallel.partition import build_ring_plan
from gnn_computing_tpu_torch.parallel.ring import ring_gcn_forward_bodies, ring_spmm_bodies
from gnn_computing_tpu_torch.parallel.ring_tiles import (
    build_ring_hybrid,
    ring_hybrid_gat_bodies,
    ring_hybrid_gcn_forward_bodies,
    ring_hybrid_spmm_bodies,
)

import torch_parallel_ranks as ranks
from test_torch_spmm import jax_native_from_port  # noqa: F401
from test_torch_spmm_gather import close, rel_l2

WORLD = 4


@pytest.fixture(scope="module")
def world():
    return spawn_world(ranks.ring_cases, WORLD, timeout=600)


def rows(world, key, d):
    """The ranks' rows of a case, stacked in rank order."""
    return np.concatenate([world[r][key] for r in range(d)])


def grads(world, key, d, n_inputs):
    """(stacked input gradients, weight gradients of rank 0)."""
    ins = [np.concatenate([world[r][key][i] for r in range(d)]) for i in range(n_inputs)]
    return ins + list(world[0][key][n_inputs:])


def sharded(mesh, *arrays):
    return [jax.device_put(jnp.asarray(x), j_shard_rows(mesh)) for x in arrays]


def gcn_oracle(gp, h, ws):
    a, x = dense_adjacency(gp), h.astype(np.float64)
    for i, w in enumerate(ws):
        x = a @ (x @ np.asarray(w, np.float64))
        x = np.maximum(x, 0.0) if i < len(ws) - 1 else x
    return x


def eq(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape and np.array_equal(got, want), what


@pytest.mark.parametrize("d", [1, 2, 4])
def test_plans_equal_jax(d):
    for with_val, seed in ((True, None), (True, 3), (False, None)):
        g, gj = rmat_graph(200, 2000, seed=7, with_val=with_val), j_rmat_graph(200, 2000, seed=7, with_val=with_val)
        (ring, gp, perm), (jring, jgp, jperm) = build_ring_plan(g, d, 8, shuffle_seed=seed), j_build_ring_plan(
            gj, d, 8, shuffle_seed=seed)
        for f in ("src", "count", "dst", "val"):
            eq(getattr(ring, f), getattr(jring, f), f"ring {f}")
        assert ring.stats() == jring.stats() and (perm is None) == (jperm is None)
        eq(gp.indptr, jgp.indptr, "padded graph")
        eq(gp.indices, jgp.indices, "padded graph")
        rtp, hring, gph = build_ring_hybrid(g, d, tile_rows=16, tile_cols=16, threshold=2)
        jrtp, jhring, jgph = j_build_ring_hybrid(gj, d, tile_rows=16, tile_cols=16, threshold=2)
        for f in ("a", "col", "row"):
            eq(getattr(rtp, f), getattr(jrtp, f), f"tiles {f}")
        for f in ("src", "count", "dst", "val"):
            eq(getattr(hring, f), getattr(jhring, f), f"residual ring {f}")
        assert rtp.stats() == jrtp.stats() and gph.num_nodes == jgph.num_nodes
    g = rmat_graph(203, 900, seed=1)
    eq(pad_to_shards(g, 4).indptr, j_pad_to_shards(j_rmat_graph(203, 900, seed=1), 4).indptr, "pad_to_shards")


def test_spawn_world_fails_at_once_when_a_rank_dies():
    """A rank that exits without a result fails the call within seconds,
    not at the world's timeout."""
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match=r"ranks \[1\] gave no result \(exited\)"):
        spawn_world(ranks.rank_one_exits, 2, timeout=300)
    assert time.perf_counter() - t0 < 60


def test_make_mesh_needs_a_world():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError):
        make_mesh(num_graph=2, device="cpu")


@pytest.mark.parametrize("d", [2, 4])
def test_ring_spmm_matches_jax(world, d):
    g = rmat_graph(200, 2000, seed=7)
    _, gp, _ = build_ring_plan(g, d, block_size=8)
    h = normal_features(gp.num_nodes, 16, seed=1)
    mesh = j_make_mesh(num_graph=d)
    jring, _, _ = j_build_ring_plan(j_rmat_graph(200, 2000, seed=7), d, block_size=8)
    want = jax.jit(lambda r, x: j_ring_spmm(mesh, r, x))(jring.device_put(j_shard_ring_plan(mesh)), *sharded(mesh, h))
    close(rows(world, f"ring_spmm{d}", d), want, f"ring_spmm d={d}", ref=spmm_dense(gp, h))


def test_ring_spmm_shuffled_matches_jax(world):
    ring, gp, perm = build_ring_plan(rmat_graph(200, 2000, seed=7), 4, block_size=8, shuffle_seed=9)
    assert perm is not None
    h = normal_features(gp.num_nodes, 8, seed=2)
    mesh = j_make_mesh(num_graph=4)
    jring, _, _ = j_build_ring_plan(j_rmat_graph(200, 2000, seed=7), 4, block_size=8, shuffle_seed=9)
    want = j_ring_spmm(mesh, jring.device_put(j_shard_ring_plan(mesh)), *sharded(mesh, h))
    close(rows(world, "ring_shuffled", 4), want, "ring shuffled", ref=spmm_dense(gp, h))


def _jax_forward_and_grads(fwd, ws, inputs, ct):
    """(forward, [d inputs..., d weights...]) of sum(fwd(ws, *inputs) * ct)."""
    out = fwd(ws, *inputs)
    n = len(inputs)
    gs = jax.grad(lambda w, *x: jnp.sum(fwd(w, *x) * ct), argnums=tuple(range(n + 1)))(ws, *inputs)
    return out, list(gs[1:]) + list(gs[0])


def _check_grads(got, want, what):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        assert rel_l2(torch.from_numpy(np.asarray(g)), w) <= 1e-4, f"{what}: gradient {i}"


def test_ring_gcn_forward_and_grads_match_jax(world):
    ring, gp, _ = build_ring_plan(rmat_graph(200, 2000, seed=7), 4, block_size=8)
    n = gp.num_nodes
    ws = glorot_weights(ranks.RING_DIMS, seed=0)
    h = normal_features(n, ranks.RING_DIMS[0], seed=3) * 0.1
    mesh = j_make_mesh(num_graph=4)
    jring, _, _ = j_build_ring_plan(j_rmat_graph(200, 2000, seed=7), 4, block_size=8)
    jring = jring.device_put(j_shard_ring_plan(mesh))
    ct = jnp.asarray(ranks.cotangent(n, ranks.RING_DIMS[-1], 31))
    want, jg = jax.jit(lambda w, x: _jax_forward_and_grads(
        lambda ww, xx: j_ring_gcn_forward(mesh, jring, ww, xx), w, [x], ct))([jnp.asarray(w) for w in ws], *sharded(mesh, h))
    close(rows(world, "ring_gcn", 4), want, "ring gcn", ref=gcn_oracle(gp, h, ws))
    _check_grads(grads(world, "ring_gcn_grads", 4, 1), jg, "ring gcn")


@pytest.mark.parametrize("d", [2, 4])
def test_ring_hybrid_spmm_matches_jax(world, d):
    rtp, hring, gp = build_ring_hybrid(rmat_graph(200, 2000, seed=7), d, tile_rows=16, tile_cols=16, threshold=2)
    assert rtp.num_dense_edges > 0 and hring.num_edges > 0
    h = normal_features(gp.num_nodes, 16, seed=4)
    mesh = j_make_mesh(num_graph=d)
    jrtp, jring, _ = j_build_ring_hybrid(j_rmat_graph(200, 2000, seed=7), d, tile_rows=16, tile_cols=16, threshold=2,
                                         residual_block=8)
    want = jax.jit(lambda t, r, x: j_ring_hybrid_spmm(mesh, t, r, x))(
        jrtp.device_put(j_shard_ring_plan(mesh)), jring.device_put(j_shard_ring_plan(mesh)), *sharded(mesh, h))
    close(rows(world, f"ring_hybrid_spmm{d}", d), want, f"ring hybrid d={d}", ref=spmm_dense(gp, h))


def test_ring_hybrid_gcn_forward_and_grads_match_jax(world):
    rtp, hring, gp = build_ring_hybrid(rmat_graph(200, 2000, seed=7), 4, tile_rows=16, tile_cols=16, threshold=2)
    n = gp.num_nodes
    ws = glorot_weights(ranks.RING_DIMS, seed=0)
    h = normal_features(n, ranks.RING_DIMS[0], seed=5) * 0.1
    mesh = j_make_mesh(num_graph=4)
    jrtp, jring, _ = j_build_ring_hybrid(j_rmat_graph(200, 2000, seed=7), 4, tile_rows=16, tile_cols=16, threshold=2)
    jrtp, jring = jrtp.device_put(j_shard_ring_plan(mesh)), jring.device_put(j_shard_ring_plan(mesh))
    ct = jnp.asarray(ranks.cotangent(n, ranks.RING_DIMS[-1], 32))
    want, jg = jax.jit(lambda w, x: _jax_forward_and_grads(
        lambda ww, xx: j_ring_hybrid_gcn_forward(mesh, jrtp, jring, ww, xx), w, [x], ct))(
        [jnp.asarray(w) for w in ws], *sharded(mesh, h))
    close(rows(world, "ring_hybrid_gcn", 4), want, "ring hybrid gcn", ref=gcn_oracle(gp, h, ws))
    _check_grads(grads(world, "ring_hybrid_gcn_grads", 4, 1), jg, "ring hybrid gcn")


def test_ring_hybrid_gat_and_grads_match_jax(world):
    rtp, hring, gp = build_ring_hybrid(rmat_graph(200, 2000, seed=7, with_val=False), 4, tile_rows=16, tile_cols=16,
                                       threshold=2)
    n = gp.num_nodes
    h, att = normal_features(n, 16, seed=6), normal_features(n, 2, seed=7) * 0.3
    mesh = j_make_mesh(num_graph=4)
    jrtp, jring, _ = j_build_ring_hybrid(j_rmat_graph(200, 2000, seed=7, with_val=False), 4, tile_rows=16,
                                         tile_cols=16, threshold=2)
    jrtp, jring = jrtp.device_put(j_shard_ring_plan(mesh)), jring.device_put(j_shard_ring_plan(mesh))
    ct = jnp.asarray(ranks.cotangent(n, 16, 33))

    @jax.jit
    def jax_side(x, a):
        fwd = lambda xx, aa: j_ring_hybrid_gat(mesh, jrtp, jring, xx, aa)  # noqa: E731
        return fwd(x, a), jax.grad(lambda xx, aa: jnp.sum(fwd(xx, aa) * ct), argnums=(0, 1))(x, a)

    want, jg = jax_side(*sharded(mesh, h, att))
    close(rows(world, "ring_hybrid_gat", 4), want, "ring hybrid gat", ref=gat_aggregate_dense(gp, h, att[:, 0], att[:, 1])[0])
    _check_grads(grads(world, "ring_hybrid_gat_grads", 4, 2), list(jg), "ring hybrid gat")


def test_bodies_equal_world(world):
    """The D rank bodies in one process (what a one-card host runs) give
    the world's rows."""
    g, gu = rmat_graph(200, 2000, seed=7), rmat_graph(200, 2000, seed=7, with_val=False)
    ws = [torch.from_numpy(w) for w in glorot_weights(ranks.RING_DIMS, seed=0)]

    def same(got, key, d):
        want = rows(world, key, d)
        got = got.detach().numpy()
        assert got.shape == want.shape and np.abs(got - want).max() <= 1e-6 * np.abs(want).max(), key

    def parts(*plans):  # every rank's parts, made once
        return [shard_all(p, "cpu") for p in plans]

    for d in (2, 4):
        ring, gp, _ = build_ring_plan(g, d, block_size=8)
        same(ring_spmm_bodies(*parts(ring), torch.from_numpy(normal_features(gp.num_nodes, 16, seed=1))),
             f"ring_spmm{d}", d)
        rtp, hring, gph = build_ring_hybrid(g, d, tile_rows=16, tile_cols=16, threshold=2, residual_block=8)
        h = torch.from_numpy(normal_features(gph.num_nodes, 16, seed=4))
        same(ring_hybrid_spmm_bodies(*parts(rtp, hring), h), f"ring_hybrid_spmm{d}", d)
    ring, gp, _ = build_ring_plan(g, 4, block_size=8)
    same(ring_gcn_forward_bodies(*parts(ring), ws, torch.from_numpy(normal_features(gp.num_nodes, 24, seed=3) * 0.1)),
         "ring_gcn", 4)
    h = torch.from_numpy(normal_features(gph.num_nodes, 24, seed=5) * 0.1)
    same(ring_hybrid_gcn_forward_bodies(*parts(rtp, hring), ws, h), "ring_hybrid_gcn", 4)
    rtp, hring, gpu = build_ring_hybrid(gu, 4, tile_rows=16, tile_cols=16, threshold=2)
    h, att = normal_features(gpu.num_nodes, 16, seed=6), normal_features(gpu.num_nodes, 2, seed=7) * 0.3
    same(ring_hybrid_gat_bodies(*parts(rtp, hring), torch.from_numpy(h), torch.from_numpy(att)), "ring_hybrid_gat", 4)
