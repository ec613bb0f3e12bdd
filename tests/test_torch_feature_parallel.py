"""The port's feature-parallel GCN (``parallel.feature_parallel``: the
plan replicated, H and W split on the feature axis, one all-reduce a
layer) against the JAX package's on its virtual CPU mesh and the float64
oracle (aggregate-first layers).

The port runs in one gloo world of 4 spawned processes
(``torch_parallel_ranks.feature_cases``: feature axes of 2 and 4 ranks).
Tolerances: forwards within 1e-5 * max|jax| and under the repo gate
against the float64 oracle; gradients of the rank's H columns and W rows
within 1e-4 relative L2 of ``jax.grad``; the D bodies in one process
within 1e-6 * max|world| of the world."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from gnn_computing_tpu.aggregator import Aggregator as JAggregator
from gnn_computing_tpu.graph.synthetic import rmat_graph as j_rmat_graph
from gnn_computing_tpu.parallel.feature_parallel import feature_sharded_gcn_forward as j_forward
from gnn_computing_tpu.parallel.feature_parallel import shard_features as j_shard_features
from gnn_computing_tpu.parallel.feature_parallel import shard_w_rows as j_shard_w_rows
from gnn_computing_tpu.parallel.mesh import make_mesh as j_make_mesh

from gnn_computing_tpu_torch.aggregator import Aggregator
from gnn_computing_tpu_torch.graph import normal_features, rmat_graph
from gnn_computing_tpu_torch.models.gcn import glorot_weights
from gnn_computing_tpu_torch.ops.reference import dense_adjacency
from gnn_computing_tpu_torch.parallel.feature_parallel import feature_sharded_gcn_forward_bodies
from gnn_computing_tpu_torch.parallel.launch import spawn_world

import torch_parallel_ranks as ranks
from test_torch_parallel import _check_grads
from test_torch_spmm import jax_native_from_port  # noqa: F401
from test_torch_spmm_gather import close


@pytest.fixture(scope="module")
def world():
    return spawn_world(ranks.feature_cases, 4, timeout=600)


def cols(world, key, d, i):
    """Gradient ``i`` of the ranks of a feature axis of d: H columns side
    by side (i = 0), W rows stacked (i > 0)."""
    parts = [world[r][key][i] for r in range(d)]
    assert [world[r][f"feature_rank{d}"] for r in range(d)] == list(range(d))
    return np.concatenate(parts, axis=1 if i == 0 else 0)


@pytest.mark.parametrize("d", [2, 4])
def test_forward_and_grads_match_jax(world, d):
    g = rmat_graph(1536, 30000, seed=3, with_val=False)
    h = normal_features(g.num_nodes, ranks.FP_DIMS[0], seed=1) * 0.1
    ws = glorot_weights(ranks.FP_DIMS, seed=2)
    mesh = j_make_mesh(num_graph=1, num_feature=d)
    sched = JAggregator.schedule_hybrid(
        j_rmat_graph(1536, 30000, seed=3, with_val=False), tile_rows=256, threshold=8, residual_block=4,
        tile_dtype=np.int8, with_transpose=True, device_put=False,
    ).device_put()
    ct = jnp.asarray(ranks.cotangent(g.num_nodes, ranks.FP_DIMS[-1], 35))

    @jax.jit
    def jax_side(x, *w):
        fwd = lambda xx, *ww: j_forward(mesh, sched, ww, xx)  # noqa: E731
        grads = jax.grad(lambda xx, *ww: jnp.sum(fwd(xx, *ww) * ct), argnums=tuple(range(len(w) + 1)))(x, *w)
        return fwd(x, *w), grads

    want, jg = jax_side(jax.device_put(jnp.asarray(h), j_shard_features(mesh)),
                        *[jax.device_put(jnp.asarray(w), j_shard_w_rows(mesh)) for w in ws])
    a, x = dense_adjacency(g), h.astype(np.float64)
    for i, w in enumerate(ws):
        x = (a @ x) @ w.astype(np.float64)
        x = np.maximum(x, 0.0) if i < len(ws) - 1 else x
    for r in range(d):  # every rank holds the whole output
        close(world[r][f"forward{d}"], want, f"feature-parallel gcn d={d} rank {r}", ref=x)
    _check_grads([cols(world, f"grads{d}", d, i) for i in range(len(ws) + 1)], list(jg), f"feature-parallel d={d}")
    assert isinstance(want.sharding, NamedSharding) and want.sharding.spec == P()


def test_bodies_equal_world(world):
    g = rmat_graph(1536, 30000, seed=3, with_val=False)
    agg = Aggregator.schedule_hybrid(g, tile_rows=256, threshold=8, residual_block=4, tile_dtype=np.int8,
                                     with_transpose=False, device="cpu")
    h = torch.from_numpy(normal_features(g.num_nodes, ranks.FP_DIMS[0], seed=1) * 0.1)
    ws = [torch.from_numpy(w) for w in glorot_weights(ranks.FP_DIMS, seed=2)]
    for d in (2, 4):
        got = feature_sharded_gcn_forward_bodies(agg, ws, h, d).numpy()
        want = world[0][f"forward{d}"]
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max(), d
