"""The port's multi-device dry run (``gnn_computing_tpu_torch.multichip``,
the counterpart of ``__graft_entry__.dryrun_multichip``) against the JAX
dry run's loss and ``jax.value_and_grad`` on the virtual CPU mesh.

The port's step runs in one gloo world of 4 spawned processes
(``torch_parallel_ranks.multichip_cases``: meshes of 2 and 4 ranks) from
the JAX dry run's own initial weights (``init_gcn_params(key(0))``).
Tolerances: loss within 1e-5 relative, the summed weight gradients within
1e-4 relative L2; the D rank bodies in one process give the same loss and
gradients (1e-6 relative).  The arxiv-scale forward of the dry run runs on
the card (chip_smoke.py phase 53), and the step there in an NCCL world of
one (phase 52; tests/test_torch_cuda.py::test_dryrun_in_an_nccl_world_of_one,
which runs where jax is absent)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gnn_computing_tpu.graph.synthetic import normal_features as j_normal_features
from gnn_computing_tpu.graph.synthetic import rmat_graph as j_rmat_graph
from gnn_computing_tpu.models import init_gcn_params as j_init_gcn_params
from gnn_computing_tpu.parallel import (
    build_ring_plan,
    make_mesh,
    ring_gcn_forward,
    ring_spmm,
    shard_ring_plan,
    shard_rows,
)
from gnn_computing_tpu.parallel.allgather_tiles import (
    allgather_hybrid_gcn_forward,
    allgather_hybrid_spmm,
    build_allgather_hybrid,
)
from gnn_computing_tpu.parallel.ring_tiles import build_ring_hybrid, ring_hybrid_gcn_forward, ring_hybrid_spmm

from gnn_computing_tpu_torch import multichip
from gnn_computing_tpu_torch.parallel.launch import spawn_world

import torch_parallel_ranks as ranks
from test_torch_spmm import jax_native_from_port  # noqa: F401
from test_torch_spmm_gather import rel_l2


def jax_weights():
    return [np.asarray(w) for w in j_init_gcn_params(jax.random.key(0), multichip.TOY_DIMS)]


@pytest.fixture(scope="module")
def world():
    return spawn_world(ranks.multichip_cases, 4, jax_weights(), timeout=600)


def jax_step(d, relu_sides=None):
    """(loss, grads) of __graft_entry__.dryrun_multichip's loss on a mesh of
    d virtual devices, its step (a).  With ``relu_sides`` (the first
    layer's pre-activation > 0 of the all-gather, ring-hybrid and ring
    paths) each path's ReLU is taken as z * side: the same forward values,
    and the derivative on that side of 0."""
    mesh = make_mesh(num_graph=d)
    dims = multichip.TOY_DIMS
    g = j_rmat_graph(64 * d, 512 * d, seed=7, with_val=False)
    ring, gp, _ = build_ring_plan(g, d, block_size=8, shuffle_seed=3)
    ring = ring.device_put(shard_ring_plan(mesh))
    rtp, hring, _ = build_ring_hybrid(g, d, tile_rows=16, tile_cols=16, threshold=2)
    rtp, hring = rtp.device_put(shard_ring_plan(mesh)), hring.device_put(shard_ring_plan(mesh))
    tplan, tgp = build_allgather_hybrid(g, d, tile_rows=64, tile_cols=128, threshold=4, residual_block=4, pack=4)
    tplan = tplan.device_put(shard_ring_plan(mesh))
    h = jax.device_put(jnp.asarray(j_normal_features(gp.num_nodes, dims[0], seed=1)), shard_rows(mesh))
    ht = jax.device_put(jnp.asarray(j_normal_features(tgp.num_nodes, dims[0], seed=2) * 0.1), shard_rows(mesh))
    labels = jnp.asarray(np.random.default_rng(0).integers(0, dims[-1], gp.num_nodes))
    labels_t = jnp.asarray(np.random.default_rng(1).integers(0, dims[-1], tgp.num_nodes))

    def forwards(params):
        if relu_sides is None:
            return (allgather_hybrid_gcn_forward(mesh, tplan, params, ht),
                    ring_hybrid_gcn_forward(mesh, rtp, hring, params, h), ring_gcn_forward(mesh, ring, params, h))
        hi = jax.lax.Precision.HIGHEST
        aggs = (lambda z: allgather_hybrid_spmm(mesh, tplan, z), lambda z: ring_hybrid_spmm(mesh, rtp, hring, z),
                lambda z: ring_spmm(mesh, ring, z))
        outs = []
        for agg, x, side in zip(aggs, (ht, h, h), relu_sides):
            x = agg(jnp.dot(x, params[0], precision=hi)) * jax.device_put(jnp.asarray(side, jnp.float32),
                                                                         shard_rows(mesh))
            outs.append(agg(jnp.dot(x, params[1], precision=hi)))
        return outs

    def loss_fn(params):
        logits_a, logits_r, ring_out = forwards(params)
        xent = jnp.mean(optax.softmax_cross_entropy_with_integer_labels(logits_a, labels_t))
        xent_r = jnp.mean(optax.softmax_cross_entropy_with_integer_labels(logits_r, labels))
        aux = jnp.mean(ring_out ** 2)
        return xent + 1e-1 * xent_r + 1e-3 * aux

    return jax.jit(jax.value_and_grad(loss_fn))([jnp.asarray(w) for w in jax_weights()])


@pytest.mark.parametrize("d", [2, 4])
def test_train_step_matches_jax(world, d):
    """Loss against the JAX dry run's; gradients against jax.grad of the
    same loss with each first-layer ReLU's derivative taken on the port's
    side of 0: where a pre-activation lies within float32 rounding of 0,
    two summation orders may take different sides, and the derivative
    jumps there (at D = 2 one ring pre-activation is 8.9e-7, 1.1e-8 of
    max|z|: the port's float32 reads -3.6e-7, the JAX package's +7.2e-7)."""
    step = world[0][f"step{d}"]
    loss, _ = jax_step(d)
    assert abs(step["loss"] - float(loss)) <= 1e-5 * abs(float(loss)), (step["loss"], float(loss))
    same_loss, grads = jax_step(d, step["relu_sides"])
    assert abs(float(same_loss) - float(loss)) <= 1e-6 * abs(float(loss))
    for i, (g, w) in enumerate(zip(step["grads"], grads)):
        assert rel_l2(torch.from_numpy(g), w) <= 1e-4, f"d={d}: weight gradient {i}"
    for r in range(1, d):  # every rank holds the same loss and summed gradients
        assert world[r][f"step{d}"]["loss"] == step["loss"]
        assert all(np.array_equal(a, b) for a, b in zip(world[r][f"step{d}"]["grads"], step["grads"]))


def test_bodies_equal_world(world):
    """The step's loss and gradients from the D rank bodies in one process
    (what one card runs at D > 1) equal the world's."""
    prob = multichip.toy_problem(4)
    params = multichip.toy_params("cpu", jax_weights())
    loss = multichip.toy_loss_bodies(prob, params, "cpu")
    loss.backward()
    step = world[0]["step4"]
    assert abs(loss.item() - step["loss"]) <= 1e-6 * abs(step["loss"])
    for p, g in zip(params, step["grads"]):
        assert np.abs(p.grad.numpy() - g).max() <= 1e-6 * np.abs(g).max()


def test_dryrun_multichip_spawns_a_world():
    """The entry point itself: a gloo world of 2 runs the step (no arxiv
    forward on the CPU) and every rank reports the same finite loss."""
    out = multichip.dryrun_multichip(2, device="cpu", arxiv=False, timeout=600)
    assert len(out) == 2 and np.isfinite(out[0]["loss"]) and out[0]["loss"] == out[1]["loss"]


def test_dryrun_on_cards_needs_one_card_a_rank(monkeypatch):
    """NCCL runs one rank a card: more ranks than cards raise before any
    process starts."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="one rank a card"):
        multichip.dryrun_multichip(2, device="cuda")
