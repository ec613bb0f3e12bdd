"""The port's per-edge MLP aggregation (``ops/edge_mlp.py``) against the
JAX package's ``edge_mlp`` / ``edge_mlp_chunked`` and ``edge_mlp_dense``
(both packages' float64 oracles), over the gather plans of both packages
built from the same numpy-seeded graphs: neighbor grouping, plain
locality, locality + neighbor grouping and nop.

Tolerances: within 1e-5 * max|jax| of JAX (float32 summation order only)
and within the repo gate (|y - ref| <= 1e-2*|ref| + 1e-5) of the float64
oracle; gradients within 1e-4 relative L2 of ``jax.grad``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_computing_tpu.ops.edge_mlp import edge_mlp as j_edge_mlp
from gnn_computing_tpu.ops.edge_mlp import edge_mlp_chunked as j_edge_mlp_chunked
from gnn_computing_tpu.ops.reference import edge_mlp_dense as j_edge_mlp_dense
from gnn_computing_tpu.schedule import make_plan as j_make_plan

from gnn_computing_tpu_torch.ops.edge_mlp import edge_mlp, edge_mlp_chunked
from gnn_computing_tpu_torch.ops.reference import edge_mlp_dense
from gnn_computing_tpu_torch.ops.validate import assert_valid
from gnn_computing_tpu_torch.schedule import make_plan

from test_torch_schedule_gather import both_graphs

SCHEDULES = {
    "ng8": ("neighbor_grouping", dict(block_size=8)),
    "las": ("locality", dict(num_partitions=4)),
    "lasng8": ("locality_neighbor_grouping", dict(num_partitions=3, block_size=8)),
    "nop": ("nop", {}),
}


def setting(name):
    """(port graph, JAX plan, port plan) over the graph with isolated rows
    and sources."""
    sched, kw = SCHEDULES[name]
    gj, gp = both_graphs("isolated")
    return gp, j_make_plan(gj, sched, **kw).device_put(), make_plan(gp, sched, **kw).to("cpu")


def feats(g, f=12, fo=10, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((g.num_nodes, f)).astype(np.float32) * 0.5,
            rng.standard_normal((f, fo)).astype(np.float32) * 0.5)


def close(got, want, what):
    got = got.detach().numpy()
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all(), what
    err = np.abs(got - want).max()
    assert err <= 1e-5 * np.abs(want).max(), f"{what}: max|port-jax| = {err:.3e}"


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_edge_mlp_matches_jax_and_dense(name):
    g, jplan, plan = setting(name)
    h, w = feats(g)
    ref = edge_mlp_dense(g, h, w)
    assert np.array_equal(ref, j_edge_mlp_dense(both_graphs("isolated")[0], h, w))
    want = np.asarray(jax.jit(j_edge_mlp)(jplan, jnp.asarray(h), jnp.asarray(w)))
    got = edge_mlp(plan, torch.from_numpy(h), torch.from_numpy(w))
    close(got, want, f"edge_mlp {name}")
    assert_valid(got, ref, what=f"edge_mlp {name} vs f64")
    # a chunk bound of a few slots: many chunks, the same sums
    close(edge_mlp(plan, torch.from_numpy(h), torch.from_numpy(w), chunk_slots=3 * plan.block_size), want,
          f"edge_mlp {name} chunked by slots")


@pytest.mark.parametrize("chunk_tasks", [1, 7, 64, 1 << 19])
@pytest.mark.parametrize("name", ["ng8", "lasng8", "nop"])
def test_edge_mlp_chunked_matches_jax(name, chunk_tasks):
    """Task chunks that do (1) and do not (7, 64 against the plans' task
    counts) divide the task count, and one chunk holding every task."""
    g, jplan, plan = setting(name)
    h, w = feats(g, seed=1)
    if chunk_tasks in (7, 64):
        assert plan.num_tasks_padded % chunk_tasks != 0
    want = np.asarray(jax.jit(j_edge_mlp_chunked, static_argnames="chunk_tasks")(
        jplan, jnp.asarray(h), jnp.asarray(w), chunk_tasks=chunk_tasks))
    got = edge_mlp_chunked(plan, torch.from_numpy(h), torch.from_numpy(w), chunk_tasks=chunk_tasks)
    close(got, want, f"edge_mlp_chunked {name} {chunk_tasks}")
    assert_valid(got, edge_mlp_dense(g, h, w), what="edge_mlp_chunked vs f64")


@pytest.mark.parametrize("fn", ["edge_mlp", "edge_mlp_chunked"])
def test_padding_slots_are_masked(fn):
    """relu(u[0] + u[dst]) of a pad slot is far from zero when u[0] is
    large; the masked sum still equals the edge list's.  The plan has
    padded tasks and tasks with empty slots."""
    g, jplan, plan = setting("ng8")
    assert plan.num_tasks_padded > plan.num_tasks and int(plan.count.min()) < plan.block_size
    h, w = feats(g, seed=2)
    w = np.abs(w)
    h[0] = 50.0  # u[0] = 50 * colsum(|w|): every pad slot would add a large positive row
    run = edge_mlp if fn == "edge_mlp" else lambda p, a, b: edge_mlp_chunked(p, a, b, chunk_tasks=5)
    got = run(plan, torch.from_numpy(h), torch.from_numpy(w))
    ref = edge_mlp_dense(g, h, w)
    assert_valid(got, ref, what=f"{fn} with a large u[0]")
    jrun = j_edge_mlp if fn == "edge_mlp" else lambda p, a, b: j_edge_mlp_chunked(p, a, b, chunk_tasks=5)
    close(got, np.asarray(jrun(jplan, jnp.asarray(h), jnp.asarray(w))), f"{fn} with a large u[0]")
    # rows that receive no edge stay exactly zero
    assert not got[torch.from_numpy(g.degrees == 0)].any()


def test_plan_values_are_ignored():
    g, _, plan = setting("ng8")
    h, w = feats(g, seed=3)
    base = edge_mlp(plan, torch.from_numpy(h), torch.from_numpy(w))
    plan.val = torch.zeros_like(plan.val)
    assert torch.equal(edge_mlp(plan, torch.from_numpy(h), torch.from_numpy(w)), base)


@pytest.mark.parametrize("fn", ["edge_mlp", "edge_mlp_chunked"])
@pytest.mark.parametrize("name", ["ng8", "lasng8"])
def test_edge_mlp_gradients_match_jax(fn, name):
    """d/d(h, W) of sum(out * ct) against jax.grad of the JAX function."""
    g, jplan, plan = setting(name)
    h, w = feats(g, seed=4)
    ct = np.random.default_rng(5).standard_normal((g.num_nodes, w.shape[1])).astype(np.float32)
    jf = j_edge_mlp if fn == "edge_mlp" else lambda p, a, b: j_edge_mlp_chunked(p, a, b, chunk_tasks=16)
    pf = edge_mlp if fn == "edge_mlp" else lambda p, a, b: edge_mlp_chunked(p, a, b, chunk_tasks=16)
    jdh, jdw = jax.jit(jax.grad(lambda a, b: jnp.sum(jf(jplan, a, b) * ct), argnums=(0, 1)))(
        jnp.asarray(h), jnp.asarray(w))
    ht, wt = torch.from_numpy(h).requires_grad_(True), torch.from_numpy(w).requires_grad_(True)
    (pf(plan, ht, wt) * torch.from_numpy(ct)).sum().backward()
    assert rel_l2(ht.grad, jdh) <= 1e-4 and rel_l2(wt.grad, jdw) <= 1e-4
