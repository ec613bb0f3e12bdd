"""The gather-only schedules of the PyTorch port (neighbor grouping,
locality, locality + neighbor grouping, nop: ``schedule.make_plan``), their
slot helpers and ``Aggregator.schedule``, against the JAX package on the
CPU, from the same numpy-seeded graphs: an RMAT graph, one with isolated
rows and sources, a 0-edge graph and one with a hub row of degree >> B.

Tolerance: none.  Plans, edge maps, slot positions and per-edge values
moved into and out of the slots are array-equal to the JAX package's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_computing_tpu.aggregator import Aggregator as JAggregator
from gnn_computing_tpu.graph.csr import CSRGraph as JCSRGraph
from gnn_computing_tpu.ops.spmm import edge_values_from_slots as j_edge_values_from_slots
from gnn_computing_tpu.ops.spmm import slot_positions as j_slot_positions
from gnn_computing_tpu.ops.spmm import slots_from_edge_values as j_slots_from_edge_values
from gnn_computing_tpu.schedule import make_plan as j_make_plan
from gnn_computing_tpu.schedule import source_partition_of as j_source_partition_of

from gnn_computing_tpu_torch.aggregator import Aggregator
from gnn_computing_tpu_torch.graph import CSRGraph, rmat_graph
from gnn_computing_tpu_torch.ops.spmm import (
    edge_values_from_slots,
    edge_values_from_slots_flat,
    slot_positions,
    slots_from_edge_values,
    slots_from_edge_values_flat,
)
from gnn_computing_tpu_torch.schedule import Schedule, make_plan, source_partition_of

# (schedule, keywords): every schedule, plain locality with B = None (the
# default) and B = 32, neighbor grouping at two block sizes
SCHEDULES = [
    ("neighbor_grouping", dict(block_size=32)),
    ("neighbor_grouping", dict(block_size=4)),
    ("locality", dict(num_partitions=4)),
    ("locality", dict(num_partitions=4, block_size=32)),
    ("locality_neighbor_grouping", dict(num_partitions=4, block_size=32)),
    ("locality_neighbor_grouping", dict(num_partitions=3, block_size=8)),
    ("nop", {}),
]
SCHEDULE_IDS = ["ng32", "ng4", "las", "las32", "lasng32", "lasng8p3", "nop"]
GRAPHS = ["rmat", "isolated", "empty", "hub"]


def graph_edges(kind: str, with_val: bool = True):
    """(dst, src, val or None, n) of a test graph, from numpy seeds."""
    rng = np.random.default_rng(11)
    if kind == "empty":
        dst = src = np.zeros(0, np.int64)
        n = 37
    elif kind == "hub":
        n = 300
        dst = np.concatenate([np.full(700, 3), rng.integers(0, n, 2500)])
        src = rng.integers(0, n, dst.shape[0])
    else:
        g = rmat_graph(400, 6000, seed=5, with_val=False)
        dst, src, n = g.dst_per_edge.astype(np.int64), g.indices.astype(np.int64), g.num_nodes
        if kind == "isolated":  # rows 100..159 receive nothing, sources 200..259 send nothing
            keep = ((dst < 100) | (dst >= 160)) & ((src < 200) | (src >= 260))
            dst, src = dst[keep], src[keep]
    val = rng.standard_normal(dst.shape[0]).astype(np.float32) if with_val else None
    return dst, src, val, n


def both_graphs(kind: str, with_val: bool = True):
    dst, src, val, n = graph_edges(kind, with_val)
    return JCSRGraph.from_edges(dst, src, n, val=val), CSRGraph.from_edges(dst, src, n, val=val)


def assert_plans_equal(got, want):
    """A host plan of the port against a host plan of the JAX package."""
    for field in ("src", "count", "dst", "val", "edge_perm"):
        g, w = getattr(got, field), getattr(want, field)
        assert (g is None) == (w is None), field
        if g is not None:
            g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
            w = np.asarray(w)
            assert g.dtype == w.dtype and np.array_equal(g.reshape(w.shape), w), field
    for field in ("num_nodes", "n_src", "block_size", "num_tasks", "num_edges", "sorted_by_dst", "partition_starts",
                  "num_tasks_padded", "num_partitions"):
        assert getattr(got, field) == getattr(want, field), field


@pytest.mark.parametrize("kind", GRAPHS)
@pytest.mark.parametrize("sched,kw", SCHEDULES, ids=SCHEDULE_IDS)
@pytest.mark.parametrize("with_val", [False, True])
def test_make_plan_equals_jax(kind, sched, kw, with_val):
    gj, gp = both_graphs(kind, with_val)
    want = j_make_plan(gj, sched, **kw)
    got = make_plan(gp, Schedule(sched), **kw)
    assert_plans_equal(got, want)
    assert got.stats() == want.stats()
    assert np.array_equal(got.slot_mask().numpy(), np.asarray(want.slot_mask()))
    # the plan's own edge values when none is given, else the graph's
    assert_plans_equal(make_plan(gp, sched, val=np.arange(gp.num_edges, dtype=np.float32), **kw),
                       j_make_plan(gj, sched, val=np.arange(gj.num_edges, dtype=np.float32), **kw))
    if kind == "hub" and kw.get("block_size") is not None:  # the hub row is cut into full tasks
        assert got.stats()["max_task"] == got.block_size < gp.max_degree()


def test_schedule_facts():
    gj, gp = both_graphs("hub")
    assert gp.max_degree() == gj.max_degree() >= 700
    assert CSRGraph.from_edges(np.zeros(0), np.zeros(0), 5).max_degree() == 0
    v = np.arange(gp.num_edges, dtype=np.float32)
    assert np.array_equal(gp.with_val(v).val, gj.with_val(v).val) and gp.with_val(v).n_src == gp.n_src
    # nop: B is the max degree (1 on an empty graph); plain locality: the longest run
    assert make_plan(gp, "nop").block_size == gp.max_degree()
    assert make_plan(CSRGraph.from_edges(np.zeros(0), np.zeros(0), 5), "nop").block_size == 1
    src = np.arange(0, 302, 7)
    assert np.array_equal(source_partition_of(src, 302, 4), j_source_partition_of(src, 302, 4))
    assert np.array_equal(source_partition_of(src, 302, 4), np.minimum(src // 75, 3))
    with pytest.raises(ValueError):
        make_plan(gp, "gather")


@pytest.mark.parametrize("kind", ["rmat", "isolated", "hub"])
@pytest.mark.parametrize("sched,kw", SCHEDULES, ids=SCHEDULE_IDS)
def test_slot_helpers_equal_jax(kind, sched, kw):
    gj, gp = both_graphs(kind)
    jplan = j_make_plan(gj, sched, **kw)
    plan = make_plan(gp, sched, **kw).to("cpu")
    ev = np.random.default_rng(3).standard_normal(gp.num_edges).astype(np.float32)

    @jax.jit
    def jax_side(p, e):
        slots = j_slots_from_edge_values(p, e)
        return j_slot_positions(p), slots, j_edge_values_from_slots(p, slots)

    pos, want, back = (np.asarray(x) for x in jax_side(jplan, jnp.asarray(ev)))
    assert np.array_equal(slot_positions(plan).numpy(), pos)
    got = slots_from_edge_values(plan, torch.from_numpy(ev))
    assert got.shape == want.shape and np.array_equal(got.numpy(), want)
    assert np.array_equal(slots_from_edge_values_flat(plan, torch.from_numpy(ev)).numpy(), want.reshape(-1))
    assert np.array_equal(edge_values_from_slots(plan, got).numpy(), back)
    assert np.array_equal(edge_values_from_slots_flat(plan, got.reshape(-1)).numpy(), back)
    assert np.array_equal(back, ev)  # every edge comes back to its CSR place
    # a plan's values are the graph's edge values in its slots
    assert np.array_equal(plan.val.numpy(), slots_from_edge_values_flat(plan, torch.from_numpy(gp.val)).numpy())


@pytest.mark.parametrize("kind", ["rmat", "isolated", "empty", "hub"])
@pytest.mark.parametrize("sched,kw", [SCHEDULES[0], SCHEDULES[3], SCHEDULES[4], SCHEDULES[6]],
                         ids=["ng32", "las32", "lasng32", "nop"])
def test_aggregator_schedule_equals_jax(kind, sched, kw):
    gj, gp = both_graphs(kind)
    jagg = JAggregator.schedule(gj, sched, with_transpose=True, device_put=False, **kw)
    agg = Aggregator.schedule(gp, sched, with_transpose=True, device="cpu", **kw)
    assert not agg.tile_parts() and agg.plan.src.dtype == torch.int64
    assert (agg.num_nodes, agg.n_src, agg.num_edges) == (jagg.num_nodes, jagg.n_src, jagg.num_edges)
    for got, want in ((agg.plan, jagg.plan), (agg.plan_t, jagg.plan_t)):
        for field in ("src", "count", "dst", "val", "edge_perm"):
            g, w = getattr(got, field), getattr(want, field)
            assert (g is None) == (w is None), field
            if g is not None:
                assert np.array_equal(g.numpy(), np.asarray(w).reshape(-1)), field
        for field in ("num_tasks", "num_edges", "partition_starts", "block_size", "sorted_by_dst"):
            assert getattr(got, field) == getattr(want, field), field
    assert np.array_equal(agg.edge_map_t.numpy(), np.asarray(jagg.edge_map_t))
    ev = np.random.default_rng(4).standard_normal(gp.num_edges).astype(np.float32)
    slots, slots_t = jax.jit(lambda a, e: (a.slot_values(e), a.transposed_val(e)))(jagg.device_put(), jnp.asarray(ev))
    assert np.array_equal(agg.slot_values(torch.from_numpy(ev)).numpy(), np.asarray(slots))
    assert np.array_equal(agg.transposed_val(torch.from_numpy(ev)).numpy(), np.asarray(slots_t))
    # the transposed plan's values are the graph's, carried over by the edge map
    assert np.array_equal(agg.plan_t.val.numpy(), agg.transposed_val(torch.from_numpy(gp.val)).reshape(-1).numpy())
    no_t = Aggregator.schedule(gp, sched, with_transpose=False, device="cpu", **kw)
    assert no_t.plan_t is None and no_t.edge_map_t is None
    with pytest.raises(ValueError):
        no_t.transposed_val(torch.from_numpy(ev))


def test_schedule_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = rmat_graph(64, 400, seed=3)
    with pytest.raises(RuntimeError, match="cuda"):
        Aggregator.schedule(g)
    with pytest.raises(RuntimeError, match="cuda"):
        make_plan(g, "locality_neighbor_grouping", num_partitions=2).to("cuda")
