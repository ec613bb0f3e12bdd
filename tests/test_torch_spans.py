"""The port's span and counter recorder (``utils.profiling``) on the CPU.

Off by default: ``span`` is a shared no-op and a training step reads the
same bits with recording on and off.  On, a GCN and a GAT training step
record the tree of spans the program names (the step's phases, the tile
part against the residual, the GAT's host reads), one step id across the
threads, the residual counters, and, under ``torch.profiler``, each span
as a user annotation around the aten ops it wraps.  The plan build records
the spans of the phases it runs; a kernel's first load records
``gnn.build``; ``launch_counts`` is the one table of the ops' launch
counters."""

import json
import threading

import numpy as np
import pytest
import torch

from gnn_computing_tpu_torch.aggregator import Aggregator
from gnn_computing_tpu_torch.graph import degree_sort, normal_features, rmat_graph
from gnn_computing_tpu_torch.models.gat import GATLayerParams, gat_forward, glorot_gat_weights
from gnn_computing_tpu_torch.models.gcn import gcn_forward_bench, glorot_weights
from gnn_computing_tpu_torch.models.training import make_train_step
from gnn_computing_tpu_torch.ops import (
    cuda_bcsr,
    cuda_build,
    cuda_gat,
    cuda_gat_bwd,
    cuda_residual,
    cuda_rowmax,
    cuda_sddmm,
)
from gnn_computing_tpu_torch.utils import profiling
from gnn_computing_tpu_torch.utils.profiling import recording, span

DIMS = (16, 8, 8, 4)
SCHEDULE = dict(tile_rows=16, tile_cols=128, threshold=4, residual_block=8, pack=2, tile_dtype=np.int8,
                bit_tiles=True)
# the spans one training step records, by model
STEP_SPANS = {
    "gcn": {"gnn.step": 1, "gnn.forward": 1, "gnn.loss": 1, "gnn.backward": 1, "gnn.optimizer": 1,
            "gnn.agg.tiles": 3, "gnn.agg.residual": 3, "gnn.agg_t.tiles": 3, "gnn.agg_t.residual": 3},
    "gat": {"gnn.step": 1, "gnn.forward": 1, "gnn.loss": 1, "gnn.backward": 1, "gnn.optimizer": 1,
            "gnn.gat.tiles": 3, "gnn.gat.residual": 3, "gnn.gat_t.tiles": 3, "gnn.gat_t.residual": 3,
            "gnn.sync": 9},
}


@pytest.fixture(scope="module")
def agg():
    g = rmat_graph(512, 6000, seed=5, with_val=False)
    return Aggregator.schedule_hybrid(g.reorder(degree_sort(g)), device="cpu", **SCHEDULE)


def make_step(model: str, agg):
    """A fresh training step over ``agg`` and its leaves, from fixed weights."""
    if model == "gcn":
        leaves = [torch.from_numpy(w).requires_grad_(True) for w in glorot_weights(DIMS, seed=1)]

        def forward(h):
            return gcn_forward_bench(agg, leaves, h)
    else:
        params = [GATLayerParams(torch.from_numpy(w).requires_grad_(True), torch.from_numpy(a).requires_grad_(True))
                  for w, a in glorot_gat_weights(DIMS, seed=1)]
        leaves = [x for p in params for x in p]

        def forward(h):
            return gat_forward(agg, params, h, stabilize="bound")
    opt = torch.optim.Adam(leaves, lr=1e-2)
    step = make_train_step(forward, opt, device="cpu")
    h = torch.from_numpy(normal_features(agg.num_nodes, DIMS[0], seed=2))
    y = torch.from_numpy(np.random.default_rng(3).integers(0, DIMS[-1], agg.num_nodes))
    return (lambda: step((h,), y)), leaves


def names(spans) -> dict:
    out = {}
    for s in spans:
        out[s.name] = out.get(s.name, 0) + 1
    return out


def test_off_by_default_span_is_one_shared_no_op():
    assert profiling._recording is None
    assert span("gnn.step") is span("gnn.sync", site="x")
    before = profiling.spans()
    with span("gnn.step"):
        profiling.count("residual.edges", 5)
    assert profiling.spans() == before


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_recording_leaves_the_step_bit_identical(agg, model):
    runs = []
    for on in (False, True):
        run, leaves = make_step(model, agg)
        if on:
            with recording():
                losses = [run() for _ in range(2)]
        else:
            losses = [run() for _ in range(2)]
        runs.append((torch.stack(losses), [x.detach().clone() for x in leaves]))
    (l0, p0), (l1, p1) = runs
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_one_step_records_the_tree(agg, model):
    run, _ = make_step(model, agg)
    run()  # warm: nothing is recorded
    with recording() as rec:
        run()
    sp = rec.spans
    assert names(sp) == STEP_SPANS[model]
    assert {s.step for s in sp} == {sp[0].step} and sp[0].name == "gnn.step" and sp[0].parent is None
    for s in sp[1:]:
        p = sp[s.parent]
        assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns, (s.name, p.name)
    parents = {s.name: sp[s.parent].name for s in sp if s.parent is not None}
    assert {k: parents[k] for k in ("gnn.forward", "gnn.loss", "gnn.backward", "gnn.optimizer")} == dict.fromkeys(
        ("gnn.forward", "gnn.loss", "gnn.backward", "gnn.optimizer"), "gnn.step")
    agg_part = "gnn.agg" if model == "gcn" else "gnn.gat"
    assert parents[agg_part + ".tiles"] == parents[agg_part + ".residual"] == "gnn.forward"
    assert parents[agg_part + "_t.tiles"] == parents[agg_part + "_t.residual"] == "gnn.backward"
    sites = sorted((sp[s.parent].name, s.attrs["site"]) for s in sp if s.name == "gnn.sync")
    if model == "gat":
        assert sites == sorted([("gnn.gat_t.residual", "spmm.slot_pos"), ("gnn.gat_t.residual", "spmm.slot_val")] * 3
                               + [("gnn.forward", "gat.bound_need")] * 3)
    else:
        assert sites == []


def test_a_span_on_another_thread_joins_the_open_step():
    got = {}

    def worker():
        with span("gnn.agg_t.tiles"):
            got["thread"] = threading.get_ident()

    with recording() as rec:
        with span("gnn.step"):
            with span("gnn.backward"):
                t = threading.Thread(target=worker)
                t.start()
                t.join(timeout=30)
        with span("gnn.step"):
            pass
    assert not t.is_alive() and got["thread"] != threading.get_ident()
    step, bwd, other, nxt = rec.spans
    assert (other.parent, other.step) == (1, step.step)
    assert nxt.parent is None and nxt.step == step.step + 1


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_residual_counters_are_the_plans_edges_and_slots(agg, model):
    run, _ = make_step(model, agg)
    with recording() as rec:
        run()
        run()
    calls = names(rec.spans)

    def slots(p):
        return p.num_tasks_padded * p.block_size

    if model == "gcn":
        fwd, bwd = agg.plan, agg.plan_t  # the backward aggregates over the transposed residual
        n_fwd, n_bwd = calls["gnn.agg.residual"], calls["gnn.agg_t.residual"]
    else:
        fwd = bwd = agg.plan  # the GAT's residual backward streams the forward plan's slots
        n_fwd, n_bwd = calls["gnn.gat.residual"], calls["gnn.gat_t.residual"]
    assert (n_fwd, n_bwd) == (6, 6)
    assert rec.counters == {"residual.edges": n_fwd * fwd.num_edges + n_bwd * bwd.num_edges,
                            "residual.slots": n_fwd * slots(fwd) + n_bwd * slots(bwd)}
    assert profiling.counters() == rec.counters  # read back after the recording closed


@pytest.mark.parametrize("on", [False, True])
def test_spans_are_user_annotations_under_the_profiler(agg, tmp_path, on):
    run, _ = make_step("gcn", agg)
    run()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        if on:
            with recording() as rec:
                run()
        else:
            run()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    notes = [e for e in events if e.get("cat") == "user_annotation" and e["name"].startswith("gnn.")]
    if not on:
        assert notes == []
        return
    assert names(rec.spans) == {k: sum(1 for e in notes if e["name"] == k) for k in names(rec.spans)}
    ops = [e for e in events if e.get("cat") == "cpu_op"]

    def holds(note, op_name):
        return any(o["name"] == op_name and note["ts"] <= o["ts"] and o["ts"] + o["dur"] <= note["ts"] + note["dur"]
                   for o in ops)

    residual = [e for e in notes if e["name"] == "gnn.agg.residual"]
    assert residual and all(holds(e, "aten::index_add_") for e in residual)
    assert all(holds(e, "aten::bmm") for e in notes if e["name"] == "gnn.agg.tiles")
    assert not any(holds(e, "aten::bmm") for e in residual)


@pytest.mark.parametrize("bit_tiles", [False, True])
@pytest.mark.parametrize("with_transpose", [False, True])
def test_the_plan_build_records_the_phases_it_runs(bit_tiles, with_transpose):
    g = rmat_graph(512, 6000, seed=5, with_val=False)
    with recording() as rec:
        gr = g.reorder(degree_sort(g))
        Aggregator.schedule_hybrid(gr, device="cpu", with_transpose=with_transpose,
                                   **dict(SCHEDULE, bit_tiles=bit_tiles))
    want = ["gnn.plan.reorder", "gnn.plan.reorder", "gnn.plan.densify"]
    want += ["gnn.plan.split_bits"] * bit_tiles + ["gnn.plan.residual"]
    want += ["gnn.plan.transpose", "gnn.plan.residual"] * with_transpose + ["gnn.plan.pad", "gnn.plan.to_device"]
    assert [s.name for s in rec.spans] == want
    assert all(s.parent is None and s.end_ns >= s.start_ns for s in rec.spans)


def test_a_kernels_first_load_records_a_build(monkeypatch, tmp_path):
    class Lib:
        def __getattr__(self, fn):
            return self.__dict__.setdefault(fn, type("Fn", (), {})())

    monkeypatch.setattr(cuda_build, "_loaded", {})
    monkeypatch.setattr(cuda_build, "build", lambda name: tmp_path / f"lib{name}.so")
    monkeypatch.setattr(cuda_build.ctypes, "CDLL", lambda path: Lib())
    with recording() as rec:
        lib = cuda_build.load("bcsr_spmm", {"f": []})
        assert cuda_build.load("bcsr_spmm", {"f": []}) is lib
    (b,) = rec.spans
    assert (b.name, b.attrs) == ("gnn.build", {"kernel": "bcsr_spmm",
                                               "cached": cuda_build.library_path("bcsr_spmm").exists()})
    assert lib.f.restype is cuda_build.ctypes.c_int


COUNTERS = [
    ("B1", cuda_bcsr, "launches"), ("B2", cuda_gat, "launches"), ("B3", cuda_gat_bwd, "dad_launches"),
    ("B4", cuda_gat_bwd, "dh_das_launches"), ("B5", cuda_rowmax, "launches"), ("B6", cuda_sddmm, "launches"),
    ("B2_twodot", cuda_gat, "twodot_launches"), ("B2_merged", cuda_gat, "merged_launches"),
    ("R1", cuda_residual, "launches"), ("P1", cuda_residual, "task_sums_launches"),
    ("P2", cuda_residual, "fused_launches"),
]


@pytest.mark.parametrize("key, module, attr", COUNTERS)
def test_launch_counts_is_the_one_table(monkeypatch, key, module, attr):
    import chip_smoke
    from gnn_computing_tpu_torch import bench

    for _, m, a in COUNTERS:
        monkeypatch.setattr(m, a, 0)
    monkeypatch.setattr(module, attr, 7)
    table = profiling.launch_counts()
    assert table == {k: 7 if k == key else 0 for k, _, _ in COUNTERS}
    assert chip_smoke.counts() == table
    assert bench.kernel_launches() == {k: table[k] for k in ("B1", "B2", "B3", "B4", "B5", "B6")}
