"""The port's figure harness (``gnn_computing_tpu_torch/benchmarks/``) on the
CPU: the four harness-math tests of ``tests/test_fig_harness.py`` on the
port's functions; the harness's accounting against the JAX harness's at the
quick dataset (the graphs array-equal, fig8's occupancies and counts, fig9's
dense coverage under all five orders, the copied constants); every
figure's ``main()`` with ``--device cpu --iters 2`` over a test-only RMAT
512 v / 4,096 e table, each row holding the JAX record's keys plus
``device`` and finite positive times, and every timed function handed to
the ``check`` hook that chip_smoke.py uses; ``capture_to_fig7``, ``plot``
and ``scaling`` in a gloo world of 2."""

import json
import math
import os

import numpy as np
import pytest
import torch

import bench as jax_bench
from benchmarks import capture_to_fig7 as j_capture
from benchmarks import common as j_common
from benchmarks import fig8_balance as j_fig8
from gnn_computing_tpu.graph import reorder as j_reorder
from gnn_computing_tpu.schedule import neighbor_grouping_plan as j_ng_plan
from gnn_computing_tpu.schedule.tiles import densify as j_densify

from gnn_computing_tpu_torch.benchmarks import (
    capture_to_fig7,
    common,
    fig7_models,
    fig8_balance,
    fig9_locality,
    fig10_fusion,
    fig11_sage,
    plot,
    scaling,
)
from gnn_computing_tpu_torch.graph import degree_sort, rmat_graph
from gnn_computing_tpu_torch.schedule import neighbor_grouping_plan, nop_plan
from gnn_computing_tpu_torch.schedule.tiles import densify

from test_torch_spmm import jax_native_from_port  # noqa: F401

TINY = {"rmat_tiny": (512, 4096)}
ITERS = 2

# the JAX harness's record keys (the common.emit calls of benchmarks/fig*.py
# and scaling.py), each with the port's "device"
FIG8_BASE = {"dataset", "schedule", "actual_s", "balanced_s", "slot_occupancy", "num_tasks", "block_size", "ts"}
JAX_KEYS = {
    "fig7": [{"dataset", "model", "seconds", "edges_per_s", "ts"}],
    "fig8": [
        FIG8_BASE | {"nop_occupancy_analytic"},
        FIG8_BASE,
        {"dataset", "schedule", "actual_s", "ts"}
        | {f"{k}_{s}" for k in ("dense", "residual", "residual_floor", "transform") for s in ("ms", "noise_floor")},
    ],
    "fig9": [{"dataset", "reorder", "dense_coverage", "hybrid_s", "gather_s", "edges_per_s", "ts"}],
    "fig10a": [{"dataset", "base_s", "adapter_s", "fused_s", "speedup", "ts"}],
    "fig10b": [{"dataset", "split_s", "fused_s", "speedup", "ts"}],
    "fig10b_pallas": [{"dataset", "split_s", "fused_s", "speedup", "ts"}],
    "fig11": [{"dataset", "strategy", "seconds", "edges_per_s", "ts"}],
    "scaling": [{"platform", "devices", "seconds", "edges_per_s", "scaling_efficiency", "n", "m", "representative",
                 "ts"}],
}
# per figure: its tags, the timed functions handed to the check hook and
# how many calls each is timed over (benchmark_chained: 9 iters; the host
# loop: 1 + max(iters, 5); fig8's hybrid is checked, decompose times it)
CHAINED, HOST = 9 * ITERS, 1 + max(ITERS, 5)
FIGURES = {
    "fig7": (fig7_models, ("fig7",), {"fig7.GCN": CHAINED, "fig7.GAT": CHAINED, "fig7.SAGE-LSTM": CHAINED}),
    "fig8": (fig8_balance, ("fig8",), {"fig8.base": CHAINED, "fig8.NG": CHAINED, "fig8.hybrid": 0}),
    "fig9": (fig9_locality, ("fig9",), {"fig9.hybrid": 5 * CHAINED, "fig9.gather": 5 * CHAINED}),
    "fig10": (fig10_fusion, ("fig10a", "fig10b", "fig10b_pallas"), {
        "fig10a.base": HOST, "fig10a.adapter": CHAINED, "fig10a.fused": CHAINED, "fig10b.split": HOST,
        "fig10b.fused": CHAINED, "fig10b_pallas.split": CHAINED, "fig10b_pallas.fused": CHAINED,
    }),
    "fig11": (fig11_sage, ("fig11",), {f"fig11.{k}": CHAINED for k in ("base", "+SpFetch", "+SpFetch+RedBypass")}),
}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the harness's many small ops on tiny graphs
    slow down by two orders of magnitude when their thread pool contends
    with other processes for the cores (as under the parallel test run)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rows(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def _times(row):
    return [v for k, v in row.items() if k.endswith("_s") and k != "ts" or k == "seconds"]


class Recorder:
    """A check hook as chip_smoke.py passes one: it calls each timed
    function once (its output must be finite) and hands back a wrapper that
    counts the calls timed."""

    def __init__(self):
        self.calls = {}

    def __call__(self, what, fn, inputs, ctx):
        with torch.no_grad():
            out = fn(*inputs)
        assert bool(torch.isfinite(out).all()), what
        self.calls.setdefault(what, 0)

        def counted(*a):
            self.calls[what] += 1
            return fn(*a)

        return counted


# ---- tests/test_fig_harness.py on the port's functions


def test_fig8_nop_occupancy_matches_analytic():
    """The 'base' schedule's slot occupancy is the reference's imbalance
    figure: valid slots / issued slots == m / (n * max_degree) for the
    true nop (warp-per-row) grid."""
    g = rmat_graph(512, 4000, seed=2, with_val=False)
    plan = nop_plan(g)
    occ = plan.stats()["slot_occupancy"]
    # stats() occupancy = valid slots / (real tasks * block); nop tasks
    # cover exactly the nonzero-degree rows at block = max_degree
    want = g.num_edges / (plan.num_tasks * plan.block_size)
    assert abs(occ - want) < 1e-9
    assert plan.block_size == max(g.max_degree(), 1)
    assert plan.num_tasks == int((np.diff(np.asarray(g.indptr)) > 0).sum())
    # balanced bound: occupancy <= 1, so balanced = actual * occ <= actual
    assert 0.0 < occ <= 1.0


def test_fig8_base_plan_block_cap():
    g = rmat_graph(512, 4000, seed=2, with_val=False)
    quick = fig8_balance.base_plan(g, True)
    assert quick.block_size == max(g.max_degree(), 1)
    capped = fig8_balance.base_plan(g, False)
    assert capped.block_size == min(max(g.max_degree(), 1), 128)
    # every edge still scheduled exactly once
    assert capped.num_edges == g.num_edges


def test_fig8_ng_occupancy_beats_nop():
    """NG's whole point (graph_schedule.h:91-154): equal-work groups ->
    higher slot occupancy than warp-per-row on a skewed graph."""
    g = rmat_graph(512, 8000, seed=3, with_val=False)
    occ_nop = nop_plan(g).stats()["slot_occupancy"]
    occ_ng = neighbor_grouping_plan(g, 8).stats()["slot_occupancy"]
    assert occ_ng > occ_nop


def test_fig9_coverage_accounting():
    """dense_coverage + residual fraction == 1 (edge conservation), and the
    degree reorder must not change the edge total."""
    g = rmat_graph(1024, 20000, seed=4, with_val=False)
    g2 = g.reorder(degree_sort(g))
    assert g2.num_edges == g.num_edges
    tp, res = densify(g2, tile_rows=256, tile_cols=128, threshold=8)
    cov = tp.num_dense_edges / g2.num_edges
    assert 0.0 <= cov <= 1.0
    assert tp.num_dense_edges + res.num_edges == g2.num_edges
    tp0, res0 = densify(g, tile_rows=256, tile_cols=128, threshold=8)
    assert tp0.num_dense_edges + res0.num_edges == g.num_edges


# ---- the accounting against the JAX harness, at the quick dataset


@pytest.fixture(scope="module")
def quick_graphs():
    """[(name, port graph, JAX graph)] of the quick table."""
    args = common.parser("").parse_args(["--quick"])
    return [(n, g, gj) for (n, g), (_, gj) in zip(common.datasets(args), j_common.datasets(args))]


def test_dataset_tables_and_flags_match_jax():
    assert common.SYN_DATASETS == j_common.SYN_DATASETS
    assert common.QUICK_DATASETS == j_common.QUICK_DATASETS
    port, jax_args = vars(common.parser("").parse_args([])), vars(j_common.parser("").parse_args([]))
    assert {k: port[k] for k in jax_args} == jax_args
    assert set(port) - set(jax_args) == {"device", "results_dir"} and port["device"] == "cuda"


def test_datasets_match_jax(quick_graphs):
    assert [n for n, _, _ in quick_graphs] == list(common.QUICK_DATASETS)
    for _, g, gj in quick_graphs:
        assert np.array_equal(g.indptr, np.asarray(gj.indptr))
        assert np.array_equal(g.indices, np.asarray(gj.indices))
        assert g.num_nodes == gj.num_nodes and g.num_edges == gj.num_edges


@pytest.mark.parametrize("quick", [True, False])
def test_fig8_accounting_matches_jax(quick_graphs, quick):
    """fig8's slot occupancy, tasks, block size and the analytic nop
    occupancy equal the JAX harness's, for the base plan (the nop grid at
    --quick, the capped NG grid otherwise) and NG."""
    for _, g, gj in quick_graphs:
        for sched, plan, jplan in (
            ("base", fig8_balance.base_plan(g, quick), j_fig8.base_plan(gj, quick)),
            ("NG", neighbor_grouping_plan(g, 32), j_ng_plan(gj, 32)),
        ):
            want = dict(slot_occupancy=jplan.stats()["slot_occupancy"], num_tasks=jplan.num_tasks,
                        block_size=jplan.block_size)
            if sched == "base":
                want["nop_occupancy_analytic"] = gj.num_edges / (gj.num_nodes * max(gj.max_degree(), 1))
            assert fig8_balance.plan_fields(g, sched, plan) == want


@pytest.mark.usefixtures("jax_native_from_port")
@pytest.mark.parametrize("order", ["none", "degree", "lpa", "cluster", "cluster_exact"])
def test_fig9_coverage_matches_jax(quick_graphs, order):
    """fig9's permutation and dense coverage under each of its five orders
    equal the JAX harness's (benchmarks/fig9_locality.py:42-60)."""
    j_orders = {
        "none": lambda g: None,
        "degree": j_reorder.degree_sort,
        "lpa": j_reorder.label_propagation_reorder,
        "cluster": lambda g: j_reorder.cluster_reorder(g, num_perm=32, bands=8, threshold=0.2),
        "cluster_exact": lambda g: j_reorder.cluster_reorder_exact(g, num_perm=32, bands=8),
    }
    for _, g, gj in quick_graphs:
        perm, jperm = fig9_locality.reorders(g)[order], j_orders[order](gj)
        assert (perm is None) == (jperm is None)
        if perm is not None:
            assert np.array_equal(perm, np.asarray(jperm))
        g2, gj2 = (g, gj) if perm is None else (g.reorder(perm), gj.reorder(jperm))
        tp, res, cov = fig9_locality.tiles(g2, 256)
        jtp, jres = j_densify(gj2, tile_rows=256, tile_cols=128)
        assert cov == jtp.num_dense_edges / max(gj2.num_edges, 1)
        assert tp.num_tiles == jtp.num_tiles and res.num_edges == jres.num_edges


def test_constants_match_jax():
    assert capture_to_fig7.SCALE_NM == jax_bench.SCALE_NM
    assert capture_to_fig7.V100_OURS == j_capture.V100_OURS
    assert capture_to_fig7.MODEL_NAME == j_capture.MODEL_NAME
    assert (fig7_models.REDDIT_N, fig7_models.REDDIT_M) == (jax_bench.REDDIT_N, jax_bench.REDDIT_M)
    assert plot.SPECS == __import__("benchmarks.plot", fromlist=["SPECS"]).SPECS


# ---- every figure's main() on the CPU


@pytest.mark.parametrize("fig", list(FIGURES))
def test_figure_main_on_cpu(fig, tmp_path, monkeypatch):
    """main() over the test-only table: each row has the JAX record's keys
    plus "device" ("cpu"), finite positive times; every timed function
    reached the check hook and was timed over the harness's calls."""
    module, tags, timed = FIGURES[fig]
    monkeypatch.setattr(common, "QUICK_DATASETS", TINY)
    rec = Recorder()
    module.main(["--quick", "--device", "cpu", "--iters", str(ITERS), "--results-dir", str(tmp_path)], check=rec)
    assert rec.calls == timed
    for tag in tags:
        rows = _rows(tmp_path / f"{tag}.jsonl")
        assert rows and all(r["dataset"] == "rmat_tiny" and r["device"] == "cpu" for r in rows)
        for r in rows:
            assert set(r) - {"device"} in JAX_KEYS[tag], (tag, sorted(r))
            times = _times(r)
            assert times and all(math.isfinite(t) and t > 0 for t in times), (tag, r)
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(f"{t}.jsonl" for t in tags)


def test_fig7_reddit_rows_from_cached_plans(tmp_path, monkeypatch):
    """fig7 --reddit at a small stand-in size: reddit_caches() writes the
    hybrid plan and presample-16 once, the plan read back is the one
    schedule_hybrid builds with REDDIT_PLAN over the degree-sorted graph,
    and the three rows carry the V100 anchors beside JAX's keys."""
    import numpy as np

    from gnn_computing_tpu_torch.aggregator import Aggregator

    n, m = 1000, 8000
    monkeypatch.setattr(fig7_models, "REDDIT_N", n)
    monkeypatch.setattr(fig7_models, "REDDIT_M", m)
    monkeypatch.setattr(fig7_models, "REDDIT_ITERS", ITERS)
    monkeypatch.setattr(fig7_models, "CACHE_DIR", str(tmp_path / "cache"))
    paths = fig7_models.reddit_caches()
    stamps = [os.path.getmtime(p) for p in paths]
    assert fig7_models.reddit_caches() == paths and [os.path.getmtime(p) for p in paths] == stamps
    g = rmat_graph(n, m, seed=123, with_val=False)
    g = g.reorder(degree_sort(g))
    p = fig7_models.REDDIT_PLAN
    want = Aggregator.schedule_hybrid(g, tile_rows=p["tile_rows"], tile_cols=p["tile_cols"], threshold=p["threshold"],
                                      residual_block=p["residual_block"], tile_dtype=np.int8, with_transpose=False,
                                      pack=p["pack"], device="cpu")
    got = fig7_models.reddit_plan("cpu")
    for a, b in ((got.tile, want.tile), (got.plan, want.plan)):
        for k, v in vars(b).items():
            assert (torch.equal(getattr(a, k), v) if isinstance(v, torch.Tensor) else getattr(a, k) == v), k
    fig7_models.main(["--reddit", "--device", "cpu", "--results-dir", str(tmp_path)])
    rows = _rows(tmp_path / "fig7.jsonl")
    assert [(r["model"], r["v100_ours_seconds"]) for r in rows] == [
        ("GCN", 0.058089), ("GAT", 0.055538), ("SAGE-LSTM", 0.014204)]
    for r in rows:
        assert set(r) - {"device"} == JAX_KEYS["fig7"][0] | {"v100_ours_seconds"}
        assert r["dataset"] == "reddit_scale_rmat" and math.isfinite(r["seconds"]) and r["seconds"] > 0


def test_scaling_in_a_gloo_world_of_two(tmp_path):
    """scaling.py --device cpu --world 2: one row a world (d = 1, 2), the
    ranks' concatenated output handed to the check hook with each rank's
    launches (none on the CPU), representative false."""
    seen = []

    def check(what, fn, inputs, ctx):
        seen.append((what, ctx["devices"], fn().shape, [r["launches"] for r in ctx["ranks"]]))

    scaling.main(["--device", "cpu", "--world", "2", "--n", "512", "--m", "4096", "--iters", str(ITERS),
                  "--results-dir", str(tmp_path)], check=check)
    rows = _rows(tmp_path / "scaling.jsonl")
    assert [r["devices"] for r in rows] == [1, 2]
    for r in rows:
        assert set(r) - {"device"} in JAX_KEYS["scaling"]
        assert r["platform"] == "cpu" and r["representative"] is False and r["device"] == "cpu"
        assert r["n"] == 512 and r["m"] == 4096 and math.isfinite(r["seconds"]) and r["seconds"] > 0
    assert rows[0]["scaling_efficiency"] == 1.0
    assert seen == [("scaling.ring", 1, (512, 32), [0]), ("scaling.ring", 2, (512, 32), [0, 0])]


def test_harness_raises_without_cuda(monkeypatch, tmp_path):
    """The figures run on the card unless asked for the CPU: no fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(common, "QUICK_DATASETS", TINY)
    for module, _, _ in FIGURES.values():
        with pytest.raises(RuntimeError, match="cuda"):
            module.main(["--quick", "--results-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="cuda"):
        scaling.main(["--results-dir", str(tmp_path)])
    assert not any(tmp_path.iterdir())


# ---- capture_to_fig7 and plot


def test_capture_to_fig7_rows(tmp_path, capsys):
    """The latest capture row per (model, scale) becomes a fig7 row with the
    V100 anchor and the capture's device; training rows, unknown scales,
    rows without time_s and broken lines are skipped; a second run appends
    nothing."""
    dev = "NVIDIA H100 80GB HBM3, 700.00 W"
    capture = [
        {"metric": "gcn3_reddit_scale_edges_per_s_per_chip", "time_s": 0.05, "ts": 10.0, "device": dev},
        {"metric": "gcn3_reddit_scale_edges_per_s_per_chip", "time_s": 0.04, "ts": 11.0, "device": dev},
        {"metric": "gat3_ppa_scale_edges_per_s_per_chip", "time_s": 0.03, "ts": 12.0, "device": dev},
        {"metric": "sagelstm_protein_scale_edges_per_s_per_chip", "time_s": 0.01, "ts": 13.0, "device": dev},
        {"metric": "gcn3_train_reddit_scale_edges_per_s_per_chip", "time_s": 0.2, "ts": 14.0},
        {"metric": "gcn3_mars_scale_edges_per_s_per_chip", "time_s": 0.2, "ts": 15.0},
        {"metric": "gat3_reddit_scale_edges_per_s_per_chip", "ts": 16.0},
    ]
    path = tmp_path / "cap.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in capture) + "{not json\n")
    argv = ["--capture", str(path), "--results-dir", str(tmp_path)]
    capture_to_fig7.main(argv)
    n_r, m_r = jax_bench.SCALE_NM["reddit"]
    n_pp, m_pp = jax_bench.SCALE_NM["ppa"]
    n_pr, _ = jax_bench.SCALE_NM["protein"]
    want = [
        dict(dataset="ppa_scale_rmat", model="GAT", seconds=0.03, edges_per_s=3 * m_pp / 0.03,
             v100_ours_seconds=0.035884, device=dev, ts=12.0),
        dict(dataset="reddit_scale_rmat", model="GCN", seconds=0.04, edges_per_s=3 * m_r / 0.04,
             v100_ours_seconds=0.058089, device=dev, ts=11.0),
        dict(dataset="protein_scale_rmat", model="SAGE-LSTM", seconds=0.01, edges_per_s=n_pr * 16 / 0.01,
             v100_ours_seconds=0.008578, device=dev, ts=13.0),
    ]
    assert _rows(tmp_path / "fig7.jsonl") == want
    assert "appended 3 rows" in capsys.readouterr().out
    capture_to_fig7.main(argv)
    assert _rows(tmp_path / "fig7.jsonl") == want
    assert "appended 0 rows" in capsys.readouterr().out


def test_plot_renders_pdfs(tmp_path):
    pytest.importorskip("matplotlib")
    rows = {
        "fig7": [dict(dataset="d", model=m, seconds=s, device="cpu", ts=1.0) for m, s in (("GCN", 1.0), ("GAT", 2.0))],
        "fig10a": [dict(dataset="d", base_s=3.0, adapter_s=2.0, fused_s=1.0, speedup=3.0, device="cpu", ts=1.0)],
    }
    for tag, rs in rows.items():
        (tmp_path / f"{tag}.jsonl").write_text("".join(json.dumps(r) + "\n" for r in rs))
    assert plot.main(["fig7", "fig10a", "--results-dir", str(tmp_path)]) == 0
    for tag in rows:
        pdf = tmp_path / f"{tag}.pdf"
        assert pdf.read_bytes()[:4] == b"%PDF"
    assert plot.main(["fig9", "--results-dir", str(tmp_path)]) == 0  # no rows: nothing drawn
    assert not os.path.exists(tmp_path / "fig9.pdf")
    with pytest.raises(SystemExit):
        plot.main(["fig12", "--results-dir", str(tmp_path)])
