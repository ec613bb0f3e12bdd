"""The port's bench (``gnn_computing_tpu_torch/bench.py``) against the root
``bench.py`` on the CPU: caches and forwards at RMAT 2,048 v / 16,384 e,
the model branches at 512 v / 4,096 e.

- Caches: the graph (rmat, community), the hybrid plans (int8 and bfloat16
  tiles, the 1-bit split, the degree and hublpa orders, a second threshold),
  the gather plan and the transposed plans, each built by both benches into
  their own temporary directory: every array of the JAX bench's npz equal
  (values and dtype) to the port's.
- Defaults and metric names: bench.py's per-model and per-scale plan
  defaults, and every model branch run through ``main``'s build and timed
  phases on the CPU, one Emitter line that parses with bench.py's metric
  name and a finite value > 0, and its capture row.
- The bench's gcn and gat forwards (``forward_fn``) against the JAX bench's
  over the same cached plan, input and weights (carried with convert.py):
  max|port - jax| <= 1e-5 max|jax| (float32 summation order), and held to
  ops/validate's gate (|y - ref| <= 1e-2 |ref| + 1e-5) against the float64
  oracle, the port missing it on no more elements than the JAX function
  (on none in the exact modes).  Port against JAX directly the gate does
  not hold at the bench's widths: at a cancellation point of the 3-layer
  512 -> 128 -> 64 -> 32 GCN (|out| 0.063 from sums of terms near 1e4) the
  JAX function's own float32 output is 1.2% off the float64 value, the
  port's within it.
- The orchestrator: a build child, then a timed child, the metric on the
  first stdout line; a timed phase over its budget exits 3 and names it.
"""

import json
import math
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jax_bench
from gnn_computing_tpu.models.gat import GATLayerParams as JGATLayerParams
from gnn_computing_tpu.models.gat import gat_forward as j_gat_forward
from gnn_computing_tpu.models.gcn import fast_layer_opts as j_fast_layer_opts
from gnn_computing_tpu.models.gcn import gcn_forward_bench as j_gcn_forward_bench

from gnn_computing_tpu_torch import bench
from gnn_computing_tpu_torch.benchmarks import capture_to_fig7, fig7_models
from gnn_computing_tpu_torch.convert import gat_params_from_jax, gcn_params_from_jax
from gnn_computing_tpu_torch.graph import normal_features, rmat_graph
from gnn_computing_tpu_torch.models.gat import glorot_gat_weights
from gnn_computing_tpu_torch.models.gcn import BENCH_DIMS, glorot_weights
from gnn_computing_tpu_torch.ops.reference import dense_adjacency, gat_aggregate_dense
from gnn_computing_tpu_torch.ops.validate import relative_error_count

from test_torch_fig_harness import one_thread  # noqa: F401
from test_torch_spmm import jax_native_from_port  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, M = 2048, 16384
TINY = ["--quick", "--device", "cpu", "--iters", "1"]


@pytest.fixture
def tiny(monkeypatch):
    """--quick's graph cut to RMAT 512 v / 4,096 e for the model branches
    (CPU seconds: bench.py --train --model gat's plain B2-B4 steps)."""
    monkeypatch.setattr(bench, "QUICK_N", 512)
    monkeypatch.setattr(bench, "QUICK_M", 4096)


@pytest.fixture
def caches(tmp_path, monkeypatch):
    """(jax dir, port dir): each bench's cache directory under tmp_path."""
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    monkeypatch.setattr(jax_bench, "_cache_dir", lambda: str(jdir))
    monkeypatch.setattr(bench, "CACHE_DIR", str(pdir))
    return jdir, pdir


def assert_npz_equal(jpath, ppath, port_only=()):
    """Every array of the JAX bench's file equal, dtype and values, to the
    port's; the port's holds nothing else but ``port_only``."""
    with np.load(jpath) as zj, np.load(ppath) as zp:
        assert set(zp.files) - set(zj.files) == set(port_only), (sorted(zj.files), sorted(zp.files))
        for k in zj.files:
            assert zj[k].dtype == zp[k].dtype, (k, zj[k].dtype, zp[k].dtype)
            assert np.array_equal(zj[k], zp[k]), k


@pytest.mark.parametrize("kind", ["rmat", "community"])
def test_graph_cache_equals_jax(caches, kind):
    jdir, pdir = caches
    jax_bench.build_graph(N, M, kind=kind)
    g = bench.build_graph(N, M, kind=kind)
    name = f"{kind}_n{N}_m{M}.edges.npz"  # bench.py:248
    assert_npz_equal(jdir / name, pdir / name)
    assert g.num_edges == M
    again = bench.build_graph(N, M, kind=kind)  # from the cache
    assert np.array_equal(again.indices, g.indices) and np.array_equal(again.indptr, g.indptr)


# (graph, hybrid_tag / build_hybrid arguments)
HYBRID = {
    "int8_degree": ("rmat", dict(threshold=48, tile_rows=512, residual_block=4, tile_dtype="int8", reorder="degree",
                                 tile_cols=256)),
    "bits_degree": ("rmat", dict(threshold=24, tile_rows=256, residual_block=4, tile_dtype="int8", reorder="degree",
                                 bit_tiles=True, tile_cols=256)),
    "int8_hublpa": ("community", dict(threshold=24, tile_rows=256, residual_block=4, tile_dtype="int8",
                                      reorder="hublpa")),
    "bf16_degree": ("rmat", dict(threshold=24, tile_rows=512, residual_block=4, tile_dtype="bf16", reorder="degree")),
    "int8_threshold2": ("rmat", dict(threshold=8, tile_rows=512, residual_block=4, tile_dtype="int8",
                                     reorder="degree", tile_cols=256)),
}


@pytest.mark.parametrize("name", sorted(HYBRID))
def test_hybrid_cache_equals_jax(caches, name):
    jdir, pdir = caches
    kind, kw = HYBRID[name]
    jagg = jax_bench.build_hybrid(lambda: jax_bench.build_graph(N, M, kind), N, M, graph_kind=kind, pack=16, **kw)
    agg = bench.build_hybrid(lambda: bench.build_graph(N, M, kind), N, M, graph_kind=kind, pack=16, **kw)
    tag = bench.hybrid_tag(N, M, kw["threshold"], kw["tile_rows"], kw["residual_block"], kw["tile_dtype"], kind,
                           kw["reorder"], kw.get("bit_tiles", False), kw.get("tile_cols", 128))
    assert tag == jax_bench.hybrid_tag(N, M, kw["threshold"], kw["tile_rows"], kw["residual_block"],
                                       kw["tile_dtype"], kind, kw["reorder"], kw.get("bit_tiles", False),
                                       kw.get("tile_cols", 128))
    assert_npz_equal(jdir / f"{tag}.npz", pdir / f"{tag}.npz", port_only={"in_degree"})
    perm = f"perm_{kind}_n{N}_m{M}_{kw['reorder']}.npy"
    assert np.array_equal(np.load(jdir / perm), np.load(pdir / perm))
    # the built aggregator and the one loaded from the cache: JAX's padded parts
    loaded = bench.build_hybrid(None, N, M, graph_kind=kind, pack=16, **kw)
    for a in (agg, loaded):
        parts, jparts = a.tile_parts(), jagg.tile_parts()
        assert len(parts) == len(jparts) >= 1
        for p, jp in zip(parts, jparts):
            assert p.bits == jp.bits and p.num_tiles == jp.num_tiles and p.pack == 16
            assert np.array_equal(np.asarray(p.a).view(np.uint8), np.asarray(jp.a).view(np.uint8))
            assert np.array_equal(p.tile_col, jp.tile_col) and np.array_equal(p.tile_row, jp.tile_row)
        assert np.array_equal(a.plan.src, jagg.plan.src) and a.plan.num_edges == jagg.plan.num_edges
        g2 = bench.build_graph(N, M, kind)
        assert np.array_equal(a.in_degree, g2.reorder(np.load(pdir / perm)).degrees)
    assert bench.build_hybrid(None, N, M, graph_kind=kind, check_only=True, **kw) is None


def test_gather_cache_equals_jax(caches):
    jdir, pdir = caches
    jplan = jax_bench.build_gather(lambda: jax_bench.build_graph(N, M), 32, N, M, "rmat")
    plan = bench.build_gather(lambda: bench.build_graph(N, M), 32, N, M, "rmat")
    name = f"gather_rmat_n{N}_m{M}_b32.npz"  # bench.py:281
    assert_npz_equal(jdir / name, pdir / name)
    loaded = bench.build_gather(None, 32, N, M, "rmat")
    for p in (plan, loaded):
        assert np.array_equal(p.src, jplan.src) and np.array_equal(p.count, jplan.count)
        assert (p.num_tasks, p.num_edges, p.partition_starts) == (jplan.num_tasks, jplan.num_edges, (0, p.num_tasks))


@pytest.mark.parametrize("bit_tiles", [False, True])
def test_transpose_cache_equals_jax(caches, bit_tiles):
    """bench.py --train's plans at its default [256, 256] geometry (R = 256:
    the JAX bench keeps the transposed 1-bit part 1-bit there too)."""
    jdir, pdir = caches
    kw = dict(threshold=24, tile_rows=256, residual_block=4, tile_dtype="int8", reorder="degree",
              bit_tiles=bit_tiles, tile_cols=256)
    tag = bench.hybrid_tag(N, M, 24, 256, 4, "int8", "rmat", "degree", bit_tiles, 256)
    jagg = jax_bench.add_transpose(
        jax_bench.build_hybrid(lambda: jax_bench.build_graph(N, M), N, M, pack=16, **kw), 16, cache_tag=tag)
    agg = bench.add_transpose(bench.build_hybrid(lambda: bench.build_graph(N, M), N, M, pack=16, **kw), 16,
                              cache_tag=tag)
    assert bench.transpose_cached(tag)
    assert_npz_equal(jdir / f"{tag}.transpose.npz", pdir / f"{tag}.transpose.npz")
    loaded = bench.add_transpose(bench.build_hybrid(None, N, M, pack=16, **kw), 16, cache_tag=tag)
    for a in (agg, loaded):
        assert len(a.tile_parts_t()) == len(jagg.tile_parts_t()) == 1 + bit_tiles
        for p, jp in zip(a.tile_parts_t(), jagg.tile_parts_t()):
            assert np.array_equal(p.a, jp.a) and np.array_equal(p.tile_row, jp.tile_row) and p.pack == 16
        assert np.array_equal(a.edge_map_t, jagg.edge_map_t)
        assert np.array_equal(a.plan_t.src, jagg.plan_t.src) and np.array_equal(a.plan_t.val, jagg.plan_t.val)


def test_sample_cache_is_fig7s():
    """The reddit SAGE sample: bench.py --model sage's cache name and
    recipe (presample_fixed_neighbors(g, k=16, seed=2) over the unsorted
    RMAT, key 'nbr'; bench.py:1139-1145) are those of the figure harness's
    fig7 --reddit, which share the file in build/bench_cache/."""
    n, m = bench.SCALE_NM["reddit"]
    assert fig7_models._cache_paths()[1] == os.path.join(bench.CACHE_DIR, f"sample{bench.SAGE_K}_rmat_n{n}_m{m}.npz")


def defaults(*argv):
    args = bench.arg_parser().parse_args(list(argv))
    bench.resolve_defaults(args)
    return {k: getattr(args, k) for k in ("threshold", "tile_rows", "tile_cols", "residual_block", "pack",
                                          "bit_tiles", "input_dtype", "reorder", "scale_label")}


# bench.py's defaults (line numbers of the root bench.py)
DEFAULTS = [
    # :1117-1128, :1357-1364 — the headline
    ((), dict(threshold=48, tile_rows=512, tile_cols=256, residual_block=4, pack=16, bit_tiles=False,
              input_dtype="f32", reorder="degree", scale_label="reddit")),
    (("--model", "gat"), dict(threshold=32, tile_rows=512, tile_cols=256, pack=16, bit_tiles=False)),
    (("--model", "spmm"), dict(threshold=48, tile_cols=256)),
    # :1092-1105 — training; bit tiles on (:935-945)
    (("--train",), dict(threshold=24, tile_rows=256, tile_cols=256, residual_block=4, pack=16, bit_tiles=True)),
    # :1236-1243 — the SDDMM hybrid at r256
    (("--model", "sddmm"), dict(threshold=24, tile_rows=256, tile_cols=128, residual_block=4, pack=16)),
    # :1331-1350 — the sparse scales; bf16 input :1456-1461
    (("--scale", "products"), dict(threshold=384, tile_rows=1024, tile_cols=128, pack=4, bit_tiles=True,
                                   input_dtype="bf16", scale_label="products")),
    (("--scale", "citation"), dict(threshold=48, tile_rows=1024, pack=4, bit_tiles=True, input_dtype="bf16")),
    (("--scale", "ppa"), dict(threshold=96, tile_rows=1024, pack=4, bit_tiles=True, input_dtype="bf16")),
    # :1351-1356 — protein
    (("--scale", "protein"), dict(threshold=48, tile_rows=512, tile_cols=128, pack=16, bit_tiles=False,
                                  input_dtype="f32")),
    # :1081, :1072-1076
    (("--graph", "community"), dict(reorder="hublpa")),
    (("--quick",), dict(threshold=48, tile_cols=256, scale_label="quick")),
    (("--tile-dtype", "bf16", "--scale", "products"), dict(bit_tiles=False)),
    (("--bit-tiles", "on", "--threshold", "12"), dict(bit_tiles=True, threshold=12)),
]


@pytest.mark.parametrize("argv,want", DEFAULTS, ids=[" ".join(a) or "headline" for a, _ in DEFAULTS])
def test_defaults_are_bench_pys(argv, want):
    got = defaults(*argv)
    assert {k: got[k] for k in want} == want


# argv, bench.py's metric name at --quick (scale label "quick"; bench.py line)
BRANCHES = [
    ((), "gcn3_quick_scale_edges_per_s_per_chip"),  # :1477
    (("--model", "gat"), "gat3_quick_scale_edges_per_s_per_chip"),  # :1477
    (("--model", "sage"), "sagelstm_quick_scale_edges_per_s_per_chip"),  # :1164
    (("--model", "edgemlp"), "edgemlp_quick_scale_edges_per_s_per_chip"),  # :1202
    (("--model", "sddmm"), "sddmm_quick_scale_edges_per_s_per_chip"),  # :1276
    (("--model", "sddmm", "--strategy", "gather"), "sddmm_quick_scale_edges_per_s_per_chip"),  # :1307
    (("--model", "spmm"), "spmm_quick_scale_edges_per_s_per_chip"),  # :1422
    (("--train",), "gcn3_train_quick_scale_step_agg_passes_edges_per_s_per_chip"),  # :773-774
    (("--train", "--model", "gat"), "gat3_train_quick_scale_step_agg_passes_edges_per_s_per_chip"),  # :773-774
    (("--strategy", "gather"), "gcn3_quick_scale_edges_per_s_per_chip"),
    (("--model", "gat", "--strategy", "gather"), "gat3_quick_scale_edges_per_s_per_chip"),
    (("--threshold2", "24"), "gcn3_quick_scale_edges_per_s_per_chip"),
    (("--input-dtype", "bf16", "--layer-config", "exact"), "gcn3_quick_scale_edges_per_s_per_chip"),
    (("--residual-dtype", "bf16_split2", "--layer-config", "exact", "--graph", "community"),
     "gcn3_quick_scale_edges_per_s_per_chip"),
    (("--scale", "products", "--model", "gat", "--gat-dot-mode", "exact"), "gat3_quick_scale_edges_per_s_per_chip"),
]


@pytest.mark.parametrize("argv,metric", BRANCHES, ids=[" ".join(a) or "gcn" for a, _ in BRANCHES])
def test_every_branch_emits_bench_pys_line(tmp_path, monkeypatch, capsys, tiny, argv, metric):
    monkeypatch.setattr(bench, "CACHE_DIR", str(tmp_path / "cache"))
    capture = tmp_path / "capture.jsonl"
    argv = [*TINY, *argv, "--capture", str(capture)]
    assert bench.main([*argv, "--phase", "build"]) == 0
    assert capsys.readouterr().out == ""
    assert not torch.cuda.is_initialized()
    assert bench.main([*argv, "--phase", "timed"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1, lines
    rec = json.loads(lines[0])
    assert list(rec) == ["metric", "value", "unit", "vs_baseline"]
    assert rec["metric"] == metric and rec["unit"] == "edges/s"
    assert math.isfinite(rec["value"]) and rec["value"] > 0 and rec["vs_baseline"] > 0
    row, = [json.loads(line) for line in capture.read_text().splitlines()]
    assert row["metric"] == metric and row["device"] == "cpu" and row["scale"] == "quick"
    assert row["time_s"] > 0 and row["calls"] == 12 and row["launches"] == {}  # chains of 1 and 2 calls: 1 * (3 + 3 reps)


def test_refused_paths_exit_nonzero(monkeypatch, tmp_path):
    monkeypatch.setattr(bench, "CACHE_DIR", str(tmp_path))
    for argv in (["--model", "spmm", "--strategy", "gather"], ["--train", "--strategy", "gather"],
                 ["--train", "--model", "sage"]):
        with pytest.raises(SystemExit, match="."):
            bench.main([*argv, "--device", "cpu", "--phase", "build"])


def _same_setting(caches, kind="rmat", **kw):
    """(JAX aggregator, port aggregator on the CPU, input, the reordered
    graph's dense adjacency in float64) over the same cached plan: each
    bench's build_hybrid from its own cache."""
    jagg = jax_bench.build_hybrid(lambda: jax_bench.build_graph(N, M, kind), N, M, graph_kind=kind, **kw)
    agg = bench.build_hybrid(lambda: bench.build_graph(N, M, kind), N, M, graph_kind=kind, **kw)
    h = normal_features(N, BENCH_DIMS[0], seed=123) * 0.1
    g2 = bench.build_graph(N, M, kind).reorder(np.load(caches[1] / f"perm_{kind}_n{N}_m{M}_degree.npy"))
    return jagg.device_put(), agg.to("cpu"), h, g2


def assert_as_close_as_jax(port, jax_out, ref, what: str, exact: bool):
    """max|port - jax| <= 1e-5 max|jax|, and against the float64 oracle the
    port misses the gate on no more elements than the JAX function (on none
    with ``exact``)."""
    port, jax_out = np.asarray(port, np.float64), np.asarray(jax_out, np.float64)
    assert port.shape == jax_out.shape == ref.shape and np.isfinite(port).all()
    err = np.abs(port - jax_out).max()
    assert err <= 1e-5 * np.abs(jax_out).max(), f"{what}: max|port - jax| = {err}"
    bad, jbad = relative_error_count(port, ref), relative_error_count(jax_out, ref)
    assert bad <= (0 if exact else jbad), f"{what}: {bad} elements off the f64 oracle's gate (jax: {jbad})"


@pytest.mark.parametrize("argv", [(), ("--layer-config", "exact", "--residual-dtype", "f16_split2"),
                                  ("--bit-tiles", "on", "--input-dtype", "bf16")])
def test_gcn_forward_matches_jax_bench(caches, argv):
    args = bench.arg_parser().parse_args(["--quick", *argv])
    bench.resolve_defaults(args)
    jagg, agg, h, g2 = _same_setting(
        caches, threshold=args.threshold, tile_rows=args.tile_rows, residual_block=args.residual_block,
        tile_dtype="int8", pack=args.pack, bit_tiles=args.bit_tiles, tile_cols=args.tile_cols)
    weights = glorot_weights(BENCH_DIMS, seed=0)
    fast = args.layer_config == "fast"
    rdt = {"f32": None, "f16_split2": "f16_split2"}[args.residual_dtype]
    x = jnp.asarray(h)
    if args.input_dtype == "bf16":  # bench.py:1462-1465
        x = x.astype(jnp.bfloat16).astype(jnp.float32)
    want = j_gcn_forward_bench(jagg, [jnp.asarray(w) for w in weights], x, residual_gather_dtype=rdt,
                               layer_opts=j_fast_layer_opts(BENCH_DIMS) if fast else None)
    hp = torch.from_numpy(h)
    if args.input_dtype == "bf16":
        hp = hp.to(torch.bfloat16)
    with torch.no_grad():
        got = bench.forward_fn(args)(agg, list(gcn_params_from_jax(weights, device="cpu").weights), hp)
    a = dense_adjacency(g2)
    ref = np.asarray(x, np.float64)
    for w in weights:
        ref = np.maximum(a @ (ref @ w.astype(np.float64)), 0.0)
    assert_as_close_as_jax(got.numpy(), want, ref, f"bench gcn {argv}", exact=not fast)


def test_gat_forward_matches_jax_bench(caches):
    args = bench.arg_parser().parse_args(["--quick", "--model", "gat"])
    bench.resolve_defaults(args)
    jagg, agg, h, g2 = _same_setting(caches, threshold=args.threshold, tile_rows=args.tile_rows,
                                 residual_block=args.residual_block, tile_dtype="int8", pack=args.pack,
                                 tile_cols=args.tile_cols)
    weights = glorot_gat_weights(BENCH_DIMS, seed=0)
    jparams = [JGATLayerParams(jnp.asarray(w), jnp.asarray(a)) for w, a in weights]
    want = j_gat_forward(jagg, jparams, jnp.asarray(h), fast=True, dot_mode=args.gat_dot_mode)  # bench.py:1440
    with torch.no_grad():
        got = bench.forward_fn(args)(agg, gat_params_from_jax(jparams, device="cpu").layer_params(),
                                     torch.from_numpy(h))
    ref = h.astype(np.float64)
    for w, a in weights:
        feat = ref @ w.astype(np.float64)
        att = feat @ a.astype(np.float64)
        ref = gat_aggregate_dense(g2, feat, att[:, 0], att[:, 1])[0]
    assert_as_close_as_jax(got.numpy(), want, ref, "bench gat", exact=True)


def test_quick_capture_row_is_no_figure_row(tmp_path):
    """A --quick capture row names scale "quick": capture_to_fig7 turns it
    into no full-scale fig7 row."""
    cap = tmp_path / "capture.jsonl"
    cap.write_text(json.dumps({"metric": "gcn3_quick_scale_edges_per_s_per_chip", "value": 1.0, "unit": "edges/s",
                               "vs_baseline": 1.0, "time_s": 0.5, "scale": "quick", "ts": 1.0}) + "\n")
    capture_to_fig7.main(["--results-dir", str(tmp_path), "--capture", str(cap)])
    assert (tmp_path / "fig7.jsonl").read_text() == ""


def _run(argv, env=None):
    env = dict(os.environ, **(env or {}), OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.run([sys.executable, "-m", "gnn_computing_tpu_torch.bench", *argv], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


def test_orchestrator_builds_then_times(tmp_path):
    """In subprocesses, as a user runs it: --model edgemlp --quick.  The cache
    is seeded with RMAT 65,536 v / 16,384 e under --quick's graph key (a
    cache file's existence is its validity), so the children build no
    4M-edge graph on the CPU."""
    n, m = bench.QUICK_N, bench.QUICK_M
    cache = tmp_path / "cache"
    cache.mkdir()
    g = rmat_graph(n, 16384, seed=123, with_val=False)
    np.savez(cache / f"rmat_n{n}_m{m}.edges.npz", indptr=g.indptr, indices=g.indices)
    argv = [*TINY, "--model", "edgemlp", "--cache-dir", str(cache), "--capture", str(tmp_path / "cap.jsonl")]
    proc = _run(argv)
    assert proc.returncode == 0, proc.stderr
    first = json.loads(proc.stdout.splitlines()[0])
    assert first["metric"] == "edgemlp_quick_scale_edges_per_s_per_chip" and first["value"] > 0
    assert "phase 1/2" in proc.stderr and "phase 2/2" in proc.stderr
    assert {p.name for p in cache.iterdir()} == {f"rmat_n{n}_m{m}.edges.npz", f"gather_rmat_n{n}_m{m}_b32.npz"}
    # a timed phase over its budget is killed and named; no fall back to --quick
    proc = _run(argv, env={"BENCH_BUDGET_S": "0"})
    assert proc.returncode == 3 and proc.stdout == ""
    assert "timed phase over its budget" in proc.stderr


def test_default_device_raises_without_cuda(monkeypatch, tmp_path, tiny):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(bench, "CACHE_DIR", str(tmp_path))
    with pytest.raises(RuntimeError, match="cuda"):
        bench.main(["--quick"])  # the orchestrator, before any build
    argv = ["--quick"]
    assert bench.main([*argv, "--phase", "build"]) == 0
    with pytest.raises(RuntimeError, match="cuda"):
        bench.main([*argv, "--phase", "timed"])
