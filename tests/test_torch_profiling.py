"""The port's utils against the JAX package's: ``profiling.plan_cost`` and
``tile_cost`` return equal dicts for the same plans (int8, 1-bit, bfloat16
and float32 tiles; exact equality, floats included: the same arithmetic on
the same integers); ``decompose`` gives every phase on the CPU and its
``analytic`` block; ``trace`` writes a Chrome trace; ``flops`` is a copy;
``timing.benchmark_chained`` and ``benchmark`` return a BenchResult."""

import json
import os

import ml_dtypes
import numpy as np
import pytest
import torch

from gnn_computing_tpu.aggregator import Aggregator as JAggregator
from gnn_computing_tpu.graph.synthetic import rmat_graph as j_rmat
from gnn_computing_tpu.utils import flops as j_flops
from gnn_computing_tpu.utils import profiling as j_profiling

from gnn_computing_tpu_torch.aggregator import Aggregator
from gnn_computing_tpu_torch.graph.csr import CSRGraph
from gnn_computing_tpu_torch.graph.synthetic import normal_features
from gnn_computing_tpu_torch.utils import flops, profiling
from gnn_computing_tpu_torch.utils.timing import BenchResult, benchmark, benchmark_chained

KW = dict(tile_rows=64, tile_cols=128, threshold=8, residual_block=4, with_transpose=False)


def graphs(weighted=False):
    gj = j_rmat(2000, 30000, seed=5, with_val=weighted)
    return gj, CSRGraph(gj.indptr, gj.indices, val=gj.val)


@pytest.mark.parametrize("fmt", ["int8", "bits", "bf16", "f32"])
@pytest.mark.parametrize("pack", [1, 16])
@pytest.mark.parametrize("f", [32, 128])
def test_plan_and_tile_cost_equal_jax(fmt, pack, f):
    gj, gp = graphs(weighted=fmt == "f32")
    j_dtype = {"int8": np.int8, "bits": np.int8, "bf16": ml_dtypes.bfloat16, "f32": np.float32}[fmt]
    p_dtype = {"int8": np.int8, "bits": np.int8, "bf16": torch.bfloat16, "f32": np.float32}[fmt]
    bits = fmt == "bits"
    ja = JAggregator.schedule_hybrid(gj, tile_dtype=j_dtype, pack=pack, bit_tiles=bits, device_put=False, **KW)
    pa = Aggregator.schedule_hybrid(gp, tile_dtype=p_dtype, pack=pack, bit_tiles=bits, device="cpu", **KW)
    assert len(pa.tile_parts()) == len(ja.tile_parts()) == (2 if bits else 1)
    for tp, jtp in zip(pa.tile_parts(), ja.tile_parts()):
        assert profiling.tile_cost(tp, f) == j_profiling.tile_cost(jtp, f)
        assert profiling.tile_cost(tp, f, h_bytes_per_elem=4) == j_profiling.tile_cost(jtp, f, h_bytes_per_elem=4)
    assert profiling.plan_cost(pa.plan, f) == j_profiling.plan_cost(ja.plan, f)
    assert profiling.plan_cost(pa.plan, f, dtype_bytes=2) == j_profiling.plan_cost(ja.plan, f, dtype_bytes=2)


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_decompose_phases_on_cpu(model):
    _, gp = graphs()
    agg = Aggregator.schedule_hybrid(gp, tile_dtype=np.int8, pack=1, bit_tiles=True, device="cpu", **KW)
    h = torch.from_numpy(normal_features(gp.num_nodes, 32, seed=1) * 0.1)
    att = torch.from_numpy(normal_features(gp.num_nodes, 2, seed=2) * 0.1)
    out = profiling.decompose(agg, h, model=model, att=att, transform_out=16, iters=2, reps=2)
    phases = ["dense", "residual", "residual_floor", "transform"] + (["total"] if model == "gcn" else [])
    assert sorted(out) == sorted(phases + ["analytic"])
    for phase in phases:
        assert out[phase]["ms"] > 0 and isinstance(out[phase]["noise_floor"], bool), phase
    assert out["analytic"] == {
        "plan": profiling.plan_cost(agg.plan, 32),
        "tile": [profiling.tile_cost(t, 32) for t in agg.tile_parts()],
    }


def test_decompose_gat_needs_att():
    _, gp = graphs()
    agg = Aggregator.schedule_hybrid(gp, tile_dtype=np.int8, pack=1, device="cpu", **KW)
    with pytest.raises(ValueError, match="att"):
        profiling.decompose(agg, torch.zeros(gp.num_nodes, 8), model="gat", iters=1, reps=1)


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "tr")) as logdir:
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(logdir)
    assert logdir == str(tmp_path / "tr") and len(files) == 1 and files[0].endswith(".pt.trace.json")
    with open(os.path.join(logdir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


@pytest.mark.parametrize("m,f,s", [(4_194_304, 128, 0.0036), (114_615_891, 32, 0.058089), (1, 1, 1.0)])
def test_flops_equal_jax(m, f, s):
    assert flops.aggregation_gflops(m, f, s) == j_flops.aggregation_gflops(m, f, s)
    assert flops.edges_per_sec(m, s, passes=3) == j_flops.edges_per_sec(m, s, passes=3)


def test_benchmark_chained_chains_each_call_on_the_last():
    """Chains of iters and 2 iters calls: a warm pair, then each rep's pair;
    every call after the first takes the previous call's perturbed input."""
    seen = []

    def fn(x, w):
        seen.append(x)
        return x @ w

    x, w = torch.rand(256, 32), torch.rand(32, 8)
    calls = []
    r = benchmark_chained(fn, x, w, iters=3, reps=2, on_rep=lambda res, k, reps: calls.append((res, k, reps)))
    assert isinstance(r, BenchResult) and r.min_s > 0 and r.max_s > 0 and r.mean_s >= r.min_s
    assert r.iters == 6 and r.compile_s > 0 and isinstance(r.noise_floor, bool)
    assert [(k, reps) for _, k, reps in calls] == [(1, 2), (2, 2)] and calls[-1][0] is r
    assert len(seen) == 3 + 6 + 2 * (3 + 6)
    assert seen[0] is x and all(s is not x for s in seen[1:3]) and not any(s.requires_grad for s in seen)
    assert "BenchResult(" in repr(r)


def test_benchmark_returns_a_bench_result():
    r = benchmark(lambda: torch.ones(128, 128) @ torch.ones(128, 128), warmup=1, iters=4)
    assert isinstance(r, BenchResult) and r.iters == 4 and 0 < r.min_s <= r.mean_s <= r.max_s
