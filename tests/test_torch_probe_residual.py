"""The port's residual-DMA probe (``gnn_computing_tpu_torch.probes.
overlap_dma_residual``) on the CPU, where ``dma_task_sums`` and
``fused_hybrid`` run their plain versions (which stand beside the P1 and P2
CUDA kernels), against the JAX probe's Pallas kernels run in TPU interpret
mode (``pltpu.force_tpu_interpret_mode()``), over an unscaled and a
factored (scale_src / scale_dst) int8 plan and a bfloat16 count plan.  The
JAX kernels take the residual plan's slots padded to whole grid steps; the
port takes the plan's own layout, so the first num_tasks_p task sums are
compared.

Tolerance: max|port - jax| <= 1e-5 * max|jax| (float32 summation order
only: the dense part is the same 'split' or 'split3' operand times exact
counts, the task sums the same products).  Float32 tiles: the port reads
their values as float32 (bcsr_spmm_plain's result exactly), the JAX probe
casts them to its bf16 operand's type, so over non-integer values it equals
the port over the plan's tiles rounded to bfloat16.  A 1-bit plan raises
ValueError."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gnn_computing_tpu.graph.reorder import degree_sort as j_degree_sort
from gnn_computing_tpu.graph.synthetic import rmat_graph as j_rmat_graph
from gnn_computing_tpu.schedule.tiles import densify as j_densify
from probes.overlap_dma_residual import dma_task_sums as j_dma_task_sums
from probes.overlap_dma_residual import fused_hybrid as j_fused_hybrid

from gnn_computing_tpu_torch.graph import degree_sort, rmat_graph
from gnn_computing_tpu_torch.ops import cuda_bcsr, cuda_residual
from gnn_computing_tpu_torch.ops.bcsr import bcsr_spmm_plain, round_h
from gnn_computing_tpu_torch.ops.spmm import weighted_task_sums
from gnn_computing_tpu_torch.probes import overlap_dma_residual as probe
from gnn_computing_tpu_torch.schedule.neighbor_grouping import neighbor_grouping_plan
from gnn_computing_tpu_torch.schedule.tiles import densify, split_bit_tiles

F = 16
TILES = dict(tile_rows=64, tile_cols=128, threshold=8)


def _launches():
    return cuda_bcsr.launches, cuda_residual.task_sums_launches, cuda_residual.fused_launches


def _setting(factored=False, dtype="int8", n=1024, m=24000):
    """(JAX tile plan, port tile plan, host residual plan, h): the same RMAT
    graph densified in both packages (int8 counts, or their bfloat16 /
    float32 form; ``factored``: edge values sd[dst] * ss[src] with the
    scales factored out of the tiles), residual block 4."""
    gj = j_rmat_graph(n, m, seed=17, with_val=False, device="cpu")
    gp = rmat_graph(n, m, seed=17, with_val=False)
    gj, gp = gj.reorder(j_degree_sort(gj)), gp.reorder(degree_sort(gp))
    kw = dict(TILES)
    val = None
    if factored:
        rng = np.random.default_rng(8)
        sd = rng.uniform(0.2, 2.0, n).astype(np.float32)
        ss = rng.uniform(0.2, 2.0, n).astype(np.float32)
        val = sd[gp.dst_per_edge] * ss[gp.indices]
        kw.update(scale_dst=sd, scale_src=ss)
    jdt, pdt = {"int8": (np.int8, np.int8), "bf16": (jnp.bfloat16, torch.bfloat16), "f32": (np.float32, np.float32)}[dtype]
    tj, _ = j_densify(gj, val=val, dtype=jdt, **kw)
    tp, res = densify(gp, val=val, dtype=pdt, **kw)
    plan = neighbor_grouping_plan(res, block_size=4)
    h = np.random.default_rng(1).standard_normal((n, F)).astype(np.float32) * 0.1
    return tj, tp, plan, h


def _jax_slots(plan, steps):
    """The JAX probe's residual inputs: the plan's slots padded to ``steps``
    grid steps of tpb tasks (idx_steps [steps, tpb * B], val [steps * tpb,
    B])."""
    nt, blk = plan.src.shape
    tpb = -(-nt // steps)
    pad = steps * tpb - nt
    src = np.pad(plan.src, ((0, pad), (0, 0))).reshape(steps, tpb * blk).astype(np.int32)
    return jnp.asarray(src), jnp.asarray(np.pad(plan.val, ((0, pad), (0, 0)))), tpb, blk


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    assert np.isfinite(got).all(), what
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), what


@pytest.mark.parametrize("factored", [False, True])
def test_dma_task_sums_matches_jax(factored):
    _, _, plan, h = _setting(factored)
    nt = plan.src.shape[0]
    idx, val, tpb, blk = _jax_slots(plan, steps=-(-nt // 64))
    with pltpu.force_tpu_interpret_mode():
        want = j_dma_task_sums(jnp.asarray(h), idx, val, tpb, blk)
    got = probe.dma_task_sums(plan.to("cpu"), torch.from_numpy(h))
    assert got.shape == (nt, F)
    _close(got.numpy(), jax.device_get(want)[:nt], f"task sums factored={factored}")
    assert torch.equal(got, weighted_task_sums(plan.to("cpu"), torch.from_numpy(h), plan.to("cpu").val))
    assert _launches() == (0, 0, 0)


@pytest.mark.parametrize("setting", ["int8", "int8-factored", "bf16"])
@pytest.mark.parametrize("h_mode", ["split", "split3"])
def test_fused_hybrid_matches_jax(setting, h_mode):
    tj, tp, plan, h = _setting(factored=setting.endswith("factored"), dtype=setting.split("-")[0])
    idx, val, tpb, blk = _jax_slots(plan, steps=tj.a.shape[0])
    with pltpu.force_tpu_interpret_mode():
        want_dense, want_ts = j_fused_hybrid(tj.device_put(), jnp.asarray(h), idx, val, tpb, blk, h_mode=h_mode)
    tpc, planc, ht = tp.to("cpu"), plan.to("cpu"), torch.from_numpy(h)
    dense, ts = probe.fused_hybrid(tpc, planc, ht, h_mode)
    _close(dense.numpy(), jax.device_get(want_dense), f"dense {setting} {h_mode}")
    _close(ts.numpy(), jax.device_get(want_ts)[: plan.src.shape[0]], f"task sums {setting} {h_mode}")
    # the plain version: B1's and P1's
    assert torch.equal(dense, bcsr_spmm_plain(tpc, round_h(ht, h_mode)))
    assert torch.equal(ts, weighted_task_sums(planc, ht, planc.val))
    assert _launches() == (0, 0, 0)


def test_fused_hybrid_float32_tiles():
    """Float32 tiles of non-integer edge values: the port keeps each value in
    float32 (its dense part is bcsr_spmm_plain's), while the JAX probe casts
    the tiles to bf16, so it equals the port over the tiles rounded to
    bfloat16; over float32 count tiles the two agree."""
    tj, tp, plan, h = _setting(dtype="f32")
    idx, val, tpb, blk = _jax_slots(plan, steps=tj.a.shape[0])
    with pltpu.force_tpu_interpret_mode():
        want_counts = j_fused_hybrid(tj.device_put(), jnp.asarray(h), idx, val, tpb, blk)[0]
    tpc, planc, ht = tp.to("cpu"), plan.to("cpu"), torch.from_numpy(h)
    _close(probe.fused_hybrid(tpc, planc, ht)[0].numpy(), jax.device_get(want_counts), "float32 counts")

    rng = np.random.default_rng(3)
    vals = rng.uniform(0.1, 1.0, tp.a.shape).astype(np.float32) * (np.asarray(tp.a) != 0)
    with pltpu.force_tpu_interpret_mode():
        want = j_fused_hybrid(dataclasses.replace(tj, a=vals).device_put(), jnp.asarray(h), idx, val, tpb, blk)[0]
    want = jax.device_get(want)
    tv = dataclasses.replace(tpc, a=torch.from_numpy(vals))
    dense = probe.fused_hybrid(tv, planc, ht)[0]
    assert torch.equal(dense, bcsr_spmm_plain(tv, round_h(ht, "split")))
    _close(probe.fused_hybrid(tv.astype(torch.bfloat16), planc, ht)[0].numpy(), want, "float32 values vs bf16 cast")
    assert np.abs(dense.numpy() - want).max() > 1e-5 * np.abs(want).max()  # the cast is visible


def test_one_bit_plan_raises():
    _, tp, plan, h = _setting()
    bits = split_bit_tiles(tp)[0]
    assert bits is not None and bits.bits
    with pytest.raises(ValueError, match="1-bit"):
        probe.fused_hybrid(bits.to("cpu"), plan.to("cpu"), torch.from_numpy(h))
    with pytest.raises(ValueError):
        probe.fused_hybrid(tp.to("cpu"), plan.to("cpu"), torch.from_numpy(h), h_mode="bf16")


@pytest.mark.parametrize("mode", ["standalone", "fused"])
def test_probe_main_on_cpu(mode, capsys):
    """The probe's main() at a tiny size on the CPU: its plan, the errors
    against spmm_plain / hybrid_spmm (float32 summation order only), and no
    time (a CPU run takes none)."""
    out = probe.main(["--device", "cpu", "--nodes", "2048", "--edges", "40000", "--f", "24", "--mode", mode])
    assert out["device"] == "cpu" and out["tiles"] > 0 and out["slots"] == out["tasks"] * 4
    assert out["error"]["max_abs_over_max_ref"] <= 1e-5
    keys = ("task_sums_ms", "residual_ms") if mode == "standalone" else ("fused_ms", "sequential_ms", "b1_p1_ms")
    assert all(out[k] is None for k in keys)
    assert "not measured on the CPU" in capsys.readouterr().out
    assert _launches() == (0, 0, 0)
