"""Residual aggregation of the PyTorch port against the JAX package's
``spmm_xla`` and the float64 dense oracle.

Tolerance: the ops/validate gate (|y - ref| <= 1e-2*|ref| + 1e-5) against
both, plus max|port - jax| <= 1e-5 * max|jax|; that slack covers float32
summation order only (the port sums tasks with index_add_, JAX with
segment_sum)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_computing_tpu.graph.synthetic import rmat_graph as j_rmat_graph
from gnn_computing_tpu.ops.spmm import spmm_xla
from gnn_computing_tpu.ops.validate import assert_valid as j_assert_valid
from gnn_computing_tpu.schedule import Schedule, make_plan

from gnn_computing_tpu_torch.graph import rmat_graph
from gnn_computing_tpu_torch.ops.reference import spmm_dense
from gnn_computing_tpu_torch.ops.spmm import spmm_plain
from gnn_computing_tpu_torch.ops.validate import assert_valid
from gnn_computing_tpu_torch.schedule.neighbor_grouping import neighbor_grouping_plan


def assert_matches_jax(port, jax_out, ref=None, what=""):
    port = np.asarray(port, np.float64)
    jax_out = np.asarray(jax_out, np.float64)
    assert port.shape == jax_out.shape
    assert np.isfinite(port).all()
    assert_valid(port, jax_out, what=f"{what} vs jax")
    if ref is not None:
        assert_valid(port, ref, what=f"{what} vs f64 oracle")
        j_assert_valid(jax_out, ref, what=f"{what}: jax vs f64 oracle")
    err = np.abs(port - jax_out).max()
    assert err <= 1e-5 * np.abs(jax_out).max(), f"{what}: max|port-jax| = {err}"


@pytest.mark.parametrize("gather_dtype", [None, "f16_split2"])
@pytest.mark.parametrize("block,f", [(4, 16), (8, 40)])
def test_residual_matches_spmm_xla(gather_dtype, block, f):
    gj = j_rmat_graph(500, 8000, seed=13, with_val=True, device="cpu")
    gp = rmat_graph(500, 8000, seed=13, with_val=True)
    h = np.random.default_rng(1).standard_normal((500, f)).astype(np.float32)
    want = spmm_xla(
        make_plan(gj, Schedule.neighbor_grouping, block_size=block).device_put(),
        jnp.asarray(h),
        gather_dtype=gather_dtype,
    )
    plan = neighbor_grouping_plan(gp, block_size=block).to("cpu")
    got = spmm_plain(plan, torch.from_numpy(h), gather_dtype=gather_dtype)
    assert got.dtype == torch.float32
    assert_matches_jax(got.numpy(), jax.device_get(want), spmm_dense(gp, h), what=f"residual {gather_dtype}")


def test_residual_rejects_unported_gather_dtype():
    """'bf16_split2', once refused, agrees with the JAX package's
    ``spmm_xla`` (max|port - jax| <= 1e-5 * max|jax|; it is held to JAX
    only, not to the f64 oracle); a string the JAX package does not know
    as a gather mode either ('bf16') raises."""
    gj = j_rmat_graph(50, 300, seed=1, with_val=True, device="cpu")
    gp = rmat_graph(50, 300, seed=1, with_val=True)
    h = np.random.default_rng(4).standard_normal((50, 8)).astype(np.float32)
    plan = neighbor_grouping_plan(gp, block_size=4).to("cpu")
    want = np.asarray(spmm_xla(
        make_plan(gj, Schedule.neighbor_grouping, block_size=4).device_put(), jnp.asarray(h), gather_dtype="bf16_split2",
    ))
    got = spmm_plain(plan, torch.from_numpy(h), gather_dtype="bf16_split2").numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    with pytest.raises(ValueError):
        spmm_plain(plan, torch.zeros(50, 8), gather_dtype="bf16")


def test_f16_split2_beyond_float16_range():
    """|h| > 65504 does not fit float16 chunks (the JAX package's table
    turns it into inf/NaN); the port stores that row scaled by a power of
    two, chosen on the device, so the result stays within the gate of the
    float64 oracle and of the exact mode of both packages (tolerance:
    assert_matches_jax), and every output row that reads no such row is
    bit-equal to the f16_split2 result without it."""
    gj = j_rmat_graph(300, 5000, seed=17, with_val=True, device="cpu")
    gp = rmat_graph(300, 5000, seed=17, with_val=True)
    h = np.random.default_rng(2).standard_normal((300, 12)).astype(np.float32)
    h[7, 3] = 3.0e5
    want = spmm_xla(make_plan(gj, Schedule.neighbor_grouping, block_size=4).device_put(), jnp.asarray(h))
    plan = neighbor_grouping_plan(gp, block_size=4).to("cpu")
    got = spmm_plain(plan, torch.from_numpy(h), gather_dtype="f16_split2")
    assert_matches_jax(got.numpy(), jax.device_get(want), spmm_dense(gp, h), what="f16_split2 overflow")
    in_range = h.copy()
    in_range[7, 3] = 0.0
    base = spmm_plain(plan, torch.from_numpy(in_range), gather_dtype="f16_split2")
    reads_7 = np.zeros(300, bool)
    reads_7[gp.dst_per_edge[gp.indices == 7]] = True
    assert reads_7.any() and not reads_7.all()
    assert torch.equal(got[~reads_7], base[~reads_7])


@pytest.mark.parametrize("fn", ["weighted_task_sums", "sddmm_slots", "att_slots_flat"])
def test_f16_split2_rows_past_float16_range(fn):
    """The f16_split2 gathers choose each row's scale on the device: rows
    within float16's range are gathered exactly as the JAX package's table
    does (bit-equal to the same call with the wide rows zeroed), rows past
    65504 stay finite and within the gate of the float64 result."""
    from gnn_computing_tpu_torch.ops.gat import _att_slots_flat
    from gnn_computing_tpu_torch.ops.spmm import f16_split2_rows, sddmm_slots, weighted_task_sums

    gp = rmat_graph(300, 5000, seed=17, with_val=True)
    plan = neighbor_grouping_plan(gp, block_size=4).to("cpu")
    rng = np.random.default_rng(4)
    h = rng.standard_normal((300, 12)).astype(np.float32)
    wide = [7, 41]
    h[7, 3] = 3.0e5
    h[41] *= 2.0e5
    _, scale = f16_split2_rows(torch.from_numpy(h))
    assert torch.equal(scale == 1.0, torch.from_numpy(~np.isin(np.arange(300), wide)))
    b = torch.from_numpy(rng.standard_normal((300, 12)).astype(np.float32))
    calls = {
        "weighted_task_sums": lambda x, g: weighted_task_sums(plan, x, plan.val, gather_dtype=g),
        "sddmm_slots": lambda x, g: sddmm_slots(plan, x, b, gather_dtype=g),
        "att_slots_flat": lambda x, g: _att_slots_flat(plan, x[:, :2], gather_dtype=g),
    }
    call = calls[fn]
    got = call(torch.from_numpy(h), "f16_split2")
    exact = call(torch.from_numpy(h).double(), None)
    assert bool(torch.isfinite(got).all())
    assert_valid(got.double().numpy(), exact.numpy(), what=f"{fn} past 65504")
    in_range = h.copy()
    if fn == "att_slots_flat":
        in_range[wide, 1] = 0.0  # the gathered src half only
    else:
        in_range[wide] = 0.0
    base = call(torch.from_numpy(in_range), "f16_split2")
    # the slots (and tasks) that read no wide row are unchanged
    src = plan.src.reshape(-1)
    reads = torch.from_numpy(np.isin(src.numpy(), wide))
    if fn == "weighted_task_sums":
        reads = reads.reshape(-1, 4).any(dim=1)
    assert bool(reads.any()) and not bool(reads.all())
    assert torch.equal(got[~reads], base[~reads])
