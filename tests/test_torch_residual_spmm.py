"""The hybrid op's residual dispatcher (``ops.spmm.residual_spmm_``) on the
CPU, where it adds ``spmm_plain``'s result into the output it is given.

On the CPU it equals out + spmm_plain bit for bit, in every gather mode,
over sorted and unsorted plans, with the plan's values or ``val`` given;
it refuses a tensor that requires grad with grad enabled and an output of
the wrong dtype, shape or device.  Its kernel counter
``residual.kernel_slots`` stays 0 on the CPU, and ``kernel_takes`` gives
the residual kernel (R1, a card only) float32 rows alone.  ``HybridSpmm``,
the GAT residual's backward and a GCN training step on the CPU read the
same bits as the formula they replaced (out + spmm_plain, out of place).
The kernel itself is held to its oracles in ``tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

from gnn_computing_tpu_torch.aggregator import Aggregator
from gnn_computing_tpu_torch.graph import degree_sort, normal_features, rmat_graph
from gnn_computing_tpu_torch.models.gcn import gcn_forward_bench, glorot_weights
from gnn_computing_tpu_torch.models.training import make_train_step
from gnn_computing_tpu_torch.ops import bcsr, bcsr_gat, cuda_residual
from gnn_computing_tpu_torch.ops.bcsr import bcsr_spmm, hybrid_spmm
from gnn_computing_tpu_torch.ops.spmm import kernel_takes, residual_spmm_, slots_from_edge_values_flat, spmm_plain
from gnn_computing_tpu_torch.schedule.locality import locality_plan
from gnn_computing_tpu_torch.schedule.neighbor_grouping import neighbor_grouping_plan
from gnn_computing_tpu_torch.utils.profiling import recording

MODES = [None, torch.float32, "f16_split2", "bf16_split2", torch.bfloat16]
DIMS = (16, 8, 8, 4)


def _graph():
    return rmat_graph(700, 9000, seed=4, with_val=False)


def _plan(kind: str):
    g = _graph()
    plan = {"ng4": lambda: neighbor_grouping_plan(g, block_size=4),
            "ng8": lambda: neighbor_grouping_plan(g, block_size=8, pad_multiple=32),
            "locality": lambda: locality_plan(g, num_partitions=3, block_size=4)}[kind]()
    return g, plan.to("cpu")


def _parent_residual(out, plan, h, val=None, gather_dtype=None):
    """The formula the dispatcher replaced: out + spmm_plain, out of place."""
    return out + spmm_plain(plan, h, gather_dtype=gather_dtype, val=val)


@pytest.mark.parametrize("kind", ["ng4", "ng8", "locality"])
@pytest.mark.parametrize("mode", MODES, ids=str)
@pytest.mark.parametrize("values", [False, True])
def test_dispatcher_on_cpu_is_out_plus_spmm_plain(kind, mode, values):
    g, plan = _plan(kind)
    rng = np.random.default_rng(1)
    h = torch.from_numpy(rng.standard_normal((g.n_src, 12)).astype(np.float32))
    out = torch.from_numpy(rng.standard_normal((g.num_nodes, 12)).astype(np.float32))
    val = None
    if values:
        val = slots_from_edge_values_flat(plan, torch.from_numpy(rng.uniform(-1, 2, g.num_edges).astype(np.float32)))
    want = out + spmm_plain(plan, h, gather_dtype=mode, val=val)
    got = out.clone()
    assert residual_spmm_(got, plan, h, val=val, gather_dtype=mode) is got
    assert torch.equal(got, want)


def test_dispatcher_takes_float64_on_cpu():
    g, plan = _plan("ng4")
    h = torch.randn(g.n_src, 5, dtype=torch.float64)
    out = torch.randn(g.num_nodes, 5, dtype=torch.float64)
    assert torch.equal(residual_spmm_(out.clone(), plan, h), out + spmm_plain(plan, h))


@pytest.mark.parametrize("which", ["out", "h", "val"])
def test_dispatcher_refuses_grad(which):
    g, plan = _plan("ng4")
    t = {"out": torch.zeros(g.num_nodes, 4), "h": torch.randn(g.n_src, 4), "val": plan.val.clone()}
    t[which].requires_grad_(True)
    with pytest.raises(RuntimeError, match="requires grad"):
        residual_spmm_(t["out"], plan, t["h"], val=t["val"])
    with torch.no_grad():
        residual_spmm_(t["out"], plan, t["h"], val=t["val"])


@pytest.mark.parametrize("case", ["out_dtype", "out_rows", "out_cols", "h_1d", "h_int", "val_shape"])
def test_dispatcher_refuses_wrong_dtypes_and_shapes(case):
    g, plan = _plan("ng4")
    out, h, val = torch.zeros(g.num_nodes, 4), torch.randn(g.n_src, 4), None
    if case == "out_dtype":
        out = out.double()
    elif case == "out_rows":
        out = out[:-1]
    elif case == "out_cols":
        out = torch.zeros(g.num_nodes, 5)
    elif case == "h_1d":
        h = h[:, 0]
    elif case == "h_int":
        h, out = h.long(), out.long()
    else:
        val = plan.val[:-1]
    with pytest.raises(ValueError):
        residual_spmm_(out, plan, h, val=val)


def test_kernel_takes_float32_rows_on_a_card_only():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert kernel_takes(cuda, None) and kernel_takes(cuda, torch.float32)
    for mode in ("f16_split2", "bf16_split2", torch.bfloat16, torch.float16):
        assert not kernel_takes(cuda, mode)
    assert not any(kernel_takes(cpu, mode) for mode in MODES)


@pytest.fixture(scope="module")
def agg():
    g = _graph()
    return Aggregator.schedule_hybrid(g.reorder(degree_sort(g)), tile_rows=16, tile_cols=128, threshold=4,
                                      residual_block=4, pack=2, tile_dtype=np.int8, bit_tiles=True, device="cpu")


@pytest.mark.parametrize("mode", MODES, ids=str)
def test_kernel_slots_stay_zero_on_cpu(agg, mode):
    h = torch.randn(agg.plan.n_src, 8, requires_grad=True)
    before = cuda_residual.launches
    with recording() as rec:
        agg.run(h, residual_gather_dtype=mode).sum().backward()
    slots = agg.plan.num_tasks_padded * agg.plan.block_size + agg.plan_t.num_tasks_padded * agg.plan_t.block_size
    assert rec.counters["residual.slots"] == slots
    assert rec.counters.get("residual.kernel_slots", 0) == 0
    assert cuda_residual.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mode", [None, "f16_split2"], ids=str)
def test_hybrid_spmm_on_cpu_is_the_parents(agg, dtype, mode):
    """Forward and gradient bitwise the parent's: tiles + spmm_plain over
    the plan, transposed tiles + spmm_plain over the transposed plan."""
    rng = np.random.default_rng(2)
    h0 = torch.from_numpy(rng.standard_normal((agg.plan.n_src, 8))).to(dtype)
    ct = torch.from_numpy(rng.standard_normal((agg.plan.num_nodes, 8))).to(dtype)
    h = h0.clone().requires_grad_(True)
    out = hybrid_spmm(agg.tile_parts(), agg.plan, h, mode, tp_t=agg.tile_parts_t(), plan_t=agg.plan_t)
    out.backward(ct)
    want = bcsr_spmm(agg.tile_parts(), h0) + spmm_plain(agg.plan, h0, gather_dtype=mode)
    want_dh = bcsr_spmm(agg.tile_parts_t(), ct) + spmm_plain(agg.plan_t, ct)
    assert torch.equal(out.detach(), want)
    assert torch.equal(h.grad, want_dh)


def _gcn_steps(agg, n_steps: int = 2):
    g_nodes = agg.plan.num_nodes
    leaves = [torch.from_numpy(w).requires_grad_(True) for w in glorot_weights(DIMS, seed=1)]
    step = make_train_step(lambda x: gcn_forward_bench(agg, leaves, x), torch.optim.Adam(leaves, lr=1e-3),
                           device="cpu")
    h = torch.from_numpy(normal_features(g_nodes, DIMS[0], seed=2))
    labels = np.random.default_rng(3).integers(0, DIMS[-1], g_nodes)
    losses = [step((h,), labels) for _ in range(n_steps)]
    return losses, [w.detach().clone() for w in leaves]


def test_gcn_step_on_cpu_is_the_parents(agg, monkeypatch):
    losses, leaves = _gcn_steps(agg)
    monkeypatch.setattr(bcsr, "residual_spmm_", _parent_residual)
    want_losses, want_leaves = _gcn_steps(agg)
    assert all(torch.equal(a, b) for a, b in zip(losses, want_losses))
    assert all(torch.equal(a, b) for a, b in zip(leaves, want_leaves))


def test_gat_residual_backward_on_cpu_is_the_parents(agg, monkeypatch):
    """The GAT residual's dh (over the transposed plan with the carried slot
    scores) equals spmm_plain's on the CPU, with its d_ad and d_as."""
    rng = np.random.default_rng(5)
    n, f = agg.plan.num_nodes, 6
    h = torch.from_numpy(rng.standard_normal((n, f)).astype(np.float32))
    gbar = torch.from_numpy(rng.standard_normal((n, f)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    score = torch.from_numpy(rng.uniform(0.1, 2.0, agg.plan.num_tasks_padded * agg.plan.block_size)
                             .astype(np.float32)) * agg.plan.slot_mask().reshape(-1)
    args = (agg.plan, agg.plan_t, agg.edge_map_t, h, gbar, c, score, None, 0.2)
    got = bcsr_gat._residual_bwd_flat(*args)
    monkeypatch.setattr(bcsr_gat, "residual_spmm_", _parent_residual)
    want = bcsr_gat._residual_bwd_flat(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
