"""The port's entry point (``gnn_computing_tpu_torch/entry.py``) against
``__graft_entry__.entry()`` on the CPU: the same graph and hybrid plan (the
1-bit and int8 tile parts, padded to 8, and the residual plan array-equal),
and ``fn`` over the same weights (carried with convert.py) and input:
max|port - jax| <= 1e-5 max|jax| (float32 summation order), and against
the float64 edge-list oracle ops/validate's gate (|y - ref| <= 1e-2 |ref|
+ 1e-5) with no element off for the port (the forward's exact modes).
Without a card ``entry()`` raises; ``main`` runs the forward, then the dry
run in a gloo world of one."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry

from gnn_computing_tpu_torch import entry
from gnn_computing_tpu_torch.convert import gcn_params_from_jax
from gnn_computing_tpu_torch.graph import rmat_graph
from gnn_computing_tpu_torch.models.gcn import glorot_weights
from gnn_computing_tpu_torch.ops import cuda_bcsr
from gnn_computing_tpu_torch.ops.validate import relative_error_count

from test_torch_fig_harness import one_thread  # noqa: F401
from test_torch_spmm import jax_native_from_port  # noqa: F401


@pytest.fixture(scope="module")
def both():
    """(JAX fn, its args), (port fn, its args on the CPU)."""
    return jax_entry.entry(), entry.entry(device="cpu")


def test_entry_plan_equals_jax(both):
    (_, (jagg, _, jh)), (_, (agg, params, h)) = both
    assert len(agg.tile_parts()) == len(jagg.tile_parts()) == 2  # the 1-bit and the int8 part
    for p, jp in zip(agg.tile_parts(), jagg.tile_parts()):
        assert p.bits == jp.bits and p.pack == jp.pack == 8 and (p.tile_rows, p.tile_cols) == (512, 128)
        assert np.array_equal(p.a.numpy().view(np.uint8), np.asarray(jp.a).view(np.uint8))
        assert np.array_equal(p.tile_col.numpy(), jp.tile_col) and np.array_equal(p.tile_row.numpy(), jp.tile_row)
    plan, jplan = agg.plan, jagg.plan
    assert (plan.num_edges, plan.block_size) == (jplan.num_edges, 4)
    assert np.array_equal(plan.src.numpy(), np.asarray(jplan.src).reshape(-1))
    assert agg.plan_t is None and agg.tile_parts_t() == ()
    assert np.array_equal(h.numpy(), np.asarray(jh))
    assert [tuple(w.shape) for w in params] == [(512, 128), (128, 64), (64, 32)]
    assert all(w.device.type == "cpu" for w in params)


def test_entry_forward_matches_jax(both):
    (jfn, (jagg, _, jh)), (fn, (agg, _, h)) = both
    weights = glorot_weights(entry.DIMS, seed=0)
    want = np.asarray(jax.jit(jfn)(jagg, [jnp.asarray(w) for w in weights], jh), np.float64)
    with torch.no_grad():
        got = fn(agg, list(gcn_params_from_jax(weights, device="cpu").weights), h).numpy().astype(np.float64)
    assert got.shape == (4096, 32) and np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    g = rmat_graph(*entry.GRAPH, seed=123, with_val=False)
    dst, src = g.dst_per_edge, g.indices
    ref = h.numpy().astype(np.float64)
    for w in weights:
        z = ref @ w.astype(np.float64)
        ref = np.zeros((g.num_nodes, z.shape[1]))
        np.add.at(ref, dst, z[src])
        ref = np.maximum(ref, 0.0)
    assert relative_error_count(got, ref) == 0
    assert cuda_bcsr.launches == 0


def test_entry_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        entry.entry()
    with pytest.raises(RuntimeError, match="cuda"):
        entry.main([])


def test_entry_main_on_the_cpu(capsys):
    entry.main(["1", "--device", "cpu", "--no-arxiv"])
    out = capsys.readouterr().out
    assert "entry OK (4096, 32)" in out and "dryrun_multichip(1): gloo world" in out
