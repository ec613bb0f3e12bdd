"""SpMM, its transpose, the SDDMM and the fused aggregate+GEMM over the
gather-only schedules (neighbor grouping, plain locality, locality +
neighbor grouping, nop) of the PyTorch port, against the JAX package on the
CPU (``spmm_xla``, ``spmm_transpose_xla``, ``sddmm``, ``spmm_nn``,
``spmm_bidir`` and ``jax.grad``) and the float64 dense oracles, from the
same numpy-seeded graph and inputs.

Tolerance: max|port - jax| <= 1e-5 * max|jax| (float32 summation order
only) in the exact modes (None, 'f16_split2') and 'bf16_split2'; the plain
16-bit modes (torch.bfloat16 / torch.float16 against jnp.bfloat16 /
jnp.float16) within 4 ulps of their dtype times max|jax|.  The exact modes
also pass the repo gate (|y - ref| <= 1e-2*|ref| + 1e-5) against the
float64 oracle; 'bf16_split2' and the 16-bit modes are held to JAX only
(JAX's own notes: 'bf16_split2' misses the gate on cancelling dots).
Gradients: within 1e-4 relative L2 of ``jax.grad``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_computing_tpu.aggregator import Aggregator as JAggregator
from gnn_computing_tpu.ops.fused_nn import spmm_nn as j_spmm_nn
from gnn_computing_tpu.ops.sddmm import sddmm as j_sddmm
from gnn_computing_tpu.ops.spmm import spmm as j_spmm
from gnn_computing_tpu.ops.spmm import spmm_bidir as j_spmm_bidir
from gnn_computing_tpu.ops.spmm import spmm_transpose_xla, spmm_xla
from gnn_computing_tpu.schedule import make_plan as j_make_plan

from gnn_computing_tpu_torch.aggregator import Aggregator
from gnn_computing_tpu_torch.ops.fused_nn import spmm_nn
from gnn_computing_tpu_torch.ops.reference import dense_adjacency, sddmm_dense, spmm_dense
from gnn_computing_tpu_torch.ops.sddmm import sddmm
from gnn_computing_tpu_torch.ops.spmm import sddmm_slots, spmm, spmm_plain, spmm_transpose
from gnn_computing_tpu_torch.ops.validate import assert_valid
from gnn_computing_tpu_torch.schedule import make_plan

from test_torch_schedule_gather import both_graphs

SCHEDULES = {
    "ng32": ("neighbor_grouping", dict(block_size=32)),
    "las": ("locality", dict(num_partitions=4)),
    "lasng32": ("locality_neighbor_grouping", dict(num_partitions=4, block_size=32)),
    "nop": ("nop", {}),
}
# gather mode: (the port's, the JAX package's, ulps of tolerance or None
# for the exact bound)
MODES = {
    "none": (None, None, None),
    "f16_split2": ("f16_split2", "f16_split2", None),
    "bf16_split2": ("bf16_split2", "bf16_split2", None),
    "bf16": (torch.bfloat16, jnp.bfloat16, 4 * 2.0**-7),
    "f16": (torch.float16, jnp.float16, 4 * 2.0**-10),
}
EXACT = ("none", "f16_split2")


def setting(name: str):
    """(host graph, JAX plan, port plan) of a schedule over the graph with
    isolated rows and sources, weighted by N(0, 1) edge values."""
    sched, kw = SCHEDULES[name]
    gj, gp = both_graphs("isolated")
    return gp, j_make_plan(gj, sched, **kw).device_put(), make_plan(gp, sched, **kw).to("cpu")


def feats(n, f, seed):
    return np.random.default_rng(seed).standard_normal((n, f)).astype(np.float32)


def close(got, want, what, tol=None, ref=None):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(jax.device_get(want), np.float64)
    assert got.shape == want.shape, what
    assert np.isfinite(got).all(), what
    err = np.abs(got - want).max() if want.size else 0.0
    assert err <= (1e-5 if tol is None else tol) * np.abs(want).max(initial=0.0), f"{what}: max|port-jax| = {err}"
    if ref is not None:
        assert_valid(got, ref, what=f"{what} vs f64 oracle")


def rel_l2(got, want) -> float:
    got, want = got.detach().numpy().astype(np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", list(SCHEDULES))
def test_spmm_modes_match_jax(name, mode):
    gp, jplan, plan = setting(name)
    port_mode, jax_mode, tol = MODES[mode]
    h, a, b = feats(gp.n_src, 24, 1), feats(gp.n_src, 16, 2), feats(gp.num_nodes, 16, 3)

    @jax.jit
    def jax_side(p, hh, aa, bb):
        return spmm_xla(p, hh, gather_dtype=jax_mode), {
            output: j_sddmm(p, aa, bb, output=output, gather_dtype=jax_mode) for output in ("slots", "edges")
        }

    want_spmm, want_sddmm = jax_side(jplan, jnp.asarray(h), jnp.asarray(a), jnp.asarray(b))
    got = spmm_plain(plan, torch.from_numpy(h), gather_dtype=port_mode)
    close(got, want_spmm, f"spmm {name} {mode}", tol, spmm_dense(gp, h) if mode in EXACT else None)
    for output, want in want_sddmm.items():
        got = sddmm(plan, torch.from_numpy(a), torch.from_numpy(b), output=output, gather_dtype=port_mode)
        ref = sddmm_dense(gp, a, b) if mode in EXACT and output == "edges" else None
        close(got, np.asarray(want).reshape(-1), f"sddmm {output} {name} {mode}", tol, ref)


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_spmm_transpose_and_nn_match_jax(name):
    gp, jplan, plan = setting(name)
    h, g_out, w = feats(gp.n_src, 20, 4), feats(gp.num_nodes, 12, 5), feats(20, 8, 6)
    v = np.random.default_rng(7).standard_normal((plan.num_tasks_padded, plan.block_size)).astype(np.float32)

    @jax.jit
    def jax_side(p, hh, gg, ww, vv):
        return (j_spmm(p, hh), spmm_transpose_xla(p, gg), j_spmm_nn(p, hh, ww), spmm_xla(p, hh, val=vv))

    jspmm, jtr, (jagg, jtrans), want = jax_side(jplan, *(jnp.asarray(x) for x in (h, g_out, w, v)))
    close(spmm(plan, torch.from_numpy(h)), jspmm, f"spmm {name}", ref=spmm_dense(gp, h))
    close(spmm_transpose(plan, torch.from_numpy(g_out)), jtr, f"spmm_transpose {name}",
          ref=dense_adjacency(gp).T @ g_out.astype(np.float64))
    agg, trans = spmm_nn(plan, torch.from_numpy(h), torch.from_numpy(w))
    close(agg, jagg, f"spmm_nn agg {name}")
    close(trans, jtrans, f"spmm_nn agg @ w {name}", ref=spmm_dense(gp, h) @ w.astype(np.float64))
    # explicit slot values, flat or [num_tasks_p, B]
    close(spmm(plan, torch.from_numpy(h), val=torch.from_numpy(v)), want, f"spmm val {name}")
    close(spmm(plan, torch.from_numpy(h), val=torch.from_numpy(v.reshape(-1))), want, f"spmm flat val {name}")
    with pytest.raises(ValueError):
        spmm(plan, torch.from_numpy(h), val=torch.zeros(gp.num_edges))
    with pytest.raises(ValueError):
        spmm(plan, torch.from_numpy(h), strategy="hybrid")


@pytest.mark.parametrize("name", ["ng32", "lasng32"])
def test_chunked_matches_unchunked(name):
    """At a bound of 3 tasks a chunk (and 1 task: a bound below B) the
    chunked spmm_plain, spmm_transpose and sddmm_slots equal one pass up to
    float32 summation order."""
    gp, _, plan = setting(name)
    h, g_out, b = (torch.from_numpy(feats(n, 16, s)) for n, s in ((gp.n_src, 8), (gp.num_nodes, 9), (gp.num_nodes, 10)))
    whole = (spmm_plain(plan, h), spmm_transpose(plan, g_out), sddmm_slots(plan, h, b))
    assert len(range(0, plan.num_tasks_padded, 3)) > 10
    for bound in (3 * plan.block_size, 1):
        for got, want, what in zip(
            (spmm_plain(plan, h, chunk_slots=bound), spmm_transpose(plan, g_out, chunk_slots=bound),
             sddmm_slots(plan, h, b, chunk_slots=bound)),
            whole, ("spmm_plain", "spmm_transpose", "sddmm_slots"),
        ):
            assert got.shape == want.shape
            assert (got - want).abs().max() <= 1e-6 * want.abs().max(), f"{what} at a bound of {bound} slots"


@pytest.mark.parametrize("name", ["ng32", "las", "lasng32"])
def test_spmm_bidir_grads_match_jax(name):
    """Gradients in h and the slot values through the transposed plan
    (Aggregator.run with val / val_t, and with the plans' own values), and
    through autograd's scatter (spmm over the forward plan alone), against
    jax.grad of the JAX package's spmm_bidir / spmm."""
    sched, kw = SCHEDULES[name]
    gj, gp = both_graphs("isolated")
    jagg = JAggregator.schedule(gj, sched, with_transpose=True, **kw)
    agg = Aggregator.schedule(gp, sched, with_transpose=True, device="cpu", **kw)
    h, ct = feats(gp.n_src, 12, 11), feats(gp.num_nodes, 12, 12)
    ev = np.random.default_rng(13).standard_normal(gp.num_edges).astype(np.float32)
    a, b = feats(gp.n_src, 8, 14), feats(gp.num_nodes, 8, 15)

    @jax.jit
    def jax_side(ja, hh, ee, cc, aa, bb):
        vt = ja.transposed_val(ee)
        out, vjp = jax.vjp(lambda x, v: j_spmm_bidir(ja.plan, ja.plan_t, x, v, vt), hh, ja.slot_values(ee))
        return dict(
            out=out, grads=vjp(cc), run=jax.grad(lambda x: jnp.sum(ja.run(x) * cc))(hh),
            spmm=jax.grad(lambda x: jnp.sum(j_spmm(ja.plan, x) * cc))(hh),
            run_transpose=ja.run_transpose(cc), run_sddmm=ja.run_sddmm(aa, bb),
        )

    want = jax_side(jagg, *(jnp.asarray(x) for x in (h, ev, ct, a, b)))
    ht = torch.from_numpy(h).requires_grad_(True)
    val = agg.slot_values(torch.from_numpy(ev)).requires_grad_(True)
    out = agg.run(ht, val=val, val_t=agg.transposed_val(torch.from_numpy(ev)))
    close(out, want["out"], f"spmm_bidir {name}")
    (out * torch.from_numpy(ct)).sum().backward()
    assert rel_l2(ht.grad, want["grads"][0]) <= 1e-4 and rel_l2(val.grad, want["grads"][1]) <= 1e-4
    # the plans' own values, and autograd's scatter over the forward plan
    for fwd, key in ((agg.run, "run"), (lambda x: spmm(agg.plan, x), "spmm")):
        ht = torch.from_numpy(h).requires_grad_(True)
        (fwd(ht) * torch.from_numpy(ct)).sum().backward()
        assert rel_l2(ht.grad, want[key]) <= 1e-4, key
    close(agg.run_transpose(torch.from_numpy(ct)), want["run_transpose"], f"run_transpose {name}")
    close(agg.run_sddmm(torch.from_numpy(a), torch.from_numpy(b)), want["run_sddmm"], f"run_sddmm {name}",
          ref=sddmm_dense(gp, a, b))


def test_hybrid_aggregator_refuses_slot_values():
    _, gp = both_graphs("rmat", with_val=False)
    hyb = Aggregator.schedule_hybrid(gp, tile_dtype=np.int8, tile_rows=64, tile_cols=64, threshold=4,
                                     with_transpose=False, device="cpu")
    h = torch.zeros(gp.n_src, 4)
    with pytest.raises(ValueError, match="inside their plans"):
        hyb.run(h, val=torch.ones(hyb.plan.num_tasks_padded * hyb.plan.block_size))
    no_t = Aggregator.schedule(gp, with_transpose=False, device="cpu")
    with pytest.raises(ValueError):
        no_t.run_transpose(h)
