"""GAT and SDDMM over float-valued tiles (the JAX package's default schedule:
float32 tiles; bench.py's ``--tile-dtype bf16``: bfloat16 tiles) in the
PyTorch port against the JAX package on the CPU, where its ops take their
XLA forms: ``run_gat`` forward and gradients under every stabilizer, over
float32 and bfloat16 count tiles and over a ``gcn_norm_val`` plan; GAT
training steps over float tiles against optax; ``hybrid_sddmm`` over float
plans, signed values included; and the GAT scoring rule on a signed-value
plan (C6: every cell whose value is nonzero is scored, as the JAX forward
scores it), whose gradients are checked against a central finite
difference of the port's own forward (the JAX backward drops the cells
with a negative value, so it is not the gradient of its forward there).

Tolerance: the ops/validate gate (|y - ref| <= 1e-2*|ref| + 1e-5) against
the JAX package plus max|port - jax| <= 1e-5 * max|jax| (float32 summation
order only; assert_matches_jax); bfloat16 SDDMM cells within one bfloat16
ulp of JAX's, cells whose value is not > 0 exactly +0 in both; the row max
exactly equal.  The finite difference: the directional derivative of a
float32 forward, within 1e-3 relative (truncation and float32 rounding of
the difference quotient)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_computing_tpu.aggregator import Aggregator as JAggregator
from gnn_computing_tpu.models.gat import GATLayerParams as JGATLayerParams
from gnn_computing_tpu.models.gat import gat_forward as j_gat_forward
from gnn_computing_tpu.ops.bcsr_gat import hybrid_gat as j_hybrid_gat
from gnn_computing_tpu.ops.bcsr_sddmm import hybrid_sddmm as j_hybrid_sddmm

from gnn_computing_tpu_torch.aggregator import Aggregator
from gnn_computing_tpu_torch.convert import gat_params_from_jax
from gnn_computing_tpu_torch.graph import normal_features
from gnn_computing_tpu_torch.models.gat import glorot_gat_weights
from gnn_computing_tpu_torch.models.training import make_train_step
from gnn_computing_tpu_torch.ops import cuda_bcsr, cuda_gat, cuda_gat_bwd, cuda_rowmax, cuda_sddmm
from gnn_computing_tpu_torch.ops.bcsr import bcsr_rowmax_plain
from gnn_computing_tpu_torch.ops.bcsr_sddmm import hybrid_sddmm
from gnn_computing_tpu_torch.ops.validate import assert_valid

from test_torch_float_tiles import _graphs, _multigraph
from test_torch_sddmm import _bf16_ulp
from test_torch_spmm import assert_matches_jax
from test_torch_train import DIMS, _check_training, _cos_weights, _jax_train

KW = dict(tile_rows=64, tile_cols=64, threshold=6, residual_block=4, pack=1)
# the multigraph's schedule: [32, 48] tiles at a threshold that leaves
# 22 tiles (3,202 edges) and a residual of 5,298 edges
MULTI = dict(tile_rows=32, tile_cols=48, threshold=150, residual_block=4, pack=1)
# (JAX tile dtype, port tile dtype); None is float32, the default of both
DTYPES = {"f32": (None, None), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _launches():
    return (cuda_bcsr.launches, cuda_gat.launches, cuda_rowmax.launches, cuda_gat_bwd.dad_launches,
            cuda_gat_bwd.dh_das_launches, cuda_sddmm.launches)


def _np(x):
    return np.asarray(jax.device_get(x), np.float64)


def _aggs(gj, gp, setting, **kw):
    """The same schedule with transposed plans in both packages: float32 or
    bfloat16 tiles of the edge counts, or ('gcn_norm') float32 tiles of the
    GCN-normalized edge values."""
    kw = dict(KW, **kw)
    if setting == "gcn_norm":
        val = gp.gcn_norm_val()
        jagg = JAggregator.schedule_hybrid(gj, val=val, **kw)
        agg = Aggregator.schedule_hybrid(gp, val=val, device="cpu", **kw)
    else:
        jdt, pdt = DTYPES[setting]
        jagg = JAggregator.schedule_hybrid(gj, tile_dtype=jdt, **kw)
        agg = Aggregator.schedule_hybrid(gp, tile_dtype=pdt, device="cpu", **kw)
    assert agg.tile.format == ("bfloat16" if setting == "bf16" else "float32")
    assert agg.tile_t.format == agg.tile.format
    return jagg, agg


def _gat_grads(jagg, agg, h, att, stabilize):
    """(out, dh, datt) of the JAX package (XLA forms, custom VJP over the
    transposed plans) and of the port, loss sum(out * cos(arange))."""

    def jloss(hh, aa):
        out = j_hybrid_gat(
            jagg.tile_parts(), jagg.plan, hh, aa, stabilize=stabilize, strategy="xla",
            tp_t=jagg.tile_parts_t(), plan_t=jagg.plan_t, edge_map_t=jagg.edge_map_t,
        )
        return jnp.sum(out * _cos_weights(out.shape)), out

    jvg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))
    (_, jout), jgrads = jvg(jnp.asarray(h), jnp.asarray(att))
    ht = torch.from_numpy(h).requires_grad_(True)
    at = torch.from_numpy(att).requires_grad_(True)
    out = agg.run_gat(ht, at, stabilize=stabilize)
    (out * torch.from_numpy(_cos_weights(tuple(out.shape)))).sum().backward()
    return (jout,) + tuple(jgrads), (out.detach(), ht.grad, at.grad)


@pytest.mark.parametrize(
    "setting,stabilize",
    [("f32", False), ("f32", True), ("f32", "bound"), ("bf16", False), ("bf16", "bound"), ("gcn_norm", False)],
)
def test_run_gat_float_tiles_matches_jax(setting, stabilize):
    """run_gat's forward and both gradients over float32 / bfloat16 count
    tiles and a gcn_norm_val plan (positive values: the JAX backward's
    v > 0 mask drops nothing) against the JAX package's."""
    gj, gp = _graphs()
    jagg, agg = _aggs(gj, gp, setting)
    n = gp.num_nodes
    h = normal_features(n, 16, seed=1)
    att = normal_features(n, 2, seed=2)
    want, got = _gat_grads(jagg, agg, h, att, stabilize)
    for g_, w_, what in zip(got, want, ("out", "dh", "datt")):
        assert_matches_jax(g_.numpy(), _np(w_), what=f"{setting} stabilize={stabilize} {what}")
    assert _launches() == (0,) * 6


@pytest.mark.parametrize("setting", ["f32", "bf16"])
def test_gat_training_over_float_tiles_matches_optax(setting):
    """3 Adam steps of the 3-layer GAT (fast=False, stabilize='bound',
    split2) over float32 / bfloat16 count tiles and their transposes,
    against optax over the JAX package's same schedule."""
    gj, gp = _graphs(n=480, m=9000, seed=29)
    jagg, agg = _aggs(gj, gp, setting)
    h = normal_features(gp.num_nodes, DIMS[0], seed=123) * 0.1
    labels = np.random.default_rng(7).integers(0, DIMS[-1], gp.num_nodes)
    jparams = [JGATLayerParams(jnp.asarray(w), jnp.asarray(a)) for w, a in glorot_gat_weights(DIMS, seed=0)]
    model = gat_params_from_jax(jparams, device="cpu")

    @jax.jit  # one compile for the 3 steps' forwards and backwards
    def jfwd(p, hh):
        return j_gat_forward(jagg, p, hh, fast=False, stabilize="bound", dot_mode="split2")

    def fwd(hh):
        return model(agg, hh, fast=False, stabilize="bound", dot_mode="split2")

    jlosses, jleaves = _jax_train(jfwd, jparams, h, labels)
    step = make_train_step(fwd, torch.optim.Adam(model.parameters(), lr=1e-3), device="cpu")
    losses = [float(step((torch.from_numpy(h),), labels)) for _ in range(3)]
    _check_training(losses, jlosses, model, jleaves)
    assert _launches() == (0,) * 6


@pytest.mark.parametrize("plan", ["f32", "bf16", "signed_f32", "signed_bf16"])
@pytest.mark.parametrize("out", ["float32", "bfloat16"])
def test_hybrid_sddmm_float_tiles_matches_jax(plan, out):
    """hybrid_sddmm over float32 / bfloat16 count tiles and over a signed
    multigraph's float tiles (values U(-1, 3)): a cell holds its dot where
    its value is > 0 (the JAX rule) and +0 elsewhere, negative cells
    included; the residual's slots equal JAX's."""
    fmt = plan.split("_")[-1]
    if plan.startswith("signed"):
        gj, gp = _multigraph()
        kw = dict(MULTI, with_transpose=False)
    else:
        gj, gp = _graphs()
        kw = dict(KW, with_transpose=False)
    jdt, pdt = DTYPES[fmt]
    jagg = JAggregator.schedule_hybrid(gj, tile_dtype=jdt, **kw)
    agg = Aggregator.schedule_hybrid(gp, tile_dtype=pdt, device="cpu", **kw)
    rng = np.random.default_rng(3)
    a = (rng.standard_normal((gp.num_nodes, 32)) * 0.1).astype(np.float32)
    b = (rng.standard_normal((gp.num_nodes, 32)) * 0.1).astype(np.float32)
    jc, jr = j_hybrid_sddmm(jagg.tile_parts(), jagg.plan, jnp.asarray(a), jnp.asarray(b),
                            out_dtype=getattr(jnp, out), dot_mode="split23")
    pc, pr = hybrid_sddmm(agg.tile_parts(), agg.plan, torch.from_numpy(a), torch.from_numpy(b),
                          out_dtype=getattr(torch, out), dot_mode="split23")
    (got,), (want,) = pc, jc
    vals = agg.tile.counts().float().numpy()
    if plan.startswith("signed"):
        assert (vals < 0).any() and (vals > 0).any()
    p, j = got.float().numpy(), np.asarray(jnp.asarray(want, jnp.float32))
    off = vals <= 0
    assert (p[off] == 0).all() and not np.signbit(p[off]).any() and (j[off] == 0).all()
    if out == "bfloat16":
        assert (np.abs(p - j) <= _bf16_ulp(np.maximum(np.abs(p), np.abs(j)))).all()
    else:
        assert np.abs(p - j).max() <= 1e-5 * np.abs(j).max()
        t, i, k = np.nonzero(~off)
        rows = agg.tile.tile_row.numpy()[t].astype(np.int64) * agg.tile.tile_rows + i
        cols = agg.tile.tile_col.numpy()[t].astype(np.int64) * agg.tile.tile_cols + k
        ref = np.einsum("ef,ef->e", b.astype(np.float64)[rows], a.astype(np.float64)[cols])
        assert_valid(p[t, i, k], ref, what=f"{plan} cells vs f64 dots")
    jr = np.asarray(jr).reshape(-1)
    assert pr.shape == jr.shape
    assert np.abs(pr.numpy() - jr).max() <= 1e-5 * np.abs(jr).max()
    assert _launches() == (0,) * 6


# ------------------------------------------------ C6: signed cell values
def _signed_setting():
    gj, gp = _multigraph()
    jagg = JAggregator.schedule_hybrid(gj, **MULTI)
    agg = Aggregator.schedule_hybrid(gp, device="cpu", **MULTI)
    vals = agg.tile.counts().numpy()
    assert agg.tile.format == "float32" and (vals < 0).any() and agg.plan.num_edges
    h = normal_features(gp.num_nodes, 8, seed=1)
    att = normal_features(gp.num_nodes, 2, seed=2)
    return gp, jagg, agg, h, att


def _directional_fd(loss, x, d, eps):
    """Central difference (loss(x + eps d) - loss(x - eps d)) / (2 eps)."""
    return (loss(x + eps * d) - loss(x - eps * d)) / (2 * eps)


def test_gat_signed_float_plan_scores_every_nonzero_cell():
    """C6.  Over a signed-value float32 plan (a multigraph with edge values
    U(-1, 3)), the port's forward equals the JAX package's (which multiplies
    every cell by its value, negative ones included), and so do the
    stabilized forwards; the row max runs over every nonzero cell; the
    gradients equal a central finite difference of the port's own forward
    along seeded directions."""
    gp, jagg, agg, h, att = _signed_setting()
    ht, at = torch.from_numpy(h), torch.from_numpy(att)
    want = jagg.run_gat(jnp.asarray(h), jnp.asarray(att))
    with torch.no_grad():
        got = agg.run_gat(ht, at)
        assert_matches_jax(got.numpy(), _np(want), what="signed plan forward")
        for stabilize in (True, "bound"):
            assert_matches_jax(agg.run_gat(ht, at, stabilize=stabilize).numpy(), _np(want),
                               what=f"signed plan stabilize={stabilize}")
    # the row max over the cells with a nonzero value, negative ones included
    tp = agg.tile
    vals = tp.counts().numpy()
    ref = np.full(tp.num_nodes, -np.inf, np.float32)
    t, i, j = np.nonzero(vals)
    np.maximum.at(ref, tp.tile_row.numpy()[t] * tp.tile_rows + i, att[tp.tile_col.numpy()[t] * tp.tile_cols + j, 1])
    assert np.array_equal(bcsr_rowmax_plain(tp, at[:, 1].contiguous()).numpy(), ref)

    # gradients, at logits kept >= 0.15 away from leaky-relu's kink (as =
    # +-(|x| + 0.5), ad ~ 0.1 N(0, 1)), so that no edge crosses it within
    # the difference's step, on both branches
    rng = np.random.default_rng(4)
    x = rng.standard_normal(gp.num_nodes)
    at = torch.from_numpy(np.stack([0.1 * rng.standard_normal(gp.num_nodes), np.sign(x) * (np.abs(x) + 0.5)], 1)
                          .astype(np.float32))
    z = at[gp.dst_per_edge, 0] + at[gp.indices, 1]
    assert float(z.abs().min()) > 0.15 and bool((z > 0).any()) and bool((z < 0).any())
    w = torch.from_numpy(_cos_weights((gp.num_nodes, 8)))
    dh = torch.from_numpy(rng.standard_normal(h.shape).astype(np.float32))
    da = torch.from_numpy(rng.standard_normal(att.shape).astype(np.float32))
    for stabilize in (False, True, "bound"):
        def loss(hh, aa):
            return float((agg.run_gat(hh, aa, stabilize=stabilize).double() * w.double()).sum())

        hg, ag = ht.clone().requires_grad_(True), at.clone().requires_grad_(True)
        (agg.run_gat(hg, ag, stabilize=stabilize) * w).sum().backward()
        with torch.no_grad():
            fd_h = _directional_fd(lambda x: loss(x, at), ht, dh, 1e-2)
            fd_a = _directional_fd(lambda x: loss(ht, x), at, da, 1e-2)
        an_h, an_a = float((hg.grad.double() * dh.double()).sum()), float((ag.grad.double() * da.double()).sum())
        assert abs(an_h - fd_h) <= 1e-3 * abs(fd_h), (stabilize, an_h, fd_h)
        assert abs(an_a - fd_a) <= 1e-3 * abs(fd_a), (stabilize, an_a, fd_a)
    assert _launches() == (0,) * 6
