"""The GAT tile modes of the PyTorch port — 'twodot' (hv_chunks 1 and 2),
'merged' and maxdot's dot_mode 'default' (``gat_bcsr_tiles``, the
counterpart of ``gat_bcsr_pallas``) — on the CPU, where they run their
plain versions, which stand beside the factored CUDA kernel and B2's
'default' flag.

Against the JAX package: ``gat_bcsr_pallas`` itself, in TPU interpret mode
(``pltpu.force_tpu_interpret_mode()``, where the Pallas bodies run on the
CPU), over int8, 1-bit, float32 and bfloat16 plans, unshifted and with a
row shift.  Each mode rounds in its own places (the JAX package's factors
and the port's shifted ones round different values), so each has its
tolerance, max|port - jax| <= tol * max|jax| on num: 1e-5 for twodot
with two chunks (~2^-17 each side), 5e-3 for one chunk (~2^-9 each side),
2e-3 for merged at |z| <~ 1, and 2^-7 for 'default' (interpret mode does
not round a DEFAULT-precision dot, so the JAX side is exact there); den is
float32 in every mode, 1e-5.  'default' is also held tightly (1e-5 * max)
to an explicit oracle: the port's float32 scores and h rounded to bfloat16
by bit arithmetic, summed in float64.

Wide logits (one source's as at 95 and 120, beyond exp's float32 range,
where the JAX package's v1 = exp(as) is inf): under the exact and the
'bound' shift every mode is finite and within its tolerance of the float64
softmax over the tile cells, with the rows the factored form cannot hold
rescued and counted.  A signed float32 plan (C6): every nonzero cell is
scored, times its value, against float64.  And 'default' through
``hybrid_gat`` / ``Aggregator.run_gat``: forward and gradients against the
JAX package (whose 'default' is exact off the TPU) within 2^-7."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gnn_computing_tpu.aggregator import Aggregator as JAggregator
from gnn_computing_tpu.graph.csr import CSRGraph as JCSRGraph
from gnn_computing_tpu.graph.reorder import degree_sort as j_degree_sort
from gnn_computing_tpu.graph.synthetic import rmat_graph as j_rmat_graph
from gnn_computing_tpu.models.gat import GATLayerParams as JGATLayerParams
from gnn_computing_tpu.models.gat import gat_forward as j_gat_forward
from gnn_computing_tpu.ops.pallas_bcsr import gat_bcsr_pallas
from gnn_computing_tpu.schedule.tiles import densify as j_densify
from gnn_computing_tpu.schedule.tiles import split_bit_tiles as j_split_bit_tiles

from gnn_computing_tpu_torch.aggregator import Aggregator
from gnn_computing_tpu_torch.convert import gat_params_from_jax
from gnn_computing_tpu_torch.graph import CSRGraph, degree_sort, normal_features, rmat_graph
from gnn_computing_tpu_torch.models.gat import gat_forward, glorot_gat_weights
from gnn_computing_tpu_torch.models.training import make_train_step, param_leaves, softmax_xent
from gnn_computing_tpu_torch.ops import bcsr_gat, cuda_gat
from gnn_computing_tpu_torch.ops.bcsr_gat import (
    FACTOR_MAX,
    _bound_rescue,
    _cell_scores,
    _resolve_shift,
    factored_terms,
    gat_bcsr,
    gat_bcsr_merged_plain,
    gat_bcsr_plain,
    gat_bcsr_tiles,
    gat_bcsr_twodot_plain,
)
from gnn_computing_tpu_torch.ops.validate import assert_valid
from gnn_computing_tpu_torch.schedule.tiles import densify, split_bit_tiles

from test_torch_gat import _wide_case

SLOPE = 0.2
F = 16
# mode -> (gat_bcsr_tiles keywords, tolerance on num against the JAX kernel)
MODES = {
    "twodot2": (dict(mode="twodot", hv_chunks=2), 1e-5),
    "twodot1": (dict(mode="twodot", hv_chunks=1), 5e-3),
    "merged": (dict(mode="merged"), 2e-3),
    "merged1": (dict(mode="merged", hv_chunks=1), 5e-3),
    "default": (dict(mode="maxdot", dot_mode="default"), 2.0**-7),
}
# the plans: [64, 128] tiles, and [256, 128] for the 1-bit part (the JAX
# kernel's 1-bit path wants R // 8 >= 32)
TILES = dict(tile_rows=64, tile_cols=128)
BIT_TILES = dict(tile_rows=256, tile_cols=128)


def _launches():
    return cuda_gat.launches, cuda_gat.twodot_launches, cuda_gat.merged_launches


@functools.lru_cache(maxsize=None)
def _plans(fmt):
    """(JAX plan on the device, port plan on the CPU, n) of one tile format
    over a 768-node RMAT graph: <= 64 tiles, so the interpret-mode kernel
    stays quick.  The 1-bit plan is the graph with its repeated edges
    dropped, so that every tile is 0/1 and goes to the 1-bit part."""
    n, m = 768, 14000
    gp = rmat_graph(n, m, seed=11, with_val=False)
    gp = gp.reorder(degree_sort(gp))
    if fmt == "b1":
        key = np.unique(gp.dst_per_edge.astype(np.int64) * n + gp.indices)
        d, s = key // n, key % n
        tj = j_split_bit_tiles(j_densify(JCSRGraph.from_edges(d, s, n), dtype=np.int8, threshold=8, **BIT_TILES)[0])[0]
        tp = split_bit_tiles(densify(CSRGraph.from_edges(d, s, n), dtype=np.int8, threshold=8, **BIT_TILES)[0])[0]
    else:
        gj = j_rmat_graph(n, m, seed=11, with_val=False, device="cpu")
        gj = gj.reorder(j_degree_sort(gj))
        jdt, pdt = {"i8": (np.int8, np.int8), "f32": (np.float32, np.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[fmt]
        tj = j_densify(gj, dtype=jdt, threshold=8, **TILES)[0]
        tp = densify(gp, dtype=pdt, threshold=8, **TILES)[0]
    assert tp.num_tiles <= 64 and tp.num_dense_edges > 5000
    assert tp.format == {"i8": "int8", "b1": "bits", "f32": "float32", "bf16": "bfloat16"}[fmt]
    return tj.device_put(), tp.to("cpu"), n


def _inputs(n, shift, seed=0):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((n, F)).astype(np.float32)
    att = (rng.standard_normal((n, 2)) * 0.3).astype(np.float32)
    row_shift = rng.uniform(-1.0, 2.0, n).astype(np.float32) if shift else None
    return h, att, row_shift


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("fmt", ["i8", "b1", "f32", "bf16"])
def test_mode_matches_jax_interpret(fmt, shift, mode):
    tj, tp, n = _plans(fmt)
    h, att, row_shift = _inputs(n, shift)
    kw, tol = MODES[mode]
    with pltpu.force_tpu_interpret_mode():
        want_num, want_den = gat_bcsr_pallas(
            tj, jnp.asarray(h), jnp.asarray(att), SLOPE, pack=1,
            row_shift=None if row_shift is None else jnp.asarray(row_shift), **kw,
        )
    rescued = dict(bcsr_gat.rescued)
    num, den = gat_bcsr_tiles(tp, _t(h), _t(att), SLOPE, row_shift=_t(row_shift), **kw)
    assert bcsr_gat.rescued == rescued  # small logits: no row needs a rescue
    assert bool(torch.isfinite(num).all()) and bool(torch.isfinite(den).all())
    assert _rel(num.numpy(), jax.device_get(want_num)) <= tol, mode
    assert _rel(den.numpy(), jax.device_get(want_den)) <= 1e-5, mode
    assert _launches() == (0, 0, 0)


def _bf16_rne(x: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 (round to nearest, ties to even) by bit arithmetic,
    back in float32 (finite inputs)."""
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32)


@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("fmt", ["i8", "b1", "f32", "bf16"])
def test_default_matches_bf16_oracle(fmt, shift):
    """'default' against its definition: every cell's float32 score (the
    port's _cell_scores) and h rounded once to bfloat16 by bit arithmetic,
    the products summed in float64; den the unrounded scores' float64 sum."""
    _, tp, n = _plans(fmt)
    h, att, row_shift = _inputs(n, shift, seed=1)
    num, den = gat_bcsr_plain(tp, _t(h), _t(att), SLOPE, row_shift=_t(row_shift), dot_mode="default")
    assert torch.equal(num, gat_bcsr(tp, _t(h), _t(att), SLOPE, _t(row_shift), dot_mode="default")[0])
    cnt = tp.counts().float()
    t, i, j = cnt.nonzero(as_tuple=True)
    rows = tp.tile_row.long()[t] * tp.tile_rows + i
    cols = tp.tile_col.long()[t] * tp.tile_cols + j
    m = torch.zeros(n) if row_shift is None else _t(row_shift)
    at = _t(att)
    s, _ = _cell_scores(cnt[t, i, j], at[rows, 0], m[rows], at[cols, 1], SLOPE)
    s = s.numpy()
    rows, cols = rows.numpy(), cols.numpy()
    ref_num = np.zeros((n, F))
    np.add.at(ref_num, rows, _bf16_rne(s).astype(np.float64)[:, None] * _bf16_rne(h)[cols].astype(np.float64))
    ref_den = np.bincount(rows, weights=s.astype(np.float64), minlength=n)
    assert _rel(num.numpy(), ref_num) <= 1e-5
    assert _rel(den.numpy(), ref_den) <= 1e-5
    # the rounding is real: the exact forward differs by more than the sum order
    assert _rel(gat_bcsr_plain(tp, _t(h), _t(att), SLOPE, row_shift=_t(row_shift))[0].numpy(), ref_num) > 1e-5


def _cell_softmax(tp, h, att, n):
    """float64 softmax over each row's tile cells (count multiplicity), with
    the row's max logit as its shift; rows without a cell give 0."""
    cnt = tp.counts().double()
    t, i, j = cnt.nonzero(as_tuple=True)
    rows = (tp.tile_row.long()[t] * tp.tile_rows + i).numpy()
    cols = (tp.tile_col.long()[t] * tp.tile_cols + j).numpy()
    z = att[rows, 0].astype(np.float64) + att[cols, 1]
    lz = np.maximum(z, SLOPE * z)
    mx = np.full(n, -np.inf)
    np.maximum.at(mx, rows, lz)
    s = cnt[t, i, j].numpy() * np.exp(lz - mx[rows])
    den = np.bincount(rows, weights=s, minlength=n)
    num = np.zeros((n, h.shape[1]))
    np.add.at(num, rows, s[:, None] * h[cols])
    return num / np.where(den == 0, 1.0, den)[:, None]


# wide logits: the tolerance against the float64 softmax; merged is held to
# its two bf16 roundings (a_m and v1 o h, 2^-9 each), not the gate
WIDE_TOL = {"twodot2": 1e-5, "twodot1": 5e-3, "merged": 2.0**-7, "merged1": 2.0**-7, "default": 2.0**-7}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("stabilize", [True, "bound"])
@pytest.mark.parametrize("big", [95.0, 120.0])
def test_wide_logits_match_softmax(big, stabilize, mode):
    """One source's as at 95 or 120, over a plan that holds every edge in
    [16, 16] tiles: the factored modes' per-node factors stay in range
    where the row reads that source, and the other rows (all their
    neighbors ~95 below A) are rescued and counted; every output is finite
    and num / den is within WIDE_TOL of the float64 softmax over the tile
    cells (twodot with two chunks also within the gate).  'bound' first
    rescues its far-below rows with the exact shift (C2), as hybrid_gat
    does."""
    g, _, h, att = _wide_case()
    tp = densify(g, dtype=np.int8, tile_rows=16, tile_cols=16, threshold=1)[0].to("cpu")
    att[5, 1] = big
    ht, at = torch.tensor(h, dtype=torch.float32), torch.tensor(att, dtype=torch.float32)
    kw, _ = MODES[mode]
    shift = _resolve_shift(tp, None, at, SLOPE, stabilize)
    before = dict(bcsr_gat.rescued)
    num, den = gat_bcsr_tiles(tp, ht, at, SLOPE, row_shift=shift, **kw)
    if stabilize == "bound":
        shift = _bound_rescue(tp, None, at, SLOPE, shift, den, None)
        assert shift is not None  # the rows not reading source 5 lie ~95 below the bound
        num, den = gat_bcsr_tiles(tp, ht, at, SLOPE, row_shift=shift, **kw)
    assert bool(torch.isfinite(num).all()) and bool(torch.isfinite(den).all())
    out = (num / torch.where(den == 0, 1.0, den)[:, None]).numpy()
    want = _cell_softmax(tp, h, att.astype(np.float32), g.num_nodes)
    assert np.abs(out - want).max() <= WIDE_TOL[mode] * np.abs(want).max(), mode
    if mode == "twodot2":
        assert_valid(out, want, what=f"as={big} {stabilize} twodot")
    if mode != "default":
        terms = factored_terms(ht, at, SLOPE, kw["mode"], 1, shift)
        t, i, j = tp.counts().nonzero(as_tuple=True)
        rows = tp.tile_row.long()[t] * tp.tile_rows + i
        cols = tp.tile_col.long()[t] * tp.tile_cols + j
        reads5 = torch.zeros(g.num_nodes, dtype=torch.bool)
        reads5[rows[cols == 5]] = True
        has_cells = torch.zeros(g.num_nodes, dtype=torch.bool)
        has_cells[rows] = True
        # the rows reading source 5 hold their factors (u1 <= 2: A lies
        # within ln 2 of 95), the others with cells are rescued
        assert not bool(terms.need[reads5].any())
        assert bool((terms.rows[reads5, 1] <= 2.0).all())
        assert bool(terms.need[has_cells & ~reads5].all()) and bool((has_cells & ~reads5).any())
        assert bcsr_gat.rescued["rows"] - before["rows"] >= int(terms.need.sum())
    assert _launches() == (0, 0, 0)


@pytest.mark.parametrize("mode", list(MODES))
def test_signed_float_plan(mode):
    """C6 on a signed float32 plan (values U(-1, 3)): every nonzero cell is
    scored, times its value, in every mode; num and den against float64
    (the factored modes' numerators round each float value to bfloat16,
    ~2^-9, so they are held at 2^-8)."""
    rng = np.random.default_rng(8)
    gp = rmat_graph(700, 12000, seed=13, with_val=False)
    gp = gp.reorder(degree_sort(gp))
    val = rng.uniform(-1.0, 3.0, gp.num_edges).astype(np.float32)
    tp = densify(gp, val=val, dtype=np.float32, threshold=4, **TILES)[0].to("cpu")
    assert bool((tp.a < 0).any())
    n = gp.num_nodes
    h, att, row_shift = _inputs(n, True, seed=3)
    kw, tol = MODES[mode]
    num, den = gat_bcsr_tiles(tp, _t(h), _t(att), SLOPE, row_shift=_t(row_shift), **kw)
    cnt = tp.a.double()
    t, i, j = (cnt != 0).nonzero(as_tuple=True)
    rows = (tp.tile_row.long()[t] * tp.tile_rows + i).numpy()
    cols = (tp.tile_col.long()[t] * tp.tile_cols + j).numpy()
    z = att[rows, 0].astype(np.float64) + att[cols, 1]
    s = cnt[t, i, j].numpy() * np.exp(np.maximum(z, SLOPE * z) - row_shift[rows])
    ref_den = np.bincount(rows, weights=s, minlength=n)
    ref_num = np.zeros((n, F))
    np.add.at(ref_num, rows, s[:, None] * h[cols])
    assert bool(torch.isfinite(num).all()) and bool(torch.isfinite(den).all())
    # bf16(v) rounds a float value in the factored modes' numerators
    assert _rel(num.numpy(), ref_num) <= max(tol, 2.0**-8 if mode != "default" else tol)
    assert _rel(den.numpy(), ref_den) <= 1e-5


def test_factored_plain_versions_are_the_tiles_modes():
    """gat_bcsr_tiles over CPU tensors runs the plain versions (no rescue at
    small logits), 'merged' always with one chunk, and a sequence of parts
    adds their partial sums."""
    _, tp, n = _plans("i8")
    h, att, row_shift = _inputs(n, True)
    args = (_t(h), _t(att), SLOPE)
    for hv in (1, 2):
        got = gat_bcsr_tiles(tp, *args, mode="twodot", hv_chunks=hv, row_shift=_t(row_shift))
        want = gat_bcsr_twodot_plain(tp, *args, hv_chunks=hv, row_shift=_t(row_shift))
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    for hv in (1, 2):
        got = gat_bcsr_tiles(tp, *args, mode="merged", hv_chunks=hv, row_shift=_t(row_shift))
        want = gat_bcsr_merged_plain(tp, *args, hv_chunks=hv, row_shift=_t(row_shift))
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    _, tb, _ = _plans("b1")
    _, t8, _ = _plans("i8")
    both = gat_bcsr_tiles((tb, t8), *args, mode="twodot")
    sep = [gat_bcsr_tiles(p, *args, mode="twodot") for p in (tb, t8)]
    assert torch.allclose(both[0], sep[0][0] + sep[1][0]) and torch.allclose(both[1], sep[0][1] + sep[1][1])
    with pytest.raises(ValueError):
        gat_bcsr_tiles(tp, *args, mode="threedot")
    with pytest.raises(ValueError):
        gat_bcsr_tiles(tp, *args, mode="twodot", hv_chunks=3)
    with pytest.raises(ValueError):
        gat_bcsr_tiles(tp, *args, dot_mode="fast")


def _layer_setting():
    gj = j_rmat_graph(480, 9000, seed=29, with_val=False, device="cpu")
    gp = rmat_graph(480, 9000, seed=29, with_val=False)
    gj, gp = gj.reorder(j_degree_sort(gj)), gp.reorder(degree_sort(gp))
    kw = dict(tile_rows=64, tile_cols=64, threshold=4, residual_block=4, pack=1, tile_dtype=np.int8)
    jagg = JAggregator.schedule_hybrid(gj, **kw)
    agg = Aggregator.schedule_hybrid(gp, device="cpu", **kw)
    return gp, jagg, agg


@pytest.mark.parametrize("stabilize", [False, True, "bound"])
def test_default_through_hybrid_gat(stabilize):
    """dot_mode='default' through Aggregator.run_gat (hybrid_gat): the
    forward within 2^-7 of the JAX package's (exact off the TPU) and of the
    port's exact forward but not equal to it, and the gradients of the
    'default' forward — its backward is the exact one, as in the JAX
    package — within 2^-7 (relative L2) of the JAX gradients."""
    gp, jagg, agg = _layer_setting()
    rng = np.random.default_rng(5)
    h = rng.standard_normal((gp.num_nodes, F)).astype(np.float32)
    att = (rng.standard_normal((gp.num_nodes, 2)) * 0.5).astype(np.float32)
    w = np.cos(np.arange(gp.num_nodes * F)).reshape(gp.num_nodes, F)

    def jloss(hh, aa):
        out = jagg.run_gat(hh, aa, stabilize=stabilize, dot_mode="default")
        return jnp.sum(out * w), out

    (_, jout), (jdh, jdatt) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(h), jnp.asarray(att))
    ht = torch.from_numpy(h).requires_grad_(True)
    at = torch.from_numpy(att).requires_grad_(True)
    out = agg.run_gat(ht, at, stabilize=stabilize, dot_mode="default")
    (out * torch.from_numpy(w).float()).sum().backward()
    with torch.no_grad():
        exact = agg.run_gat(torch.from_numpy(h), torch.from_numpy(att), stabilize=stabilize)
    assert bool(torch.isfinite(out).all())
    assert _rel(out.detach().numpy(), jax.device_get(jout)) <= 2.0**-7
    assert 1e-6 < _rel(out.detach().numpy(), exact.numpy()) <= 2.0**-7
    for got, want in ((ht.grad, jdh), (at.grad, jdatt)):
        want = np.asarray(jax.device_get(want), np.float64)
        assert np.linalg.norm(got.numpy() - want) <= 2.0**-7 * np.linalg.norm(want)
    assert _launches() == (0, 0, 0)


def test_default_training_step():
    """Three Adam steps of the 3-layer GAT with dot_mode='default' (bench.py
    --train --model gat --gat-dot-mode default, stabilize='bound'): finite
    losses that fall, each within 2^-7 of the JAX package's loss at the
    same weights, and first-step gradients within 2^-6 (relative L2) of
    JAX's: the scores' bf16 rounding (~2^-9) passes through the attention
    gradients' cancellation (here up to 7.8e-3)."""
    import optax

    _, jagg, agg = _layer_setting()
    dims = (32, 16, 8, 4)
    weights = glorot_gat_weights(dims, seed=0)
    h = normal_features(agg.num_nodes, dims[0], seed=3) * 0.5
    labels = np.arange(agg.num_nodes) % dims[-1]
    jparams = [JGATLayerParams(jnp.asarray(w), jnp.asarray(a)) for w, a in weights]

    def jloss(p):
        out = j_gat_forward(jagg, p, jnp.asarray(h), stabilize="bound", dot_mode="default")
        logp = jax.nn.log_softmax(out)
        return -jnp.mean(jnp.take_along_axis(logp, jnp.asarray(labels)[:, None], axis=1))

    model = gat_params_from_jax(jparams, device="cpu")
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    step = make_train_step(
        lambda x: gat_forward(agg, model.layer_params(), x, stabilize="bound", dot_mode="default"), opt, device="cpu"
    )
    jopt = optax.adam(1e-3)
    jstate = jopt.init(jparams)
    losses, jlosses = [], []
    for k in range(3):
        if k == 0:
            out = gat_forward(agg, model.layer_params(), torch.from_numpy(h), stabilize="bound", dot_mode="default")
            softmax_xent(out, torch.from_numpy(labels)).backward()
            grads = [p.grad.detach().clone() for p in param_leaves(model)]
            model.zero_grad(set_to_none=True)
        jl, jg = jax.value_and_grad(jloss)(jparams)
        if k == 0:
            for got, want in zip(grads, jax.tree_util.tree_leaves(jg)):
                want = np.asarray(want, np.float64)
                assert np.linalg.norm(got.numpy() - want) <= 2.0**-6 * np.linalg.norm(want)
        updates, jstate = jopt.update(jg, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        jlosses.append(float(jl))
        losses.append(float(step((torch.from_numpy(h),), torch.from_numpy(labels))))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert np.allclose(losses, jlosses, rtol=2.0**-7, atol=0), (losses, jlosses)
    assert _launches() == (0, 0, 0)
