"""The GAT slice: tile aggregation, row max, residual attention, the hybrid
op and the 3-layer forward of the PyTorch port (plain versions, which stand
beside the B2 and B5 CUDA kernels) against the JAX package on the CPU —
where ``gat_bcsr`` runs ``gat_bcsr_xla`` and ``bcsr_rowmax`` runs
``_bcsr_rowmax_xla`` — and against the float64 oracle ``gat_aggregate_dense``.

Tolerance: the ops/validate gate (|y - ref| <= 1e-2*|ref| + 1e-5) against
both, plus max|port - jax| <= 1e-5 * max|jax|, which covers float32
summation order only.  The row max has no rounding: equal, -inf rows
included."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_computing_tpu.aggregator import Aggregator as JAggregator
from gnn_computing_tpu.graph.csr import CSRGraph as JCSRGraph
from gnn_computing_tpu.graph.reorder import degree_sort as j_degree_sort
from gnn_computing_tpu.graph.synthetic import normal_features as j_normal_features
from gnn_computing_tpu.graph.synthetic import rmat_graph as j_rmat_graph
from gnn_computing_tpu.models.gat import GATLayerParams as JGATLayerParams
from gnn_computing_tpu.models.gat import gat_forward as j_gat_forward
from gnn_computing_tpu.ops import reference as j_reference
from gnn_computing_tpu.ops.bcsr import _bcsr_rowmax_xla as j_rowmax
from gnn_computing_tpu.ops.bcsr_gat import _hybrid_row_shift as j_row_shift
from gnn_computing_tpu.ops.bcsr_gat import gat_bcsr as j_gat_bcsr
from gnn_computing_tpu.ops.gat import gat_aggregate_parts as j_gat_aggregate_parts
from gnn_computing_tpu.schedule import Schedule, make_plan
from gnn_computing_tpu.schedule.tiles import densify as j_densify

from gnn_computing_tpu_torch.aggregator import Aggregator
from gnn_computing_tpu_torch.convert import gat_params_from_jax
from gnn_computing_tpu_torch.graph import CSRGraph, degree_sort, normal_features, rmat_graph
from gnn_computing_tpu_torch.models.gat import GAT, gat_forward, gat_layer, glorot_gat_weights
from gnn_computing_tpu_torch.ops import cuda_bcsr, cuda_gat, cuda_rowmax
from gnn_computing_tpu_torch.ops.bcsr import bcsr_rowmax, bcsr_rowmax_plain
from gnn_computing_tpu_torch.ops.bcsr_gat import _hybrid_row_shift, gat_bcsr, gat_bcsr_plain, hybrid_gat
from gnn_computing_tpu_torch.ops.gat import gat_aggregate_parts
from gnn_computing_tpu_torch.ops.reference import gat_aggregate_dense
from gnn_computing_tpu_torch.ops.validate import assert_valid
from gnn_computing_tpu_torch.schedule.neighbor_grouping import neighbor_grouping_plan
from gnn_computing_tpu_torch.schedule.tiles import densify

from test_torch_spmm import assert_matches_jax, jax_native_from_port  # noqa: F401

TILES = dict(tile_rows=64, tile_cols=64, threshold=6)


def _graphs(n=600, m=24000, seed=21, band=None):
    """Degree-sorted RMAT graph in both packages; ``band`` = (lo, hi) drops
    every edge into destinations lo..hi-1, so those rows have none."""
    gj = j_rmat_graph(n, m, seed=seed, with_val=False, device="cpu")
    gp = rmat_graph(n, m, seed=seed, with_val=False)
    gj, gp = gj.reorder(j_degree_sort(gj)), gp.reorder(degree_sort(gp))
    if band is not None:
        d, s = gp.dst_per_edge, gp.indices
        keep = (d < band[0]) | (d >= band[1])
        gj = JCSRGraph.from_edges(d[keep], s[keep], n)
        gp = CSRGraph.from_edges(d[keep], s[keep], n)
    return gj, gp


def _att(n, scale, seed=2):
    return (normal_features(n, 2, seed=seed) * scale).astype(np.float32)


def _launches():
    return cuda_bcsr.launches, cuda_gat.launches, cuda_rowmax.launches


def _as_np(x):
    return np.asarray(jax.device_get(x), np.float64)


@pytest.mark.parametrize("pack", [1, 4])
@pytest.mark.parametrize("shift", [False, True])
def test_gat_bcsr_plain_matches_jax(pack, shift):
    gj, gp = _graphs()
    tj, _ = j_densify(gj, dtype=np.int8, **TILES)
    tp, _ = densify(gp, dtype=np.int8, **TILES)
    tj, tp = tj.pad_runs(pack).device_put(), tp.pad_runs(pack).to("cpu")
    h = np.random.default_rng(4).standard_normal((gp.n_src, 24)).astype(np.float32)
    att = _att(gp.num_nodes, 1.0)
    row_shift = None
    if shift:
        row_shift = np.random.default_rng(5).uniform(-1.0, 3.0, gp.num_nodes).astype(np.float32)

    want_num, want_den = j_gat_bcsr(
        tj, jnp.asarray(h), jnp.asarray(att), strategy="xla",
        row_shift=None if row_shift is None else jnp.asarray(row_shift),
    )
    t = lambda x: None if x is None else torch.from_numpy(x)  # noqa: E731
    num, den = gat_bcsr_plain(tp, t(h), t(att), row_shift=t(row_shift))
    got = gat_bcsr(tp, t(h), t(att), row_shift=t(row_shift), dot_mode="split2")
    assert torch.equal(got[0], num) and torch.equal(got[1], den)

    # f64 oracle over the plan's own tile cells
    cells = tp.a.nonzero(as_tuple=True)
    rows = (tp.tile_row.long()[cells[0]] * 64 + cells[1]).numpy()
    cols = (tp.tile_col.long()[cells[0]] * 64 + cells[2]).numpy()
    cnt = tp.a[cells].double().numpy()
    z = att[rows, 0].astype(np.float64) + att[cols, 1]
    s = cnt * np.exp(np.maximum(z, 0.2 * z) - (0.0 if row_shift is None else row_shift[rows]))
    ref_den = np.bincount(rows, weights=s, minlength=gp.num_nodes)
    ref_num = np.zeros((gp.num_nodes, 24))
    np.add.at(ref_num, rows, s[:, None] * h[cols])
    assert_matches_jax(num.numpy(), _as_np(want_num), ref_num, what=f"num pack{pack} shift{shift}")
    assert_matches_jax(den.numpy(), _as_np(want_den), ref_den, what=f"den pack{pack} shift{shift}")
    assert _launches() == (0, 0, 0)


@pytest.mark.parametrize("pack", [1, 4])
def test_rowmax_plain_equals_jax(pack):
    gj, gp = _graphs(band=(300, 420))
    kw = dict(TILES, ensure_row_coverage=True)
    tj, _ = j_densify(gj, dtype=np.int8, **kw)
    tp, _ = densify(gp, dtype=np.int8, **kw)
    tj, tp = tj.pad_runs(pack).device_put(), tp.pad_runs(pack).to("cpu")
    vals = np.random.default_rng(6).standard_normal(gp.n_src).astype(np.float32)
    want = np.asarray(j_rowmax(tj, jnp.asarray(vals)))
    got = bcsr_rowmax_plain(tp, torch.from_numpy(vals))
    assert torch.equal(bcsr_rowmax(tp, torch.from_numpy(vals)), got)
    assert np.isneginf(want).sum() >= 120  # the band, and rows the tiles miss
    assert np.array_equal(got.numpy(), want)
    # the same max over the plan's cells, in numpy
    ref = np.full(gp.num_nodes, -np.inf, np.float32)
    t, i, j = np.nonzero(tp.a.numpy())
    np.maximum.at(ref, tp.tile_row.numpy()[t] * 64 + i, vals[tp.tile_col.numpy()[t] * 64 + j])
    assert np.array_equal(got.numpy(), ref)
    assert _launches() == (0, 0, 0)


@pytest.mark.parametrize("att_gather", [None, "f16_split2"])
@pytest.mark.parametrize("h_gather", [None, "f16_split2"])
@pytest.mark.parametrize("shift", [False, True])
def test_gat_aggregate_parts_matches_jax(att_gather, h_gather, shift):
    gj = j_rmat_graph(500, 8000, seed=13, with_val=False, device="cpu")
    gp = rmat_graph(500, 8000, seed=13, with_val=False)
    h = np.random.default_rng(1).standard_normal((500, 12)).astype(np.float32)
    att = _att(500, 0.5)
    row_shift = np.random.default_rng(3).uniform(0.0, 2.0, 500).astype(np.float32) if shift else None
    jplan = make_plan(gj, Schedule.neighbor_grouping, block_size=4).device_put()
    want = j_gat_aggregate_parts(
        jplan, jnp.asarray(h), jnp.asarray(att), att_gather_dtype=att_gather, h_gather_dtype=h_gather,
        row_shift=None if row_shift is None else jnp.asarray(row_shift),
    )
    plan = neighbor_grouping_plan(gp, block_size=4).to("cpu")
    num, den, score = gat_aggregate_parts(
        plan, torch.from_numpy(h), torch.from_numpy(att), att_gather_dtype=att_gather,
        h_gather_dtype=h_gather, row_shift=None if row_shift is None else torch.from_numpy(row_shift),
    )
    assert score.shape == tuple(want[2].shape)
    _, ref_score, ref_den = gat_aggregate_dense(gp, h, att[:, 0], att[:, 1])
    sh = 0.0 if row_shift is None else row_shift.astype(np.float64)
    ref_den = ref_den * np.exp(-sh)
    ref_num = np.zeros((500, 12))
    np.add.at(ref_num, gp.dst_per_edge, (ref_score * np.exp(-np.broadcast_to(sh, 500)[gp.dst_per_edge]))[:, None] * h[gp.indices])
    what = f"residual att={att_gather} h={h_gather} shift={shift}"
    assert_matches_jax(num.numpy(), _as_np(want[0]), ref_num, what=f"{what} num")
    assert_matches_jax(den.numpy(), _as_np(want[1]), ref_den, what=f"{what} den")
    assert_matches_jax(score.numpy(), _as_np(want[2]), what=f"{what} slot scores")


def _stabilize_setting(att_scale):
    """tests/test_gat_stabilize.py's setting, without bit tiles or
    transposes."""
    gj = j_rmat_graph(2000, 30000, seed=21, with_val=False, device="cpu")
    gp = rmat_graph(2000, 30000, seed=21, with_val=False)
    h = j_normal_features(gp.num_nodes, 16, seed=1) * 0.1
    att = j_normal_features(gp.num_nodes, 2, seed=2) * att_scale
    kw = dict(tile_rows=64, tile_cols=128, threshold=4, residual_block=4)
    jagg = JAggregator.schedule_hybrid(gj, tile_dtype=np.int8, with_transpose=False, **kw)
    agg = Aggregator.schedule_hybrid(gp, tile_dtype=np.int8, with_transpose=False, device="cpu", **kw)
    return gp, np.asarray(h, np.float32), np.asarray(att, np.float32), jagg, agg


@pytest.mark.parametrize(
    "stabilize,att_scale", [(False, 0.1), (True, 0.1), (True, 15.0), ("bound", 0.1), ("bound", 15.0)]
)
def test_run_gat_matches_jax(stabilize, att_scale):
    gp, h, att, jagg, agg = _stabilize_setting(att_scale)
    want = jagg.run_gat(jnp.asarray(h), jnp.asarray(att), stabilize=stabilize)
    got = agg.run_gat(torch.from_numpy(h), torch.from_numpy(att), stabilize=stabilize)
    ref = gat_aggregate_dense(gp, h, att[:, 0], att[:, 1])[0]
    assert_matches_jax(got.numpy(), _as_np(want), ref, what=f"run_gat stabilize={stabilize} scale={att_scale}")
    if stabilize is True:
        shift = _hybrid_row_shift(agg.tile_parts(), agg.plan, torch.from_numpy(att), 0.2)
        want_shift = j_row_shift(jagg.tile_parts(), jagg.plan, jnp.asarray(att), 0.2)
        assert np.array_equal(shift.numpy(), np.asarray(want_shift))
    assert _launches() == (0, 0, 0)


def _forward_setting(dims, pack, heads=1):
    gj = j_rmat_graph(480, 9000, seed=29, with_val=False, device="cpu")
    gp = rmat_graph(480, 9000, seed=29, with_val=False)
    gj, gp = gj.reorder(j_degree_sort(gj)), gp.reorder(degree_sort(gp))
    kw = dict(tile_rows=64, tile_cols=64, threshold=4, residual_block=4, pack=pack)
    jagg = JAggregator.schedule_hybrid(gj, tile_dtype=np.int8, with_transpose=False, **kw)
    agg = Aggregator.schedule_hybrid(gp, tile_dtype=np.int8, with_transpose=False, device="cpu", **kw)
    weights = glorot_gat_weights(dims, seed=0, heads=heads)
    h = normal_features(gp.num_nodes, dims[0], seed=123) * 0.1
    return gp, jagg, agg, weights, h


@pytest.mark.parametrize("pack", [1, 16])
def test_gat_forward_matches_jax(pack):
    dims = (64, 32, 16, 8)
    gp, jagg, agg, weights, h = _forward_setting(dims, pack)
    jparams = [JGATLayerParams(jnp.asarray(w), jnp.asarray(a)) for w, a in weights]
    want = j_gat_forward(jagg, jparams, jnp.asarray(h), fast=True, dot_mode="split2")

    model = gat_params_from_jax(jparams, device="cpu")
    assert [tuple(w.shape) for w in model.w] == list(zip(dims[:-1], dims[1:]))
    assert [tuple(a.shape) for a in model.w_att] == [(d, 2) for d in dims[1:]]
    with torch.no_grad():
        got = model(agg, torch.from_numpy(h), fast=True, dot_mode="split2")
        same = gat_forward(agg, model.layer_params(), torch.from_numpy(h), fast=True, dot_mode="split2")
        exact = model(agg, torch.from_numpy(h))
    assert torch.equal(got, same)

    ref = h.astype(np.float64)
    for w, a in weights:
        feat = ref @ w.astype(np.float64)
        att = feat @ a.astype(np.float64)
        ref = gat_aggregate_dense(gp, feat, att[:, 0], att[:, 1])[0]
    assert_matches_jax(got.numpy(), _as_np(want), ref, what=f"gat forward pack{pack}")
    assert_matches_jax(exact.numpy(), _as_np(want), ref, what=f"gat forward exact modes pack{pack}")
    assert _launches() == (0, 0, 0)


def test_gat_two_head_layer_matches_jax():
    dims = (24, 16)
    gp, jagg, agg, weights, h = _forward_setting(dims, pack=1, heads=2)
    (w, a), = weights
    assert a.shape == (2, 16, 2)
    want = j_gat_forward(jagg, [JGATLayerParams(jnp.asarray(w), jnp.asarray(a))], jnp.asarray(h), fast=True)
    with torch.no_grad():
        model = gat_params_from_jax([(w, a)], device="cpu")
        got = gat_layer(agg, torch.from_numpy(h), model.layer_params()[0], att_gather_dtype="f16_split2",
                        h_gather_dtype="f16_split2")
    feat = h.astype(np.float64) @ w
    ref = np.concatenate(
        [gat_aggregate_dense(gp, feat, *(feat @ a[k]).T)[0] for k in range(2)], axis=1
    )
    assert got.shape == (gp.num_nodes, 32)
    assert_matches_jax(got.numpy(), _as_np(want), ref, what="2-head layer")


def test_gat_dense_oracle_equals_jax():
    _, gp = _graphs(n=300, m=5000, seed=3)
    gj = j_rmat_graph(300, 5000, seed=3, with_val=False, device="cpu")
    gj = gj.reorder(j_degree_sort(gj))
    h = np.random.default_rng(0).standard_normal((300, 5))
    att = np.random.default_rng(1).standard_normal((300, 2))
    for got, want in zip(gat_aggregate_dense(gp, h, att[:, 0], att[:, 1], 0.3),
                         j_reference.gat_aggregate_dense(gj, h, att[:, 0], att[:, 1], 0.3)):
        assert np.array_equal(got, want)


def test_glorot_gat_weights_scale():
    dims = (512, 128, 64, 32)
    for heads in (1, 4):
        ws = glorot_gat_weights(dims, seed=0, heads=heads)
        for i, (w, a) in enumerate(ws):
            scale = np.sqrt(2.0 / (dims[i] + dims[i + 1]))
            assert w.shape == (dims[i], dims[i + 1]) and w.dtype == np.float32
            assert a.shape == ((dims[i + 1], 2) if heads == 1 else (heads, dims[i + 1], 2))
            assert abs(w.std() / scale - 1.0) < 0.1
    a1 = glorot_gat_weights(dims, seed=0)
    a2 = glorot_gat_weights(dims, seed=0)
    assert all(np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1]) for x, y in zip(a1, a2))
    assert isinstance(GAT(a1, device="cpu"), torch.nn.Module)


def test_unported_gat_options_raise():
    gp, h, att, jagg, agg = _stabilize_setting(0.1)
    ht, at = torch.from_numpy(h), torch.from_numpy(att)
    with pytest.raises(ValueError):
        agg.run_gat(ht, at, dot_mode="twodot")
    with pytest.raises(ValueError):
        agg.run_gat(ht, at, stabilize="loose")
    with pytest.raises(ValueError):  # no gather mode in the JAX package either
        gat_aggregate_parts(agg.plan, ht, at, att_gather_dtype="bf16")
    # factored plans are refused: attention provides the edge weights
    rng = np.random.default_rng(0)
    sd = rng.uniform(0.5, 2.0, gp.num_nodes).astype(np.float32)
    ss = rng.uniform(0.5, 2.0, gp.n_src).astype(np.float32)
    scaled, _ = densify(gp, dtype=np.int8, val=sd[gp.dst_per_edge] * ss[gp.indices], scale_dst=sd, scale_src=ss,
                        tile_rows=64, tile_cols=128, threshold=4)
    with pytest.raises(ValueError, match="raw count"):
        hybrid_gat(scaled.to("cpu"), None, ht, at)
    # no tiles: the gather-only path, gat_aggregate over the plan, as the
    # JAX aggregator without tiles runs it
    want = dataclasses.replace(jagg, tile=None, tile_bits=None).run_gat(jnp.asarray(h), jnp.asarray(att))
    got = dataclasses.replace(agg, tile=None).run_gat(ht, at)
    assert_matches_jax(got.numpy(), _as_np(want), what="run_gat without tiles")


# ------------------------------------------------------- wide logits (C1, C2)
def _wide_case():
    """64 rows, 16x16 tiles: a dense 16x16 block (rows and sources 0..15)
    plus sparse random edges (tiles and residual); att ~ 0.1 N(0, 1)."""
    rng = np.random.default_rng(3)
    bd, bs = np.meshgrid(np.arange(16), np.arange(16), indexing="ij")
    dst = np.concatenate([bd.reshape(-1), rng.integers(0, 64, 600)])
    src = np.concatenate([bs.reshape(-1), rng.integers(0, 64, 600)])
    g = CSRGraph.from_edges(dst, src, 64)
    agg = Aggregator.schedule_hybrid(g, tile_dtype=np.int8, tile_rows=16, tile_cols=16, threshold=60,
                                     residual_block=4, pack=1, device="cpu")
    assert agg.tile.num_dense_edges and agg.plan.num_edges
    h = rng.standard_normal((64, 8))
    att = rng.standard_normal((64, 2)) * 0.1
    return g, agg, h, att


def _softmax_oracle(g, h, att, slope=0.2):
    """float64 GAT aggregation over the edge list, with autograd: the
    softmax over each row's in-edges of exp(lrelu(ad_i + as_j)), shifted by
    each row's max logit."""
    dst = torch.from_numpy(g.dst_per_edge.astype(np.int64))
    src = torch.from_numpy(g.indices.astype(np.int64))
    h64 = torch.tensor(h, dtype=torch.float64, requires_grad=True)
    a64 = torch.tensor(att, dtype=torch.float64, requires_grad=True)
    z = a64[dst, 0] + a64[src, 1]
    lz = torch.maximum(z, slope * z)
    mx = torch.full((g.num_nodes,), -torch.inf, dtype=torch.float64).scatter_reduce(0, dst, lz, "amax")
    s = torch.exp(lz - mx[dst].detach())
    den = torch.zeros(g.num_nodes, dtype=torch.float64).index_add(0, dst, s)
    num = torch.zeros((g.num_nodes, h.shape[1]), dtype=torch.float64).index_add(0, dst, s[:, None] * h64[src])
    return num / torch.where(den == 0, 1.0, den)[:, None], h64, a64


@pytest.mark.parametrize("big", [95.0, 120.0])
@pytest.mark.parametrize("stabilize", [True, "bound"])
def test_gat_wide_logits_match_softmax_oracle(big, stabilize):
    """One source's as at 95 or 120, beyond exp's float32 range: the
    stabilized forward and its gradients are finite and pass the gate
    against a float64 softmax oracle (the JAX package returns NaN here, so
    it is no oracle); the rows reading that source are ~its h."""
    g, agg, h, att = _wide_case()
    att[5, 1] = big
    want, h64, a64 = _softmax_oracle(g, h, att)
    w = np.cos(np.arange(64 * 8)).reshape(64, 8)
    (want * torch.from_numpy(w)).sum().backward()
    ht = torch.tensor(h, dtype=torch.float32, requires_grad=True)
    at = torch.tensor(att, dtype=torch.float32, requires_grad=True)
    got = agg.run_gat(ht, at, stabilize=stabilize)
    (got * torch.from_numpy(w).float()).sum().backward()
    for x, ref, what in ((got, want, "out"), (ht.grad, h64.grad, "dh"), (at.grad, a64.grad, "datt")):
        assert bool(torch.isfinite(x).all()), what
        assert_valid(x.detach().numpy(), ref.detach().numpy(), what=f"as={big} {stabilize} {what}")
    assert np.abs(got[:16].detach().numpy() - h[5]).max() < 1e-5
    assert cuda_gat.launches == 0


def test_gat_bound_far_below_matches_softmax_oracle():
    """C2: row 0's in-neighbors all have as = -100 and a source of another
    row has as = +100, so under the global bound every score of row 0
    underflows; the 'bound' forward rescues such rows with the exact shift
    and equals the softmax (here the mean of h over row 0's neighbors), and
    so do its gradients, with and without the aggregator's in-degrees."""
    g, agg, h, att = _wide_case()
    nbrs = np.unique(g.indices[g.indptr[0] : g.indptr[1]])
    far = next(j for j in range(16, 64) if j not in nbrs and (g.indices == j).any())
    att[:, 1] = np.clip(att[:, 1], -1.0, 1.0)
    att[nbrs, 1] = -100.0
    att[far, 1] = 100.0
    want, h64, a64 = _softmax_oracle(g, h, att)
    w = np.cos(np.arange(64 * 8)).reshape(64, 8)
    (want * torch.from_numpy(w)).sum().backward()
    for sched in (agg, dataclasses.replace(agg, in_degree=None)):
        ht = torch.tensor(h, dtype=torch.float32, requires_grad=True)
        at = torch.tensor(att, dtype=torch.float32, requires_grad=True)
        got = sched.run_gat(ht, at, stabilize="bound")
        (got * torch.from_numpy(w).float()).sum().backward()
        for x, ref, what in ((got, want, "out"), (ht.grad, h64.grad, "dh"), (at.grad, a64.grad, "datt")):
            assert bool(torch.isfinite(x).all()), what
            assert_valid(x.detach().numpy(), ref.detach().numpy(), what=f"far below: {what}")
        counts = np.bincount(g.indices[g.indptr[0] : g.indptr[1]], minlength=64)
        assert np.abs(got[0].detach().numpy() - counts @ h / counts.sum()).max() < 1e-5
