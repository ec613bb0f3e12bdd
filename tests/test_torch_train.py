"""The training slice: transposed plans, the flat slot helpers, the GAT
tile backward (plain versions, which stand beside the B3 and B4 CUDA
kernels), the autograd Functions of ``hybrid_spmm`` and ``hybrid_gat``, and
GCN/GAT training steps with checkpoints, against the JAX package on the CPU
(where its ops take their XLA forms: ``gat_bwd_dad_xla``,
``gat_bwd_dh_das_xla``, the custom VJPs over the transposed plans, optax).

Tolerance: plans and index helpers are array-equal.  Float results pass the
ops/validate gate (|y - ref| <= 1e-2*|ref| + 1e-5) against the JAX package
and max|port - jax| <= 1e-5 * max|jax|, which covers float32 summation
order only.  Training: the losses of 3 Adam steps agree within 1e-5
relative and the parameters within 1e-5 * max|param|."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gnn_computing_tpu.aggregator import Aggregator as JAggregator
from gnn_computing_tpu.graph.csr import CSRGraph as JCSRGraph
from gnn_computing_tpu.graph.reorder import degree_sort as j_degree_sort
from gnn_computing_tpu.graph.synthetic import rmat_graph as j_rmat_graph
from gnn_computing_tpu.models.gat import GATLayerParams as JGATLayerParams
from gnn_computing_tpu.models.gat import gat_forward as j_gat_forward
from gnn_computing_tpu.models.gcn import gcn_forward_bench as j_gcn_forward_bench
from gnn_computing_tpu.models.training import load_checkpoint as j_load_checkpoint
from gnn_computing_tpu.models.training import save_checkpoint as j_save_checkpoint
from gnn_computing_tpu.ops.bcsr import hybrid_spmm as j_hybrid_spmm
from gnn_computing_tpu.ops.bcsr_gat import _branch_factors as j_branch_factors
from gnn_computing_tpu.ops.bcsr_gat import gat_bwd_dad_xla, gat_bwd_dh_das_xla
from gnn_computing_tpu.ops.bcsr_gat import hybrid_gat as j_hybrid_gat
from gnn_computing_tpu.ops.spmm import edge_values_from_slots_flat as j_edge_values_from_slots_flat
from gnn_computing_tpu.ops.spmm import sddmm_slots_xla
from gnn_computing_tpu.ops.spmm import slots_from_edge_values_flat as j_slots_from_edge_values_flat
from gnn_computing_tpu.ops.spmm import spmm_xla
from gnn_computing_tpu.schedule import Schedule, make_plan
from gnn_computing_tpu.schedule.tiles import densify as j_densify

from gnn_computing_tpu_torch.aggregator import Aggregator
from gnn_computing_tpu_torch.convert import gat_params_from_jax, gcn_params_from_jax, params_from_checkpoint
from gnn_computing_tpu_torch.graph import CSRGraph, degree_sort, normal_features, rmat_graph
from gnn_computing_tpu_torch.models.gat import glorot_gat_weights
from gnn_computing_tpu_torch.models.gcn import glorot_weights
from gnn_computing_tpu_torch.models.training import (
    accuracy,
    load_checkpoint,
    make_train_step,
    param_leaves,
    save_checkpoint,
)
from gnn_computing_tpu_torch.ops import bcsr, bcsr_gat, cuda_bcsr, cuda_gat, cuda_gat_bwd, cuda_rowmax
from gnn_computing_tpu_torch.ops.bcsr_gat import (
    _score_terms,
    gat_bwd_dad,
    gat_bwd_dad_plain,
    gat_bwd_dh_das,
    gat_bwd_dh_das_plain,
)
from gnn_computing_tpu_torch.ops.spmm import (
    edge_values_from_slots_flat,
    sddmm_slots,
    slots_from_edge_values_flat,
    spmm_plain,
)
from gnn_computing_tpu_torch.schedule.neighbor_grouping import neighbor_grouping_plan
from gnn_computing_tpu_torch.schedule.tiles import densify

from test_torch_spmm import assert_matches_jax

# tests/test_gat_streaming_bwd.py's setting, without bit tiles
SCHEDULE = dict(tile_rows=16, tile_cols=128, threshold=4, residual_block=8, pack=2)


def _launches():
    return (cuda_bcsr.launches, cuda_gat.launches, cuda_rowmax.launches,
            cuda_gat_bwd.dad_launches, cuda_gat_bwd.dh_das_launches)


def _np(x):
    return np.asarray(jax.device_get(x), np.float64)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _graphs(n=700, m=22000, seed=5, with_val=False, src_gap=None):
    """RMAT graph in both packages; ``src_gap`` = (lo, hi) drops every edge
    from sources lo..hi-1, so the transposed plan needs coverage fillers."""
    gj = j_rmat_graph(n, m, seed=seed, with_val=with_val, device="cpu")
    gp = rmat_graph(n, m, seed=seed, with_val=with_val)
    if src_gap is not None:
        d, s = gp.dst_per_edge, gp.indices
        keep = (s < src_gap[0]) | (s >= src_gap[1])
        val = None if gp.val is None else gp.val[keep]
        gj = JCSRGraph.from_edges(d[keep], s[keep], n, val=val)
        gp = CSRGraph.from_edges(d[keep], s[keep], n, val=val)
    return gj, gp


def _aggs(gj, gp, tile_dtype=np.int8, **kw):
    """The same hybrid schedule with transposed plans in both packages
    (int8 count tiles unless ``tile_dtype`` says otherwise)."""
    kw = dict(SCHEDULE, **kw)
    jagg = JAggregator.schedule_hybrid(gj, tile_dtype=tile_dtype, with_transpose=True, **kw)
    agg = Aggregator.schedule_hybrid(gp, tile_dtype=tile_dtype, with_transpose=True, device="cpu", **kw)
    return jagg, agg


# ------------------------------------------------------------ host layer
@pytest.mark.parametrize("with_val", [False, True])
def test_transpose_with_map_equals_jax(with_val):
    gj, gp = _graphs(with_val=with_val)
    gtj, mapj = gj.transpose_with_map()
    gtp, mapp = gp.transpose_with_map()
    assert np.array_equal(gtp.indptr, gtj.indptr) and np.array_equal(gtp.indices, gtj.indices)
    assert (gtp.val is None) == (gtj.val is None)
    if with_val:
        assert np.array_equal(gtp.val, gtj.val)
        assert np.array_equal(gtp.val, gp.val[mapp])
    assert np.array_equal(mapp, mapj) and mapp.dtype == np.int64
    assert (gtp.num_nodes, gtp.n_src) == (gp.n_src, gp.num_nodes)
    assert np.array_equal(gp.transpose().indices, gtp.indices)
    # transposed edge i is original edge map[i]
    assert np.array_equal(gtp.indices, gp.dst_per_edge[mapp])
    assert np.array_equal(gtp.dst_per_edge, gp.indices[mapp])


@pytest.mark.parametrize("tiles", [(16, 128), (64, 32)])
@pytest.mark.parametrize("pack", [1, 4])
def test_tile_transpose_equals_jax(tiles, pack):
    tr, tc = tiles
    gj, gp = _graphs(src_gap=(256, 520))
    kw = dict(tile_rows=tr, tile_cols=tc, threshold=4)
    tj, _ = j_densify(gj, dtype=np.int8, **kw)
    tp, _ = densify(gp, dtype=np.int8, **kw)
    ttj, ttp = tj.transpose(), tp.transpose()
    # source tiles without a tile of their own get zero coverage fillers
    missing = np.setdiff1d(np.arange(ttp.num_row_tiles), np.asarray(tp.tile_col))
    assert len(missing) >= 2
    assert ttp.num_tiles == tp.num_tiles + len(missing)
    assert not np.asarray(ttp.a)[np.isin(np.asarray(ttp.tile_row), missing)].any()
    for got, want in ((ttp, ttj), (ttp.pad_runs(pack), ttj.pad_runs(pack))):
        for field in ("a", "tile_col", "tile_row"):
            assert np.array_equal(np.asarray(getattr(got, field)), np.asarray(getattr(want, field))), field
        assert (got.num_tiles, got.num_nodes, got.n_src, got.tile_rows, got.tile_cols) == (
            want.num_tiles, want.num_nodes, want.n_src, want.tile_rows, want.tile_cols)
        assert np.array_equal(got.run_start, np.searchsorted(got.tile_row, np.arange(got.num_row_tiles + 1)))
    # A^T holds the same cells
    t, i, j = np.nonzero(ttp.a)
    cells_t = np.sort((ttp.tile_col[t].astype(np.int64) * tr + j) * 10**6 + ttp.tile_row[t] * tc + i)
    t, i, j = np.nonzero(tp.a)
    cells = np.sort((tp.tile_row[t].astype(np.int64) * tr + i) * 10**6 + tp.tile_col[t] * tc + j)
    assert np.array_equal(cells, cells_t)


def test_factored_transpose_swaps_scales():
    gj, gp = _graphs()
    rng = np.random.default_rng(0)
    sd = rng.uniform(0.5, 2.0, gp.num_nodes).astype(np.float32)
    ss = rng.uniform(0.5, 2.0, gp.n_src).astype(np.float32)
    tp, _ = densify(gp, dtype=np.int8, val=sd[gp.dst_per_edge] * ss[gp.indices], scale_dst=sd, scale_src=ss,
                    tile_rows=16, tile_cols=128, threshold=4)
    tt = tp.transpose()
    assert np.array_equal(tt.scale_dst, ss) and np.array_equal(tt.scale_src, sd)


def test_schedule_hybrid_with_transpose_equals_jax():
    gj, gp = _graphs()
    jagg, agg = _aggs(gj, gp)
    assert agg.tile_parts_t() and len(agg.tile_parts_t()) == len(jagg.tile_parts_t())
    for field in ("a", "tile_col", "tile_row"):
        assert np.array_equal(getattr(agg.tile_t, field).numpy(), np.asarray(getattr(jagg.tile_t, field))), field
    assert agg.tile_t.num_tiles == jagg.tile_t.num_tiles and agg.tile_t.pack == 2
    pj, pp = jagg.plan_t, agg.plan_t
    nt, b = pj.num_tasks_padded, pj.block_size
    assert np.array_equal(pp.src.numpy(), np.asarray(pj.src).reshape(-1))
    assert np.array_equal(pp.val.numpy(), np.asarray(pj.val).reshape(-1))
    for field in ("count", "dst"):
        assert np.array_equal(getattr(pp, field).numpy(), np.asarray(getattr(pj, field))), field
    assert (pp.num_tasks_padded, pp.block_size, pp.num_edges) == (nt, b, pj.num_edges)
    assert np.array_equal(agg.edge_map_t.numpy(), np.asarray(jagg.edge_map_t))
    assert agg.edge_map_t.dtype == torch.int64
    moved = agg.to("cpu")
    assert moved.tile_t.a.dtype == torch.int8 and moved.plan_t.src.dtype == torch.int64
    assert _launches() == (0, 0, 0, 0, 0)


# ------------------------------------------------------- slot helpers
def test_flat_slot_helpers_equal_jax():
    gj, gp = _graphs(n=500, m=8000, seed=13)
    jplan = make_plan(gj, Schedule.neighbor_grouping, block_size=4).device_put()
    plan = neighbor_grouping_plan(gp, block_size=4).to("cpu")
    ev = np.random.default_rng(3).standard_normal(gp.num_edges).astype(np.float32)
    want = j_slots_from_edge_values_flat(jplan, jnp.asarray(ev))
    got = slots_from_edge_values_flat(plan, torch.from_numpy(ev))
    assert np.array_equal(got.numpy(), np.asarray(want))
    back = edge_values_from_slots_flat(plan, got)
    assert np.array_equal(back.numpy(), np.asarray(j_edge_values_from_slots_flat(jplan, want)))
    assert np.array_equal(back.numpy(), ev)
    # explicit slot values in spmm_plain, against spmm_xla's
    h = np.random.default_rng(4).standard_normal((gp.n_src, 12)).astype(np.float32)
    assert_matches_jax(
        spmm_plain(plan, torch.from_numpy(h), val=got).numpy(), _np(spmm_xla(jplan, jnp.asarray(h), val=want)),
        what="spmm_plain explicit val",
    )


@pytest.mark.parametrize("chunk_slots", [1 << 22, 64])
def test_sddmm_slots_matches_jax(chunk_slots):
    gj, gp = _graphs(n=500, m=8000, seed=13)
    jplan = make_plan(gj, Schedule.neighbor_grouping, block_size=4).device_put()
    plan = neighbor_grouping_plan(gp, block_size=4).to("cpu")
    rng = np.random.default_rng(5)
    a = rng.standard_normal((gp.n_src, 10)).astype(np.float32)
    b = rng.standard_normal((gp.num_nodes, 10)).astype(np.float32)
    want = _np(sddmm_slots_xla(jplan, jnp.asarray(a), jnp.asarray(b))).reshape(-1)
    got = sddmm_slots(plan, torch.from_numpy(a), torch.from_numpy(b), chunk_slots=chunk_slots)
    assert got.shape == (plan.num_tasks_padded * 4,)
    ref = np.zeros_like(want)
    valid = (np.arange(got.numel()) % 4) < np.repeat(plan.count.numpy(), 4)
    src = plan.src.numpy()[valid]
    dst = np.repeat(plan.dst.numpy(), 4)[valid]
    ref[valid] = (a[src].astype(np.float64) * b[dst]).sum(axis=1)
    assert_matches_jax(got.numpy(), want, ref, what="sddmm_slots")


# ------------------------------------------------------- GAT tile backward
def _bwd_inputs(n, f, att_scale, shift, seed=1):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((n, f)).astype(np.float32)
    gbar = rng.standard_normal((n, f)).astype(np.float32)
    c = rng.standard_normal(n).astype(np.float32)
    att = (rng.standard_normal((n, 2)) * att_scale).astype(np.float32)
    row_shift = None
    if shift:
        a_max = att[:, 1].max()
        row_shift = np.maximum(att[:, 0] + a_max, 0.2 * (att[:, 0] + a_max)).astype(np.float32)
    return h, gbar, c, att, row_shift


@pytest.mark.parametrize("att_scale,shift", [(0.1, False), (1.0, False), (15.0, True)])
def test_gat_bwd_plain_matches_xla(att_scale, shift):
    gj, gp = _graphs()
    jagg, agg = _aggs(gj, gp)
    n = gp.num_nodes
    h, gbar, c, att, row_shift = _bwd_inputs(n, 16, att_scale, shift)
    ju12, jv12 = j_branch_factors(jnp.asarray(att), 0.2, None if row_shift is None else jnp.asarray(row_shift))
    # the port scores each cell from (ad, M) and as (no per-node factors)
    dm, asrc = _score_terms(_t(att), None if row_shift is None else _t(row_shift))
    args = (_t(h), _t(gbar), _t(c), dm, asrc, 0.2)
    jargs = (jnp.asarray(h), jnp.asarray(gbar), jnp.asarray(c), ju12, jv12, 0.2)

    dad = gat_bwd_dad_plain(agg.tile, *args)
    assert torch.equal(gat_bwd_dad(agg.tile, *args), dad)
    assert_matches_jax(dad.numpy(), _np(gat_bwd_dad_xla(jagg.tile, *jargs)), what=f"d_ad scale {att_scale}")
    dh, das = gat_bwd_dh_das_plain(agg.tile_t, *args)
    got = gat_bwd_dh_das(agg.tile_t, *args)
    assert torch.equal(got[0], dh) and torch.equal(got[1], das)
    want_dh, want_das = gat_bwd_dh_das_xla(jagg.tile_t, *jargs)
    assert_matches_jax(dh.numpy(), _np(want_dh), what=f"dh scale {att_scale}")
    assert_matches_jax(das.numpy(), _np(want_das), what=f"d_as scale {att_scale}")

    # float64 oracle over the forward plan's cells
    tp = agg.tile
    t, i, j = np.nonzero(tp.a.numpy())
    rows = tp.tile_row.numpy()[t].astype(np.int64) * 16 + i
    cols = tp.tile_col.numpy()[t].astype(np.int64) * 128 + j
    z = att[rows, 0].astype(np.float64) + att[cols, 1]
    m = 0.0 if row_shift is None else row_shift[rows].astype(np.float64)
    s = tp.a.numpy()[t, i, j] * np.exp(np.maximum(z, 0.2 * z) - m)
    term = np.where(z >= 0, 1.0, 0.2) * s * ((gbar[rows].astype(np.float64) * h[cols]).sum(1) - c[rows])
    assert_matches_jax(dad.numpy(), _np(gat_bwd_dad_xla(jagg.tile, *jargs)),
                       np.bincount(rows, weights=term, minlength=n), what="d_ad vs f64")
    assert_matches_jax(das.numpy(), _np(want_das), np.bincount(cols, weights=term, minlength=n), what="d_as vs f64")
    ref_dh = np.zeros((n, 16))
    np.add.at(ref_dh, cols, s[:, None] * gbar[rows])
    assert_matches_jax(dh.numpy(), _np(want_dh), ref_dh, what="dh vs f64")
    assert _launches() == (0, 0, 0, 0, 0)


# ------------------------------------------------------- autograd Functions
def _cos_weights(shape):
    return np.cos(np.arange(int(np.prod(shape)), dtype=np.float32)).reshape(shape)


def test_hybrid_spmm_grad_matches_jax():
    """Factored edge values (val = scale_dst[dst] * scale_src[src]): the
    transposed tiles carry the swapped scales, the transposed residual the
    values."""
    gj, gp = _graphs()
    rng = np.random.default_rng(0)
    sd = rng.uniform(0.5, 2.0, gp.num_nodes).astype(np.float32)
    ss = rng.uniform(0.5, 2.0, gp.n_src).astype(np.float32)
    val = sd[gp.dst_per_edge] * ss[gp.indices]
    gp = CSRGraph(gp.indptr, gp.indices, val=val)
    jagg, agg = _aggs(gj, gp, tile_rows=64, tile_cols=64, val=val, scale_dst=sd, scale_src=ss)
    assert agg.tile_t.scale_dst is not None
    h = normal_features(gp.n_src, 12, seed=1)
    w = _cos_weights((gp.num_nodes, 12))

    def jloss(hh):
        out = j_hybrid_spmm(jagg.tile_parts(), jagg.tile_parts_t(), jagg.plan, jagg.plan_t, hh, "xla")
        return jnp.sum(out * w)

    want = jax.grad(jloss)(jnp.asarray(h))
    ht = torch.from_numpy(h).requires_grad_(True)
    out = agg.run(ht)
    assert type(out.grad_fn).__name__ == "HybridSpmmBackward"
    (out * torch.from_numpy(w)).sum().backward()
    # float64 oracle: A^T @ w
    ref = np.zeros((gp.n_src, 12))
    np.add.at(ref, gp.indices, gp.val[:, None].astype(np.float64) * w[gp.dst_per_edge])
    assert_matches_jax(ht.grad.numpy(), _np(want), ref, what="hybrid_spmm dh")
    assert _launches() == (0, 0, 0, 0, 0)


def _jax_gat_grads(jagg, h, att, stabilize):
    def loss(hh, aa):
        out = j_hybrid_gat(
            jagg.tile_parts(), jagg.plan, hh, aa, stabilize=stabilize, strategy="xla",
            tp_t=jagg.tile_parts_t(), plan_t=jagg.plan_t, edge_map_t=jagg.edge_map_t,
        )
        return jnp.sum(out * _cos_weights(out.shape))

    return jax.grad(loss, argnums=(0, 1))(jnp.asarray(h), jnp.asarray(att))


@pytest.mark.parametrize(
    "stabilize,att_scale", [(False, 1.0), (True, 1.0), (True, 15.0), ("bound", 1.0), ("bound", 15.0)]
)
def test_hybrid_gat_grads_match_jax(stabilize, att_scale):
    gj, gp = _graphs()
    jagg, agg = _aggs(gj, gp)
    n = gp.num_nodes
    h = normal_features(n, 16, seed=1)
    att = (normal_features(n, 2, seed=2) * att_scale).astype(np.float32)
    want_dh, want_datt = _jax_gat_grads(jagg, h, att, stabilize)
    ht = torch.from_numpy(h).requires_grad_(True)
    at = torch.from_numpy(att).requires_grad_(True)
    out = agg.run_gat(ht, at, stabilize=stabilize)
    assert type(out.grad_fn).__name__ == "HybridGatBackward"
    (out * torch.from_numpy(_cos_weights(tuple(out.shape)))).sum().backward()
    what = f"stabilize={stabilize} scale={att_scale}"
    assert_matches_jax(ht.grad.numpy(), _np(want_dh), what=f"dh {what}")
    assert_matches_jax(at.grad.numpy(), _np(want_datt), what=f"datt {what}")
    assert _launches() == (0, 0, 0, 0, 0)


def test_gat_grads_match_float64_autograd():
    """The hand-written backward against float64 autograd through a dense
    GAT over the whole edge list (stabilize='bound', whose shift is a
    constant of the gradient)."""
    gj, gp = _graphs()
    _, agg = _aggs(gj, gp)
    n = gp.num_nodes
    h = normal_features(n, 16, seed=3)
    att = normal_features(n, 2, seed=4)
    w = torch.from_numpy(_cos_weights((n, 16))).double()
    ht = torch.from_numpy(h).requires_grad_(True)
    at = torch.from_numpy(att).requires_grad_(True)
    (agg.run_gat(ht, at, stabilize="bound") * w.float()).sum().backward()
    hd = torch.from_numpy(h).double().requires_grad_(True)
    ad = torch.from_numpy(att).double().requires_grad_(True)
    dst = torch.from_numpy(gp.dst_per_edge.astype(np.int64))
    src = torch.from_numpy(gp.indices.astype(np.int64))
    z = ad[dst, 0] + ad[src, 1]
    score = torch.exp(torch.maximum(z, 0.2 * z))
    num = torch.zeros((n, 16), dtype=torch.float64).index_add(0, dst, score[:, None] * hd[src])
    den = torch.zeros(n, dtype=torch.float64).index_add(0, dst, score)
    (num / torch.where(den == 0, 1.0, den)[:, None] * w).sum().backward()
    assert_matches_jax(ht.grad.numpy(), hd.grad.numpy(), what="dh vs f64 autograd")
    assert_matches_jax(at.grad.numpy(), ad.grad.numpy(), what="datt vs f64 autograd")


def test_functions_run_their_own_backward(monkeypatch):
    """The gradients come from the Functions' backwards (B1 over the
    transposed tiles for GCN, the plain B3/B4 versions for GAT), not from
    autograd through the plain forward."""
    gj, gp = _graphs()
    _, agg = _aggs(gj, gp)
    calls = {"dad": 0, "dh_das": 0, "tiles_t": 0}
    for name, key in (("gat_bwd_dad_plain", "dad"), ("gat_bwd_dh_das_plain", "dh_das")):
        orig = getattr(bcsr_gat, name)

        def counted(*a, _orig=orig, _key=key, **kw):
            calls[_key] += 1
            return _orig(*a, **kw)

        monkeypatch.setattr(bcsr_gat, name, counted)
    orig_spmm = bcsr.bcsr_spmm

    def counted_spmm(tp, h, h_mode="auto"):
        if isinstance(tp, tuple) and tp and tp[0] is agg.tile_t:
            calls["tiles_t"] += 1
        return orig_spmm(tp, h, h_mode)

    monkeypatch.setattr(bcsr, "bcsr_spmm", counted_spmm)
    h = torch.from_numpy(normal_features(gp.num_nodes, 8, seed=1)).requires_grad_(True)
    att = torch.from_numpy(normal_features(gp.num_nodes, 2, seed=2)).requires_grad_(True)
    out = agg.run_gat(h, att, stabilize="bound")
    assert calls == {"dad": 0, "dh_das": 0, "tiles_t": 0}
    out.sum().backward()
    assert calls == {"dad": 1, "dh_das": 1, "tiles_t": 0}
    agg.run(h).sum().backward()
    assert calls == {"dad": 1, "dh_das": 1, "tiles_t": 1}
    # without grad, no graph and no backward
    with torch.no_grad():
        assert agg.run_gat(h, att).grad_fn is None and agg.run(h).grad_fn is None
    assert _launches() == (0, 0, 0, 0, 0)


def test_backward_without_transposes_raises():
    gj, gp = _graphs()
    agg = Aggregator.schedule_hybrid(gp, tile_dtype=np.int8, with_transpose=False, device="cpu", **SCHEDULE)
    assert agg.tile_t is None and agg.plan_t is None
    h = torch.from_numpy(normal_features(gp.num_nodes, 8, seed=1)).requires_grad_(True)
    att = torch.from_numpy(normal_features(gp.num_nodes, 2, seed=2))
    with pytest.raises(RuntimeError, match="with_transpose=True"):
        agg.run(h).sum().backward()
    with pytest.raises(RuntimeError, match="with_transpose=True"):
        agg.run_gat(h, att).sum().backward()
    # a transposed tile plan without the residual's transposed plan
    _, full = _aggs(gj, gp)
    with pytest.raises(RuntimeError, match="with_transpose=True"):
        dataclasses.replace(full, plan_t=None).run_gat(h, att).sum().backward()


def test_kernel_wrappers_refuse_grad():
    from gnn_computing_tpu_torch.ops.cuda_bcsr import bcsr_spmm_cuda
    from gnn_computing_tpu_torch.ops.cuda_gat import gat_bcsr_cuda
    from gnn_computing_tpu_torch.ops.cuda_gat_bwd import gat_bwd_dad_cuda, gat_bwd_dh_das_cuda
    from gnn_computing_tpu_torch.ops.cuda_rowmax import rowmax_bcsr_cuda

    gj, gp = _graphs()
    _, agg = _aggs(gj, gp)
    n = gp.num_nodes
    h = torch.zeros((n, 8), requires_grad=True)
    dm = torch.ones((n, 2))
    v = torch.ones(n)
    c = torch.zeros(n)
    for call in (
        lambda: bcsr_spmm_cuda(agg.tile, h),
        lambda: gat_bcsr_cuda(agg.tile, h, dm, v, 0.2),
        lambda: rowmax_bcsr_cuda(agg.tile, c.requires_grad_(True)),
        lambda: gat_bwd_dad_cuda(agg.tile, h, h, c, dm, v, 0.2),
        lambda: gat_bwd_dh_das_cuda(agg.tile_t, h, h, c, dm, v, 0.2),
    ):
        with pytest.raises(RuntimeError, match="requires grad"):
            call()
    # with grad off they get as far as the device check
    with torch.no_grad():
        with pytest.raises(ValueError, match="CUDA"):
            gat_bwd_dad_cuda(agg.tile, h, h, c, dm, v, 0.2)
        with pytest.raises(ValueError, match="CUDA"):
            gat_bwd_dh_das_cuda(agg.tile_t, h, h, c, dm, v, 0.2)


# ------------------------------------------------------- training steps
DIMS = (64, 32, 16, 8)


def _train_setting(tiles="int8"):
    """tiles: 'int8' count tiles, 'bits' (bench.py --train's 1-bit and int8
    parts) or 'f32' (float32 tiles of the GCN-normalized edge values, the
    JAX package's default schedule)."""
    gj, gp = _graphs(n=480, m=9000, seed=29)
    gj, gp = gj.reorder(j_degree_sort(gj)), gp.reorder(degree_sort(gp))
    kw = dict(tile_rows=64, tile_cols=64, residual_block=4, pack=1, bit_tiles=tiles == "bits")
    if tiles == "f32":
        kw.update(tile_dtype=None, val=gp.gcn_norm_val())
    jagg, agg = _aggs(gj, gp, **kw)
    bit_tiles = tiles == "bits"
    assert len(agg.tile_parts_t()) == (2 if bit_tiles else 1)
    h = normal_features(gp.num_nodes, DIMS[0], seed=123) * 0.1
    labels = np.random.default_rng(7).integers(0, DIMS[-1], gp.num_nodes)
    return jagg, agg, h, labels


def _jax_train(jfwd, params, h, labels, steps=3):
    opt = optax.adam(1e-3)
    state = opt.init(params)
    losses = []
    for _ in range(steps):
        def loss_fn(p):
            logp = jax.nn.log_softmax(jfwd(p, jnp.asarray(h)))
            return -jnp.mean(jnp.take_along_axis(logp, jnp.asarray(labels)[:, None], axis=1))

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        losses.append(float(loss))
    return losses, jax.tree_util.tree_leaves(params)


def _check_training(losses, jlosses, model, jleaves):
    assert np.isfinite(losses).all()
    assert np.allclose(losses, jlosses, rtol=1e-5, atol=0), (losses, jlosses)
    assert losses[-1] < losses[0]
    for got, want in zip(param_leaves(model), jleaves):
        want = np.asarray(want)
        assert np.abs(got.detach().numpy() - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize(
    "model_kind,tiles",
    [("gcn", "int8"), ("gat", "int8"), ("gcn", "bits"), ("gat", "bits"), ("gcn", "f32")],
    ids=["gcn", "gat", "gcn-bit_tiles", "gat-bit_tiles", "gcn-f32_tiles"],
)
def test_training_steps_match_optax(model_kind, tiles):
    """3 Adam steps against optax, over int8 tiles, over bench.py --train's
    default split into a 1-bit and an int8 part, and (GCN) over float32
    tiles of the GCN-normalized weighted graph."""
    jagg, agg, h, labels = _train_setting(tiles)
    if tiles == "f32":
        assert agg.tile.format == "float32" and agg.tile_t.format == "float32"
    if model_kind == "gcn":
        weights = glorot_weights(DIMS, seed=0)
        jparams = [jnp.asarray(w) for w in weights]
        model = gcn_params_from_jax(jparams, device="cpu")

        def jfwd(p, hh):
            return j_gcn_forward_bench(jagg, p, hh, strategy="xla")

        def fwd(hh):
            return model(agg, hh)
    else:
        weights = glorot_gat_weights(DIMS, seed=0)
        jparams = [JGATLayerParams(jnp.asarray(w), jnp.asarray(a)) for w, a in weights]
        model = gat_params_from_jax(jparams, device="cpu")

        def jfwd(p, hh):
            return j_gat_forward(jagg, p, hh, fast=False, stabilize="bound", dot_mode="split2")

        def fwd(hh):
            return model(agg, hh, fast=False, stabilize="bound", dot_mode="split2")

    jlosses, jleaves = _jax_train(jfwd, jparams, h, labels)
    step = make_train_step(fwd, torch.optim.Adam(model.parameters(), lr=1e-3), device="cpu")
    losses = [float(step((torch.from_numpy(h),), labels)) for _ in range(3)]
    _check_training(losses, jlosses, model, jleaves)
    with torch.no_grad():
        acc = accuracy(fwd(torch.from_numpy(h)), torch.from_numpy(labels))
    assert 0.0 <= float(acc) <= 1.0
    assert _launches() == (0, 0, 0, 0, 0)


def test_masked_loss_and_accuracy():
    logits = torch.tensor([[2.0, 0.0], [0.0, 1.0], [3.0, 0.0]], requires_grad=True)
    labels = torch.tensor([0, 0, 1])
    mask = torch.tensor([True, True, False])
    assert float(accuracy(logits, labels)) == pytest.approx(1 / 3)
    assert float(accuracy(logits, labels, mask)) == pytest.approx(0.5)
    opt = torch.optim.SGD([logits], lr=0.0)
    step = make_train_step(lambda x: x, opt, device="cpu")
    want = optax.softmax_cross_entropy_with_integer_labels(jnp.asarray(logits.detach().numpy()), jnp.asarray(labels))
    assert float(step((logits,), labels.numpy(), mask.numpy())) == pytest.approx(float(want[:2].mean()), rel=1e-6)
    assert float(step((logits,), labels)) == pytest.approx(float(want.mean()), rel=1e-6)
    with pytest.raises(ValueError):
        make_train_step(lambda x: x, opt, loss="mse", device="cpu")


# ------------------------------------------------------- checkpoints
@pytest.mark.parametrize("model_kind", ["gcn", "gat"])
def test_checkpoints_cross_between_packages(model_kind, tmp_path):
    if model_kind == "gcn":
        weights = glorot_weights(DIMS, seed=1)
        jparams = [jnp.asarray(w) for w in weights]
        model = gcn_params_from_jax(glorot_weights(DIMS, seed=2), device="cpu")
        jlike = [jnp.zeros_like(w) for w in jparams]
    else:
        weights = glorot_gat_weights(DIMS, seed=1)
        jparams = [JGATLayerParams(jnp.asarray(w), jnp.asarray(a)) for w, a in weights]
        model = gat_params_from_jax(glorot_gat_weights(DIMS, seed=2), device="cpu")
        jlike = [JGATLayerParams(jnp.zeros_like(p.w), jnp.zeros_like(p.w_att)) for p in jparams]
    # JAX -> port
    j_save_checkpoint(str(tmp_path / "jax.npz"), jparams, step=7)
    loaded, step = params_from_checkpoint(str(tmp_path / "jax.npz"), model)
    assert loaded is model and step == 7
    for got, want in zip(param_leaves(model), jax.tree_util.tree_leaves(jparams)):
        assert np.array_equal(got.detach().numpy(), np.asarray(want))
    # port -> JAX
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(-2.0)
    save_checkpoint(str(tmp_path / "port.npz"), model, step=11)
    jgot, jstep = j_load_checkpoint(str(tmp_path / "port.npz"), jlike)
    assert jstep == 11
    for got, want in zip(jax.tree_util.tree_leaves(jgot), param_leaves(model)):
        assert np.array_equal(np.asarray(got), want.detach().numpy())
    # a plain list of tensors loads as new tensors; a wrong shape raises
    leaves, step = load_checkpoint(str(tmp_path / "port.npz"), [p.detach() for p in param_leaves(model)])
    assert step == 11 and all(torch.equal(a, b) for a, b in zip(leaves, param_leaves(model)))
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(str(tmp_path / "port.npz"), [torch.zeros(3, 3)])
