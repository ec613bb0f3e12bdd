"""Bit-tile training in the PyTorch port against the JAX package (bench.py
``--train``'s default configuration): the transpose of a 1-bit plan, the
``bit_tiles=True, with_transpose=True`` schedule, the plain versions of B2
(GAT tile aggregation), B3 and B4 (its backward) and B5 (tile row max) over
1-bit parts, and the gradients of ``hybrid_spmm`` and ``hybrid_gat`` on a
bit-tile aggregator.  The JAX side runs its XLA forms on the CPU.  (3 Adam
steps of GCN and GAT on a bit-tile aggregator against optax are cases of
``tests/test_torch_train.py::test_training_steps_match_optax``.)

Tolerance, as ``tests/test_torch_train.py``: plans are array-equal; float
results pass the ops/validate gate (|y - ref| <= 1e-2*|ref| + 1e-5) against
the JAX package and max|port - jax| <= 1e-5 * max|jax| (float32 summation
order only); the row max is exactly equal.  A plain version over a 1-bit
part equals itself over the part's ``unpack_bits()`` (the same operations
in the same order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_computing_tpu.aggregator import Aggregator as JAggregator
from gnn_computing_tpu.graph.reorder import degree_sort as j_degree_sort
from gnn_computing_tpu.graph.synthetic import rmat_graph as j_rmat_graph
from gnn_computing_tpu.ops.bcsr import _bcsr_rowmax_xla
from gnn_computing_tpu.ops.bcsr import hybrid_spmm as j_hybrid_spmm
from gnn_computing_tpu.ops.bcsr_gat import _branch_factors as j_branch_factors
from gnn_computing_tpu.ops.bcsr_gat import gat_bcsr_xla, gat_bwd_dad_xla, gat_bwd_dh_das_xla
from gnn_computing_tpu.ops.bcsr_gat import hybrid_gat as j_hybrid_gat
from gnn_computing_tpu.schedule import tiles as j_tiles

from gnn_computing_tpu_torch.aggregator import Aggregator
from gnn_computing_tpu_torch.graph import degree_sort, normal_features, rmat_graph
from gnn_computing_tpu_torch.ops import cuda_bcsr, cuda_gat, cuda_gat_bwd, cuda_rowmax
from gnn_computing_tpu_torch.ops.bcsr import bcsr_rowmax, bcsr_rowmax_plain
from gnn_computing_tpu_torch.ops.bcsr_gat import (
    _global_bound_shift,
    _score_terms,
    gat_bcsr,
    gat_bcsr_plain,
    gat_bwd_dad,
    gat_bwd_dad_plain,
    gat_bwd_dh_das,
    gat_bwd_dh_das_plain,
)
from gnn_computing_tpu_torch.schedule.tiles import densify, split_bit_tiles, unpack_bit_tiles

from test_torch_spmm import assert_matches_jax

# (n, m, tile_rows, tile_cols, threshold): R, C in {16, 64, 256}; every
# split has a 1-bit and an int8 part
SETTINGS = {
    "r16c64": (1500, 30000, 16, 64, 3),
    "r64c64": (2048, 40000, 64, 64, 6),
    "r256c256": (2048, 65536, 256, 256, None),
}


def _launches():
    return (cuda_bcsr.launches, cuda_gat.launches, cuda_rowmax.launches,
            cuda_gat_bwd.dad_launches, cuda_gat_bwd.dh_das_launches)


def _np(x):
    return np.asarray(jax.device_get(x), np.float64)


def _graphs(n, m, seed=5):
    gj = j_rmat_graph(n, m, seed=seed, with_val=False, device="cpu")
    gp = rmat_graph(n, m, seed=seed, with_val=False)
    return gj.reorder(j_degree_sort(gj)), gp.reorder(degree_sort(gp))


def _bit_parts(setting):
    """(JAX 1-bit part, port 1-bit part, port graph), host plans, unpadded."""
    n, m, tr, tc, thr = SETTINGS[setting]
    gj, gp = _graphs(n, m)
    kw = dict(tile_rows=tr, tile_cols=tc, threshold=thr)
    jb, _ = j_tiles.split_bit_tiles(j_tiles.densify(gj, dtype=np.int8, **kw)[0])
    pb, _ = split_bit_tiles(densify(gp, dtype=np.int8, **kw)[0])
    assert jb is not None and pb is not None and pb.bits
    return jb, pb, gp


def _host(p):
    """A port plan on the CPU as numpy arrays, as the JAX plans are held."""
    return dataclasses.replace(
        p, a=p.a.numpy(), tile_row=p.tile_row.numpy(), tile_col=p.tile_col.numpy(), run_start=p.run_start.numpy()
    )


def _same_counts(jp, pp, bytes_equal):
    """A JAX part and a port part hold the same tiles (the port's counts()
    against the JAX plan's unpacked tiles); with ``bytes_equal`` both keep
    1-bit bytes and those are equal."""
    assert pp.bits or not bytes_equal
    assert np.array_equal(np.asarray(pp.counts()), j_tiles.unpack_bit_tiles(np.asarray(jp.a)) if jp.bits else jp.a)
    if bytes_equal:
        assert jp.bits and np.asarray(jp.a).dtype == np.uint8 and np.array_equal(np.asarray(jp.a), pp.a)
    assert np.array_equal(np.asarray(jp.tile_row), pp.tile_row)
    assert np.array_equal(np.asarray(jp.tile_col), pp.tile_col)
    for k in ("num_tiles", "num_dense_edges", "num_nodes", "n_src", "tile_rows", "tile_cols", "pack"):
        assert getattr(jp, k) == getattr(pp, k), k
    assert np.array_equal(pp.run_start, np.searchsorted(pp.tile_row, np.arange(pp.num_row_tiles + 1)))


# ------------------------------------------------------------ host layer
@pytest.mark.parametrize("setting", sorted(SETTINGS))
@pytest.mark.parametrize("pack", [1, 16])
def test_bit_transpose_equals_jax(setting, pack):
    jb, pb, _ = _bit_parts(setting)
    jt, pt = jb.transpose(), pb.transpose()
    assert pt.bits and pt.a.dtype == np.uint8
    assert pt.a.shape == (pt.num_tiles, pb.tile_cols // 8, pb.tile_rows)
    assert (pt.tile_rows, pt.tile_cols) == (pb.tile_cols, pb.tile_rows)
    for got, want in ((pt, jt), (pt.pad_runs(pack), jt.pad_runs(pack))):
        assert got.bits and want.bits
        for field in ("a", "tile_col", "tile_row"):
            assert np.array_equal(np.asarray(getattr(got, field)), np.asarray(getattr(want, field))), field
        for k in ("num_tiles", "num_nodes", "n_src", "tile_rows", "tile_cols", "num_dense_edges", "pack"):
            assert getattr(got, k) == getattr(want, k), k
        assert np.array_equal(got.run_start, np.searchsorted(got.tile_row, np.arange(got.num_row_tiles + 1)))
    # the transposed part holds the same cells as the unpacked part's transpose
    assert np.array_equal(unpack_bit_tiles(pt.a), pb.unpack_bits().transpose().a)


def test_bit_transpose_needs_c_multiple_of_8():
    _, gp = _graphs(700, 22000)
    pb, _ = split_bit_tiles(densify(gp, dtype=np.int8, tile_rows=16, tile_cols=12, threshold=2)[0])
    assert pb is not None
    with pytest.raises(ValueError, match="C = 12 is not a multiple of 8"):
        pb.transpose()


@pytest.mark.parametrize("setting,pack", [("r16c64", 1), ("r64c64", 4), ("r256c256", 16)])
def test_schedule_hybrid_bits_with_transpose_equals_jax(setting, pack):
    n, m, tr, tc, thr = SETTINGS[setting]
    gj, gp = _graphs(n, m)
    kw = dict(tile_rows=tr, tile_cols=tc, threshold=thr, residual_block=4, pack=pack, bit_tiles=True)
    ja = JAggregator.schedule_hybrid(gj, tile_dtype=np.int8, with_transpose=True, device_put=False, **kw)
    pa = Aggregator.schedule_hybrid(gp, tile_dtype=np.int8, with_transpose=True, device="cpu", **kw)
    # the transposed parts in the JAX order, the 1-bit part first; the port
    # keeps it 1-bit at every R, the JAX package unpacks it below R = 256
    assert [p.bits for p in pa.tile_parts_t()] == [True, False]
    assert [p.bits for p in ja.tile_parts_t()] == [tc >= 256, False]
    assert pa.tile_bits_t.a.dtype == torch.uint8 and pa.tile_t.a.dtype == torch.int8
    for jp, pp in zip(ja.tile_parts() + ja.tile_parts_t(), pa.tile_parts() + pa.tile_parts_t()):
        _same_counts(jp, _host(pp), bytes_equal=jp.bits)
    pj, pp = ja.plan_t, pa.plan_t
    assert np.array_equal(pp.src.numpy(), np.asarray(pj.src).reshape(-1))
    for field in ("count", "dst"):
        assert np.array_equal(getattr(pp, field).numpy(), np.asarray(getattr(pj, field))), field
    assert pp.num_edges == pj.num_edges and pa.plan.num_edges == ja.plan.num_edges
    assert np.array_equal(pa.edge_map_t.numpy(), np.asarray(ja.edge_map_t))
    moved = pa.to("cpu")
    assert moved.tile_bits_t.a.dtype == torch.uint8 and moved.tile_bits_t.bits
    assert _launches() == (0, 0, 0, 0, 0)


# ------------------------------------------------------- plain versions
def _inputs(n, f, att_scale, shift, seed=1):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((n, f)).astype(np.float32)
    gbar = rng.standard_normal((n, f)).astype(np.float32)
    c = rng.standard_normal(n).astype(np.float32)
    att = (rng.standard_normal((n, 2)) * att_scale).astype(np.float32)
    row_shift = _global_bound_shift(torch.from_numpy(att), 0.2) if shift else None
    return [torch.from_numpy(x) for x in (h, gbar, c, att)] + [row_shift]


@pytest.mark.parametrize("setting", sorted(SETTINGS))
@pytest.mark.parametrize("att_scale,shift", [(0.1, False), (15.0, True)])
def test_bit_plain_versions_match_jax(setting, att_scale, shift):
    """B2, B3, B4 and B5's plain versions over a 1-bit part (and B4 over
    its transpose) against the JAX XLA functions over the same part, and
    against themselves over the part unpacked to int8."""
    jb, pb, gp = _bit_parts(setting)
    tp, tp_t = pb.to("cpu"), pb.transpose().to("cpu")
    jp, jp_t = jb.device_put(), jb.transpose().device_put()
    n = gp.num_nodes
    h, gbar, c, att, row_shift = _inputs(n, 24, att_scale, shift)
    jrow_shift = None if row_shift is None else jnp.asarray(row_shift.numpy())
    what = f"{setting} scale {att_scale}"

    num, den = gat_bcsr_plain(tp, h, att, row_shift=row_shift)
    assert all(torch.equal(x, y) for x, y in zip(gat_bcsr(tp, h, att, row_shift=row_shift), (num, den)))
    un = gat_bcsr_plain(tp.unpack_bits(), h, att, row_shift=row_shift)
    assert torch.equal(num, un[0]) and torch.equal(den, un[1])
    jnum, jden = gat_bcsr_xla(jp, jnp.asarray(h.numpy()), jnp.asarray(att.numpy()), row_shift=jrow_shift)
    assert_matches_jax(num.numpy(), _np(jnum), what=f"B2 num {what}")
    assert_matches_jax(den.numpy(), _np(jden), what=f"B2 den {what}")

    dm, asrc = _score_terms(att, row_shift)
    args = (h, gbar, c, dm, asrc, 0.2)
    ju12, jv12 = j_branch_factors(jnp.asarray(att.numpy()), 0.2, jrow_shift)
    jargs = tuple(jnp.asarray(x.numpy()) for x in args[:3]) + (ju12, jv12, 0.2)
    dad = gat_bwd_dad_plain(tp, *args)
    assert torch.equal(gat_bwd_dad(tp, *args), dad)
    assert torch.equal(gat_bwd_dad_plain(tp.unpack_bits(), *args), dad)
    assert_matches_jax(dad.numpy(), _np(gat_bwd_dad_xla(jp, *jargs)), what=f"B3 {what}")
    dh, das = gat_bwd_dh_das_plain(tp_t, *args)
    got = gat_bwd_dh_das(tp_t, *args)
    assert torch.equal(got[0], dh) and torch.equal(got[1], das)
    un = gat_bwd_dh_das_plain(tp_t.unpack_bits(), *args)
    assert torch.equal(un[0], dh) and torch.equal(un[1], das)
    jdh, jdas = gat_bwd_dh_das_xla(jp_t, *jargs)
    assert_matches_jax(dh.numpy(), _np(jdh), what=f"B4 dh {what}")
    assert_matches_jax(das.numpy(), _np(jdas), what=f"B4 d_as {what}")

    vals = att[:, 1].contiguous()
    mx = bcsr_rowmax_plain(tp, vals)
    assert torch.equal(bcsr_rowmax(tp, vals), mx)
    assert torch.equal(bcsr_rowmax_plain(tp.unpack_bits(), vals), mx)
    assert np.array_equal(mx.numpy(), np.asarray(_bcsr_rowmax_xla(jp, jnp.asarray(vals.numpy()))))
    assert bool(torch.isneginf(mx).any()) and bool(torch.isfinite(mx).any())
    assert _launches() == (0, 0, 0, 0, 0)


# ------------------------------------------------------- gradients
def _bit_aggs(setting="r64c64"):
    n, m, tr, tc, thr = SETTINGS[setting]
    gj, gp = _graphs(n, m)
    kw = dict(tile_rows=tr, tile_cols=tc, threshold=thr, residual_block=4, pack=2, bit_tiles=True)
    jagg = JAggregator.schedule_hybrid(gj, tile_dtype=np.int8, with_transpose=True, **kw)
    agg = Aggregator.schedule_hybrid(gp, tile_dtype=np.int8, with_transpose=True, device="cpu", **kw)
    assert len(agg.tile_parts()) == len(agg.tile_parts_t()) == 2
    return jagg, agg, gp


def _cos_weights(shape):
    return np.cos(np.arange(int(np.prod(shape)), dtype=np.float32)).reshape(shape)


def test_hybrid_spmm_grad_over_bits_matches_jax():
    jagg, agg, gp = _bit_aggs()
    h = normal_features(gp.n_src, 12, seed=1)
    w = _cos_weights((gp.num_nodes, 12))

    def jloss(hh):
        out = j_hybrid_spmm(jagg.tile_parts(), jagg.tile_parts_t(), jagg.plan, jagg.plan_t, hh, "xla")
        return jnp.sum(out * w)

    want = jax.grad(jloss)(jnp.asarray(h))
    ht = torch.from_numpy(h).requires_grad_(True)
    (agg.run(ht) * torch.from_numpy(w)).sum().backward()
    ref = np.zeros((gp.n_src, 12))
    np.add.at(ref, gp.indices, w[gp.dst_per_edge].astype(np.float64))
    assert_matches_jax(ht.grad.numpy(), _np(want), ref, what="hybrid_spmm dh over 1-bit parts")
    assert _launches() == (0, 0, 0, 0, 0)


@pytest.mark.parametrize("stabilize,att_scale", [(False, 1.0), (True, 1.0), (True, 15.0), ("bound", 15.0)])
def test_hybrid_gat_grads_over_bits_match_jax(stabilize, att_scale):
    jagg, agg, gp = _bit_aggs()
    n = gp.num_nodes
    h = normal_features(n, 16, seed=1)
    att = (normal_features(n, 2, seed=2) * att_scale).astype(np.float32)

    def jloss(hh, aa):
        out = j_hybrid_gat(
            jagg.tile_parts(), jagg.plan, hh, aa, stabilize=stabilize, strategy="xla",
            tp_t=jagg.tile_parts_t(), plan_t=jagg.plan_t, edge_map_t=jagg.edge_map_t,
        )
        return jnp.sum(out * _cos_weights(out.shape))

    want_dh, want_datt = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(h), jnp.asarray(att))
    ht = torch.from_numpy(h).requires_grad_(True)
    at = torch.from_numpy(att).requires_grad_(True)
    out = agg.run_gat(ht, at, stabilize=stabilize)
    (out * torch.from_numpy(_cos_weights(tuple(out.shape)))).sum().backward()
    what = f"over 1-bit parts, stabilize={stabilize} scale={att_scale}"
    assert_matches_jax(ht.grad.numpy(), _np(want_dh), what=f"dh {what}")
    assert_matches_jax(at.grad.numpy(), _np(want_datt), what=f"datt {what}")
    assert _launches() == (0, 0, 0, 0, 0)
