"""B4 on the cell walk, emulated on the CPU, and the updateval chain's work
list.  The plans are test_torch_cell_walk's (int8, 1-bit, float32 and
bfloat16 counts, signed float32 / bfloat16 values), transposed as the GAT
backward takes them.

B4 (dh, d_att_src over the transposed plan): the per-tile partials of
[s gbar | lrelu' s gbar | lrelu' s c] (two branches over one gathered gbar
row, kept apart, and the den term), summed as the walk sums them
(ops.cell_walk.chunked_sums over the transposed plan's own list), then dh =
the first branch and d_as = <h, second branch> - den; over count plans of
every format (against gat_bwd_dh_das_plain and the JAX package's
gat_bwd_dh_das_xla) and signed float plans (C6: every cell != 0 scored
times its value; the JAX backward keeps cells > 0, so against the plain
version only), with the softmax shift on and off, and one source at as =
95 with the exact shift (C1).  Tolerance: max|emulation - ref| <= 1e-5 *
max|ref| (float32 summation order only).

B6 has no work list: one block a tile, so nothing of it runs on the CPU
but its plain version (tests/test_torch_sddmm.py).

The updateval chain (B6's cells -> tileplan_with_values -> B1): the
weighted plan walks the count plan's work list, cached under its own tile
tensor, so a second chain builds no list (builds counted by patching
cell_walk.build_walk); B1's order over that list on the weighted plan
equals bcsr_spmm_plain."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_computing_tpu.ops.bcsr_gat import _branch_factors as j_branch_factors
from gnn_computing_tpu.ops.bcsr_gat import gat_bwd_dh_das_xla as j_gat_bwd_dh_das
from gnn_computing_tpu.schedule import tiles as j_tiles

from gnn_computing_tpu_torch.ops import cell_walk, cuda_bcsr, cuda_gat_bwd, cuda_sddmm
from gnn_computing_tpu_torch.ops.bcsr import bcsr_spmm_plain
from gnn_computing_tpu_torch.ops.bcsr_gat import (
    _cell_scores,
    _hybrid_row_shift,
    _pad_to,
    _score_terms,
    gat_bwd_dh_das_plain,
)
from gnn_computing_tpu_torch.ops.bcsr_sddmm import sddmm_bcsr_plain, tileplan_with_values
from gnn_computing_tpu_torch.schedule.tiles import densify, split_bit_tiles

from test_torch_cell_walk import KW, _att, _close, _graphs, _h_tiles, _run_rows, _values

SLOPE = 0.2


@functools.lru_cache(maxsize=None)
def _host(fmt: str, values: str):
    """(JAX host plan or None, port host plan) over the forward graph."""
    gj, gp = _graphs()
    if fmt in ("i8", "b1"):
        tj, tp = j_tiles.densify(gj, dtype=np.int8, **KW)[0], densify(gp, dtype=np.int8, **KW)[0]
        if fmt == "b1":
            tj, tp = j_tiles.split_bit_tiles(tj)[0], split_bit_tiles(tp)[0]
        return tj, tp
    jdt, pdt = {"f32": (np.float32, np.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[fmt]
    if values == "signed":
        return None, densify(gp, val=_values(gp), dtype=pdt, **KW)[0]
    return j_tiles.densify(gj, dtype=jdt, **KW)[0], densify(gp, dtype=pdt, **KW)[0]


def _plans(fmt: str, values: str):
    """(JAX transposed plan or None, port forward plan, port transposed plan),
    the port's on the CPU."""
    tj, tp = _host(fmt, values)
    return (None if tj is None else tj.transpose()), tp.to("cpu"), tp.transpose().to("cpu")


def _dh_das_emulated(tp_t, walk, h, gbar, c, dm, asrc):
    """B4's order: per-tile partials of [s gbar | w gbar | w c] over the
    transposed plan, chunked_sums, then (dh, <h, num1> - den)."""
    tr, tc = tp_t.tile_rows, tp_t.tile_cols
    col = tp_t.tile_col.long()
    asp = _pad_to(asrc, tp_t.num_row_tiles * tr).reshape(-1, tr)[tp_t.tile_row.long()]
    dmp = _pad_to(dm, tp_t.num_col_tiles * tc).reshape(-1, tc, 2)[col]
    cp = _pad_to(c, tp_t.num_col_tiles * tc).reshape(-1, tc)[col]
    s, z = _cell_scores(tp_t.counts().float(), dmp[:, None, :, 0], dmp[:, None, :, 1], asp[:, :, None], SLOPE)
    w = torch.where(z >= 0, 1.0, SLOPE) * s
    gb = _h_tiles(tp_t, gbar)[col]
    parts = torch.cat([torch.bmm(s, gb), torch.bmm(w, gb), (w * cp[:, None, :]).sum(dim=2, keepdim=True)], dim=2)
    out = _run_rows(tp_t, cell_walk.chunked_sums(walk, parts))
    f = h.shape[1]
    return out[:, :f], (h * out[:, f : 2 * f]).sum(dim=1) - out[:, 2 * f]


def _bwd_inputs(n, f, seed=1):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in ((n, f), (n, f), (n,))]


@pytest.mark.parametrize("bound", [16, 64])
@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("fmt,values", [("i8", "counts"), ("b1", "counts"), ("f32", "counts"), ("bf16", "counts"),
                                        ("f32", "signed"), ("bf16", "signed")])
def test_b4_order_matches_plain_and_jax(fmt, values, shift, bound):
    tj_t, tp, tp_t = _plans(fmt, values)
    walk = cell_walk.build_walk(tp_t, bound)
    assert walk.num_multi > 0
    n = tp.num_nodes
    h, gbar, c = _bwd_inputs(n, 20)
    att = torch.from_numpy(_att(n))
    row_shift = _hybrid_row_shift(tp, None, att, SLOPE) if shift else None
    dm, asrc = _score_terms(att, row_shift)
    dh, d_as = _dh_das_emulated(tp_t, walk, h, gbar, c, dm, asrc)
    want_dh, want_das = gat_bwd_dh_das_plain(tp_t, h, gbar, c, dm, asrc, SLOPE)
    _close(dh, want_dh, f"B4 dh {fmt} {values} vs plain")
    _close(d_as, want_das, f"B4 d_as {fmt} {values} vs plain")
    if tj_t is not None:
        jshift = None if row_shift is None else jnp.asarray(row_shift.numpy())
        u12, v12 = j_branch_factors(jnp.asarray(att.numpy()), SLOPE, jshift)
        jargs = tuple(jnp.asarray(x.numpy()) for x in (h, gbar, c)) + (u12, v12, SLOPE)
        j_dh, j_das = j_gat_bwd_dh_das(tj_t.device_put(), *jargs)
        _close(dh, j_dh, f"B4 dh {fmt} vs jax")
        _close(d_as, j_das, f"B4 d_as {fmt} vs jax")
    assert cuda_gat_bwd.dh_das_launches == 0


@pytest.mark.parametrize("fmt,values", [("i8", "counts"), ("b1", "counts"), ("f32", "signed")])
def test_b4_order_wide_logits(fmt, values):
    """One source at as = 95, the exact shift (C1): every score stays <= |v|
    and the emulation is finite and equal to the plain version."""
    _, tp, tp_t = _plans(fmt, values)
    walk = cell_walk.build_walk(tp_t, 16)
    n = tp.num_nodes
    h, gbar, c = _bwd_inputs(n, 16, seed=2)
    att = torch.from_numpy(_att(n))
    hub = int(tp.tile_col[0]) * tp.tile_cols + int(torch.nonzero(tp.counts(0, 1)[0].any(dim=0))[0])
    att[hub, 1] = 95.0
    dm, asrc = _score_terms(att, _hybrid_row_shift(tp, None, att, SLOPE))
    dh, d_as = _dh_das_emulated(tp_t, walk, h, gbar, c, dm, asrc)
    want_dh, want_das = gat_bwd_dh_das_plain(tp_t, h, gbar, c, dm, asrc, SLOPE)
    for x in (dh, d_as, want_dh, want_das):
        assert bool(torch.isfinite(x).all())
    assert bool(d_as[hub] != 0)
    _close(dh, want_dh, f"B4 dh {fmt} {values} as=95")
    _close(d_as, want_das, f"B4 d_as {fmt} {values} as=95")


@pytest.mark.parametrize("part", [0, 1])
def test_updateval_chain_builds_no_list_again(monkeypatch, part):
    """The chain's weighted plan takes its count plan's work list: the first
    chain builds the count plan's list once, the second builds none; the
    weighted plan's list is that one, and B1's order over it equals
    bcsr_spmm_plain on the weighted plan."""
    builds = []
    real = cell_walk.build_walk

    def counted(tp, bound=None):
        builds.append(id(tp.a))
        return real(tp, bound)

    monkeypatch.setattr(cell_walk, "build_walk", counted)
    _, gp = _graphs()
    tp = split_bit_tiles(densify(gp, dtype=np.int8, **KW)[0])[part].to("cpu")
    assert tp.bits == (part == 0)
    rng = np.random.default_rng(6)
    a = torch.from_numpy(rng.standard_normal((tp.n_src, 8)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((tp.num_nodes, 8)).astype(np.float32))
    h = torch.from_numpy(rng.standard_normal((tp.n_src, 12)).astype(np.float32))

    def chain():
        w = tileplan_with_values(tp, sddmm_bcsr_plain(tp, a, b, out_dtype=torch.float32))
        return w, cell_walk.walk_for(w)

    w1, walk1 = chain()
    assert builds == [id(tp.a)]
    w2, walk2 = chain()
    assert builds == [id(tp.a)] and walk2 is walk1 is cell_walk.walk_for(tp)
    assert w2.a is not w1.a and not w2.bits
    # the list serves the weighted plan: every chunk within its bound in the
    # weighted plan's cells, or one tile; the same chunks as its own list
    own = real(w2, walk2.bound)
    # the chunk arrays every kernel walks (B1's staged part of an int8 list,
    # which a float plan's own list lacks, serves B1 over int8 tiles only)
    mine, theirs = own.parts(), walk2.parts()
    walked = ("chunk_run", "chunk_tile", "chunk_slot", "run_chunk", "multi_run")
    assert all(np.array_equal(mine[k], theirs[k]) for k in walked) or own.total_cells < walk2.total_cells
    p = walk2.parts()
    nnz = cell_walk.tile_nnz(w2).numpy()
    prefix = np.concatenate([[0], np.cumsum(nnz)])
    tile = p["chunk_tile"].astype(np.int64)
    assert np.all((prefix[tile[1:]] - prefix[tile[:-1]] <= walk2.bound) | (np.diff(tile) == 1))
    parts = torch.bmm(w2.counts().float(), _h_tiles(w2, h)[w2.tile_col.long()])
    _close(_run_rows(w2, cell_walk.chunked_sums(walk2, parts)), bcsr_spmm_plain(w2, h), "B1 over the weighted plan")
    assert cuda_bcsr.launches == 0 and cuda_sddmm.launches == 0
