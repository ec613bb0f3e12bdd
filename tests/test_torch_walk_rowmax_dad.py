"""The cell walk's work list (ops/cell_walk.py), which B3 and B5 walk as B1
and B2 do, and the orders in which B3 and B5 sum over it, emulated on the
CPU and held to the plain versions and the JAX package.  The plans are test_torch_cell_walk's (int8, 1-bit, float32 and
bfloat16, transposes, pad_runs(16) fillers, filler-only and empty runs, a
skewed plan with one run holding every tile).

The work list: every chunk keeps its cell bound unless it is one tile;
every tile lies in exactly one chunk, in order, inside its run; the list
equals a plain-Python cut by the module doc's rules, tile by tile.  The
cache builds a plan's list once for every kernel that walks it, builds it
once more after an edit in place, and drops it with the tile tensor.

B3 (d_att_dst): the per-tile partials of [lrelu' s h | lrelu' s], summed as
the walk sums them (ops.cell_walk.chunked_sums), then <gbar, num> - c * den,
over count plans of every format (against gat_bwd_dad_plain and the JAX
package's gat_bwd_dad_xla) and signed float plans (C6: every cell != 0
scored times its value; the JAX backward keeps cells > 0, so against the
plain version only), with the softmax shift on and off, one source at as =
95 with the exact shift (C1; the JAX form's factors overflow there), and
rows whose logits are all >= 0 (their true d_ad is 0 when gbar and c come
from the forward).  Tolerance: max|emulation - ref| <= 1e-5 * max|ref|
(float32 summation order only).

B5 (row max): the per-tile maxima, each chunk's maximum over its tiles,
then a run's over its chunks, torch.equal to bcsr_rowmax_plain and (count
plans) to the JAX package's _bcsr_rowmax_xla, -inf rows included: a max
does not round."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_computing_tpu.ops.bcsr import _bcsr_rowmax_xla as j_rowmax
from gnn_computing_tpu.ops.bcsr_gat import _branch_factors as j_branch_factors
from gnn_computing_tpu.ops.bcsr_gat import gat_bwd_dad_xla as j_gat_bwd_dad
from gnn_computing_tpu.schedule import tiles as j_tiles

from gnn_computing_tpu_torch.ops import cell_walk, cuda_gat_bwd, cuda_rowmax
from gnn_computing_tpu_torch.ops.bcsr import bcsr_rowmax_plain
from gnn_computing_tpu_torch.ops.bcsr_gat import (
    _cell_scores,
    _hybrid_row_shift,
    _pad_to,
    _score_terms,
    gat_bcsr_plain,
    gat_bwd_dad_plain,
)
from gnn_computing_tpu_torch.schedule.tiles import densify, split_bit_tiles

from test_torch_cell_walk import KW, PLANS, _att, _check_walk, _close, _graphs, _h_tiles, _run_rows, _values

SLOPE = 0.2


@functools.lru_cache(maxsize=None)
def _plan(kind: str):
    return PLANS[kind]().to("cpu")


def _reference_chunks(nnz: np.ndarray, run_start: np.ndarray, bound: int) -> np.ndarray:
    """chunk_tile of the module doc's cut, tile by tile: a tile starts a
    chunk where it starts its run, where the run's cells before it enter
    another window of bound/2 cells, or where it or the tile before it
    holds more than bound/2 cells; an empty run adds one chunk of no
    tiles."""
    half = bound // 2
    starts = []
    for r in range(len(run_start) - 1):
        lo, hi = run_start[r], run_start[r + 1]
        if lo == hi:
            starts.append(lo)
            continue
        before = 0
        for t in range(lo, hi):
            new = (t == lo or before // half != (before - nnz[t - 1]) // half or nnz[t] > half
                   or nnz[t - 1] > half)
            if new:
                starts.append(t)
            before += nnz[t]
    return np.array(starts + [run_start[-1]], np.int64)


@pytest.mark.parametrize("bound", [2, 8, 16, 64, 300, 1000, 4096, None])
@pytest.mark.parametrize("kind", sorted(PLANS))
def test_work_list_reference_cut(kind, bound):
    """The list equals the module doc's cut, tile by tile, from one tile a
    chunk (bound 2: every tile with a cell starts one) to the default
    bound (None: one chunk a run at this size)."""
    tp = _plan(kind)
    walk = cell_walk.build_walk(tp, bound)
    _check_walk(tp, walk)
    p = walk.parts()
    want = _reference_chunks(cell_walk.tile_nnz(tp).numpy(), tp.run_start.numpy().astype(np.int64), walk.bound)
    assert np.array_equal(p["chunk_tile"], want)
    if kind == "skewed" and bound is not None and bound <= 64:  # the one run is cut
        assert walk.num_multi == 1 and walk.num_chunks > tp.num_row_tiles
    assert cuda_rowmax.launches == 0 and cuda_gat_bwd.dad_launches == 0


def test_walk_cache_builds_once(monkeypatch):
    """walk_for builds a plan's list once, however often the kernels that
    share it ask (B1, B2, B3 and B5 each call walk_for at launch); an edit
    in place builds it once more; the tile tensor's end drops it."""
    builds = []
    real = cell_walk.build_walk

    def counted(tp, bound=None):
        builds.append(id(tp.a))
        return real(tp, bound)

    monkeypatch.setattr(cell_walk, "build_walk", counted)
    tp = PLANS["i8 pad16"]().to("cpu")
    walk = cell_walk.walk_for(tp)
    for _ in range(4):
        assert cell_walk.walk_for(tp) is walk
    assert builds == [id(tp.a)]
    assert torch.equal(walk.work, real(tp).work)
    # an edit in place: the list is built again, once
    tp.a[tp.run_start[1] - 1] = 0
    edited = cell_walk.walk_for(tp)
    assert edited is not walk and cell_walk.walk_for(tp) is edited
    assert len(builds) == 2
    # the tile tensor's end drops the list cached under it
    ident = id(tp.a)
    assert ident in cell_walk._cache
    del tp
    assert ident not in cell_walk._cache


# ------------------------------------------------------------------ B3
def _plans(fmt: str, values: str):
    """(JAX host plan or None, port plan on the CPU): int8 counts or their
    1-bit part, the counts as float32 / bfloat16 tiles, or signed float32 /
    bfloat16 values (no JAX plan: its backward keeps only cells > 0)."""
    gj, gp = _graphs()
    if fmt in ("i8", "b1"):
        tj, tp = j_tiles.densify(gj, dtype=np.int8, **KW)[0], densify(gp, dtype=np.int8, **KW)[0]
        if fmt == "b1":
            tj, tp = j_tiles.split_bit_tiles(tj)[0], split_bit_tiles(tp)[0]
        return tj, tp.to("cpu")
    jdt, pdt = {"f32": (np.float32, np.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[fmt]
    if values == "signed":
        return None, densify(gp, val=_values(gp), dtype=pdt, **KW)[0].to("cpu")
    return j_tiles.densify(gj, dtype=jdt, **KW)[0], densify(gp, dtype=pdt, **KW)[0].to("cpu")


def _tile_terms(tp, dm, asrc):
    """Each tile's cell weights lrelu' * s [T, R, C] (0 off the cells)."""
    tr, tc = tp.tile_rows, tp.tile_cols
    dmp = _pad_to(dm, tp.num_row_tiles * tr).reshape(-1, tr, 2)[tp.tile_row.long()]
    asp = _pad_to(asrc, tp.num_col_tiles * tc).reshape(-1, tc)[tp.tile_col.long()]
    s, z = _cell_scores(tp.counts().float(), dmp[:, :, 0, None], dmp[:, :, 1, None], asp[:, None, :], SLOPE)
    return torch.where(z >= 0, 1.0, SLOPE) * s


def _dad_emulated(tp, walk, h, gbar, c, dm, asrc):
    """B3's order: per-tile partials of [w h | w], chunked_sums, then the
    row dot."""
    w = _tile_terms(tp, dm, asrc)
    f = h.shape[1]
    parts = torch.cat([torch.bmm(w, _h_tiles(tp, h)[tp.tile_col.long()]), w.sum(dim=2, keepdim=True)], dim=2)
    out = _run_rows(tp, cell_walk.chunked_sums(walk, parts))
    return (gbar * out[:, :f]).sum(dim=1) - c * out[:, f]


def _bwd_inputs(n, f, seed=1):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in ((n, f), (n, f), (n,))]


@pytest.mark.parametrize("bound", [16, 64])
@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("fmt,values", [("i8", "counts"), ("b1", "counts"), ("f32", "counts"), ("bf16", "counts"),
                                        ("f32", "signed"), ("bf16", "signed")])
def test_b3_order_matches_plain_and_jax(fmt, values, shift, bound):
    tj, tp = _plans(fmt, values)
    walk = cell_walk.build_walk(tp, bound)
    assert walk.num_multi > 0
    n = tp.num_nodes
    h, gbar, c = _bwd_inputs(n, 20)
    att = torch.from_numpy(_att(n))
    row_shift = _hybrid_row_shift(tp, None, att, SLOPE) if shift else None
    dm, asrc = _score_terms(att, row_shift)
    got = _dad_emulated(tp, walk, h, gbar, c, dm, asrc)
    want = gat_bwd_dad_plain(tp, h, gbar, c, dm, asrc, SLOPE)
    _close(got, want, f"B3 {fmt} {values} vs plain")
    if tj is not None:
        jshift = None if row_shift is None else jnp.asarray(row_shift.numpy())
        u12, v12 = j_branch_factors(jnp.asarray(att.numpy()), SLOPE, jshift)
        jargs = tuple(jnp.asarray(x.numpy()) for x in (h, gbar, c)) + (u12, v12, SLOPE)
        _close(got, j_gat_bwd_dad(tj.device_put(), *jargs), f"B3 {fmt} vs jax")


@pytest.mark.parametrize("fmt,values", [("i8", "counts"), ("f32", "signed")])
def test_b3_order_wide_logits(fmt, values):
    """One source at as = 95, the exact shift (C1): every score stays <= |v|
    and the emulation is finite and equal to the plain version."""
    _, tp = _plans(fmt, values)
    walk = cell_walk.build_walk(tp, 16)
    n = tp.num_nodes
    h, gbar, c = _bwd_inputs(n, 16, seed=2)
    att = torch.from_numpy(_att(n))
    hub = int(tp.tile_col[0]) * tp.tile_cols + int(torch.nonzero(tp.counts(0, 1)[0].any(dim=0))[0])
    att[hub, 1] = 95.0
    dm, asrc = _score_terms(att, _hybrid_row_shift(tp, None, att, SLOPE))
    got = _dad_emulated(tp, walk, h, gbar, c, dm, asrc)
    want = gat_bwd_dad_plain(tp, h, gbar, c, dm, asrc, SLOPE)
    assert bool(torch.isfinite(got).all()) and bool(torch.isfinite(want).all())
    _close(got, want, f"B3 {fmt} {values} as=95")


@pytest.mark.parametrize("fmt", ["i8", "b1"])
def test_b3_order_rows_of_nonnegative_logits(fmt):
    """gbar and c from the forward (gbar = ct / den, c = <ct, out> / den, out
    = num / den): a row whose logits are all >= 0 has d_ad = <gbar, num> - c
    den = 0 in exact arithmetic, left to cancellation in either form; the
    emulation stays within 1e-5 * max|plain| over every row."""
    _, tp = _plans(fmt, "counts")
    walk = cell_walk.build_walk(tp, 16)
    n = tp.num_nodes
    h, ct, _ = _bwd_inputs(n, 16, seed=3)
    att = torch.from_numpy(_att(n))
    att[: n // 2, 0] = 4.0 - att[: n // 2, 1].min()  # rows below n/2: every logit >= 0
    num, den = gat_bcsr_plain(tp, h, att)
    safe = torch.where(den == 0, 1.0, den)
    out = num / safe[:, None]
    gbar, c = ct / safe[:, None], (ct * out).sum(dim=1) / safe
    dm, asrc = _score_terms(att)
    got = _dad_emulated(tp, walk, h, gbar, c, dm, asrc)
    want = gat_bwd_dad_plain(tp, h, gbar, c, dm, asrc, SLOPE)
    _close(got, want, f"B3 {fmt} nonnegative logits")
    scale = want.abs().max()
    assert scale > 0 and bool((want[: n // 2].abs() <= 1e-5 * scale).all())
    assert bool((got[: n // 2].abs() <= 1e-5 * scale).all())


# ------------------------------------------------------------------ B5
@pytest.mark.parametrize("bound", [2, 16, 64])
@pytest.mark.parametrize("fmt,values", [("i8", "counts"), ("b1", "counts"), ("f32", "counts"), ("bf16", "counts"),
                                        ("f32", "signed"), ("bf16", "signed")])
def test_b5_order_equals_plain_and_jax(fmt, values, bound):
    """Each chunk's max over its tiles' maxima, then a run's over its
    chunks (rows without a cell: -inf)."""
    tj, tp = _plans(fmt, values)
    walk = cell_walk.build_walk(tp, bound)
    assert walk.num_multi > 0
    vals = torch.from_numpy(np.random.default_rng(4).standard_normal(tp.n_src).astype(np.float32) * 3)
    tc = tp.tile_cols
    v = torch.full((tp.num_col_tiles * tc,), float("-inf"))
    v[: tp.n_src] = vals
    tile_max = torch.where(tp.counts() != 0, v.reshape(-1, 1, tc)[tp.tile_col.long()], float("-inf")).amax(dim=2)
    p = walk.parts()
    out = torch.full((tp.num_row_tiles, tp.tile_rows), float("-inf"))
    for r in range(tp.num_row_tiles):
        for k in range(p["run_chunk"][r], p["run_chunk"][r + 1]):
            lo, hi = p["chunk_tile"][k], p["chunk_tile"][k + 1]
            chunk = tile_max[lo:hi].amax(dim=0) if hi > lo else torch.full((tp.tile_rows,), float("-inf"))
            out[r] = torch.maximum(out[r], chunk)
    got = out.reshape(-1)[: tp.num_nodes]
    want = bcsr_rowmax_plain(tp, vals)
    assert torch.equal(got, want)
    assert bool(torch.isneginf(want).any()) and bool(torch.isfinite(want).any())
    if tj is not None:
        assert np.array_equal(got.numpy(), np.asarray(j_rowmax(tj.device_put(), jnp.asarray(vals.numpy()))))
