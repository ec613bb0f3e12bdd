"""The cell walk's work list (ops/cell_walk.py), the plan of B1's and B2's
CUDA kernels, and the order in which those kernels sum, emulated on the
CPU and held to the plain versions and the JAX package.

The work list, over int8, 1-bit, float32 and bfloat16 plans, their
transposes, pad_runs(16) fillers, filler-only and empty runs, a ragged n and
a skewed plan (one run holding every tile, a tile row of all ones): every
tile lies in exactly one chunk, in order, inside its run; every chunk keeps
its cell bound unless it is a single tile; an empty run has one chunk of no
tiles; the scratch slots and the finish pass's run list agree with the
chunks; B1's staged chunks are those the rule marks (int8 plans only,
live tiles of at least STAGE_K * C cells on average), each with its live
tiles, and the other chunks its gather list.  The cache gives a plan whose tiles changed (astype, pad_runs,
split_bit_tiles, transpose, an edit in place) a new list.

Staging (B1's staged walk): the chunks a plan's stage_k marks, on a plan
with a dense hub run beside sparse int8 tiles and a 1-bit part; stage_k
forcing every chunk of live tiles or none; the chunk cuts, and so
chunked_sums, the same under any stage_k; a launch staging them only where
their blocks fill the card (cell_walk.stages); share_walk refusing an int8
plan.

The summation order: per-tile partials, each chunk's partials added in
tile order, a run's chunk sums in chunk order (ops.cell_walk.chunked_sums),
for B1's sum and for B2's num and den (maxdot; twodot's two branches with
their post-scales applied to the run sums).  Tolerance: max|emulation -
ref| <= 1e-5 * max|ref| against the port's plain version and the JAX
package's CPU path (float32 summation order only)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_computing_tpu.graph.csr import CSRGraph as JCSRGraph
from gnn_computing_tpu.ops.bcsr import bcsr_spmm as j_bcsr_spmm
from gnn_computing_tpu.ops.bcsr_gat import gat_bcsr as j_gat_bcsr
from gnn_computing_tpu.schedule import tiles as j_tiles

from gnn_computing_tpu_torch.graph import CSRGraph, degree_sort, rmat_graph
from gnn_computing_tpu_torch.ops import cell_walk, cuda_bcsr, cuda_gat
from gnn_computing_tpu_torch.ops.bcsr import bcsr_spmm_plain
from gnn_computing_tpu_torch.ops.bcsr_gat import (
    _cell_scores,
    _factored_chunk,
    _pad_to,
    _score_terms,
    factored_terms,
    gat_bcsr_plain,
    gat_bcsr_twodot_plain,
)
from gnn_computing_tpu_torch.schedule.tiles import densify, split_bit_tiles

TOL = 1e-5
KW = dict(tile_rows=64, tile_cols=64, threshold=3)
FORMATS = {"i8": (np.int8, np.int8), "f32": (np.float32, np.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
BOUNDS = [64, 1000, None]


def _edges(n=1237, m=60000, seed=3):
    """A degree-sorted RMAT graph's edges with a band of rows without edges
    and a last row-tile too sparse for any tile (a filler-only run after
    pad_runs, an empty run without row coverage)."""
    g = rmat_graph(n, m, seed=seed, with_val=False)
    g = g.reorder(degree_sort(g))
    d, s = g.dst_per_edge, g.indices
    keep = ((d < 800) | (d >= 1100)) & ((d < n - 64) | (s % 97 == 0))
    return d[keep], s[keep], n


def _graphs():
    d, s, n = _edges()
    return JCSRGraph.from_edges(d, s, n), CSRGraph.from_edges(d, s, n)


def _values(g):
    """Signed float edge values, for the float formats."""
    return np.random.default_rng(7).uniform(-1.0, 3.0, g.num_edges).astype(np.float32)


def _host_plans(fmt: str, coverage: bool = True):
    """(JAX host plan, port host plan) of fmt over the same graph: int8
    counts, the 1-bit part of them, or float32 / bfloat16 signed values."""
    gj, gp = _graphs()
    kw = dict(KW, ensure_row_coverage=coverage)
    if fmt == "b1":
        tj, tp = j_tiles.densify(gj, dtype=np.int8, **kw)[0], densify(gp, dtype=np.int8, **kw)[0]
        return j_tiles.split_bit_tiles(tj)[0], split_bit_tiles(tp)[0]
    jdt, pdt = FORMATS[fmt]
    val = None if fmt == "i8" else _values(gp)
    return (j_tiles.densify(gj, val=val, dtype=jdt, **kw)[0], densify(gp, val=val, dtype=pdt, **kw)[0])


def _skewed(tp):
    """One run holding every tile of a host plan, with one all-ones tile row."""
    a = np.array(tp.a)
    a[0, 0, :] = 1
    nrt = tp.num_row_tiles
    return dataclasses.replace(
        tp, a=a, tile_row=np.zeros(tp.num_tiles, np.int32),
        run_start=np.array([0] + [tp.num_tiles] * nrt, np.int32),
    )


PLANS = {
    "i8": lambda: _host_plans("i8")[1],
    "i8 pad16": lambda: _host_plans("i8")[1].pad_runs(16),
    "i8 transposed": lambda: _host_plans("i8")[1].transpose(),
    "i8 empty runs": lambda: _host_plans("i8", coverage=False)[1],
    "i8 filler-only runs": lambda: _host_plans("i8", coverage=False)[1].pad_runs(16),
    "b1": lambda: _host_plans("b1")[1],
    "b1 transposed pad16": lambda: _host_plans("b1")[1].transpose().pad_runs(16),
    "f32": lambda: _host_plans("f32")[1],
    "f32 transposed": lambda: _host_plans("f32")[1].transpose(),
    "bf16 pad16": lambda: _host_plans("bf16")[1].pad_runs(16),
    "skewed": lambda: _skewed(_host_plans("i8")[1]),
}


def _check_walk(tp, walk, stage_k=None):
    """The work list's invariants (module doc), the list built with stage_k."""
    p = walk.parts()
    k, nrt, t = walk.num_chunks, tp.num_row_tiles, tp.num_tiles
    rs = tp.run_start.numpy().astype(np.int64)
    nnz = cell_walk.tile_nnz(tp).numpy()
    run, tile, slot = p["chunk_run"], p["chunk_tile"].astype(np.int64), p["chunk_slot"]
    assert len(run) == k and len(tile) == k + 1 and tile[0] == 0 and tile[-1] == t
    assert np.all(np.diff(tile) >= 0) and np.all(np.diff(run) >= 0)  # in order
    # each chunk inside its run; the chunks of run r are run_chunk[r]..
    assert np.all(rs[run] <= tile[:-1]) and np.all(tile[1:] <= rs[run + 1])
    per_run = np.bincount(run, minlength=nrt)
    assert np.array_equal(p["run_chunk"], np.concatenate([[0], np.cumsum(per_run)]))
    assert np.all(per_run >= 1)
    sizes = np.diff(tile)
    empty = rs[1:] == rs[:-1]
    # an empty run: one chunk of no tiles; every other chunk holds tiles
    assert np.array_equal(sizes == 0, empty[run])
    assert np.all(per_run[empty] == 1)
    # every tile in exactly one chunk: the ranges tile the axis
    assert sizes.sum() == t
    # the bound: at most `bound` cells, or a single tile
    prefix = np.concatenate([[0], np.cumsum(nnz)])
    cells = prefix[tile[1:]] - prefix[tile[:-1]]
    assert np.all((cells <= walk.bound) | (sizes == 1))
    assert walk.max_chunk_cells == cells.max() and walk.total_cells == nnz.sum()
    # scratch slots: one per chunk of a run of several, consecutive in a run
    multi = per_run > 1
    assert np.array_equal(p["multi_run"], np.flatnonzero(multi))
    assert np.array_equal(slot < 0, ~multi[run])
    used = slot[slot >= 0]
    assert np.array_equal(np.sort(used), np.arange(walk.num_slots)) and np.all(np.diff(used) == 1)
    _check_stage(tp, walk, cells, nnz, stage_k)
    return cells


def _check_stage(tp, walk, cells, nnz, stage_k=None):
    """B1's staged chunks: those whose live tiles average at least stage_k *
    C cells, on a plan B1 may stage; each with its live tiles in order; the
    other chunks in the gather list."""
    p = walk.parts()
    k = cell_walk.STAGE_K if stage_k is None else stage_k
    tile = p["chunk_tile"].astype(np.int64)
    live = np.array([(nnz[a:b] > 0).sum() for a, b in zip(tile[:-1], tile[1:])], np.int64)
    want = (live > 0) & (cells >= k * tp.tile_cols * np.maximum(live, 1)) & cell_walk.stageable(tp)
    assert np.array_equal(p["stage_chunk"], np.flatnonzero(want))
    assert np.array_equal(p["gather_chunk"], np.flatnonzero(~want))
    assert np.array_equal(p["stage_start"], np.concatenate([[0], np.cumsum(live[want])]))
    lives = [np.arange(a, b)[nnz[a:b] > 0] for a, b in zip(tile[:-1][want], tile[1:][want])]
    assert np.array_equal(p["stage_tile"], np.concatenate([np.zeros(0, np.int64)] + lives))
    assert walk.staged_cells == cells[want].sum()
    # the staged tiles' cell lists: each row's cells in column order, column |
    # the value's float32 bits above the lower 16
    row, listed = p["stage_row"].astype(np.int64), p["stage_cells"]
    assert len(row) == len(p["stage_tile"]) * tp.tile_rows + 1 and row[0] == 0 and row[-1] == len(listed)
    if len(p["stage_tile"]):
        sel = tp.a.numpy()[p["stage_tile"]]
        col = tp.tile_col.numpy()[p["stage_tile"]].astype(np.int64)[:, None, None] * tp.tile_cols
        nz = (sel != 0) & (col + np.arange(tp.tile_cols) < tp.n_src)
        assert np.array_equal(np.diff(row), nz.sum(axis=2).ravel())
        t_, r_, c_ = np.nonzero(nz)
        bits = sel[t_, r_, c_].astype(np.float32).view(np.int32)
        assert np.all(bits & 0xFFFF == 0)  # an int8 count's float: nothing below the upper 16 bits
        assert np.array_equal(listed, c_.astype(np.int32) | bits)
    assert cell_walk.stageable(tp) == (tp.format == "int8" and tp.tile_cols <= 256)


@pytest.mark.parametrize("bound", BOUNDS)
@pytest.mark.parametrize("kind", sorted(PLANS))
def test_work_list(kind, bound):
    tp = PLANS[kind]().to("cpu")
    walk = cell_walk.build_walk(tp, bound)
    cells = _check_walk(tp, walk)
    if bound == 64:
        assert walk.num_multi > 0  # chunk edges inside runs
    if kind == "skewed":  # the one run is cut into chunks, the rest are empty
        assert walk.num_multi == (walk.num_chunks > tp.num_row_tiles)
        assert bound is None or walk.num_multi == 1
    if "empty" in kind:
        assert walk.num_chunks > len(np.unique(tp.tile_row.numpy()))
    assert cuda_bcsr.launches == 0 and cuda_gat.launches == 0


def test_work_list_follows_the_plan():
    """walk_for caches a list under the plan's tiles; a plan whose tiles
    changed gets a new list, equal to the one built for it."""
    host = _host_plans("i8")[1]
    tp = host.to("cpu")
    walk = cell_walk.walk_for(tp)
    assert cell_walk.walk_for(tp) is walk
    assert cell_walk.walk_for(dataclasses.replace(tp, tile_col=tp.tile_col.clone())) is walk  # same tiles
    changed = {
        "astype": tp.astype(torch.float32),
        "pad_runs": host.pad_runs(16).to("cpu"),
        "split_bit_tiles": split_bit_tiles(host)[0].to("cpu"),
        "transpose": host.transpose().to("cpu"),
        "to": host.to("cpu"),
    }
    for what, other in changed.items():
        got = cell_walk.walk_for(other)
        assert got is not walk, what
        want = cell_walk.build_walk(other)
        assert torch.equal(got.work, want.work), what
        _check_walk(other, got)
    # an edit in place: every cell of one tile cleared
    tp.a[tp.run_start[1] - 1] = 0
    edited = cell_walk.walk_for(tp)
    assert edited is not walk and edited.total_cells < walk.total_cells
    assert torch.equal(edited.work, cell_walk.build_walk(tp).work)


def _h_tiles(tp, h):
    """h padded and cut into the plan's column tiles [nct, C, f]."""
    return _pad_to(h, tp.num_col_tiles * tp.tile_cols).reshape(tp.num_col_tiles, tp.tile_cols, -1)


def _run_rows(tp, sums):
    """[nrt, R, x] run sums as [num_nodes, x] rows."""
    return sums.reshape(tp.num_row_tiles * tp.tile_rows, -1)[: tp.num_nodes]


def _close(got, want, what):
    err = (got.double() - torch.as_tensor(np.asarray(want, np.float64))).abs().max().item()
    scale = np.abs(np.asarray(want, np.float64)).max()
    assert err <= TOL * scale, f"{what}: max|d| = {err:.3e}, max|ref| = {scale:.3e}"


# (fmt, bound, stage_k): the plan's own staging (STAGE_K), then every chunk
# with a live tile staged (k = 0) or none (k = inf)
B1_ORDER = [pytest.param(fmt, bound, None, id=f"{fmt}-{bound}") for fmt in ("i8", "b1", "f32", "bf16")
            for bound in (64, 256)]
B1_ORDER += [pytest.param(fmt, 64, k, id=f"{fmt}-64-k{k}") for fmt in ("i8", "f32") for k in (0, float("inf"))]


@pytest.mark.parametrize("fmt,bound,stage_k", B1_ORDER)
def test_b1_order_matches_plain_and_jax(fmt, bound, stage_k):
    """B1's summation order over the list's chunks, whichever chunks are
    staged: staging cuts nothing, so the order is the same."""
    tj, tp = _host_plans(fmt)
    tj, tp = tj.pad_runs(4), tp.pad_runs(4).to("cpu")
    walk = cell_walk.build_walk(tp, bound, stage_k=stage_k)
    assert walk.num_multi > 0
    assert (walk.num_staged > 0) == (fmt == "i8" and stage_k != float("inf"))
    h = np.random.default_rng(4).standard_normal((tp.n_src, 24)).astype(np.float32)
    ht = torch.from_numpy(h)
    parts = torch.bmm(tp.counts().float(), _h_tiles(tp, ht)[tp.tile_col.long()])
    got = _run_rows(tp, cell_walk.chunked_sums(walk, parts))
    _close(got, bcsr_spmm_plain(tp, ht), f"B1 {fmt} vs plain")
    want = j_bcsr_spmm(tj.device_put(), jnp.asarray(h), strategy="auto", h_mode="native")
    _close(got, want, f"B1 {fmt} vs jax")


def _att(n, seed=2):
    return (np.random.default_rng(seed).standard_normal((n, 2)) * 0.5).astype(np.float32)


@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("fmt", ["i8", "b1", "f32", "bf16"])
def test_b2_order_matches_plain_and_jax(fmt, shift):
    """maxdot's num and den: per-tile partials of the scores' products and
    sums, chunked as the kernel sums them."""
    tj, tp = _host_plans(fmt)
    tp = tp.to("cpu")
    walk = cell_walk.build_walk(tp, 64)
    assert walk.num_multi > 0
    n, f = tp.num_nodes, 16
    h = np.random.default_rng(4).standard_normal((tp.n_src, f)).astype(np.float32)
    att = _att(n)
    row_shift = np.random.default_rng(5).uniform(-1.0, 2.0, n).astype(np.float32) if shift else None
    ht, at = torch.from_numpy(h), torch.from_numpy(att)
    rt = None if row_shift is None else torch.from_numpy(row_shift)
    dm, asrc = _score_terms(at, rt)
    tr, tc = tp.tile_rows, tp.tile_cols
    dmp = _pad_to(dm, tp.num_row_tiles * tr).reshape(-1, tr, 2)[tp.tile_row.long()]
    asp = _pad_to(asrc, tp.num_col_tiles * tc).reshape(-1, tc)[tp.tile_col.long()]
    s, _ = _cell_scores(tp.counts().float(), dmp[:, :, 0, None], dmp[:, :, 1, None], asp[:, None, :], 0.2)
    parts = torch.cat([torch.bmm(s, _h_tiles(tp, ht)[tp.tile_col.long()]), s.sum(dim=2, keepdim=True)], dim=2)
    out = _run_rows(tp, cell_walk.chunked_sums(walk, parts))
    num, den = out[:, :f], out[:, f]
    ref_num, ref_den = gat_bcsr_plain(tp, ht, at, row_shift=rt)
    _close(num, ref_num, f"B2 num {fmt} vs plain")
    _close(den, ref_den, f"B2 den {fmt} vs plain")
    j_num, j_den = j_gat_bcsr(tj, jnp.asarray(h), jnp.asarray(att), strategy="xla",
                              row_shift=None if row_shift is None else jnp.asarray(row_shift))
    _close(num, j_num, f"B2 num {fmt} vs jax")
    _close(den, j_den, f"B2 den {fmt} vs jax")


@pytest.mark.parametrize("fmt", ["i8", "f32"])
def test_twodot_order_matches_plain(fmt):
    """twodot's two branches: each branch's products and den terms chunked
    as the kernel sums them, the row post-scales u_b applied to the run
    sums, against the plain version over the same per-node operands."""
    tp = _host_plans(fmt)[1].to("cpu")
    walk = cell_walk.build_walk(tp, 64)
    assert walk.num_multi > 0
    n, f = tp.num_nodes, 16
    h = torch.from_numpy(np.random.default_rng(4).standard_normal((tp.n_src, f)).astype(np.float32))
    att = torch.from_numpy(_att(n))
    terms = factored_terms(h, att, 0.2, "twodot", 2, None)
    tr, tc = tp.tile_rows, tp.tile_cols
    rows = _pad_to(terms.rows, tp.num_row_tiles * tr).reshape(-1, tr, 4)
    cols = _pad_to(terms.cols, tp.num_col_tiles * tc).reshape(-1, tc, 4)
    hv = [_h_tiles(tp, x) for x in terms.hv]
    _, branches = _factored_chunk(tp, rows, cols, hv, "twodot", 0, tp.num_tiles)
    num = den = 0.0
    for b, (p_b, d_b) in enumerate(branches):
        sums = _run_rows(tp, cell_walk.chunked_sums(walk, torch.cat([p_b, d_b[:, :, None]], dim=2)))
        u = terms.rows[:n, 1 + b]
        num = num + u[:, None] * sums[:, :f]
        den = den + u * sums[:, f]
    ref_num, ref_den = gat_bcsr_twodot_plain(tp, h, att)
    _close(num, ref_num, f"twodot num {fmt}")
    _close(den, ref_den, f"twodot den {fmt}")


def _dense_hub_plans():
    """(int8 plan, 1-bit part, int8 part) over a graph with a dense block:
    the first 64 rows to about half of all columns, beside the test
    graph's edges, so each tile of the hub run holds ~2,000 cells."""
    d, s, n = _edges()
    dd, ss = np.nonzero(np.random.default_rng(2).random((64, n)) < 0.5)
    g = CSRGraph.from_edges(np.concatenate([d, dd]), np.concatenate([s, ss]), n)
    tp = densify(g, dtype=np.int8, **KW)[0]
    bits, rest = split_bit_tiles(tp)
    return tp, bits, rest


@pytest.mark.parametrize("stage_k", [0, 0.5, 1, 4, 64, float("inf")])
@pytest.mark.parametrize("part", ["int8", "1-bit part", "int8 part", "int8 pad16", "int8 transposed"])
def test_staged_chunks(part, stage_k):
    """The chunks stage_k marks: none of a 1-bit part; with k = 0 every
    chunk with a live tile, with k = inf none; at STAGE_K every chunk of the
    dense hub run; under any k the same chunk cuts."""
    tp, bits, rest = _dense_hub_plans()
    tp = {"int8": tp, "1-bit part": bits, "int8 part": rest, "int8 pad16": tp.pad_runs(16),
          "int8 transposed": tp.transpose()}[part].to("cpu")
    walk = cell_walk.build_walk(tp, 4096, stage_k=stage_k)
    base = cell_walk.build_walk(tp, 4096, stage_k=float("inf"))
    nnz = cell_walk.tile_nnz(tp).numpy()
    cells = _check_walk(tp, base, float("inf"))
    _check_stage(tp, walk, cells, nnz, stage_k)
    p, q = walk.parts(), base.parts()
    for name in ("chunk_run", "chunk_tile", "chunk_slot", "run_chunk", "multi_run"):
        assert np.array_equal(p[name], q[name]), name
    assert base.num_staged == 0 and base.staged_cells == 0
    if part == "1-bit part":
        assert walk.num_staged == 0
        return
    live = np.array([(nnz[a:b] > 0).any() for a, b in zip(p["chunk_tile"][:-1], p["chunk_tile"][1:])])
    if stage_k == 0:
        assert np.array_equal(p["stage_chunk"], np.flatnonzero(live))
    if stage_k == cell_walk.STAGE_K and part != "int8 transposed":
        hub = p["run_chunk"][0], p["run_chunk"][1]
        assert hub[1] - hub[0] > 1 and set(range(*hub)) <= set(p["stage_chunk"].tolist())
        assert 0 < walk.staged_cells <= walk.total_cells


# (staged chunks, tile rows, f, SMs, staged?): blocks = chunks * ceil(R /
# STAGE_ROWS) * ceil(f / 128) against STAGE_WAVES * SMs
STAGES = [
    (0, 256, 128, 1, False),
    (cell_walk.STAGE_WAVES * 132, 256, 128, 132, True),
    (cell_walk.STAGE_WAVES * 132 - 1, 256, 32, 132, False),
    (cell_walk.STAGE_WAVES * 66, 512, 64, 132, True),
    (cell_walk.STAGE_WAVES * 66 - 1, 512, 64, 132, False),
    (cell_walk.STAGE_WAVES * 66, 256, 256, 132, True),
    (cell_walk.STAGE_WAVES * 33, 1024, 121, 132, True),
]


@pytest.mark.parametrize("chunks,rows,f,sms,staged", STAGES)
def test_stages_where_the_blocks_fill_the_card(chunks, rows, f, sms, staged):
    """A launch stages a list's staged chunks only where their blocks fill
    the card STAGE_WAVES times."""
    walk = cell_walk.build_walk(_dense_hub_plans()[2].to("cpu"), 4096)
    walk = dataclasses.replace(walk, num_staged=chunks, tile_rows=rows)
    assert cell_walk.stages(walk, f, sms) is staged


def test_share_walk_refuses_a_stageable_plan():
    """share_walk refuses to hand a list to an int8 plan, whose staged
    cells B1 would read from the list's values."""
    tp = _dense_hub_plans()[2].to("cpu")
    with pytest.raises(ValueError, match="staged cells"):
        cell_walk.share_walk(tp, dataclasses.replace(tp, a=tp.a.clone()))
