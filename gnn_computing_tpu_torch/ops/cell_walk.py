"""The work list of the cell walk (``csrc/cell_walk.cuh``): B1's, B2's, B3's
and B4's (over a transposed plan), and B5's max walk
(``csrc/rowmax_bcsr.cu``), one list per plan.

The walk touches only a tile row's nonzero cells, and its unit of work is a
chunk: a run of tiles (the tiles of one destination row-tile) cut into
consecutive tile ranges bounded in nonzero cells, so that a hub run, which
can hold a large share of all cells, is spread over many blocks.

The cut, with H = bound // 2: a tile starts a new chunk where it starts its
run, where the run's cells before it enter another window of H cells, where
it holds more than H cells or where the tile before it did.  So a chunk is
either one tile (possibly over the bound) or tiles whose cells sum to at
most 2H - 1 < bound; every tile lies in exactly one chunk, in order, inside
one run; an empty run gets one chunk of no tiles, which writes zeros (B5:
-inf).  It
is built on the plan's device from ``run_start`` and the tiles' nonzero
counts with a few tensor passes, once per plan: ``walk_for`` caches it
under the plan's tile tensor (``TilePlan.to``, ``astype``, ``pad_runs``,
``transpose`` and ``split_bit_tiles`` all make a new one), checked against
the ``run_start`` tensor and both tensors' version counters, so a list can
not outlive the tiles it was cut from.  ``share_walk`` hands a plan's list
to a plan with the same tiles in the same runs whose nonzero cells are a
subset of its own (``ops.bcsr_sddmm.tileplan_with_values``: the count plan
weighted by per-cell values), which the list serves as it is: its chunks
depend on the tiles and runs, and its cell bound only grows tighter (B1
stages no float plan, so the staged part goes unread).

B1 (``csrc/bcsr_spmm.cu``) walks some chunks another way: a chunk of an
int8 plan (``C <= STAGE_MAX_C``; never a 1-bit or float plan) whose live
tiles (those with a nonzero cell; ``pad_runs``'s all-zero fillers are not)
hold at least ``stage_k * C`` nonzero cells each on average is *staged*:
its blocks load each live tile's C rows of H into shared memory once, for
all the tile's rows, where the other chunks gather one H row a nonzero
cell, and read the tile's nonzero cells from a list made here once
(``stage_cells``) where the others decode every tile row at each launch
(``csrc/cell_walk.cuh``: stage_kernel).  Staging marks chunks and cuts
none: the chunks, their tiles and their slots are the same whatever
``stage_k``, and so are B1's sums, bitwise.  The list holds the staged
chunks, the live tiles of each, the other chunks and the staged tiles'
cells, for B1's two kinds of block; B2-B5 and P2 walk every chunk as
before.  A launch stages the list's chunks only where their blocks fill
the card (``stages``); else it walks every chunk by gathers.

The chunks of a run of more than one chunk write their partial sums to a
scratch slot each (``walk_args`` allocates ``num_slots`` slots of
``slot_floats`` floats for a launch), and the walk's finish pass adds them
in chunk order.  ``chunked_sums`` is the plain emulation of that order (per-tile
partial, chunk partials in tile order, run sums in chunk order), for the
tests.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, Optional, Tuple

import numpy as np
import torch

# the least chunk bound in nonzero cells (on the H100 at the quick scale,
# 2^15 and 2^17 were slower), and the number of chunks a plan's bound aims
# at beyond it: a plan of more than 2^28 cells takes a larger bound, so its
# scratch stays a few thousand slots
MIN_BOUND = 1 << 16
TARGET_CHUNKS = 4096
# tiles whose nonzero cells are counted at once (a bool [chunk, R, C] mask)
_NNZ_CHUNK = 1024
# staged tiles whose cells are listed at once
_LIST_CHUNK = 256
# a chunk is staged where its live tiles hold at least STAGE_K * C nonzero
# cells each on average: STAGE_K cells for every H row its blocks load (on
# the H100 at the reddit plans, 0.25 to 1 alike, 4 slower: PERF.md, B1)
STAGE_K = 0.5
# the widest tile the staged walk takes (its H column block and a unit more
# fit the block's shared-memory ring)
STAGE_MAX_C = 256
# rows of a staged block (csrc/cell_walk.cuh: kStageRows)
STAGE_ROWS = 256
# a launch stages the list's chunks where their blocks (one an SM: the
# block's ring is 192 KB) fill the card at least STAGE_WAVES times; in
# fewer waves the last one leaves SMs idle that the gather walk's small
# blocks keep busy (on the H100 the staged walk lost at up to 4.8 waves and
# won at every width from 6.1 on: PERF.md, B1)
STAGE_WAVES = 6


@dataclasses.dataclass(frozen=True)
class CellWalk:
    """One plan's work list.

    work:   int32 on the plan's device, the kernels' array chunk_run[K] |
            chunk_tile[K + 1] | chunk_slot[K] | run_chunk[nrt + 1] |
            multi_run[M] (csrc/cell_walk.cuh: Work), then B1's
            stage_chunk[S] | stage_start[S + 1] | stage_tile[L] |
            gather_chunk[K - S] | stage_row[L * R + 1] | stage_cells[N]
            (Stage): the staged chunks, the offsets of each one's live tiles
            in stage_tile, the other chunks, and the staged tiles' cell
            lists (stage_cells).
    staged_cells: the nonzero cells of the staged chunks.
    """

    work: torch.Tensor
    num_chunks: int
    num_multi: int
    num_slots: int
    num_row_tiles: int
    bound: int
    max_chunk_cells: int
    total_cells: int
    num_staged: int
    num_stage_tiles: int
    staged_cells: int
    tile_rows: int
    num_listed: int

    def parts(self) -> Dict[str, np.ndarray]:
        """The work list's arrays, on the host."""
        k, m, nrt, s, l = self.num_chunks, self.num_multi, self.num_row_tiles, self.num_staged, self.num_stage_tiles
        w = self.work.cpu().numpy()
        sizes = (k, k + 1, k, nrt + 1, m, s, s + 1, l, k - s, l * self.tile_rows + 1, self.num_listed)
        names = ("chunk_run", "chunk_tile", "chunk_slot", "run_chunk", "multi_run", "stage_chunk", "stage_start",
                 "stage_tile", "gather_chunk", "stage_row", "stage_cells")
        return {name: w[e - n : e] for name, n, e in zip(names, sizes, np.cumsum(sizes))}

    def scratch_bytes(self, tile_rows: int, f: int, nb: int = 1, den: bool = False) -> int:
        return 4 * self.num_slots * slot_floats(tile_rows, f, nb, den)


def slot_floats(tile_rows: int, f: int, nb: int = 1, den: bool = False) -> int:
    """Floats of one scratch slot: num [nb, R, f], then den [nb, R], rounded
    up to 4 (csrc/cell_walk.cuh: slot_floats)."""
    x = nb * tile_rows * (f + int(den))
    return -(-x // 4) * 4


def tile_nnz(tp) -> torch.Tensor:
    """int64 [T] nonzero cells of each tile (a 1-bit tile's set bits), on
    the plan's device, counted in chunks of tiles."""
    a = tp.a
    out = torch.empty(tp.num_tiles, dtype=torch.int64, device=a.device)
    for s in range(0, tp.num_tiles, _NNZ_CHUNK):
        c = a[s : s + _NNZ_CHUNK]
        if tp.bits:
            out[s : s + _NNZ_CHUNK] = sum(((c >> b) & 1).sum(dim=(1, 2), dtype=torch.int64) for b in range(8))
        else:
            out[s : s + _NNZ_CHUNK] = (c != 0).sum(dim=(1, 2), dtype=torch.int64)
    return out


def stageable(tp) -> bool:
    """Whether B1 may stage the plan's chunks: int8 count tiles at most
    STAGE_MAX_C wide (module doc)."""
    return tp.format == "int8" and tp.tile_cols <= STAGE_MAX_C


def stage_cells(tp, stage_tile: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(stage_row int64 [L * R + 1], stage_cells int32 [N]): the nonzero
    cells of the plan's tiles ``stage_tile`` (L of them), tile by tile, a
    tile row's in ascending column order, each its column | its value's
    float32 bits above the lower 16 (an int8 count's float leaves those
    zero); row i of the l-th tile's cells are stage_cells[stage_row[l * R +
    i] .. stage_row[l * R + i + 1]].  Columns at or past n_src hold no edge
    and are left out, as the walk leaves them."""
    dev = tp.a.device
    c = tp.tile_cols
    counts, cells = [], []
    for s in range(0, stage_tile.numel(), _LIST_CHUNK):
        sel = stage_tile[s : s + _LIST_CHUNK]
        blk = tp.a[sel]
        col = tp.tile_col[sel].to(torch.int64)[:, None, None] * c + torch.arange(c, device=dev)
        nz = (blk != 0) & (col < tp.n_src)
        counts.append(nz.sum(dim=2, dtype=torch.int64).flatten())
        t_, r_, c_ = torch.nonzero(nz, as_tuple=True)
        cells.append(c_.to(torch.int32) | (blk[t_, r_, c_].float().view(torch.int32) & -65536))
    row = torch.zeros(stage_tile.numel() * tp.tile_rows + 1, dtype=torch.int64, device=dev)
    if counts:
        torch.cumsum(torch.cat(counts), 0, out=row[1:])
    return row, torch.cat(cells) if cells else torch.zeros(0, dtype=torch.int32, device=dev)


def build_walk(tp, bound: Optional[int] = None, stage_k: Optional[float] = None) -> CellWalk:
    """The work list of a plan whose tensors lie on one device (module doc);
    ``bound`` defaults to MIN_BOUND, or more for a plan of more than
    MIN_BOUND * TARGET_CHUNKS nonzero cells; ``stage_k`` to STAGE_K."""
    dev = tp.a.device
    nrt, t = tp.num_row_tiles, tp.num_tiles
    nnz = tile_nnz(tp)
    total = int(nnz.sum()) if t else 0
    if bound is None:
        bound = max(MIN_BOUND, -(-total // TARGET_CHUNKS))
    bound = max(2, bound + bound % 2)
    half = bound // 2
    rs = tp.run_start.to(device=dev, dtype=torch.int64)
    prefix = torch.zeros(t + 1, dtype=torch.int64, device=dev)
    torch.cumsum(nnz, 0, out=prefix[1:])
    tiles = torch.arange(t, dtype=torch.int64, device=dev)
    run_of = torch.searchsorted(rs[1:], tiles, right=True)
    first = rs[run_of]
    win = (prefix[:-1] - prefix[first]) // half
    big = nnz > half
    new = tiles == first
    new[1:] |= (win[1:] != win[:-1]) | big[1:] | big[:-1]
    starts = tiles[new]
    empty = torch.nonzero(rs[1:] == rs[:-1]).flatten()
    chunk_run = torch.cat([run_of[starts], empty])
    chunk_tile = torch.cat([starts, rs[empty]])
    order = torch.argsort(chunk_run * (t + 1) + chunk_tile)
    chunk_run, chunk_tile = chunk_run[order], chunk_tile[order]
    k = chunk_run.numel()
    chunk_tile = torch.cat([chunk_tile, torch.full((1,), t, dtype=torch.int64, device=dev)])
    cells = prefix[chunk_tile[1:]] - prefix[chunk_tile[:-1]]
    per_run = torch.bincount(chunk_run, minlength=nrt)
    run_chunk = torch.zeros(nrt + 1, dtype=torch.int64, device=dev)
    torch.cumsum(per_run, 0, out=run_chunk[1:])
    multi = per_run > 1
    slots_of_run = torch.where(multi, per_run, 0)
    slot_base = torch.cumsum(slots_of_run, 0) - slots_of_run
    rank = torch.arange(k, dtype=torch.int64, device=dev) - run_chunk[chunk_run]
    chunk_slot = torch.where(multi[chunk_run], slot_base[chunk_run] + rank, -1)
    multi_run = torch.nonzero(multi).flatten()
    live = nnz > 0
    live_prefix = torch.zeros(t + 1, dtype=torch.int64, device=dev)
    torch.cumsum(live, 0, out=live_prefix[1:])
    chunk_live = live_prefix[chunk_tile[1:]] - live_prefix[chunk_tile[:-1]]
    k_stage = STAGE_K if stage_k is None else stage_k
    staged = (chunk_live > 0) & (cells >= k_stage * tp.tile_cols * chunk_live) & stageable(tp)
    stage_chunk = torch.nonzero(staged).flatten()
    stage_start = torch.zeros(stage_chunk.numel() + 1, dtype=torch.int64, device=dev)
    torch.cumsum(chunk_live[stage_chunk], 0, out=stage_start[1:])
    tile_chunk = torch.searchsorted(chunk_tile[:-1], tiles, right=True) - 1
    stage_tile = tiles[live & staged[tile_chunk]]
    stage_row, listed = stage_cells(tp, stage_tile)
    work = torch.cat([chunk_run, chunk_tile, chunk_slot, run_chunk, multi_run, stage_chunk, stage_start, stage_tile,
                      torch.nonzero(~staged).flatten(), stage_row]).to(torch.int32)
    work = torch.cat([work, listed])
    return CellWalk(
        work=work.contiguous(),
        num_chunks=k,
        num_multi=multi_run.numel(),
        num_slots=int(slots_of_run.sum()),
        num_row_tiles=nrt,
        bound=bound,
        max_chunk_cells=int(cells.max()) if k else 0,
        total_cells=total,
        num_staged=stage_chunk.numel(),
        num_stage_tiles=stage_tile.numel(),
        staged_cells=int(cells[stage_chunk].sum()),
        tile_rows=tp.tile_rows,
        num_listed=listed.numel(),
    )


# id(plan's tile tensor) -> (weakref to it, weakref to its run_start, the
# key below, the list)
_cache: Dict[int, Tuple[weakref.ref, weakref.ref, tuple, CellWalk]] = {}


def _key(tp) -> tuple:
    return (tp.a._version, tp.run_start._version, tp.num_tiles, tp.num_nodes, tp.tile_rows, tp.tile_cols,
            MIN_BOUND, TARGET_CHUNKS)


def walk_for(tp) -> CellWalk:
    """The plan's work list, built at first use and cached under its tile
    tensor (module doc)."""
    a, rs = tp.a, tp.run_start
    ent = _cache.get(id(a))
    if ent is not None and ent[0]() is a and ent[1]() is rs and ent[2] == _key(tp):
        return ent[3]
    walk = build_walk(tp)
    ident = id(a)
    _cache[ident] = (weakref.ref(a, lambda _, i=ident: _cache.pop(i, None)), weakref.ref(rs), _key(tp), walk)
    return walk


def share_walk(src, dst) -> None:
    """Cache ``src``'s work list (built if it has none) under ``dst``'s tile
    tensor, for a ``dst`` with ``src``'s tiles in ``src``'s order and runs
    whose nonzero cells are a subset of ``src``'s (module doc).  Does
    nothing where the two plans' tiles lie on different devices.  ``dst``
    must not be stageable: B1 would read its staged cells' values from the
    list, which holds ``src``'s."""
    if dst.a.device != src.a.device:
        return
    if stageable(dst):
        raise ValueError("share_walk: B1 would read src's cell values for dst's staged cells")
    if (dst.num_tiles, dst.num_row_tiles, dst.tile_rows, dst.tile_cols) != (
        src.num_tiles, src.num_row_tiles, src.tile_rows, src.tile_cols
    ):
        raise ValueError("share_walk: the plans' tiles or runs differ")
    walk = walk_for(src)
    a, ident = dst.a, id(dst.a)
    _cache[ident] = (weakref.ref(a, lambda _, i=ident: _cache.pop(i, None)), weakref.ref(dst.run_start), _key(dst),
                     walk)


def stages(walk: CellWalk, f: int, sms: int) -> bool:
    """Whether B1 at width f stages the list's staged chunks on a card of
    ``sms`` SMs: their blocks (STAGE_ROWS rows, a 128-wide f-slice each)
    fill it at least STAGE_WAVES times."""
    blocks = walk.num_staged * -(-walk.tile_rows // STAGE_ROWS) * -(-f // 128)
    return blocks > 0 and blocks >= STAGE_WAVES * sms


def walk_args(tp, f: int, dev, nb: int = 1, den: bool = False) -> tuple:
    """(scratch, work, scratch pointer, num_chunks, num_multi) of a cell-walk
    launch over ``tp`` at width f: the plan's cached work list (walk_for)
    and a scratch buffer for its multi-chunk runs (None when there is none),
    which the caller holds over the launch."""
    walk = walk_for(tp)
    scratch = None
    if walk.num_slots:
        scratch = torch.empty(walk.num_slots * slot_floats(tp.tile_rows, f, nb, den), dtype=torch.float32,
                              device=dev)
    return (scratch, walk.work.data_ptr(), None if scratch is None else scratch.data_ptr(), walk.num_chunks,
            walk.num_multi)


def chunked_sums(walk: CellWalk, tile_parts: torch.Tensor) -> torch.Tensor:
    """Plain emulation of the walk's summation order over per-tile partials
    ``tile_parts`` [T, R, X] (each tile's finished partial): each chunk's
    partials added in tile order, then a run's chunk sums in chunk order
    (a run of one chunk is its chunk's sum).  Returns [nrt, R, X]."""
    p = walk.parts()
    nrt = walk.num_row_tiles
    out = tile_parts.new_zeros((nrt,) + tuple(tile_parts.shape[1:]))
    for r in range(nrt):
        run_sum = None
        for k in range(p["run_chunk"][r], p["run_chunk"][r + 1]):
            acc = tile_parts.new_zeros(tile_parts.shape[1:])
            for t in range(p["chunk_tile"][k], p["chunk_tile"][k + 1]):
                acc = acc + tile_parts[t]
            run_sum = acc if run_sum is None else run_sum + acc
        out[r] = run_sum
    return out
