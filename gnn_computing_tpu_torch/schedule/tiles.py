"""Tile densification: dense int8 count tiles + a sparse residual graph.

Port of the integer count path of ``gnn_computing_tpu/schedule/tiles.py``
(``TilePlan``, ``densify``, ``pad_runs``, ``transpose``, the 1-bit format
``pack_bit_tiles`` / ``unpack_bit_tiles`` / ``split_bit_tiles``).  Edges falling in [R x C]
adjacency blocks that hold at least ``threshold`` edges become dense tiles
holding exact edge counts; the rest stay in a residual CSR graph for the
gather path.  Factored edge values val[e] = scale_dst[dst] * scale_src[src]
keep the tiles exact counts and carry the scales beside them.

The counts are written straight from the sorted cell keys: no float
[T, R, C] staging array (the JAX package's numpy fallback builds one, 34 GB
at reddit scale).  A cell holds at most 127 edges; in each cell the first
127 edges in edge order stay in the tile and later ones spill to the
residual, the rule of the JAX package's native fill.

1-bit tiles (``TilePlan.bits``): a tile whose every cell holds 0 or 1 is
stored as uint8 [R/8, C], plane-major along rows: bit b of a[t, i, c] is
cell (b*R/8 + i, c) — the layout the JAX package's code packs and decodes
(its ``TilePlan.bits`` comment describes another).  ``split_bit_tiles``
splits an int8 plan by tile content into a 1-bit and an int8 part;
``transpose`` keeps a plan's format, so the transposed 1-bit part packs the
forward's C as its R.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from gnn_computing_tpu_torch.device import resolve_device
from gnn_computing_tpu_torch.graph.csr import CSRGraph

INT8_CAP = 127


def run_offsets(tile_row: np.ndarray, num_row_tiles: int) -> np.ndarray:
    """int32[nrt + 1]: tiles of destination row-tile r are
    ``run_start[r]:run_start[r + 1]`` (tile_row must be sorted)."""
    return np.searchsorted(
        np.asarray(tile_row), np.arange(num_row_tiles + 1), side="left"
    ).astype(np.int32)


@dataclasses.dataclass
class TilePlan:
    """Dense adjacency tiles, sorted by destination row-tile.

    a:         int8 [num_tiles, R, C]; a[t, i, j] counts the edges
               (src = tile_col[t]*C + j) -> (dst = tile_row[t]*R + i);
               with ``bits``, uint8 [num_tiles, R/8, C] in the 1-bit
               format (module doc), every count 0 or 1.
    tile_col:  int32[num_tiles] source-tile index per tile.
    tile_row:  int32[num_tiles] destination-tile index, ascending.
    run_start: int32[nrt + 1] run offsets into the tile axis (run_offsets).
    scale_dst/scale_src: optional f32[num_nodes]/[n_src] diagonal factors
               applied around the tile product (factored edge values).
    """

    a: object
    tile_col: object
    tile_row: object
    run_start: object
    scale_dst: Optional[object]
    scale_src: Optional[object]

    num_nodes: int
    n_src: int
    tile_rows: int
    tile_cols: int
    num_tiles: int
    num_dense_edges: int
    # run-length multiple guaranteed by pad_runs
    pack: int = 1
    # ``a`` holds 1-bit tiles (module doc)
    bits: bool = False

    @property
    def num_row_tiles(self) -> int:
        return -(-self.num_nodes // self.tile_rows)

    @property
    def num_col_tiles(self) -> int:
        return -(-self.n_src // self.tile_cols)

    def to(self, device) -> "TilePlan":
        dev = resolve_device(device)

        def put(x, dtype):
            return None if x is None else torch.as_tensor(x).to(device=dev, dtype=dtype)

        return dataclasses.replace(
            self,
            # bytes of a 1-bit plan go above 127: they stay uint8
            a=put(self.a, torch.uint8 if self.bits else torch.int8),
            tile_col=put(self.tile_col, torch.int32),
            tile_row=put(self.tile_row, torch.int32),
            run_start=put(self.run_start, torch.int32),
            scale_dst=put(self.scale_dst, torch.float32),
            scale_src=put(self.scale_src, torch.float32),
        )

    def counts(self, start: int = 0, stop: Optional[int] = None):
        """The edge counts [stop - start, R, C] of tiles start..stop (the
        1-bit format unpacked), for the plain versions."""
        a = self.a[start:stop]
        return unpack_bit_tiles(a) if self.bits else a

    def unpack_bits(self) -> "TilePlan":
        """The same plan with int8 count tiles."""
        if not self.bits:
            return self
        return dataclasses.replace(self, a=unpack_bit_tiles(self.a), bits=False)

    def pad_runs(self, multiple: int) -> "TilePlan":
        """Pad every tile-row run with all-zero tiles (column 0) to a multiple
        of ``multiple`` tiles — the layout the TPU kernel's K-tile steps need.
        The CUDA kernel takes any run length, so there the filler tiles are
        only extra work."""
        if multiple <= 1:
            return self
        rows = np.asarray(self.tile_row)
        nrt = self.num_row_tiles
        lens = np.diff(run_offsets(rows, nrt)).astype(np.int64)
        padded = np.where(lens > 0, -(-lens // multiple) * multiple, 0)
        new_start = np.zeros(nrt + 1, np.int64)
        np.cumsum(padded, out=new_start[1:])
        total = int(new_start[-1])
        old_start = np.concatenate([[0], np.cumsum(lens)])
        # destination slot of every existing tile: its run's new start plus
        # its rank inside the run
        pos = new_start[rows] + (np.arange(len(rows)) - old_start[rows])
        old_a = np.asarray(self.a)
        a = np.zeros((total,) + old_a.shape[1:], old_a.dtype)
        a[pos] = old_a
        cols = np.zeros(total, np.int32)
        cols[pos] = self.tile_col
        new_rows = np.repeat(np.arange(nrt, dtype=np.int32), padded)
        return dataclasses.replace(
            self,
            a=a,
            tile_col=cols,
            tile_row=new_rows,
            run_start=new_start.astype(np.int32),
            num_tiles=total,
            pack=multiple,
        )

    def transpose(self) -> "TilePlan":
        """Tile plan of A^T, for the backward: tiles stably sorted by source
        tile and each transposed (rows and columns swap roles, [C, R] tiles),
        plus one all-zero filler tile for every transposed row-tile that got
        none, so the transposed plan covers every row-tile as densify's
        does; scales swap.  Take it from the unpadded plan, then pad_runs,
        as the JAX package's aggregator does.  A 1-bit plan stays 1-bit: each
        tile is unpacked, transposed and packed again (chunks of tiles at a
        time), so the forward's C must be a multiple of 8."""
        order = np.argsort(np.asarray(self.tile_col), kind="stable")
        a_in = np.asarray(self.a)
        if self.bits:
            if self.tile_cols % 8:
                raise ValueError(
                    f"the transpose of a 1-bit plan packs the forward's C as its R: "
                    f"C = {self.tile_cols} is not a multiple of 8"
                )
            a = np.empty((len(order), self.tile_cols // 8, self.tile_rows), np.uint8)
            for s in range(0, len(order), 4096):
                a[s : s + 4096] = pack_bit_tiles(unpack_bit_tiles(a_in[order[s : s + 4096]]).transpose(0, 2, 1))
        else:
            a = np.ascontiguousarray(a_in[order].transpose(0, 2, 1))
        rows = np.asarray(self.tile_col)[order].astype(np.int32)
        cols = np.asarray(self.tile_row)[order].astype(np.int32)
        nrt_t = self.num_col_tiles
        missing = np.setdiff1d(np.arange(nrt_t, dtype=np.int32), rows)
        if len(missing):
            a = np.concatenate([a, np.zeros((len(missing),) + a.shape[1:], a.dtype)])
            rows = np.concatenate([rows, missing])
            cols = np.concatenate([cols, np.zeros(len(missing), np.int32)])
            order2 = np.argsort(rows, kind="stable")
            a, rows, cols = a[order2], rows[order2], cols[order2]
        return TilePlan(
            a=a,
            tile_col=cols,
            tile_row=rows,
            run_start=run_offsets(rows, nrt_t),
            scale_dst=self.scale_src,
            scale_src=self.scale_dst,
            num_nodes=self.n_src,
            n_src=self.num_nodes,
            tile_rows=self.tile_cols,
            tile_cols=self.tile_rows,
            num_tiles=len(rows),
            num_dense_edges=self.num_dense_edges,
            bits=self.bits,
        )


def pack_bit_tiles(a: np.ndarray) -> np.ndarray:
    """[T, R, C] 0/1 tiles -> uint8 [T, R/8, C], plane-major along rows:
    bit b of out[t, i, c] = a[t, b*(R/8) + i, c]."""
    a = np.asarray(a)
    t, r, c = a.shape
    if r % 8:
        raise ValueError(f"1-bit tiles need R % 8 == 0, got R = {r}")
    bits = (a != 0).astype(np.uint8).reshape(t, 8, r // 8, c)
    shifts = (1 << np.arange(8, dtype=np.uint8))[None, :, None, None]
    return (bits * shifts).sum(axis=1, dtype=np.uint8)


def unpack_bit_tiles(packed):
    """Inverse of pack_bit_tiles: uint8 [T, R/8, C] -> int8 [T, R, C]; a
    numpy array or a tensor, returned as the same kind."""
    if isinstance(packed, torch.Tensor):
        return torch.cat([(packed >> b) & 1 for b in range(8)], dim=1).to(torch.int8)
    packed = np.asarray(packed)
    return np.concatenate([(packed >> b) & 1 for b in range(8)], axis=1).astype(np.int8)


def split_bit_tiles(tp: TilePlan) -> Tuple[Optional[TilePlan], Optional[TilePlan]]:
    """Split a host int8 count plan into (1-bit part, int8 part) by tile
    content: tiles whose every cell is 0 or 1 go to the 1-bit part,
    multigraph tiles (a cell > 1) stay int8.  Either part may be None.
    Each part gets all-zero filler tiles (column 0) for the row-tiles it
    lacks, a stable sort by row and its own ``num_dense_edges``.  Runs
    before pad_runs, as in the JAX package."""
    if tp.bits or tp.pack != 1:
        raise ValueError("split_bit_tiles takes an unpadded int8 plan (split before pad_runs)")
    a = np.asarray(tp.a)
    t = a.shape[0]
    if t == 0:
        return None, tp
    chunk = 4096
    multi = np.zeros(t, bool)
    for i in range(0, t, chunk):
        multi[i : i + chunk] = a[i : i + chunk].max(axis=(1, 2)) > 1
    if not multi.any():
        return dataclasses.replace(tp, a=pack_bit_tiles(a), bits=True), None
    if multi.all():
        return None, tp
    nrt = tp.num_row_tiles

    def part(sel, bits, num_edges):
        aa = a[sel]
        rows = np.asarray(tp.tile_row)[sel]
        cols = np.asarray(tp.tile_col)[sel]
        missing = np.setdiff1d(np.arange(nrt, dtype=np.int32), rows)
        if len(missing):
            aa = np.concatenate([aa, np.zeros((len(missing),) + aa.shape[1:], aa.dtype)])
            rows = np.concatenate([rows, missing])
            cols = np.concatenate([cols, np.zeros(len(missing), np.int32)])
        order = np.argsort(rows, kind="stable")
        rows = rows[order].astype(np.int32)
        return dataclasses.replace(
            tp,
            a=pack_bit_tiles(aa[order]) if bits else aa[order],
            tile_row=rows,
            tile_col=cols[order].astype(np.int32),
            run_start=run_offsets(rows, nrt),
            num_tiles=len(rows),
            num_dense_edges=int(num_edges),
            bits=bits,
        )

    edges_multi = sum(
        int(a[i : i + chunk][multi[i : i + chunk]].sum(dtype=np.int64)) for i in range(0, t, chunk)
    )
    return part(~multi, True, tp.num_dense_edges - edges_multi), part(multi, False, edges_multi)


def densify(
    g: CSRGraph,
    val: Optional[np.ndarray] = None,
    tile_rows: int = 256,
    tile_cols: int = 128,
    threshold: Optional[int] = None,
    ensure_row_coverage: bool = True,
    dtype=np.int8,
    scale_dst: Optional[np.ndarray] = None,
    scale_src: Optional[np.ndarray] = None,
) -> Tuple[TilePlan, CSRGraph]:
    """Split a graph into (int8 count tile plan, residual sparse graph).

    The default threshold scales with tile area: 48 edges per 128x128.
    ``ensure_row_coverage`` adds one all-zero tile for every destination
    row-tile that has no dense tile.  The residual keeps the original edge
    values.
    """
    if np.dtype(dtype) != np.int8:
        raise NotImplementedError("the port builds int8 count tiles only")
    tr, tc = tile_rows, tile_cols
    if threshold is None:
        threshold = max(1, (48 * tr * tc) // (128 * 128))
    if val is None:
        val = g.val
    if val is None:
        val = np.ones(g.num_edges, np.float32)
    val = np.asarray(val, np.float32)

    src = g.indices.astype(np.int64)
    dst = g.dst_per_edge.astype(np.int64)
    nct = -(-g.n_src // tc)
    nrt = -(-g.num_nodes // tr)

    key = (dst // tr) * nct + (src // tc)
    nbins = nrt * nct
    if nbins <= (1 << 29):
        # direct histogram over tile cells, no sort of the edge keys
        dense_mask = np.bincount(key, minlength=nbins) >= threshold
        edge_dense = dense_mask[key]
        dense_keys = np.flatnonzero(dense_mask)
        tile_of_edge = (np.cumsum(dense_mask) - 1)[key[edge_dense]]
    else:
        uniq, inverse, counts = np.unique(key, return_inverse=True, return_counts=True)
        dense_sel = counts >= threshold
        edge_dense = dense_sel[inverse]
        dense_keys = uniq[dense_sel]
        tile_of_edge = np.searchsorted(dense_keys, key[edge_dense])
    tile_row = (dense_keys // nct).astype(np.int32)
    tile_col = (dense_keys % nct).astype(np.int32)

    de_src, de_dst = src[edge_dense], dst[edge_dense]
    tile_val = val[edge_dense]
    if scale_dst is not None:
        tile_val = tile_val / np.asarray(scale_dst, np.float32)[de_dst]
    if scale_src is not None:
        tile_val = tile_val / np.asarray(scale_src, np.float32)[de_src]
    if not np.allclose(tile_val, 1.0):
        raise ValueError(
            "int8 tiles hold edge counts: tile edge values (after the scales) "
            "must all be 1"
        )

    if ensure_row_coverage:
        missing = np.setdiff1d(np.arange(nrt, dtype=np.int32), tile_row)
        tile_row = np.concatenate([tile_row, missing])
        tile_col = np.concatenate([tile_col, np.zeros(len(missing), np.int32)])
    num_tiles = len(tile_row)
    order = np.argsort(tile_row, kind="stable")
    slot = np.empty(num_tiles, np.int64)  # dense tile id -> final position
    slot[order] = np.arange(num_tiles)

    # per-cell counts from the sorted cell keys; rank edges within a cell in
    # edge order (stable sort) and spill those past the int8 cap
    cell = tile_of_edge * (tr * tc) + (de_dst % tr) * tc + (de_src % tc)
    by_cell = np.argsort(cell, kind="stable")
    sc = cell[by_cell]
    new_cell = np.ones(len(sc), bool)
    new_cell[1:] = sc[1:] != sc[:-1]
    first = np.flatnonzero(new_cell)
    per_cell = np.diff(np.append(first, len(sc)))
    rank = np.arange(len(sc)) - np.repeat(first, per_cell)
    spill = np.zeros(len(cell), bool)
    spill[by_cell] = rank >= INT8_CAP
    cells = sc[first]

    a = np.zeros((num_tiles, tr, tc), np.int8)
    a.reshape(-1)[slot[cells // (tr * tc)] * (tr * tc) + cells % (tr * tc)] = np.minimum(
        per_cell, INT8_CAP
    )
    edge_dense[np.flatnonzero(edge_dense)[spill]] = False

    tile_row = tile_row[order]
    plan = TilePlan(
        a=a,
        tile_col=tile_col[order].astype(np.int32),
        tile_row=tile_row.astype(np.int32),
        run_start=run_offsets(tile_row, nrt),
        scale_dst=None if scale_dst is None else np.asarray(scale_dst, np.float32),
        scale_src=None if scale_src is None else np.asarray(scale_src, np.float32),
        num_nodes=g.num_nodes,
        n_src=g.n_src,
        tile_rows=tr,
        tile_cols=tc,
        num_tiles=num_tiles,
        num_dense_edges=int(edge_dense.sum()),
    )

    res_sel = ~edge_dense
    res = CSRGraph.from_edges(
        dst=dst[res_sel],
        src=src[res_sel].astype(np.int32),
        num_nodes=g.num_nodes,
        val=val[res_sel],
        n_src=g.n_src,
    )
    return plan, res
