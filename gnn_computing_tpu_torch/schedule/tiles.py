"""Tile densification: dense adjacency tiles + a sparse residual graph.

Port of ``gnn_computing_tpu/schedule/tiles.py`` (``TilePlan``, ``densify``,
``densify_gcn_norm``, ``pad_runs``, ``transpose``, ``astype``, the 1-bit
format ``pack_bit_tiles`` / ``unpack_bit_tiles`` / ``split_bit_tiles``).
Edges falling in [R x C] adjacency blocks that hold at least ``threshold``
edges become dense tiles; the rest stay in a residual CSR graph for the
gather path.

Tile value formats (``TilePlan.a``):
  int8     exact edge counts (unweighted graphs, or factored edge values
           val[e] = scale_dst[dst] * scale_src[src] with the scales beside
           the tiles), counted in edge order by the native host library
           (``native.saturating_count_i8``), as the JAX package's densify
           counts them, with no float staging array.  A cell holds at most
           127 edges; in each cell the first 127 edges in edge order stay
           in the tile and later ones spill to the residual.
  float32  edge values (after the scales), duplicate edges of a cell
           summed in float32 in edge order (``native.scatter_add_f32``), as
           the JAX package's fill does; the JAX package's default.  No cap,
           no spill.
  bfloat16 the float32 sums rounded to nearest even.  numpy has no
           bfloat16, so a host plan holds its uint16 bit pattern and ``to``
           turns it into a torch.bfloat16 tensor.

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

from gnn_computing_tpu_torch import native
from gnn_computing_tpu_torch.device import resolve_device
from gnn_computing_tpu_torch.graph.csr import CSRGraph

INT8_CAP = 127
# tile value format -> (host numpy storage, device torch dtype)
TILE_FORMATS = {
    "int8": (np.int8, torch.int8),
    "float32": (np.float32, torch.float32),
    "bfloat16": (np.uint16, torch.bfloat16),
}


def tile_format(dtype) -> str:
    """The tile value format a dtype names: int8, float32 (also None, the
    JAX package's default) or bfloat16 (torch.bfloat16 or "bfloat16")."""
    if dtype is None:
        return "float32"
    if dtype == "bfloat16":
        return "bfloat16"
    for fmt, (np_dtype, torch_dtype) in TILE_FORMATS.items():
        if isinstance(dtype, torch.dtype):
            if dtype == torch_dtype:
                return fmt
        elif fmt != "bfloat16" and np.dtype(dtype) == np_dtype:  # np.uint16 holds bfloat16's bits only
            return fmt
    raise NotImplementedError(f"tile dtype {dtype!r}: the port builds int8, float32 and bfloat16 tiles")


def _host_values(a: np.ndarray, fmt: str) -> np.ndarray:
    """Host tile values (int8 counts or float32) in the host storage of
    ``fmt``; float32 -> bfloat16 rounds to nearest even."""
    if fmt == "bfloat16":
        bf = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16)
        return bf.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).astype(TILE_FORMATS[fmt][0], copy=False)


def _as_tensor(a) -> torch.Tensor:
    """Tile values as a tensor of their device dtype (a host bfloat16 bit
    pattern becomes torch.bfloat16)."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype == np.uint16:
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    return torch.as_tensor(a)


def run_offsets(tile_row: np.ndarray, num_row_tiles: int) -> np.ndarray:
    """int32[nrt + 1]: tiles of destination row-tile r are
    ``run_start[r]:run_start[r + 1]`` (tile_row must be sorted)."""
    return np.searchsorted(
        np.asarray(tile_row), np.arange(num_row_tiles + 1), side="left"
    ).astype(np.int32)


@dataclasses.dataclass
class TilePlan:
    """Dense adjacency tiles, sorted by destination row-tile.

    a:         [num_tiles, R, C] tile values (module doc): a[t, i, j] is
               the int8 count, or the float32 / bfloat16 summed value, of
               the edges (src = tile_col[t]*C + j) -> (dst = tile_row[t]*R + i);
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

    @property
    def format(self) -> str:
        """'bits' for a 1-bit plan, else the tile value format (module doc)."""
        if self.bits:
            return "bits"
        dt = _as_tensor(self.a[:0]).dtype
        for fmt, (_, torch_dtype) in TILE_FORMATS.items():
            if dt == torch_dtype:
                return fmt
        raise ValueError(f"tiles of dtype {dt} are no tile format")

    def to(self, device) -> "TilePlan":
        """The plan on ``device``; the tiles keep their format (uint8 1-bit
        bytes, int8 counts, float32 or bfloat16 values)."""
        dev = resolve_device(device)

        def put(x, dtype):
            return None if x is None else torch.as_tensor(x).to(device=dev, dtype=dtype)

        return dataclasses.replace(
            self,
            a=_as_tensor(self.a).to(dev),
            tile_col=put(self.tile_col, torch.int32),
            tile_row=put(self.tile_row, torch.int32),
            run_start=put(self.run_start, torch.int32),
            scale_dst=put(self.scale_dst, torch.float32),
            scale_src=put(self.scale_src, torch.float32),
        )

    def counts(self, start: int = 0, stop: Optional[int] = None):
        """The tile values [stop - start, R, C] of tiles start..stop (edge
        counts, the 1-bit format unpacked; a float plan's values, a host
        bfloat16 plan's as float32), for the plain versions."""
        a = self.a[start:stop]
        if self.bits:
            return unpack_bit_tiles(a)
        if isinstance(a, np.ndarray) and a.dtype == np.uint16:
            return (a.astype(np.uint32) << 16).view(np.float32)
        return a

    def astype(self, dtype) -> "TilePlan":
        """The plan with its tiles in another value format (int8, float32 or
        bfloat16; see tile_format).  A 1-bit plan has a fixed layout and
        refuses, as in the JAX package."""
        if self.bits:
            raise ValueError("1-bit tiles have a fixed uint8 layout: unpack_bits() first")
        fmt = tile_format(dtype)
        if isinstance(self.a, torch.Tensor):
            a = self.a.to(TILE_FORMATS[fmt][1])
        else:
            a = _host_values(self.counts(), fmt)
        return dataclasses.replace(self, a=a)

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
    if tp.bits or tp.pack != 1 or np.asarray(tp.a).dtype != np.int8:
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
    dtype=np.float32,
    scale_dst: Optional[np.ndarray] = None,
    scale_src: Optional[np.ndarray] = None,
) -> Tuple[TilePlan, CSRGraph]:
    """Split a graph into (tile plan, residual sparse graph).

    ``dtype`` picks the tile value format (module doc; see tile_format):
    float32 by default, as in the JAX package, int8 counts or bfloat16.
    With ``scale_dst``/``scale_src`` the tiles hold val[e] / (scale_dst[dst]
    * scale_src[src]) and the scales ride along in the plan; int8 tiles
    need those to be 1.  The default threshold scales with tile area: 48
    edges per 128x128.  ``ensure_row_coverage`` adds one all-zero tile for
    every destination row-tile that has no dense tile.  The residual keeps
    the original edge values.
    """
    fmt = tile_format(dtype)
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
    if fmt == "int8" and not np.allclose(tile_val, 1.0):
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

    # each edge's cell in the final tile order; the native library fills
    # the cells in edge order, as the JAX package's densify does
    cell = tile_of_edge * (tr * tc) + (de_dst % tr) * tc + (de_src % tc)
    flat = slot[cell // (tr * tc)] * (tr * tc) + cell % (tr * tc)
    if fmt == "int8":
        # saturating counts; an edge past the int8 cap of its cell spills
        # back to the residual
        a = np.zeros((num_tiles, tr, tc), np.int8)
        spill = native.saturating_count_i8(flat, INT8_CAP, a.reshape(-1))
        edge_dense[np.flatnonzero(edge_dense)[spill]] = False
    else:
        # float32 sums (bfloat16 rounds the sums)
        a = np.zeros((num_tiles, tr, tc), np.float32)
        native.scatter_add_f32(flat, tile_val, a.reshape(-1))
        a = _host_values(a, fmt)

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


def densify_gcn_norm(g: CSRGraph, **kw) -> Tuple[TilePlan, CSRGraph]:
    """densify with the symmetric GCN normalization factored out:
    val[e] = 1/sqrt(deg_dst * deg_src) = scale_dst[dst] * scale_src[src],
    so the tiles hold the edge counts (exact in float32 and bfloat16) and
    the scales ride beside them."""
    out_deg = np.bincount(g.indices, minlength=g.n_src).astype(np.float32)
    in_deg = g.degrees.astype(np.float32)
    s_dst = 1.0 / np.sqrt(np.maximum(in_deg, 1.0))
    s_src = 1.0 / np.sqrt(np.maximum(out_deg, 1.0))
    val = s_dst[g.dst_per_edge] * s_src[g.indices]
    return densify(g, val=val, scale_dst=s_dst, scale_src=s_src, **kw)
