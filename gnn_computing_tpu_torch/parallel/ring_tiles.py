"""Distributed hybrid aggregation on a ring: dense tiles + residual gather.

Port of ``gnn_computing_tpu/parallel/ring_tiles.py``.  The ring is the
capacity fallback of the all-gather form (``parallel/allgather_tiles.py``):
no rank ever holds more than one feature shard, at the price of per-step
tile products and tiles padded to the largest (owner, step) cell.

  * vertices are split into D contiguous shards; rank d owns the output and
    feature rows of shard d;
  * the padded global graph is densified once; each dense tile belongs to
    (owner = tile-row shard, ring step = source-shard distance), so the
    tiles stack as [D, D, T, R, C];
  * at step s rank d holds feature shard (d + s) mod D and, from that one
    buffer, computes the step's tile products and the residual gather.

The JAX package runs both with XLA (``einsum``, gathers, segment sums), so
here both are plain PyTorch: ``bmm`` over the step's tiles and
``index_add``; no hand-written kernel runs on the ring (PERF.md §7 asks
whether B1 should).  ``*_bodies`` run the D rank bodies in one process,
over every rank's plan parts made once (``mesh.shard_all``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from gnn_computing_tpu_torch.graph.csr import CSRGraph
from gnn_computing_tpu_torch.ops.gat import DEFAULT_SLOPE
from gnn_computing_tpu_torch.parallel.mesh import GRAPH_AXIS, Mesh, ring_shift, shard_ring_plan
from gnn_computing_tpu_torch.parallel.partition import RingPlan, RingShard, build_ring_plan
from gnn_computing_tpu_torch.parallel.ring import gcn_layers
from gnn_computing_tpu_torch.schedule.tiles import _as_tensor, densify


@dataclasses.dataclass
class RingTileShard:
    """One rank's tiles: a [D, T, R, C] (float32), col/row [D, T] int64."""

    a: torch.Tensor
    col: torch.Tensor
    row: torch.Tensor
    num_devices: int
    shard_size: int
    tile_rows: int
    tile_cols: int


@dataclasses.dataclass
class RingTilePlan:
    """Dense tiles bucketed per (owner rank, ring step).

    a:   [D, D, T, R, C] tile values (zero-padded per cell to a common T).
    col: [D, D, T] int32 — source tile index LOCAL to the step's shard.
    row: [D, D, T] int32 — destination tile index LOCAL to the owner.
    Axis 0 is the owner; axis 1 is the ring step.
    """

    a: np.ndarray
    col: np.ndarray
    row: np.ndarray
    num_devices: int
    shard_size: int
    tile_rows: int
    tile_cols: int
    num_dense_edges: int

    @property
    def tiles_per_cell(self) -> int:
        return self.a.shape[2]

    def shard(self, rank: int, device) -> RingTileShard:
        return RingTileShard(
            a=_as_tensor(self.a[rank]).to(device, torch.float32),
            col=torch.as_tensor(self.col[rank]).to(device, torch.int64),
            row=torch.as_tensor(self.row[rank]).to(device, torch.int64),
            num_devices=self.num_devices,
            shard_size=self.shard_size,
            tile_rows=self.tile_rows,
            tile_cols=self.tile_cols,
        )

    def stats(self) -> dict:
        a = np.asarray(self.a)
        nz = np.abs(a).sum(axis=(3, 4)) > 0
        per_cell = nz.sum(axis=2)  # [D, D]
        return {
            "num_devices": self.num_devices,
            "tiles_per_cell_padded": int(self.tiles_per_cell),
            "nonzero_tiles": int(nz.sum()),
            "local_tile_fraction": float(per_cell[:, 0].sum()) / max(per_cell.sum(), 1),
            "a_bytes": int(a.nbytes),
            "num_dense_edges": int(self.num_dense_edges),
        }


def build_ring_hybrid(
    g: CSRGraph,
    num_devices: int,
    tile_rows: int = 256,
    tile_cols: int = 128,
    threshold: Optional[int] = None,
    residual_block: int = 8,
    tile_dtype=np.float32,
    val: Optional[np.ndarray] = None,
) -> Tuple[RingTilePlan, RingPlan, CSRGraph]:
    """(tile ring plan, residual gather ring plan, padded graph): the graph
    padded so every shard holds whole row and column tiles, densified once,
    the tiles bucketed by (owner = tile-row shard, step = (source shard -
    owner) mod D); the residual edges through build_ring_plan."""
    d = num_devices
    if val is None and g.val is not None:
        val = g.val
    unit = int(np.lcm(tile_rows, tile_cols))
    n_pad = -(-g.num_nodes // (d * unit)) * (d * unit)
    if n_pad != g.num_nodes:
        indptr = np.concatenate([g.indptr, np.full(n_pad - g.num_nodes, g.indptr[-1], np.int32)])
        g = CSRGraph(indptr=indptr, indices=g.indices, val=g.val, n_src=n_pad)
    ns = n_pad // d
    nrt_local = ns // tile_rows
    nct_local = ns // tile_cols

    tp, res = densify(
        g, val=val, tile_rows=tile_rows, tile_cols=tile_cols, threshold=threshold, ensure_row_coverage=False,
        dtype=tile_dtype,
    )
    trow = np.asarray(tp.tile_row)[: tp.num_tiles]
    tcol = np.asarray(tp.tile_col)[: tp.num_tiles]
    a_all = np.asarray(tp.a)[: tp.num_tiles]
    owner = trow // nrt_local
    step = (tcol // nct_local - owner) % d

    # bucket (owner, step) -> tile list; pad every cell to the max count
    cell_of_tile = owner * d + step
    order = np.argsort(cell_of_tile, kind="stable")
    counts = np.bincount(cell_of_tile[order], minlength=d * d)
    t_max = max(int(counts.max()), 1)
    a = np.zeros((d, d, t_max, tile_rows, tile_cols), a_all.dtype)
    col = np.zeros((d, d, t_max), np.int32)
    row = np.zeros((d, d, t_max), np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)])
    for cell in range(d * d):
        sel = order[starts[cell] : starts[cell + 1]]
        if not len(sel):
            continue
        dev, s = divmod(cell, d)
        k = len(sel)
        sel = sel[np.argsort(trow[sel], kind="stable")]  # destination order within the cell
        a[dev, s, :k] = a_all[sel]
        col[dev, s, :k] = (tcol[sel] % nct_local).astype(np.int32)
        row[dev, s, :k] = (trow[sel] % nrt_local).astype(np.int32)

    rtp = RingTilePlan(
        a=a, col=col, row=row, num_devices=d, shard_size=ns, tile_rows=tile_rows, tile_cols=tile_cols,
        num_dense_edges=tp.num_dense_edges,
    )
    ring, g_ring, _ = build_ring_plan(res, d, block_size=residual_block, val=res.val)
    assert g_ring.num_nodes == n_pad
    return rtp, ring, g


def _shards(mesh: Mesh, rtp, ring):
    if isinstance(rtp, RingTilePlan):
        rtp = shard_ring_plan(mesh, rtp)
    if isinstance(ring, RingPlan):
        ring = shard_ring_plan(mesh, ring)
    return rtp, ring


def _local_ring_hybrid(tiles: RingTileShard, ring: RingShard, h_local: torch.Tensor, next_buffer) -> torch.Tensor:
    """One rank's body: per step the step's tile products and the residual
    gather from the one buffer held."""
    d, b = tiles.num_devices, ring.block_size
    ns, f = h_local.shape
    tr, tc = tiles.tile_rows, tiles.tile_cols
    out_t = h_local.new_zeros((ns // tr, tr, f))
    out_r = torch.zeros_like(h_local)
    buf = h_local
    for s in range(d):
        nxt = next_buffer(s, buf) if s + 1 < d else None
        gsel = buf.reshape(ns // tc, tc, f).index_select(0, tiles.col[s])
        out_t = out_t.index_add(0, tiles.row[s], torch.bmm(tiles.a[s].to(buf.dtype), gsel))
        msg = buf.index_select(0, ring.src[s]) * ring.val[s][:, None].to(buf.dtype)
        out_r = out_r.index_add(0, ring.dst[s], msg.reshape(-1, b, f).sum(dim=1))
        buf = nxt
    return out_t.reshape(ns, f) + out_r


def ring_hybrid_spmm(mesh: Mesh, rtp, ring, h_local: torch.Tensor) -> torch.Tensor:
    """Distributed hybrid SpMM over this rank's rows ``h_local``."""
    rtp, ring = _shards(mesh, rtp, ring)
    return _local_ring_hybrid(rtp, ring, h_local, lambda s, buf: ring_shift(mesh, buf, GRAPH_AXIS))


def ring_hybrid_spmm_bodies(tiles, rings, h: torch.Tensor) -> torch.Tensor:
    """The D rank bodies in one process over the full ``h``; ``tiles`` and
    ``rings``: every rank's RingTileShard and RingShard (``mesh.shard_all``)."""
    d = len(tiles)
    shards = h.split(tiles[0].shard_size)
    return torch.cat([
        _local_ring_hybrid(tiles[r], rings[r], shards[r], lambda s, buf, r=r: shards[(r + s + 1) % d])
        for r in range(d)
    ])


def ring_hybrid_gcn_forward(mesh: Mesh, rtp, ring, params, h_local: torch.Tensor) -> torch.Tensor:
    """Distributed 3-layer GCN over the hybrid ring."""
    rtp, ring = _shards(mesh, rtp, ring)
    return gcn_layers(lambda z: ring_hybrid_spmm(mesh, rtp, ring, z), params, h_local)


def ring_hybrid_gcn_forward_bodies(tiles, rings, params, h: torch.Tensor) -> torch.Tensor:
    return gcn_layers(lambda z: ring_hybrid_spmm_bodies(tiles, rings, z), params, h)


# ----------------------------------------------------------------- GAT ring
def _local_ring_hybrid_gat(
    tiles: RingTileShard, ring: RingShard, packed: torch.Tensor, ad: torch.Tensor, next_buffer,
    relu_slope: float = DEFAULT_SLOPE,
) -> torch.Tensor:
    """One rank's fused-GAT body.  The rotated buffer packs [h | v1 | as]
    per source row (v1 = exp(as)), so one shift feeds the tile products,
    the residual gather and the attention factors; the branch-2 factor
    exp(slope * as) is derived in-step.  The un-stabilized reference form,
    so every step's partial denominators add exactly.  Tiles go through
    the two-branch exact form: a cell's count goes to branch 1
    (exp(ad_i) exp(as_j)) where ad_i + as_j > 0, else to branch 2
    (exp(slope ad_i) exp(slope as_j))."""
    d, b = tiles.num_devices, ring.block_size
    ns = packed.shape[0]
    f = packed.shape[1] - 2
    tr, tc = tiles.tile_rows, tiles.tile_cols
    nrt, nct = ns // tr, ns // tc
    u1t = torch.exp(ad).reshape(nrt, tr)
    u2t = torch.exp(relu_slope * ad).reshape(nrt, tr)
    adt = ad.reshape(nrt, tr)
    num = packed.new_zeros((ns, f))
    den = packed.new_zeros((ns,))
    buf = packed
    for s in range(d):
        nxt = next_buffer(s, buf) if s + 1 < d else None
        hb, v1, asb = buf[:, :f], buf[:, f], buf[:, f + 1]
        v2 = torch.exp(relu_slope * asb)
        # dense tiles, the two-branch exact form
        col_s, row_s = tiles.col[s], tiles.row[s]
        hv1 = torch.cat([hb * v1[:, None], v1[:, None]], dim=1).reshape(nct, tc, f + 1)
        hv2 = torch.cat([hb * v2[:, None], v2[:, None]], dim=1).reshape(nct, tc, f + 1)
        z = adt.index_select(0, row_s)[:, :, None] + asb.reshape(nct, tc).index_select(0, col_s)[:, None, :]
        af = tiles.a[s].float()
        a1 = torch.where(z > 0, af, 0.0)
        a2 = af - a1
        p = (
            u1t.index_select(0, row_s)[:, :, None] * torch.bmm(a1, hv1.index_select(0, col_s))
            + u2t.index_select(0, row_s)[:, :, None] * torch.bmm(a2, hv2.index_select(0, col_s))
        )
        both = torch.zeros((nrt, tr, f + 1), dtype=p.dtype, device=p.device).index_add(0, row_s, p).reshape(ns, f + 1)
        # residual gather from the same buffer
        src_s, cnt_s, dst_s = ring.src[s], ring.count[s], ring.dst[s]
        nt = cnt_s.shape[0]
        zr = ad.index_select(0, dst_s)[:, None] + asb.index_select(0, src_s).reshape(nt, b)
        slot = torch.arange(b, device=zr.device)[None, :] < cnt_s[:, None]
        score = torch.where(slot, torch.exp(torch.where(zr > 0, zr, relu_slope * zr)), 0.0)
        msg = hb.index_select(0, src_s).reshape(nt, b, f) * score[:, :, None]
        num = num + both[:, :f] + torch.zeros_like(num).index_add(0, dst_s, msg.sum(dim=1))
        den = den + both[:, f] + torch.zeros_like(den).index_add(0, dst_s, score.sum(dim=1))
        buf = nxt
    return num / torch.where(den == 0.0, 1.0, den)[:, None]


def _gat_buffers(h: torch.Tensor, att: torch.Tensor):
    """([h | exp(as) | as] float32, ad) of some rows."""
    a_s = att[:, 1:2].float()
    return torch.cat([h.float(), torch.exp(a_s), a_s], dim=1), att[:, 0].float()


def ring_hybrid_gat(
    mesh: Mesh, rtp, ring, h_local: torch.Tensor, att_local: torch.Tensor, relu_slope: float = DEFAULT_SLOPE
) -> torch.Tensor:
    """Distributed fused GAT over the hybrid ring; ``h_local`` [ns, f] and
    ``att_local`` [ns, 2] are this rank's rows.  Needs raw count tiles:
    build the plans from an unweighted graph (no g.val, val=None), since
    attention provides the edge weights; a value-weighted build computes
    val-scaled attention."""
    rtp, ring = _shards(mesh, rtp, ring)
    packed, ad = _gat_buffers(h_local, att_local)
    out = _local_ring_hybrid_gat(rtp, ring, packed, ad, lambda s, buf: ring_shift(mesh, buf, GRAPH_AXIS), relu_slope)
    return out.to(h_local.dtype)


def ring_hybrid_gat_bodies(
    tiles, rings, h: torch.Tensor, att: torch.Tensor, relu_slope: float = DEFAULT_SLOPE
) -> torch.Tensor:
    """The D rank bodies of ring_hybrid_gat in one process (parts as in
    ring_hybrid_spmm_bodies)."""
    d, ns = len(tiles), tiles[0].shard_size
    packed, ad = _gat_buffers(h, att)
    shards = packed.split(ns)
    return torch.cat([
        _local_ring_hybrid_gat(tiles[r], rings[r], shards[r], ad[r * ns : (r + 1) * ns],
                               lambda s, buf, r=r: shards[(r + s + 1) % d], relu_slope)
        for r in range(d)
    ]).to(h.dtype)
