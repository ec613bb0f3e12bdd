"""Distributed hybrid aggregation, all-gather form: the single-card tile
kernel on every rank.

Port of ``gnn_computing_tpu/parallel/allgather_tiles.py``, the default
scale-out path for graphs whose feature matrix fits one card: one
all-gather of the row-sharded H per aggregation (``mesh.all_gather_rows``),
then each rank runs its own row shard's tile groups through the unmodified
single-card tile product B1 (``ops.bcsr.bcsr_spmm``: ``csrc/bcsr_spmm.cu`` on
the card, ``bcsr_spmm_plain`` on the CPU), plus its residual tasks as one
gather (``ops.spmm.spmm_plain``) against the gathered buffer.

The host plans are array-equal to the JAX package's: tiles bucketed per
owner and padded to one tile count per owner (the last run extended with
zero tiles, so pack-K runs stay whole), 1-bit and int8 groups, and with
``local_split`` each owner's work split into LOCAL groups and tasks (every
source in the owner's own shard, columns rebased; they read ``h_local``,
independent of the all-gather) and HALO work (reads the gathered buffer).

Gradients: B1 over a group runs the group's transposed tile plan in the
backward (built with ``with_transpose=True``: ``TilePlan.transpose`` of
each owner's group, 1-bit kept 1-bit, so C % 8 == 0 there); the residual's
backward is ``spmm_transpose`` over the same tasks; the all-gather's sums
the cotangent's rows over the ranks.

The rank body (``_local_allgather_hybrid``) takes ``h_local`` and the
gathered buffer, so the world form (``allgather_hybrid_spmm``) and the
in-process form over all D bodies (``allgather_hybrid_spmm_bodies``, one
process, no collective; what a one-card host runs) share it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from gnn_computing_tpu_torch.graph.csr import CSRGraph
from gnn_computing_tpu_torch.ops.bcsr import hybrid_spmm
from gnn_computing_tpu_torch.ops.spmm import spmm_plain, spmm_transpose
from gnn_computing_tpu_torch.parallel.mesh import GRAPH_AXIS, Mesh, all_gather_rows, shard_ring_plan
from gnn_computing_tpu_torch.parallel.ring import gcn_layers
from gnn_computing_tpu_torch.schedule import make_plan
from gnn_computing_tpu_torch.schedule.plan import AggregationPlan
from gnn_computing_tpu_torch.schedule.tiles import TilePlan, densify, run_offsets, split_bit_tiles


@dataclasses.dataclass
class TileGroup:
    """One tile class (1-bit or int) bucketed per owner shard.

    a:   [D, T, R (/8 if bits), C]; row/col: int32[D, T].  row is LOCAL to
    the owner (tile_row % local row-tiles); col is GLOBAL (the kernel reads
    the gathered H), or shard-rebased for a ``local`` group.  Every owner
    is padded to the common T by extending its last destination run with
    zero tiles (col 0), as in the JAX package; a rank's device view
    (``AllGatherHybrid.shard``) leaves the all-zero tiles out.
    transposed: with_transpose builds, per owner, the host TilePlan of the
    transpose of the group's nonzero tiles, itself without all-zero tiles
    (the backward's plan).
    """

    a: np.ndarray
    row: np.ndarray
    col: np.ndarray
    tile_rows: int
    tile_cols: int
    pack: int
    bits: bool
    # every tile's source columns lie in the owner's own row shard: the
    # kernel reads h_local, with no data dependence on the all-gather
    local: bool = False
    transposed: Optional[tuple] = None

    def owner_plan(self, rank: int, shard_size: int, n_pad: int) -> TilePlan:
        """Owner ``rank``'s host TilePlan of the group's nonzero tiles, pack
        1.  The all-zero tiles (the per-owner padding and the coverage
        fillers, which the TPU kernel's fixed shapes need) are left out: the
        CUDA kernel takes any run length and writes zeros for an empty run,
        so they would only add work, all of it in the padded last run."""
        return _nonzero_tiles(TilePlan(
            a=self.a[rank], tile_col=self.col[rank], tile_row=self.row[rank],
            run_start=run_offsets(self.row[rank], shard_size // self.tile_rows), scale_dst=None, scale_src=None,
            num_nodes=shard_size, n_src=shard_size if self.local else n_pad, tile_rows=self.tile_rows,
            tile_cols=self.tile_cols, num_tiles=self.a.shape[1], num_dense_edges=0, pack=self.pack, bits=self.bits,
        ))


@dataclasses.dataclass
class AllGatherShard:
    """One rank's part of an AllGatherHybrid on its device: (TilePlan, its
    transpose or None, local) per group; the halo residual tasks ``res``
    (sources global) and the local ones ``lres`` (sources shard-rebased)."""

    groups: list
    res: AggregationPlan
    lres: Optional[AggregationPlan]
    shard_size: int
    n_pad: int


@dataclasses.dataclass
class AllGatherHybrid:
    """Row-sharded hybrid plan: tile groups + residual NG tasks per owner.

    rsrc: int32[D, NT*B] flat slot sources (GLOBAL ids); rval f32 same
    shape (0 in pad slots); rcnt/rdst int32[D, NT] (dst LOCAL).
    lsrc/lcnt/ldst/lval: the same layout for the LOCAL residual tasks
    (every source in the destination's own shard, shard-rebased), present
    when the plan was built with local_split.
    """

    groups: Tuple[TileGroup, ...]
    rsrc: np.ndarray
    rcnt: np.ndarray
    rdst: np.ndarray
    rval: np.ndarray
    num_devices: int
    shard_size: int
    n_pad: int
    block_size: int
    num_edges: int
    num_res_edges: int
    lsrc: Optional[np.ndarray] = None
    lcnt: Optional[np.ndarray] = None
    ldst: Optional[np.ndarray] = None
    lval: Optional[np.ndarray] = None

    def _res_plan(self, src, cnt, dst, val, rank: int, n_src: int, device) -> AggregationPlan:
        nt = cnt.shape[1]
        return AggregationPlan(
            src=src[rank].reshape(nt, self.block_size), count=cnt[rank], dst=dst[rank],
            val=val[rank].reshape(nt, self.block_size), edge_perm=None, num_nodes=self.shard_size, n_src=n_src,
            block_size=self.block_size, num_tasks=nt,
            num_edges=1,  # nonzero: pad tasks have value 0 and add zeros
            sorted_by_dst=True, partition_starts=(0, nt),
        ).to(device)

    def shard(self, rank: int, device) -> AllGatherShard:
        """Rank ``rank``'s part on ``device``: its groups' nonzero tiles
        (in their format) and transposes; a group without any is left out."""
        groups = []
        for grp in self.groups:
            tp = grp.owner_plan(rank, self.shard_size, self.n_pad)
            if not tp.num_tiles:
                continue
            tp_t = None if grp.transposed is None else grp.transposed[rank].to(device)
            groups.append((tp.to(device), tp_t, grp.local))
        lres = None
        if self.lsrc is not None:
            lres = self._res_plan(self.lsrc, self.lcnt, self.ldst, self.lval, rank, self.shard_size, device)
        return AllGatherShard(
            groups=groups, res=self._res_plan(self.rsrc, self.rcnt, self.rdst, self.rval, rank, self.n_pad, device),
            lres=lres, shard_size=self.shard_size, n_pad=self.n_pad,
        )

    def stats(self) -> dict:
        return {
            "num_devices": self.num_devices,
            "groups": [
                {"bits": g.bits, "local": g.local, "tiles_per_owner": int(g.a.shape[1]), "a_bytes": int(g.a.nbytes)}
                for g in self.groups
            ],
            "res_tasks_per_owner": int(self.rcnt.shape[1]),
            "local_res_tasks_per_owner": None if self.lcnt is None else int(self.lcnt.shape[1]),
            "num_res_edges": int(self.num_res_edges),
        }


def _nonzero_tiles(tp: TilePlan) -> TilePlan:
    """A host plan without its all-zero tiles, pack 1 (runs may become
    empty)."""
    a = np.asarray(tp.a)
    keep = a.reshape(a.shape[0], -1).any(axis=1)
    rows = np.asarray(tp.tile_row)[keep]
    return dataclasses.replace(
        tp, a=a[keep], tile_row=rows, tile_col=np.asarray(tp.tile_col)[keep],
        run_start=run_offsets(rows, tp.num_row_tiles), num_tiles=int(keep.sum()), pack=1,
    )


def _bucket_tiles_by_owner(tp: TilePlan, d: int, ns: int, pack: int):
    """TilePlan -> per-owner padded [D, T, ...] arrays (row made local)."""
    nrt_local = ns // tp.tile_rows
    rows = np.asarray(tp.tile_row)[: tp.num_tiles]
    cols = np.asarray(tp.tile_col)[: tp.num_tiles]
    a = np.asarray(tp.a)[: tp.num_tiles]
    owner = rows // nrt_local

    per_owner = []
    for dev in range(d):
        sel = np.flatnonzero(owner == dev)
        aa = a[sel]
        rr = (rows[sel] % nrt_local).astype(np.int32)
        cc = cols[sel].astype(np.int32)
        # local row coverage: a zero tile (col 0) for every local row-tile
        # without one
        missing = np.setdiff1d(np.arange(nrt_local, dtype=np.int32), rr)
        if len(missing):
            aa = np.concatenate([aa, np.zeros((len(missing),) + aa.shape[1:], aa.dtype)])
            rr = np.concatenate([rr, missing])
            cc = np.concatenate([cc, np.zeros(len(missing), np.int32)])
        order = np.argsort(rr, kind="stable")
        rr = rr[order]
        sub = dataclasses.replace(
            tp, a=aa[order], tile_row=rr, tile_col=cc[order], num_tiles=len(rr),
            run_start=run_offsets(rr, tp.num_row_tiles),
        ).pad_runs(pack)
        per_owner.append((np.asarray(sub.a), np.asarray(sub.tile_row), np.asarray(sub.tile_col)))

    t_max = max(x[0].shape[0] for x in per_owner)
    t_max = -(-t_max // pack) * pack
    arrs, rws, cls = [], [], []
    for aa, rr, cc in per_owner:
        padn = t_max - aa.shape[0]
        if padn:
            # extend the LAST run: same row, col 0, zero tiles (K-aligned, as
            # both t_max and every per-owner count are)
            aa = np.concatenate([aa, np.zeros((padn,) + aa.shape[1:], aa.dtype)])
            last_row = rr[-1] if len(rr) else np.int32(0)
            rr = np.concatenate([rr, np.full(padn, last_row, np.int32)])
            cc = np.concatenate([cc, np.zeros(padn, np.int32)])
        arrs.append(aa)
        rws.append(rr)
        cls.append(cc)
    return np.stack(arrs), np.stack(rws).astype(np.int32), np.stack(cls).astype(np.int32)


def build_allgather_hybrid(
    g: CSRGraph,
    num_devices: int,
    tile_rows: int = 256,
    tile_cols: int = 128,
    threshold: Optional[int] = None,
    residual_block: int = 4,
    tile_dtype=np.int8,
    bit_tiles: bool = True,
    pack: int = 8,
    val: Optional[np.ndarray] = None,
    local_split: bool = True,
    with_transpose: bool = False,
) -> Tuple[AllGatherHybrid, CSRGraph]:
    """(sharded hybrid plan, padded graph).  The graph pads so every shard
    is whole tiles; tiles bucket per owner; residual NG tasks bucket by
    destination shard.  ``local_split`` (default on) also splits each
    owner's tiles and residual tasks into LOCAL work (every source in the
    owner's own shard, read from h_local) and HALO work (needs the gathered
    buffer).  ``with_transpose`` adds each group's per-owner transposed
    tile plan, which the backward needs."""
    d = num_devices
    if val is None and g.val is not None:
        val = g.val
    unit = int(np.lcm(tile_rows, tile_cols))
    n_pad = -(-g.num_nodes // (d * unit)) * (d * unit)
    if n_pad != g.num_nodes:
        indptr = np.concatenate([g.indptr, np.full(n_pad - g.num_nodes, g.indptr[-1], np.int32)])
        g = CSRGraph(indptr=indptr, indices=g.indices, val=g.val, n_src=n_pad)
    ns = n_pad // d

    tp, res = densify(
        g, val=val, tile_rows=tile_rows, tile_cols=tile_cols, threshold=threshold,
        ensure_row_coverage=False,  # per-owner coverage added in bucketing
        dtype=tile_dtype,
    )
    assert tp.scale_dst is None and tp.scale_src is None
    parts = []
    if bit_tiles and np.issubdtype(np.dtype(tile_dtype), np.integer):
        bit_p, int_p = split_bit_tiles(dataclasses.replace(tp, pack=1))
        parts += [p for p in (bit_p, int_p) if p is not None]
    else:
        parts.append(tp)
    nrt_local = ns // tile_rows
    nct_local = ns // tile_cols

    def _split_local(p: TilePlan):
        """(local part with shard-rebased cols, halo part)."""
        rows = np.asarray(p.tile_row)[: p.num_tiles]
        cols = np.asarray(p.tile_col)[: p.num_tiles]
        owner = rows // nrt_local
        is_local = (cols // nct_local) == owner
        out = []
        for sel, loc in ((np.flatnonzero(is_local), True), (np.flatnonzero(~is_local), False)):
            cc = cols[sel]
            if loc:
                cc = cc - owner[sel] * nct_local
            out.append((dataclasses.replace(
                p, a=np.asarray(p.a)[sel], tile_row=rows[sel], tile_col=cc.astype(np.int32), num_tiles=len(sel),
                run_start=run_offsets(rows[sel], p.num_row_tiles),
            ), loc))
        return out

    groups = []
    for p in parts:
        for sub, loc in (_split_local(p) if local_split else [(p, False)]):
            a, row, col = _bucket_tiles_by_owner(sub, d, ns, pack)
            grp = TileGroup(a=a, row=row, col=col, tile_rows=tile_rows, tile_cols=tile_cols, pack=pack,
                            bits=p.bits, local=loc)
            if with_transpose:
                # the transpose's coverage fillers are all-zero tiles too
                grp.transposed = tuple(_nonzero_tiles(grp.owner_plan(r, ns, n_pad).transpose()) for r in range(d))
            groups.append(grp)

    # residual: NG tasks sorted by dst -> contiguous owner ranges
    rp = make_plan(res, "neighbor_grouping", block_size=residual_block)
    nt = rp.num_tasks
    dst = np.asarray(rp.dst)[:nt]
    src = np.asarray(rp.src)[:nt]
    cnt = np.asarray(rp.count)[:nt]
    b = rp.block_size
    slot_valid = np.arange(b)[None, :] < cnt[:, None]
    v = np.asarray(rp.val)[:nt] if rp.val is not None else slot_valid.astype(np.float32)
    bounds = np.searchsorted(dst, np.arange(d + 1) * ns)
    # task locality: every VALID slot's source in the destination's shard
    task_owner = dst // ns
    src_local = (src // ns) == task_owner[:, None]
    task_is_local = np.logical_or(src_local, ~slot_valid).all(axis=1)

    def _bucket_res(keep_mask, rebase):
        nt_max = 1
        picks = []
        for dev in range(d):
            lo, hi = bounds[dev], bounds[dev + 1]
            sel = np.flatnonzero(keep_mask[lo:hi]) + lo
            picks.append(sel)
            nt_max = max(nt_max, len(sel))
        s = np.zeros((d, nt_max, b), np.int32)
        vv = np.zeros((d, nt_max, b), np.float32)
        c = np.zeros((d, nt_max), np.int32)
        dd = np.zeros((d, nt_max), np.int32)
        for dev, sel in enumerate(picks):
            k = len(sel)
            ss = src[sel]
            if rebase:
                # pad slots may carry any global id: clamp into the shard so
                # rebased indices stay in range (value 0)
                ss = np.clip(ss - dev * ns, 0, ns - 1)
            s[dev, :k] = ss
            vv[dev, :k] = v[sel]
            c[dev, :k] = cnt[sel]
            dd[dev, :k] = (dst[sel] - dev * ns).astype(np.int32)
        return s.reshape(d, nt_max * b), c, dd, vv.reshape(d, nt_max * b)

    if local_split:
        rsrc, rcnt, rdst, rval = _bucket_res(~task_is_local, False)
        lsrc, lcnt, ldst, lval = _bucket_res(task_is_local, True)
    else:
        rsrc, rcnt, rdst, rval = _bucket_res(np.ones(len(dst), bool), False)
        lsrc = lcnt = ldst = lval = None

    plan = AllGatherHybrid(
        groups=tuple(groups), rsrc=rsrc, rcnt=rcnt, rdst=rdst, rval=rval, num_devices=d, shard_size=ns,
        n_pad=n_pad, block_size=b, num_edges=g.num_edges, num_res_edges=res.num_edges,
        lsrc=lsrc, lcnt=lcnt, ldst=ldst, lval=lval,
    )
    return plan, g


class _ResidualSpmm(torch.autograd.Function):
    """Residual tasks' sums; backward: the same tasks transposed."""

    @staticmethod
    def forward(ctx, h, plan, gather_dtype):
        ctx.plan = plan
        return spmm_plain(plan, h, gather_dtype=gather_dtype)

    @staticmethod
    def backward(ctx, ct):
        return spmm_transpose(ctx.plan, ct), None, None


def _local_allgather_hybrid(
    view: AllGatherShard, h_local: torch.Tensor, h_full: torch.Tensor, tile_h_mode: str = "auto",
    residual_gather_dtype=None,
) -> torch.Tensor:
    """One rank's body: B1 over each tile group (local groups on
    ``h_local``, halo groups on the gathered ``h_full``), then the local
    and the halo residual tasks."""
    parts = [
        hybrid_spmm(tp, None, h_local if local else h_full, tile_h_mode=tile_h_mode, tp_t=tp_t)
        for tp, tp_t, local in view.groups
    ]
    if view.lres is not None:
        parts.append(_ResidualSpmm.apply(h_local, view.lres, residual_gather_dtype))
    parts.append(_ResidualSpmm.apply(h_full, view.res, residual_gather_dtype))
    return sum(parts[1:], parts[0])


def allgather_hybrid_spmm(
    mesh: Mesh, plan, h_local: torch.Tensor, tile_h_mode: str = "auto", residual_gather_dtype=None
) -> torch.Tensor:
    """Distributed hybrid SpMM: ``h_local`` is this rank's [n_pad / D, f]
    rows; returns its rows of A @ H.  ``plan``: an AllGatherHybrid or this
    rank's AllGatherShard (shard once and reuse it: the kernels' work lists
    are cached under its tiles)."""
    if isinstance(plan, AllGatherHybrid):
        plan = shard_ring_plan(mesh, plan)
    h_full = all_gather_rows(mesh, h_local, GRAPH_AXIS)
    return _local_allgather_hybrid(plan, h_local, h_full, tile_h_mode, residual_gather_dtype)


def allgather_hybrid_spmm_bodies(
    views, h: torch.Tensor, tile_h_mode: str = "auto", residual_gather_dtype=None
) -> torch.Tensor:
    """The D rank bodies in one process: rank r gets its rows of ``h`` and
    ``h`` itself, which is what the all-gather gives it.  ``views``: the
    ranks' AllGatherShards in rank order."""
    ns = views[0].shard_size
    return torch.cat([
        _local_allgather_hybrid(v, h[r * ns : (r + 1) * ns], h, tile_h_mode, residual_gather_dtype)
        for r, v in enumerate(views)
    ])


def allgather_hybrid_gcn_forward(mesh: Mesh, plan, params, h_local: torch.Tensor, **kw) -> torch.Tensor:
    """Distributed 3-layer GCN: local transform (float32), all-gather hybrid
    aggregation, ReLU between layers."""
    if isinstance(plan, AllGatherHybrid):
        plan = shard_ring_plan(mesh, plan)
    return gcn_layers(lambda z: allgather_hybrid_spmm(mesh, plan, z, **kw), params, h_local)


def allgather_hybrid_gcn_forward_bodies(views, params, h: torch.Tensor, **kw) -> torch.Tensor:
    return gcn_layers(lambda z: allgather_hybrid_spmm_bodies(views, z, **kw), params, h)
