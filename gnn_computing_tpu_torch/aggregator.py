"""Aggregator: the user-facing handle bundling a scheduled graph.

Port of ``gnn_computing_tpu/aggregator.py``.  ``schedule`` builds a
gather-only aggregator: a plan of one of the reference's four schedules
(schedule.make_plan: neighbor grouping, locality, locality + neighbor
grouping, nop) and, with ``with_transpose=True`` (the default), the same
schedule of the transposed graph and its edge map, which the backward of
``run`` aggregates over (ops.spmm.spmm_bidir).  ``run`` is the SpMM,
``run_gat`` the fused GAT (ops.gat.gat_aggregate), ``run_sddmm`` the
SDDMM, all plain PyTorch: the JAX package has no kernel on this path.

``schedule_hybrid`` builds the hybrid one: dense adjacency tiles
(schedule.tiles; float32 edge values by default, as in the JAX package,
or int8 counts or bfloat16 values) plus a neighbor-grouping plan for the
residual edges, run by ops.bcsr.hybrid_spmm (``run``) and
ops.bcsr_gat.hybrid_gat (``run_gat``) over the hand-written kernels.
``with_transpose=True`` (the default, as in the JAX package) adds the
transposed tile plan, the transposed residual plan and the edge map that
the ops' backwards stream.
``bit_tiles=True`` splits int8 count tiles into a 1-bit part (``tile_bits``)
and an int8 part (``tile``); with ``with_transpose=True`` each part gets its own
transposed plan (``tile_bits_t``, ``tile_t``), the configuration of bench.py
``--train``.  Every tile kernel reads all four tile formats (int8,
1-bit, float32, bfloat16).  Unlike the JAX package,
a transposed 1-bit part stays 1-bit whatever its R: the JAX package unpacks
it below R = 256, the minimum int8 sublane tile of its Mosaic kernel; the
CUDA kernels need only R % 8 == 0.  Both store the same counts, so the
function is the same.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from gnn_computing_tpu_torch.device import resolve_device
from gnn_computing_tpu_torch.graph.csr import CSRGraph
from gnn_computing_tpu_torch.ops.bcsr import hybrid_spmm
from gnn_computing_tpu_torch.ops.bcsr_gat import hybrid_gat
from gnn_computing_tpu_torch.ops.gat import DEFAULT_SLOPE, gat_aggregate
from gnn_computing_tpu_torch.ops.sddmm import sddmm
from gnn_computing_tpu_torch.ops.spmm import slots_from_edge_values, spmm, spmm_bidir
from gnn_computing_tpu_torch.schedule import Schedule, make_plan
from gnn_computing_tpu_torch.schedule.neighbor_grouping import neighbor_grouping_plan
from gnn_computing_tpu_torch.schedule.plan import AggregationPlan
from gnn_computing_tpu_torch.schedule.tiles import TilePlan, densify, split_bit_tiles, tile_format
from gnn_computing_tpu_torch.utils.profiling import span


@dataclasses.dataclass
class Aggregator:
    plan: AggregationPlan  # every edge (schedule) or the residual edges (schedule_hybrid)
    num_nodes: int
    n_src: int
    num_edges: int
    tile: Optional[TilePlan] = None
    # transposed plans for the backward (with_transpose=True)
    tile_t: Optional[TilePlan] = None
    plan_t: Optional[AggregationPlan] = None
    edge_map_t: Optional[object] = None  # plan_t's graph edge -> plan's graph edge
    tile_bits: Optional[TilePlan] = None  # 1-bit part (bit_tiles=True)
    tile_bits_t: Optional[TilePlan] = None  # its transposed plan (with_transpose=True)
    in_degree: Optional[object] = None  # int32 [n]: every row's in-edges (tiles and residual)

    def tile_parts(self) -> tuple:
        """The non-empty tile parts: the 1-bit part first, as in the JAX
        package."""
        return tuple(p for p in (self.tile_bits, self.tile) if p is not None and p.num_tiles)

    def tile_parts_t(self) -> tuple:
        """The non-empty transposed tile parts, the 1-bit part first."""
        return tuple(p for p in (self.tile_bits_t, self.tile_t) if p is not None and p.num_tiles)

    @classmethod
    def schedule(
        cls,
        g: CSRGraph,
        schedule=Schedule.neighbor_grouping,
        with_transpose: bool = True,
        device="cuda",
        **kw,
    ) -> "Aggregator":
        """A gather-only aggregator: ``make_plan(g, schedule, **kw)`` and,
        with ``with_transpose``, the same schedule of the transposed graph
        with its edge map (transposed edge i is edge edge_map_t[i]), placed
        on ``device``."""
        dev = resolve_device(device)
        plan = make_plan(g, schedule, **kw)
        plan_t = edge_map = None
        if with_transpose:
            gt, edge_map = g.transpose_with_map()
            plan_t = make_plan(gt, schedule, **kw)
            edge_map = edge_map.astype(np.int32)
        agg = cls(plan=plan, num_nodes=g.num_nodes, n_src=g.n_src, num_edges=g.num_edges, plan_t=plan_t,
                  edge_map_t=edge_map)
        return agg.to(dev)

    @classmethod
    def schedule_hybrid(
        cls,
        g: CSRGraph,
        val=None,
        tile_rows: int = 256,
        tile_cols: int = 128,
        threshold: Optional[int] = None,
        residual_block: int = 8,
        tile_dtype=None,
        with_transpose: bool = True,
        pack: int = 8,
        bit_tiles: bool = False,
        device="cuda",
        **densify_kw,
    ) -> "Aggregator":
        """Dense tiles of ``tile_dtype`` (None: float32 edge values; np.int8:
        edge counts; torch.bfloat16) + a neighbor-grouping plan (block
        ``residual_block``) for the edges left outside them, placed on
        ``device``.  ``pack`` pads tile-row runs to a multiple of that many
        tiles as the TPU kernel needs; the CUDA kernel takes any run length,
        so ``pack=1`` saves the filler tiles there.  ``with_transpose``
        also builds what the backward streams: the transposed tile plan
        (from the unpadded plan, then padded), a neighbor-grouping plan of
        the transposed residual with the same block, and its edge map.
        ``bit_tiles`` splits int8 count tiles by content (split_bit_tiles)
        before padding each part, and each part is transposed on its own;
        it raises ValueError over float tiles, as the JAX package asserts.

        Spans (recorded under utils.profiling.recording): ``gnn.plan.densify``,
        ``gnn.plan.split_bits``, ``gnn.plan.residual`` (each residual plan),
        ``gnn.plan.transpose`` (each tile part's and the residual's),
        ``gnn.plan.pad`` (the padding of every part) and
        ``gnn.plan.to_device``."""
        dev = resolve_device(device)
        if bit_tiles and tile_format(tile_dtype) != "int8":
            raise ValueError("bit_tiles needs integer count tiles (tile_dtype=np.int8)")
        with span("gnn.plan.densify"):
            tile, res = densify(
                g, val=val, tile_rows=tile_rows, tile_cols=tile_cols,
                threshold=threshold, dtype=tile_dtype, **densify_kw,
            )
        tile_b = None
        if bit_tiles:
            with span("gnn.plan.split_bits"):
                tile_b, tile = split_bit_tiles(tile)
        with span("gnn.plan.residual"):
            plan = neighbor_grouping_plan(res, block_size=residual_block)
        tile_t = tile_bt = plan_t = edge_map = None
        if with_transpose:
            with span("gnn.plan.transpose"):
                tile_t = None if tile is None else tile.transpose()
                tile_bt = None if tile_b is None else tile_b.transpose()
                gt, edge_map = res.transpose_with_map()
            with span("gnn.plan.residual"):
                plan_t = neighbor_grouping_plan(gt, block_size=residual_block)
            edge_map = edge_map.astype(np.int32)
        with span("gnn.plan.pad"):
            tile, tile_b, tile_t, tile_bt = (None if p is None else p.pad_runs(pack)
                                             for p in (tile, tile_b, tile_t, tile_bt))
        agg = cls(
            plan=plan,
            num_nodes=g.num_nodes,
            n_src=g.n_src,
            num_edges=g.num_edges,
            tile=tile,
            tile_t=tile_t,
            plan_t=plan_t,
            edge_map_t=edge_map,
            tile_bits=tile_b,
            tile_bits_t=tile_bt,
            in_degree=g.degrees,
        )
        with span("gnn.plan.to_device"):
            return agg.to(dev)

    def to(self, device) -> "Aggregator":
        dev = resolve_device(device)

        def put(x):
            return None if x is None else x.to(dev)

        return dataclasses.replace(
            self,
            plan=self.plan.to(dev),
            tile=put(self.tile),
            tile_t=put(self.tile_t),
            plan_t=put(self.plan_t),
            edge_map_t=None if self.edge_map_t is None else torch.as_tensor(self.edge_map_t).to(dev, torch.int64),
            tile_bits=put(self.tile_bits),
            tile_bits_t=put(self.tile_bits_t),
            in_degree=None if self.in_degree is None else torch.as_tensor(self.in_degree).to(dev, torch.int32),
        )

    def _plans_t(self):
        """(transposed tile parts or None, transposed residual plan or None)
        for the ops' backwards."""
        plan_t = self.plan_t if self.plan_t is not None and self.plan_t.num_edges else None
        return self.tile_parts_t() or None, plan_t

    def slot_values(self, edge_val: torch.Tensor) -> torch.Tensor:
        """Per-edge values (CSR edge order) -> the forward plan's
        [num_tasks_p, B] slots."""
        return slots_from_edge_values(self.plan, edge_val)

    def transposed_val(self, edge_val: torch.Tensor) -> torch.Tensor:
        """Per-edge values (CSR edge order) -> the transposed plan's slots."""
        if self.plan_t is None:
            raise ValueError("the aggregator has no transposed plan (with_transpose=False)")
        return slots_from_edge_values(self.plan_t, edge_val[self.edge_map_t])

    def run(
        self,
        h: torch.Tensor,
        residual_gather_dtype=None,
        tile_h_mode: str = "auto",
        *,
        val=None,
        val_t=None,
        strategy: str = "auto",
    ) -> torch.Tensor:
        """Weighted aggregation out = A @ h.  Over tiles + residual (the
        hybrid op, edge values inside the plans: ``val`` raises); without
        tiles over the gather plan, ``val`` / ``val_t`` slot values
        overriding the plans' (``val_t`` needed beside ``val`` for the
        transposed backward; the gather modes are not used there, as in the
        JAX package).  Differentiable in h (and ``val``) when the
        aggregator holds transposed plans; a gather plan without them
        differentiates through autograd's scatter."""
        tps = self.tile_parts()
        if tps:
            if val is not None or val_t is not None:
                raise ValueError("hybrid aggregators carry edge values inside their plans")
            plan = self.plan if self.plan.num_edges else None
            tp_t, plan_t = self._plans_t()
            return hybrid_spmm(tps, plan, h, residual_gather_dtype, tile_h_mode, tp_t=tp_t, plan_t=plan_t)
        if self.plan_t is not None:
            if val is None and self.plan_t.val is not None:
                return spmm_bidir(self.plan, self.plan_t, h)
            if val is not None and val_t is not None:
                return spmm_bidir(self.plan, self.plan_t, h, val, val_t)
        return spmm(self.plan, h, val=val, strategy=strategy)

    def run_transpose(self, g_out: torch.Tensor, val_t=None) -> torch.Tensor:
        """Aggregation over the reversed graph (dH-style products)."""
        if self.plan_t is None:
            raise ValueError("the aggregator has no transposed plan (with_transpose=False)")
        return spmm(self.plan_t, g_out, val=val_t)

    def run_sddmm(self, a: torch.Tensor, b: torch.Tensor, output: str = "edges") -> torch.Tensor:
        """Per-edge dots <a[src], b[dst]> over the forward plan (ops.sddmm)."""
        return sddmm(self.plan, a, b, output=output)

    def run_gat(
        self,
        h: torch.Tensor,
        att: torch.Tensor,
        relu_slope: float = DEFAULT_SLOPE,
        stabilize=False,
        att_gather_dtype=None,
        h_gather_dtype=None,
        dot_mode: str = "exact",
    ) -> torch.Tensor:
        """Fused GAT attention aggregation (softmax over each row's in-edges
        of exp(leaky_relu(att[dst, 0] + att[src, 1])), weighting h) over the
        tiles + residual (ops.bcsr_gat.hybrid_gat; differentiable in (h,
        att) when the aggregator holds transposed plans) or, without tiles,
        over the gather plan (ops.gat.gat_aggregate, through autograd; the
        gather modes and ``dot_mode`` are not used there, as in the JAX
        package)."""
        tps = self.tile_parts()
        if not tps:
            return gat_aggregate(self.plan, h, att, relu_slope=relu_slope, stabilize=stabilize)
        plan = self.plan if self.plan.num_edges else None
        tp_t, plan_t = self._plans_t()
        return hybrid_gat(
            tps, plan, h, att, relu_slope=relu_slope,
            att_gather_dtype=att_gather_dtype, h_gather_dtype=h_gather_dtype,
            stabilize=stabilize, dot_mode=dot_mode,
            tp_t=tp_t, plan_t=plan_t, edge_map_t=self.edge_map_t,
            has_edges=None if self.in_degree is None else self.in_degree > 0,
        )
