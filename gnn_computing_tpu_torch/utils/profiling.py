"""Profiling: a trace context, analytic plan and tile costs, and a measured
per-phase decomposition of a hybrid aggregation pass.

Port of ``gnn_computing_tpu/utils/profiling.py``.  ``trace`` records a
``torch.profiler`` trace (the CPU and, on a card, its CUDA activity) and
writes it as a Chrome trace into ``logdir``.  ``plan_cost`` and
``tile_cost`` return the JAX package's dicts for the same plan.
``decompose`` times the same phases with the chained harness
(utils.timing.benchmark_chained): on the card ``dense`` launches B1 (GCN)
or B2 (GAT) over the aggregator's tile parts.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Optional

import torch

from gnn_computing_tpu_torch.schedule.plan import AggregationPlan
from gnn_computing_tpu_torch.schedule.tiles import TilePlan


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """``with trace(dir): run_step()`` records a torch.profiler trace of the
    block (CPU activity, and CUDA activity where a card is present) and
    writes it into ``logdir`` (default: ``gnn_torch_trace`` under the
    temporary directory) as ``<ms since epoch>.pt.trace.json``, viewable in
    chrome://tracing or Perfetto.  Yields ``logdir``."""
    if logdir is None:
        logdir = os.path.join(tempfile.gettempdir(), "gnn_torch_trace")
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield logdir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, f"{int(time.time() * 1e3)}.pt.trace.json"))


def plan_cost(plan: AggregationPlan, feature_len: int, dtype_bytes: int = 4) -> dict:
    """Analytic per-pass cost of the gather strategy on a plan; every issued
    slot (pads included) counts in ``bytes_gathered``."""
    slots = plan.num_tasks_padded * plan.block_size
    row_bytes = feature_len * dtype_bytes
    return {
        "slots_issued": int(slots),
        "valid_edges": int(plan.num_edges),
        "slot_occupancy": plan.num_edges / max(slots, 1),
        "bytes_gathered": int(slots) * row_bytes,
        "bytes_output": plan.num_nodes * row_bytes,
        "flops": 2 * plan.num_edges * feature_len,
    }


def tile_cost(tp: TilePlan, feature_len: int, h_bytes_per_elem: int = 2) -> dict:
    """Analytic per-pass cost of the dense-tile strategy: the A-tile stream,
    one H tile per tile, one output-tile write per run."""
    a = torch.as_tensor(tp.a)
    a_bytes = a.numel() * a.element_size()
    t = a.shape[0]
    h_tile_bytes = tp.tile_cols * feature_len * h_bytes_per_elem
    runs = len(torch.as_tensor(tp.tile_row[: tp.num_tiles]).unique()) or 1
    return {
        "num_tiles": int(t),
        "a_bytes": a_bytes,
        "h_bytes": int(t) * h_tile_bytes,
        "out_bytes": runs * tp.tile_rows * feature_len * 4,
        "flops_mxu": 2 * int(t) * tp.tile_rows * tp.tile_cols * feature_len,
        "edges_covered": int(tp.num_dense_edges),
        "bytes_per_edge": (a_bytes + t * h_tile_bytes) / max(tp.num_dense_edges, 1),
    }


def decompose(
    agg,
    h,
    model: str = "gcn",
    att=None,
    tile_h_mode: str = "auto",
    residual_gather_dtype=None,
    transform_out: Optional[int] = None,
    iters: int = 8,
    reps: int = 3,
) -> dict:
    """Measured per-phase decomposition of a hybrid aggregation pass on the
    device of ``h`` (a tensor on the aggregator's device), each phase timed
    by the chained harness:

      dense          — the tile pass: ops.bcsr.bcsr_spmm (GCN) or
                       ops.bcsr_gat.gat_bcsr's num (GAT) over the tile parts
      residual       — the residual pipeline: ops.spmm.spmm_plain (GCN,
                       ``residual_gather_dtype``) or the GAT residual's num
                       (ops.gat.gat_aggregate_parts)
      residual_floor — index_select of h by the residual's slot sources,
                       summed: the random-row gather alone
      transform      — [n, f] @ [f, f_out] float32 matmul, TF32 off
      total          — the whole hybrid pass, agg.run (GCN only)

    Returns {phase: {"ms", "noise_floor"}} plus "analytic": plan_cost of
    the residual plan and tile_cost of each tile part."""
    from gnn_computing_tpu_torch.utils.timing import benchmark_chained

    h = torch.as_tensor(h)
    f = h.shape[-1]
    out = {}

    def measure(name, fn, *args):
        r = benchmark_chained(fn, h, *args, iters=iters, reps=reps)
        out[name] = {"ms": r.min_s * 1e3, "noise_floor": bool(r.noise_floor)}

    tps = agg.tile_parts()
    if model == "gat":
        if att is None:
            raise ValueError("the GAT decomposition needs att [n, 2]")
        att = torch.as_tensor(att, device=h.device)
    if tps:
        from gnn_computing_tpu_torch.ops.bcsr import bcsr_spmm

        if model == "gat":
            from gnn_computing_tpu_torch.ops.bcsr_gat import gat_bcsr

            measure("dense", lambda hh, t, a: gat_bcsr(t, hh, a)[0], tps, att)
        else:
            measure("dense", lambda hh, t: bcsr_spmm(t, hh, h_mode=tile_h_mode), tps)
    plan = agg.plan if agg.plan is not None and agg.plan.num_edges else None
    if plan is not None:
        if model == "gat":
            from gnn_computing_tpu_torch.ops.gat import gat_aggregate_parts

            measure("residual", lambda hh, p, a: gat_aggregate_parts(p, hh, a)[0], plan, att)
        else:
            from gnn_computing_tpu_torch.ops.spmm import spmm_plain

            measure("residual", lambda hh, p: spmm_plain(p, hh, gather_dtype=residual_gather_dtype), plan)
        measure("residual_floor", lambda hh, s: hh.index_select(0, s).sum(dim=0), plan.src_flat())
    gen = torch.Generator(device=h.device).manual_seed(0)
    w = torch.randn((f, transform_out or f), generator=gen, device=h.device, dtype=h.dtype) * 0.1
    measure("transform", lambda hh, ww: hh @ ww, w)
    if tps and model == "gcn":
        measure("total", lambda hh, a: a.run(hh, tile_h_mode=tile_h_mode), agg)
    out["analytic"] = {
        "plan": plan_cost(plan, f) if plan is not None else None,
        "tile": [tile_cost(t, f) for t in tps] or None,
    }
    return out
