"""Profiling: the port's spans and counters, a trace context, analytic plan
and tile costs, a measured per-phase decomposition of a hybrid aggregation
pass, and the kernels' launch counts.

Port of ``gnn_computing_tpu/utils/profiling.py``.  ``span`` and ``count``
mark the program's layers where the work happens (the step's phases, the
tile part against the residual, the GAT's host reads, the plan build,
kernel builds); they record only inside ``recording()`` and cost one flag
check otherwise.  ``trace`` records a ``torch.profiler`` trace (the CPU
and, on a card, its CUDA activity) and writes it as a Chrome trace into
``logdir``; spans recorded under it stand there as user annotations on the
kernels' clock.  ``plan_cost`` and ``tile_cost`` return the JAX package's
dicts for the same plan.  ``decompose`` times the same phases with the
chained harness (utils.timing.benchmark_chained): on the card ``dense``
launches B1 (GCN) or B2 (GAT) over the aggregator's tile parts.
``launch_counts`` gathers the ops' launch counters into one table.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
import threading
import time
from typing import TYPE_CHECKING, Optional

import torch

if TYPE_CHECKING:  # the plan modules import graph/, whose spans import this module
    from gnn_computing_tpu_torch.schedule.plan import AggregationPlan
    from gnn_computing_tpu_torch.schedule.tiles import TilePlan


# ------------------------------------------------------ spans and counters
@dataclasses.dataclass
class Span:
    """One recorded span: ``parent`` and the list indices are positions in
    its recording's ``spans``; times are ``time.perf_counter_ns``."""

    name: str
    start_ns: int
    end_ns: Optional[int]  # None while it is open
    parent: Optional[int]
    step: int
    attrs: dict

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class Recording:
    """What one ``recording()`` kept: its spans in the order they opened
    and its counters.

    A span's parent is the span open below it on its thread.  A span opened
    on a thread with none open (autograd's device thread, running a
    backward the main thread waits on) joins the open step: its parent is
    the innermost span open on the thread that opened that step, and it
    takes the step's id.  A span opened while no step is open starts the
    next step."""

    def __init__(self):
        self.spans: list = []
        self.counters: dict = {}
        self._lock = threading.Lock()
        self._local = threading.local()
        self._step = 0
        self._step_stack: list = []  # the open stack of the thread that opened the current step

    def _open(self, name: str, attrs: dict) -> int:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        with self._lock:
            if stack:
                parent = stack[-1]
                step = self.spans[parent].step
            elif self._step_stack:
                parent = self._step_stack[-1]
                step = self._step
            else:
                parent = None
                self._step += 1
                step = self._step
                self._step_stack = stack
            idx = len(self.spans)
            self.spans.append(Span(name, time.perf_counter_ns(), None, parent, step, attrs))
        stack.append(idx)
        return idx

    def _close(self, idx: int):
        self.spans[idx].end_ns = time.perf_counter_ns()
        self._local.stack.pop()


class _Span:
    __slots__ = ("rec", "name", "attrs", "idx", "annotation")

    def __init__(self, rec: Recording, name: str, attrs: dict):
        self.rec, self.name, self.attrs = rec, name, attrs

    def __enter__(self):
        self.annotation = None
        if torch.autograd._profiler_enabled():  # the span on the profiler's (and the kernels') timeline
            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
        self.idx = self.rec._open(self.name, self.attrs)

    def __exit__(self, *exc):
        self.rec._close(self.idx)
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        return False


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()
_recording: Optional[Recording] = None  # None: tracing is off
_last: Optional[Recording] = None


def span(name: str, **attrs):
    """``with span("gnn.agg.residual"): ...`` records the block as a span
    (name, start and end, parent, step id, ``attrs``) while a
    ``recording()`` is open, and then, under an active ``torch.profiler``
    profile, also as a ``record_function`` of the same name.  Otherwise it
    returns a shared no-op context: one flag check, no clock read."""
    if _recording is None:
        return _NO_SPAN
    return _Span(_recording, name, attrs)


def count(name: str, n: int):
    """Add ``n`` to the counter ``name`` while a ``recording()`` is open."""
    rec = _recording
    if rec is not None:
        with rec._lock:
            rec.counters[name] = rec.counters.get(name, 0) + n


@contextlib.contextmanager
def recording():
    """Turn spans and counters on for the block; yields the Recording.
    Nothing is written to disk."""
    global _recording, _last
    if _recording is not None:
        raise RuntimeError("a recording is already open")
    rec = Recording()
    _recording = rec
    try:
        yield rec
    finally:
        _recording = None
        _last = rec


def _current() -> Optional[Recording]:
    return _recording if _recording is not None else _last


def spans() -> list:
    """The spans of the open recording, or else of the last one closed."""
    rec = _current()
    return [] if rec is None else list(rec.spans)


def counters() -> dict:
    """The counters of the open recording, or else of the last one closed."""
    rec = _current()
    return {} if rec is None else dict(rec.counters)


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """``with trace(dir): run_step()`` records a torch.profiler trace of the
    block (CPU activity, and CUDA activity where a card is present) and
    writes it into ``logdir`` (default: ``gnn_torch_trace`` under the
    temporary directory) as ``<ms since epoch>.pt.trace.json``, viewable in
    chrome://tracing or Perfetto.  Under ``recording()`` the program's spans
    are in it as user annotations.  Yields ``logdir``."""
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


def launch_counts() -> dict:
    """Every kernel's launches so far, as the ops' wrappers count them: B1-B6,
    B2's 'twodot' and 'merged' kernel apart (B2's 'default' launches are
    among B2's), the hybrid op's residual kernel R1, and the probe kernels
    P1 and P2."""
    from gnn_computing_tpu_torch.ops import cuda_bcsr, cuda_gat, cuda_gat_bwd, cuda_residual, cuda_rowmax, cuda_sddmm

    return dict(
        B1=cuda_bcsr.launches, B2=cuda_gat.launches, B3=cuda_gat_bwd.dad_launches,
        B4=cuda_gat_bwd.dh_das_launches, B5=cuda_rowmax.launches, B6=cuda_sddmm.launches,
        B2_twodot=cuda_gat.twodot_launches, B2_merged=cuda_gat.merged_launches,
        R1=cuda_residual.launches, P1=cuda_residual.task_sums_launches, P2=cuda_residual.fused_launches,
    )
