"""The program's spans on the device trace's clock: which ``gnn.*`` span of
the port launched each kernel and held each idle gap, and the per-layer
readings they give.

    python3 -m portbench.spans --workload <name> --seed <n>

runs a cell's set-up (``harness.prepare`` and ``harness.start``) with the
port's recorder on (``gnn_computing_tpu_torch.utils.profiling.recording``:
the plan build, the kernel builds, the first passes), then two traced
windows of ``harness.TRACE_STEPS`` passes, each as ``--trace 1`` takes its
own (``trace.capture``): the first with recording off, which is the
capture the harness reads, the second with recording on, whose trace holds
the spans as user annotations beside the kernels.  It logs the plan and
build spans' seconds, the host reads (``gnn.sync``) per pass by site, the
idle time per pass by the innermost span open at each gap's start, and the
recorder's on-cost (the second capture's busy and idle time against the
first's), and prints one JSON line with the readings of ``readings``.
It exits 2 without a card, or where the program has no recorder.

A kernel belongs to every span whose interval holds the runtime call that
launched it (matched by ``correlation``, as ``trace.step_of_kernels``
places kernels in steps), by time and not by thread: autograd launches the
backward's kernels from its own thread while the step's thread waits
inside ``gnn.backward``.  An idle gap belongs to every span open at its
start.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import sys
import time

from portbench import trace

PREFIX = "gnn."
RESIDUAL = ("gnn.agg.residual", "gnn.agg_t.residual", "gnn.gat.residual", "gnn.gat_t.residual")
# the per-layer name's suffix by the end-to-end metric the cell reports
SUFFIX = {"train_step_ms": "train", "gat_step_ms": "gat", "forward_ms": "forward"}


class _Intervals:
    """The union of a span's intervals, each [start, end), for point queries."""

    def __init__(self, intervals):
        merged = trace._union(intervals)
        self.starts = [s for s, _ in merged]
        self.ends = [e for _, e in merged]

    def holds(self, t: float) -> bool:
        k = bisect.bisect_right(self.starts, t) - 1
        return k >= 0 and t < self.ends[k]


@dataclasses.dataclass
class SpanSummary:
    steps: int
    device_s: dict  # span name -> device seconds of the kernels launched inside it, in the window
    idle_s: dict  # span name -> device idle seconds of the gaps that start inside it
    innermost_idle_s: dict  # the innermost span open at a gap's start ("none" outside all) -> idle seconds


def by_span(events) -> SpanSummary:
    """Device and idle seconds of each ``gnn.*`` span over the last window
    range of a trace (module doc)."""
    win = trace._ranges(events, trace.WINDOW)
    if not win:
        raise ValueError("the trace holds no window range")
    w0, w1 = win[-1].ts, win[-1].end
    notes = [e for e in events if e.cat == "user_annotation" and e.name.startswith(PREFIX)]
    spans = {}
    for e in notes:
        spans.setdefault(e.name, []).append((e.ts, e.end))
    spans = {k: _Intervals(v) for k, v in spans.items()}
    launch_ts = {e.corr: e.ts for e in events if e.cat in ("cuda_runtime", "cuda_driver") and e.corr is not None}
    dev = [e for e in events if e.cat in trace.DEVICE_CATS and e.end > w0 and e.ts < w1]
    device_s = dict.fromkeys(spans, 0.0)
    for e in dev:
        ts = launch_ts.get(e.corr)
        if ts is None:
            continue
        d = (min(e.end, w1) - max(e.ts, w0)) / 1e6
        for name, iv in spans.items():
            if iv.holds(ts):
                device_s[name] += d
    busy = trace._union((max(e.ts, w0), min(e.end, w1)) for e in dev)
    gaps, prev = [], w0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = e
    if w1 > prev:
        gaps.append((prev, w1))
    idle_s, innermost = dict.fromkeys(spans, 0.0), {}
    for s, e in gaps:
        d = (e - s) / 1e6
        for name, iv in spans.items():
            if iv.holds(s):
                idle_s[name] += d
        open_ = [n for n in notes if n.ts <= s < n.end]
        key = min(open_, key=lambda n: n.dur).name if open_ else "none"
        innermost[key] = innermost.get(key, 0.0) + d
    return SpanSummary(len(trace._ranges(events, trace.STEP)), device_s, idle_s, innermost)


def _span_seconds(spans, name: str):
    got = [s.seconds for s in spans if s.name == name and s.end_ns is not None]
    return sum(got) if got else None


def readings(suffix: str, summary: SpanSummary | None, setup_spans: list, counters: dict) -> dict:
    """The per-layer readings by name: ``<base>.<suffix>`` for the passes'
    ones (device ms per pass from ``summary``, the residual's occupancy
    from ``counters``), the plain base for the set-up's host seconds
    (``setup_spans``).  A reading whose spans or counters are missing is
    None."""
    out = {}
    dev = {} if summary is None else summary.device_s
    idle = {} if summary is None else summary.idle_s
    steps = 0 if summary is None else summary.steps

    def per_pass_ms(seconds, names):
        present = [n for n in names if n in seconds]
        return 1e3 * sum(seconds[n] for n in present) / steps if present and steps else None

    out[f"residual_ms.{suffix}"] = per_pass_ms(dev, RESIDUAL)
    out[f"bwd_ms.{suffix}"] = per_pass_ms(dev, ("gnn.backward",))
    out[f"opt_ms.{suffix}"] = per_pass_ms(dev, ("gnn.optimizer",))
    out[f"sync_idle_ms.{suffix}"] = per_pass_ms(idle, ("gnn.sync",))
    slots = counters.get("residual.slots")
    out[f"residual_occupancy.{suffix}"] = (100.0 * counters["residual.edges"] / slots
                                          if slots and "residual.edges" in counters else None)
    out["plan_densify_s"] = _span_seconds(setup_spans, "gnn.plan.densify")
    out["plan_transpose_s"] = _span_seconds(setup_spans, "gnn.plan.transpose")
    out["build_s"] = _span_seconds(setup_spans, "gnn.build")
    return out


def per_pass_by_site(spans: list) -> dict:
    """``gnn.sync`` spans per pass by their ``site``; a pass is a root span
    (``gnn.step``, or ``gnn.forward`` outside a step)."""
    passes = sum(1 for s in spans if s.parent is None and s.name in ("gnn.step", "gnn.forward"))
    sites = {}
    for s in spans:
        if s.name == "gnn.sync":
            site = s.attrs.get("site", "?")
            sites[site] = sites.get(site, 0) + 1
    return {k: v / passes for k, v in sites.items()} if passes else {}


def run(cell, seed: int, device, log=print) -> dict:
    """Set-up under the recorder, the two captures, and what they read."""
    import torch

    from gnn_computing_tpu_torch.utils import profiling
    from portbench import harness

    device = torch.device(device)
    t0 = time.perf_counter()
    with profiling.recording() as setup:
        s = harness.prepare(cell, seed, device)
        one, _ = harness.start(s)
        harness._sync(device)
    log(f"set-up {time.perf_counter() - t0:.3f} s (plan {s.plan_s:.3f} s), recorder on")
    plan = {}
    for sp in setup.spans:
        if sp.name.startswith(("gnn.plan.", "gnn.build")):
            plan[sp.name] = plan.get(sp.name, 0.0) + sp.seconds
    builds = [(sp.attrs.get("kernel"), sp.attrs.get("cached"), round(sp.seconds, 6))
              for sp in setup.spans if sp.name == "gnn.build"]
    log(f"plan and build spans (s): {plan}; builds (kernel, cached, s): {builds}")
    occupancy = {k: p.num_edges / (p.num_tasks_padded * p.block_size)
                 for k, p in (("plan", s.agg.plan), ("plan_t", s.agg.plan_t)) if p is not None and p.num_edges}
    log(f"residual plans' own num_edges / slots: {occupancy}")

    def sync():
        harness._sync(device)

    ev, agreed_off, _ = trace.capture(one, harness.TRACE_STEPS, harness.counters, sync)
    off = trace.summarize(ev)
    del ev
    with profiling.recording() as rec:
        ev, agreed_on, _ = trace.capture(one, harness.TRACE_STEPS, harness.counters, sync)
    on = trace.summarize(ev)
    summary = by_span(ev)
    del ev
    cost = {"busy_ms_per_pass": [1e3 * x.busy_s / x.steps for x in (off, on)],
            "idle_ms_per_pass": [1e3 * (x.window_s - x.busy_s) / x.steps for x in (off, on)],
            "window_ms_per_pass": [1e3 * x.window_s / x.steps for x in (off, on)],
            "launches_agree": [agreed_off, agreed_on]}
    log(f"recorder on-cost, [off, on]: {cost}")
    sites = per_pass_by_site(rec.spans)
    log(f"gnn.sync per pass by site: {sites}")
    idle_by = {k: 1e3 * v / summary.steps for k, v in summary.innermost_idle_s.items()}
    log(f"idle ms per pass by the innermost span at the gap's start: {idle_by}")
    dev_by = {k: 1e3 * v / summary.steps for k, v in summary.device_s.items()}
    log(f"device ms per pass launched inside each span: {dev_by}")
    suffix = next(SUFFIX[m["name"]] for m in cell.end_to_end if m["name"] in SUFFIX)
    read = readings(suffix, summary, setup.spans, rec.counters)
    return {"workload": cell.name, "seed": seed, "readings": read, "on_cost": cost, "plan_spans_s": plan,
            "residual_plans_occupancy": occupancy, "sync_per_pass": sites, "idle_ms_per_pass_by_span": idle_by,
            "device_ms_per_pass_by_span": dev_by, "counters": rec.counters}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)

    import torch

    from gnn_computing_tpu_torch.utils import profiling
    from portbench import spec
    from portbench.run import log, power_limit

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available():
        log(f"{args.workload} needs a CUDA card")
        return 2
    if not hasattr(profiling, "recording"):
        log("the program has no span recorder (utils.profiling.recording)")
        return 2
    result = run(cell, args.seed, "cuda", log=log)
    result["device"] = f"{torch.cuda.get_device_name(0)}; {power_limit()}"
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
