"""The traced window: torch.profiler over a few steps, read back as plain events.

``capture`` profiles (CPU and CUDA activities) a short steady window after
the measured one, bounded by two ``synchronize()`` calls, with a
``portbench.step`` range around each step (one step before the window,
inside the profile, takes the profiler's start-up costs), and reads the
exported Chrome trace back as ``Event``s.  A profile has been seen to drop a kernel's
records, so each profile is checked against the ops' launch counters over
the same steps (``launches_agree``) and taken again, up to three times,
when they disagree.

Device operations are classed by name: GEMM (cuBLAS, cuDNN, CUTLASS),
ATen (ATen's kernels and the helpers it launches: cub, thrust; memcpy and
memset), and by exclusion the port's kernels, so that a kernel a later
change adds is the port's without an edit here.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import tempfile

WINDOW = "portbench.window"
STEP = "portbench.step"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
GEMM = re.compile(
    r"gemm|gemv|cublas|cudnn|cutlass|xmma|splitKreduce|dot_kernel|reduce_1Block|scal_kernel|axpy_kernel|nrm2"
    r"|asum_kernel|^(sm\d\d|ampere|hopper|volta|turing)_", re.I)
ATEN = re.compile(r"at::native|at_cuda_detail|at::cuda|c10::|cub::|thrust::|^Memcpy|^Memset", re.I)


@dataclasses.dataclass(frozen=True)
class Event:
    name: str
    cat: str
    ts: float  # microseconds
    dur: float
    corr: int | None = None

    @property
    def end(self) -> float:
        return self.ts + self.dur


def kernel_class(e: Event) -> str:
    """'gemm', 'aten' or 'port' for a device event."""
    if e.cat != "kernel":
        return "aten"
    name = e.name.removeprefix("void ")
    if GEMM.search(name):
        return "gemm"
    if ATEN.search(name):
        return "aten"
    return "port"


def short_name(name: str) -> str:
    """'void (anonymous namespace)::walk_kernel<Int8Tiles>(...)' -> 'walk_kernel'."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return name.split("<")[0].split("(")[0].split("::")[-1] or name[:60]


def read_chrome_trace(path: str) -> list:
    with open(path) as f:
        raw = json.load(f)
    out = []
    for e in raw.get("traceEvents", []):
        if e.get("ph") != "X" or "dur" not in e:
            continue
        args = e.get("args") or {}
        corr = args.get("correlation")
        out.append(Event(str(e.get("name", "")), str(e.get("cat", "")), float(e["ts"]), float(e["dur"]),
                         None if corr is None else int(corr)))
    return out


def _ranges(events, name: str) -> list:
    return sorted((e for e in events if e.cat == "user_annotation" and e.name == name), key=lambda e: e.ts)


def step_of_kernels(events) -> list:
    """Per traced step, the port's kernels launched in it (each device
    kernel placed by the runtime call that launched it)."""
    steps = _ranges(events, STEP)
    launch_ts = {e.corr: e.ts for e in events if e.cat in ("cuda_runtime", "cuda_driver") and e.corr is not None}
    counts = [0] * len(steps)
    for e in events:
        if e.cat != "kernel" or kernel_class(e) != "port":
            continue
        ts = launch_ts.get(e.corr)
        for k, s in enumerate(steps):
            if ts is not None and s.ts <= ts <= s.end:
                counts[k] += 1
                break
    return counts


def launches_agree(events, counted: list) -> bool:
    """Whether the trace holds every launch the ops counted: in each step
    at least as many of the port's kernels as the counters moved, and the
    same number in steps whose counters moved alike."""
    seen = step_of_kernels(events)
    if len(seen) != len(counted):
        return False
    by_count = {}
    for s, c in zip(seen, counted):
        if s < c or by_count.setdefault(c, s) != s:
            return False
    return True


def capture(run_step, steps: int, counters, sync, tries: int = 3):
    """(events, agreed, moved): profile ``steps`` calls of ``run_step()``;
    ``counters()`` gives the ops' launch counters by kernel, and ``moved``
    how far each moved over the profile kept."""
    from torch.profiler import ProfilerActivity, profile, record_function

    for _ in range(tries):
        counted = []
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run_step()  # outside the window: the profiler's own start-up lands here
            sync()
            start = counters()
            with record_function(WINDOW):
                for _ in range(steps):
                    before = sum(counters().values())
                    with record_function(STEP):
                        run_step()
                    counted.append(sum(counters().values()) - before)
                sync()
        moved = {k: v - start[k] for k, v in counters().items() if v != start[k]}
        with tempfile.TemporaryDirectory(prefix="portbench-trace-") as d:
            path = os.path.join(d, "trace.json")
            prof.export_chrome_trace(path)
            del prof
            events = read_chrome_trace(path)
        agreed = launches_agree(events, counted)
        if agreed:
            break
    return events, agreed, moved


def _union(intervals) -> list:
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    steps: int
    class_s: dict  # 'gemm' / 'aten' / 'port' -> device seconds in the window
    device_ops: list  # [[short name, seconds]], the 10 largest
    idle_gaps: list  # [[host op running at its middle, seconds]], the 10 longest gaps

    @property
    def idle_share(self) -> float:
        return max(0.0, 1.0 - self.busy_s / self.window_s)


def summarize(events) -> Summary:
    """Device time by class and by operation, busy and idle time, within
    the window range."""
    win = _ranges(events, WINDOW)
    if not win:
        raise ValueError("the trace holds no window range")
    w0, w1 = win[-1].ts, win[-1].end
    dev = [e for e in events if e.cat in DEVICE_CATS and e.end > w0 and e.ts < w1]
    class_s, by_name = {"gemm": 0.0, "aten": 0.0, "port": 0.0}, {}
    for e in dev:
        d = (min(e.end, w1) - max(e.ts, w0)) / 1e6
        class_s[kernel_class(e)] += d
        key = short_name(e.name)
        by_name[key] = by_name.get(key, 0.0) + d
    busy = _union((max(e.ts, w0), min(e.end, w1)) for e in dev)
    busy_s = sum(e - s for s, e in busy) / 1e6
    gaps, prev = [], w0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = e
    if w1 > prev:
        gaps.append((prev, w1))
    host = [e for e in events if e.cat in ("cpu_op", "cuda_runtime", "cuda_driver")
            or (e.cat == "user_annotation" and not e.name.startswith("portbench."))]
    idle_gaps = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = (s + e) / 2
        running = [h for h in host if h.ts <= mid <= h.end]
        label = min(running, key=lambda h: h.dur).name if running else "no host op (Python)"
        idle_gaps.append([label, (e - s) / 1e6])
    device_ops = [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]]
    return Summary(window_s=(w1 - w0) / 1e6, busy_s=busy_s, steps=len(_ranges(events, STEP)), class_s=class_s,
                   device_ops=device_ops, idle_gaps=idle_gaps)
