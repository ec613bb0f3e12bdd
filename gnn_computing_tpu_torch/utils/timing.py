"""Kernel and step timing on the card: CUDA events (a call's host-side
launch included) and the profiler's device time alone."""

from __future__ import annotations

import statistics
from typing import Callable, Dict, Optional

import torch


def cuda_time_ms(fn: Callable[[], object], warmup: int = 3, iters: int = 10) -> float:
    """Median milliseconds of ``fn()`` on the current CUDA stream: ``warmup``
    discarded calls, then ``iters`` calls each between two events.  Raises
    without a card: a time taken on the CPU is not a device time."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_time_ms needs a CUDA device")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn: Callable[[], object], iters: int = 10, expect=(), tries: int = 3) -> Optional[Dict[str, float]]:
    """{kernel: mean device ms a call} of the CUDA kernels ``fn`` launches,
    from torch.profiler over ``iters`` calls after one warm-up, with their
    sum under "all"; None where the profiler saw no device time, or missed
    a kernel named in ``expect`` in each of ``tries`` profiles (one profile
    has been seen to drop a kernel's records).  Raises without a card."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_ms needs a CUDA device")
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        per = {}
        for e in prof.key_averages():
            t = getattr(e, "device_time_total", 0.0) if e.device_type == torch.autograd.DeviceType.CUDA else 0.0
            if t > 0:
                # "void (anonymous namespace)::rowmax_walk_kernel<BitTiles>(...)" -> rowmax_walk_kernel
                name = e.key.replace("(anonymous namespace)::", "").removeprefix("void ")
                name = name.split("<")[0].split("(")[0].split("::")[-1] or e.key[:40]
                per[name] = per.get(name, 0.0) + t / iters / 1e3
        if per and all(k in per for k in expect):
            per["all"] = sum(per.values())
            return per
    return None
