"""Timing: wall-clock benchmarks with warm-up discard, the chained
two-length harness, and kernel and step timing on the card.

Port of ``gnn_computing_tpu/utils/timing.py`` (``BenchResult``,
``benchmark``, ``benchmark_chained``) beside the port's own ``cuda_time_ms``
(CUDA events, a call's host-side launch included) and ``device_ms`` (the
profiler's device time alone).  On the card every time is taken by CUDA
events around the timed calls; ``time.perf_counter`` times only calls whose
tensors lie on the CPU.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable, Dict, Optional

import torch


@dataclasses.dataclass
class BenchResult:
    mean_s: float
    min_s: float
    max_s: float
    iters: int
    compile_s: float
    # True when benchmark_chained's slope went negative (the loop body below
    # the launch-jitter noise floor) and the result fell back to the
    # overhead-inclusive bound total / (2 iters): an upper bound, not a
    # measurement
    noise_floor: bool = False

    def __repr__(self):
        nf = ", NOISE-FLOOR BOUND" if self.noise_floor else ""
        return (
            f"BenchResult(mean={self.mean_s * 1e3:.3f}ms, "
            f"min={self.min_s * 1e3:.3f}ms, iters={self.iters}, "
            f"compile={self.compile_s:.2f}s{nf})"
        )


def _on_cuda(x) -> bool:
    """Whether ``x`` (a tensor or a nested sequence of them) holds a CUDA
    tensor."""
    if isinstance(x, torch.Tensor):
        return x.is_cuda
    if isinstance(x, (tuple, list)):
        return any(_on_cuda(v) for v in x)
    return False


def _timed(fn: Callable, cuda: bool) -> float:
    """Seconds of one ``fn()``: between two CUDA events on the current
    stream when ``cuda``, else by ``time.perf_counter``."""
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def benchmark(fn: Callable, warmup: int = 3, iters: int = 10) -> BenchResult:
    """Time ``fn()`` (which returns tensors) with warm-up discard; the first
    call (kernel builds, work lists) is reported as ``compile_s``."""
    t0 = time.perf_counter()
    cuda = _on_cuda(fn())
    if cuda:
        torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    for _ in range(warmup):
        fn()
    times = [_timed(fn, cuda) for _ in range(iters)]
    return BenchResult(
        mean_s=sum(times) / len(times),
        min_s=min(times),
        max_s=max(times),
        iters=iters,
        compile_s=compile_s,
    )


def benchmark_chained(fn: Callable, *args, iters: int = 8, reps: int = 2, on_rep=None) -> BenchResult:
    """Per-call seconds of ``fn(*args)`` from chains of ``iters`` and
    ``2 iters`` dependent calls: each call's ``args[0]`` (a float tensor) is
    the last one's plus 1e-30 * out[0] (numerically nil), and the slope
    (min of the long chains - min of the short ones) / iters cancels the
    fixed cost of a chain, as the JAX package's harness does.  Where the
    slope is not positive the result falls back to the overhead-inclusive
    bound min(long) / (2 iters) and sets ``noise_floor``.  Runs under
    ``torch.no_grad``; ``fn`` returns a tensor.

    ``on_rep(result, k, reps)`` is called after each rep with the estimate
    over reps 1..k."""
    first, rest = args[0], args[1:]
    cuda = first.is_cuda

    def chain(n: int) -> torch.Tensor:
        x = first
        for _ in range(n):
            out = fn(x, *rest)
            x = x + (out.reshape(-1)[0].float() * 1e-30).to(x.dtype)
        return x.reshape(-1)[0]

    with torch.no_grad():
        compile_s = _timed(lambda: float(chain(iters)), False)
        chain(2 * iters)  # warm the long chain too
        t1s, t2s = [], []
        result = None
        for k in range(reps):
            t1s.append(_timed(lambda: chain(iters), cuda))
            t2s.append(_timed(lambda: chain(2 * iters), cuda))
            slope = (min(t2s) - min(t1s)) / iters
            noise_floor = slope <= 0
            if noise_floor:
                slope = min(t2s) / (2 * iters)
            mean = max((sum(t2s) - sum(t1s)) / len(t1s) / iters, slope)
            result = BenchResult(
                mean_s=mean,
                min_s=slope,
                max_s=max(t2s) / (2 * iters),
                iters=iters * (k + 1),
                compile_s=compile_s,
                noise_floor=noise_floor,
            )
            if on_rep is not None:
                on_rep(result, k + 1, reps)
    return result


def cuda_time_ms(fn: Callable[[], object], warmup: int = 3, iters: int = 10) -> float:
    """Median milliseconds of ``fn()`` on the current CUDA stream: ``warmup``
    discarded calls, then ``iters`` calls each between two events.  Raises
    without a card: a time taken on the CPU is not a device time."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_time_ms needs a CUDA device")
    for _ in range(warmup):
        fn()
    return statistics.median(_timed(fn, True) * 1e3 for _ in range(iters))


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
