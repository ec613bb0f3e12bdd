"""Start a world of processes and collect each rank's result.

``spawn_world(fn, world_size, *args)`` starts ``world_size`` fresh Python
processes (``torch.multiprocessing``, start method 'spawn'), initializes
``torch.distributed`` in each through a file store in a new temporary
directory (no fixed port, so several worlds can start at once), calls
``fn(rank, world_size, *args)`` there and returns the ranks' results in rank
order.  ``fn`` must be importable by name from a module the child can
import (it imports only what that module imports).  A rank that raises
fails the call with its traceback; a world that does not finish within
``timeout`` seconds is terminated and raises, so a hung rank cannot hang the
caller.  Every rank destroys its process group before it exits.

On the CPU the backend is gloo and each rank runs single-threaded (the
ranks share the machine's cores); on a card it is NCCL, one rank a device.
"""

from __future__ import annotations

import datetime
import os
import queue
import shutil
import tempfile
import traceback

import torch


def _rank_main(fn, rank: int, world_size: int, backend: str, store: str, timeout: float, threads, args, out):
    import torch.distributed as dist

    if threads:
        torch.set_num_threads(threads)
    try:
        dist.init_process_group(
            backend, init_method=f"file://{store}", rank=rank, world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout),
        )
        try:
            out.put((rank, True, fn(rank, world_size, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # report anything, KeyboardInterrupt and SystemExit too, then exit with it
        out.put((rank, False, traceback.format_exc()))
        raise


def spawn_world(
    fn, world_size: int, *args, backend: str = "gloo", timeout: float = 300.0, threads: int = 1
) -> list:
    """[fn(rank, world_size, *args) for every rank], each run in its own
    process of one torch.distributed world (module doc).  ``threads``: torch
    intra-op threads a rank (None leaves torch's default)."""
    ctx = torch.multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="gnn_world_")
    store = os.path.join(tmp, "store")
    out = ctx.Queue()
    procs = [
        ctx.Process(target=_rank_main, args=(fn, r, world_size, backend, store, timeout, threads, args, out), daemon=True)
        for r in range(world_size)
    ]
    results = {}
    try:
        for p in procs:
            p.start()
        deadline = datetime.datetime.now() + datetime.timedelta(seconds=timeout)
        while len(results) < world_size:
            left = (deadline - datetime.datetime.now()).total_seconds()
            # a rank that had exited before the wait began had put all it would
            # put; waiting in short slices fails the call within a second of it
            dead = [r for r, p in enumerate(procs) if not p.is_alive() and r not in results]
            try:
                rank, ok, payload = out.get(timeout=min(max(left, 0.1), 1.0))
            except queue.Empty:
                if left <= 0 or dead:
                    raise RuntimeError(
                        f"world of {world_size}: ranks {sorted(set(range(world_size)) - set(results))} gave no "
                        f"result ({'exited' if dead else f'timed out after {timeout} s'})"
                    ) from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world_size} failed:\n{payload}")
            results[rank] = payload
        return [results[r] for r in range(world_size)]
    finally:
        for p in procs:
            p.join(timeout=10)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join()
        out.close()
        shutil.rmtree(tmp, ignore_errors=True)
