"""Probe: is the first multi-threaded call of a CPU transcendental exact?

Each trial is a new process (forked from a parent that has imported torch
and run no operator, so nothing of PyTorch's or MKL's lazy set-up has run)
that sets ``--threads`` intra-op threads and calls one operator for the
first time on an ``--n``-element float32 tensor (numpy seed 0), then once
more on the same tensor.  Both results are held to the operator in float64:
a trial is "off" when an element's relative error exceeds ``--rtol`` (the
operators are accurate to a few float32 ulps, 6e-8 each).  ``--warm exp1``
first runs ``torch.exp`` on one element on the calling thread, which is
what ``import gnn_computing_tpu_torch`` does (``--warm log1``: ``torch.log``
on one element instead); the trials fork from this process, so a package
imported before ``main`` runs (``python -c "import gnn_computing_tpu_torch;
..."``) has run its import-time code in every trial.  ``--jobs`` trials run
at once, which loads the machine as a parallel test run does.

CPU only; no card is needed.  It prints one JSON line per (operator, warm)
with the count of trials off at the first and at the second call and the
largest relative error seen:

  python gnn_computing_tpu_torch/probes/first_threaded_call.py --trials 720
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
from typing import Optional, Sequence

import numpy as np
import torch

OPS = {
    # name: (torch call, float64 numpy reference, input maker, error floor);
    # an element's error is |y - ref| / max(|ref|, floor)
    "exp": (torch.exp, np.exp, lambda r, n: r.normal(0.0, 3.0, n), 1e-30),
    "log": (torch.log, np.log, lambda r, n: r.uniform(0.01, 100.0, n), 1e-30),
    "tanh": (torch.tanh, np.tanh, lambda r, n: r.normal(0.0, 2.0, n), 1e-30),
    "sigmoid": (torch.sigmoid, lambda x: 1.0 / (1.0 + np.exp(-x)), lambda r, n: r.normal(0.0, 3.0, n), 1e-30),
    # x - logsumexp(x) cancels near 0: there the error is held to 1, as the
    # inputs' own float32 rounding is
    "log_softmax": (
        lambda x: torch.log_softmax(x.reshape(-1, 32), dim=1).reshape(-1),
        lambda x: (x.reshape(-1, 32) - np.log(np.exp(x.reshape(-1, 32)).sum(axis=1, keepdims=True))).reshape(-1),
        lambda r, n: r.normal(0.0, 3.0, n),
        1.0,
    ),
}


def _trial(op: str, warm: str, n: int, threads: int) -> tuple:
    fn, ref_fn, make, floor = OPS[op]
    torch.set_num_threads(threads)
    x64 = make(np.random.default_rng(0), n)
    x = torch.from_numpy(x64.astype(np.float32))
    ref = ref_fn(x.double().numpy())
    if warm == "exp1":
        torch.exp(torch.zeros(1))
    elif warm == "log1":
        torch.log(torch.ones(1))
    first = fn(x).double().numpy()
    second = fn(x).double().numpy()

    def rel(y):
        return float(np.max(np.abs(y - ref) / np.maximum(np.abs(ref), floor)))

    return rel(first), rel(second)


def main(argv: Optional[Sequence[str]] = None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ops", default=",".join(OPS))
    ap.add_argument("--warm", default="none,exp1")
    ap.add_argument("--trials", type=int, default=720)
    ap.add_argument("--jobs", type=int, default=6)
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--n", type=int, default=11_520)
    ap.add_argument("--rtol", type=float, default=1e-6)
    a = ap.parse_args(argv)
    out = []
    ctx = mp.get_context("fork")
    for op in a.ops.split(","):
        for warm in a.warm.split(","):
            # a new pool per trial batch would reuse processes; maxtasksperchild=1 gives every trial its own
            with ctx.Pool(a.jobs, maxtasksperchild=1) as pool:
                res = pool.starmap(_trial, [(op, warm, a.n, a.threads)] * a.trials, chunksize=1)
            first, second = np.array([r[0] for r in res]), np.array([r[1] for r in res])
            row = dict(op=op, warm=warm, trials=a.trials, threads=a.threads, n=a.n, torch=torch.__version__,
                       off_first=int((first > a.rtol).sum()), off_second=int((second > a.rtol).sum()),
                       max_rel_first=float(first.max()), max_rel_second=float(second.max()))
            print(json.dumps(row), flush=True)
            out.append(row)
    return out


if __name__ == "__main__":
    main()
