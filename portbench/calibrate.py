"""Readings that the limits in ``limits/<cell>.json`` are set from.

    python3 -m portbench.calibrate --traffic reddit-train --seeds 5,6,7

It draws the traffic's graph and runs the program's set-up of it once (every
seed runs the same graph and plan), then, for each seed and every cell of
BENCHMARK.json on that traffic, draws the seed's data, builds the window's
step object anew from the drawn weights in each mode and reads what the
comparison reads:

* ``sound``: the program as the configuration states it (the lower reading);
* ``tf32``: the control, the program with TF32 switched on for its float32
  matmuls (the configuration states float32 with TF32 off);
* ``half`` (training cells): the fault of half the batch left out, the
  loss's mean taken over the other half;
* ``exact`` (configurations with ``gat.stabilize``): a second witness, the
  program with the exact row shift (``stabilize=True``, kernel B5 every
  call) in place of the configuration's 'bound' shift and its rescue; the
  shift cancels in the softmax, so the reference is the same.

Then the reference runs once per cell and seed.  One JSON line per (cell,
seed, mode) goes to standard output, with the B5 launches of that mode's
steps (the 'bound' rescue's row max, or the exact shift's) and the leaves
that ``update_gap`` leaves out.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time

import torch

from portbench import harness, spec


@contextlib.contextmanager
def mode(name: str):
    """The program switched into ``name`` for the duration (``exact`` is a
    change of the configuration: see ``with_mode``)."""
    import gnn_computing_tpu_torch  # noqa: F401  (its import sets TF32 off)
    from gnn_computing_tpu_torch.models import training

    if name in ("sound", "exact"):
        yield
    elif name == "tf32":
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    elif name == "half":
        xent = training.softmax_xent

        def half(logits, labels, mask=None):
            k = logits.shape[0] // 2
            return xent(logits[:k], labels[:k])

        training.softmax_xent = half
        try:
            yield
        finally:
            training.softmax_xent = xent
    else:
        raise ValueError(f"unknown mode {name!r}")


def modes(cell: spec.Cell) -> tuple:
    out = ("sound", "tf32", "half") if cell.traffic["pass"] == "train" else ("sound", "tf32")
    return out + (("exact",) if "gat" in cell.config else ())


def with_mode(s: harness.Setup, name: str) -> harness.Setup:
    if name != "exact":
        return s
    cfg = dict(s.cell.config, gat=dict(s.cell.config["gat"], stabilize=True))
    return dataclasses.replace(s, cell=dataclasses.replace(s.cell, config=cfg))


def readings(s: harness.Setup, names) -> tuple:
    """(progs, B5 launches) of each mode's set-up steps on ``s``."""
    progs, b5 = [], []
    for name in names:
        before = harness.counters()["B5"]
        with mode(name):
            one, prog = harness.start(with_mode(s, name))
            del one
        b5.append(harness.counters()["B5"] - before)
        progs.append(prog)
    return progs, b5


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    bench = spec.benchmark()
    cells = [spec.cell(w["name"], bench) for w in bench["workloads"] if w["traffic"] == args.traffic]
    t0 = time.perf_counter()
    planned = harness.plan_graph(cells[0].traffic, args.device)
    print(f"{args.traffic}: set-up {time.perf_counter() - t0:.1f} s, plan {planned.plan_s:.1f} s", file=sys.stderr,
          flush=True)
    for seed in (int(x) for x in args.seeds.split(",")):
        for cell in cells:
            t1 = time.perf_counter()
            s = harness.prepare(cell, seed, args.device, planned)
            names = modes(cell)
            progs, b5 = readings(s, names)
            if not s.train:
                progs = [{"out": p["out"]} for p in progs]
            for name, launches, numbers in zip(names, b5, harness.reference_numbers(s, progs)):
                print(json.dumps({"cell": cell.name, "seed": seed, "mode": name, "b5": launches, **numbers}),
                      flush=True)
            del s, progs
            print(f"{cell.name} seed {seed}: {time.perf_counter() - t1:.1f} s", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
