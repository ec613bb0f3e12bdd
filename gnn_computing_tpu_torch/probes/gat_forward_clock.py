"""Probe: the 3-layer GAT forward's time, by CUDA events and by kernel.

Builds ``chip_smoke.py``'s GAT path at quick scale (RMAT 65,536 v /
4,194,304 e, seed 123, degree-sorted; int8 [512, 256] tiles at threshold
32, residual block 4, as ``bench.py --model gat``; glorot weights, seed 0;
``fast=True``, ``dot_mode='split2'``) and times the forward un-stabilized,
with ``stabilize=True`` (B5, then B2 shifted) and with ``stabilize='bound'``:
CUDA events (median of 10 after 3 warm-ups, the host's launches included)
and the profiler's device time by kernel (mean of 10), B2's and B5's kernels
apart from the rest.  It prints one JSON line and runs only on the card.

``--repeat N`` times each forward N times over in one process.  The package
is imported from the first entry of sys.path that holds it, so an older
tree put first on PYTHONPATH is timed by this script of the newer one:

  python gnn_computing_tpu_torch/probes/gat_forward_clock.py
  PYTHONPATH=old_tree python gnn_computing_tpu_torch/probes/gat_forward_clock.py

The profiler helper is read from the ``utils/timing.py`` beside this
script, whichever package is timed.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import subprocess
import sys
from typing import Optional, Sequence

import numpy as np
import torch

GAT_SCHEDULE = dict(tile_rows=512, tile_cols=256, threshold=32)  # bench.py --model gat
RESIDUAL_BLOCK = 4
# the profiler's names of B2's kernels (csrc/gat_bcsr.cu over cell_walk.cuh:
# the walk and its finish pass; no other kernel of the forward walks) and
# B5's (csrc/rowmax_bcsr.cu: its -inf fill and its max walk)
B2_KERNELS = ("walk_kernel", "finish_kernel")
B5_KERNELS = ("rowmax_walk_kernel", "fill_neg_inf")


def _timing():
    """utils/timing.py beside this script, loaded on its own."""
    path = pathlib.Path(__file__).resolve().parents[1] / "utils" / "timing.py"
    spec = importlib.util.spec_from_file_location("gat_forward_clock_timing", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repeat", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gat_forward_clock: no CUDA card; the forward is timed only there", file=sys.stderr)
        return 1
    import gnn_computing_tpu_torch
    from gnn_computing_tpu_torch.aggregator import Aggregator
    from gnn_computing_tpu_torch.convert import gat_params_from_jax
    from gnn_computing_tpu_torch.graph import degree_sort, normal_features, rmat_graph
    from gnn_computing_tpu_torch.models.gat import glorot_gat_weights
    from gnn_computing_tpu_torch.models.gcn import BENCH_DIMS

    timing = _timing()
    dev = torch.device("cuda")
    g = rmat_graph(1 << 16, 1 << 22, seed=123, with_val=False)
    g = g.reorder(degree_sort(g))
    agg = Aggregator.schedule_hybrid(g, tile_dtype=np.int8, with_transpose=False, residual_block=RESIDUAL_BLOCK,
                                     pack=1, device=dev, **GAT_SCHEDULE)
    model = gat_params_from_jax(glorot_gat_weights(BENCH_DIMS, seed=0), device=dev)
    h0 = torch.from_numpy(normal_features(g.num_nodes, BENCH_DIMS[0], seed=123) * 0.1).to(dev)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    out = dict(package=str(pathlib.Path(gnn_computing_tpu_torch.__file__).resolve().parent.parent), card=card)
    modes = {"plain": {}, "stabilize=True": dict(stabilize=True), "stabilize='bound'": dict(stabilize="bound")}
    with torch.no_grad():
        for label, kw in modes.items():
            fwd = lambda: model(agg, h0, fast=True, dot_mode="split2", **kw)  # noqa: E731
            readings = []
            for _ in range(args.repeat):
                expect = B2_KERNELS[:1] + (B5_KERNELS[:1] if kw.get("stabilize") is True else ())
                per = timing.device_ms(fwd, expect=expect)
                r = dict(ms=timing.cuda_time_ms(fwd), device_ms=None if per is None else per["all"])
                if per is not None:
                    r["B2_device_ms"] = sum(per.get(k, 0.0) for k in B2_KERNELS)
                    r["B5_device_ms"] = sum(per.get(k, 0.0) for k in B5_KERNELS)
                    r["rest_device_ms"] = r["device_ms"] - r["B2_device_ms"] - r["B5_device_ms"]
                    r["kernels"] = per
                readings.append(r)
            out[label] = readings
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
