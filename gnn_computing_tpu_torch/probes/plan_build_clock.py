"""Probe: host seconds of the hybrid plan build.

Builds ``chip_smoke.py``'s graph (RMAT, seed 123, degree-sorted) at
``--scale quick`` (65,536 v / 4,194,304 e) or ``reddit`` (232,965 v /
114,615,891 e) and times ``schedule.tiles.densify`` at bench.py's GCN
geometry (int8 [512, 256] tiles at threshold 48) and, at the quick scale,
over float32 tiles at the same geometry (``gcn_norm_val`` weights, the
weighted GCN path); at reddit the float32 plan (≈32 GB of A) is left out.
Each densify runs ``--reps`` times; the graph's and the sort's seconds are
printed beside them.  Host work only: no card is needed.  It prints one
JSON line.

The package is imported from the first entry of sys.path that holds it, so
an older tree put first on PYTHONPATH is timed by this script of the newer
one:

  python gnn_computing_tpu_torch/probes/plan_build_clock.py --scale quick
  PYTHONPATH=old_tree python gnn_computing_tpu_torch/probes/plan_build_clock.py --scale quick
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time
from typing import Optional, Sequence

import numpy as np

SCALES = {"quick": (1 << 16, 1 << 22), "reddit": (232_965, 114_615_891)}
SCHEDULE = dict(tile_rows=512, tile_cols=256, threshold=48)  # bench.py's GCN forward


def main(argv: Optional[Sequence[str]] = None) -> dict:
    # this checkout's package, unless an entry of PYTHONPATH holds another
    sys.path.append(str(pathlib.Path(__file__).resolve().parents[2]))
    import gnn_computing_tpu_torch
    from gnn_computing_tpu_torch.graph import degree_sort, rmat_graph
    from gnn_computing_tpu_torch.schedule.tiles import densify

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", choices=sorted(SCALES), default="quick")
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args(argv)
    n, m = SCALES[args.scale]
    out = dict(scale=args.scale, n=n, m=m, package=gnn_computing_tpu_torch.__file__, geometry=SCHEDULE)
    t0 = time.perf_counter()
    g = rmat_graph(n, m, seed=123, with_val=False)
    out["graph_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    g = g.reorder(degree_sort(g))
    out["degree_sort_s"] = time.perf_counter() - t0
    cases = {"int8": dict(dtype=np.int8)}
    if args.scale == "quick":
        deg_out = np.bincount(g.indices, minlength=g.n_src).astype(np.float32)
        val = 1.0 / np.sqrt(np.maximum(g.degrees.astype(np.float32), 1.0))[g.dst_per_edge]
        cases["float32"] = dict(dtype=np.float32, val=val / np.sqrt(np.maximum(deg_out, 1.0))[g.indices])
    for name, kw in cases.items():
        secs = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            tp, res = densify(g, **kw, **SCHEDULE)
            secs.append(time.perf_counter() - t0)
        out[name] = dict(densify_s=secs, tiles=tp.num_tiles, dense_edges=tp.num_dense_edges,
                         residual_edges=res.num_edges, a_bytes=int(tp.a.nbytes))
        del tp, res
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
