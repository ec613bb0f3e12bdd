"""Probe: host counts of the fig7 harness's hybrid plans.

Builds a dataset of the figure harness's tables (``--dataset``, default
``rmat_mid``: RMAT 65,536 v / 8,388,608 e, seed 123), reorders it as fig7
does (fig7_models.reorder: degree sort, or hub + LPA for a community
graph), and prints for each plan one JSON line: tiles (before and
after ``pad_runs``), the tiles' bytes, the edges in tiles, the residual's
edges and slots (tasks x block).  The plans are fig7's sweep plan (int8
[256, 128] t24, residual block --nei 32, pack 16), fig7 ``--reddit``'s
(REDDIT_PLAN: int8 [512, 128] t24, residual 4, pack 16) and bench.py's
main path (int8 [512, 256] t48, residual 4, pack 1).  Host work only: no
card is needed.

  python gnn_computing_tpu_torch/probes/fig7_plan_stats.py [--dataset rmat_mid]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
from typing import Optional, Sequence

import numpy as np

PLANS = {
    "fig7": dict(tile_rows=256, tile_cols=128, threshold=24, residual_block=32, pack=16),
    "fig7_reddit": None,  # fig7_models.REDDIT_PLAN
    "bench_main_path": dict(tile_rows=512, tile_cols=256, threshold=48, residual_block=4, pack=1),
}


def main(argv: Optional[Sequence[str]] = None) -> list:
    sys.path.append(str(pathlib.Path(__file__).resolve().parents[2]))
    from gnn_computing_tpu_torch.benchmarks import common, fig7_models
    from gnn_computing_tpu_torch.schedule.neighbor_grouping import neighbor_grouping_plan
    from gnn_computing_tpu_torch.schedule.tiles import densify

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="rmat_mid", choices=sorted(common.SYN_DATASETS))
    args = ap.parse_args(argv)
    n, m = common.SYN_DATASETS[args.dataset]
    g = next(common.datasets(argparse.Namespace(quick=False, only=args.dataset)))[1]
    g = g.reorder(fig7_models.reorder(args.dataset, g))
    out = []
    for name, p in PLANS.items():
        p = p or fig7_models.REDDIT_PLAN
        tp, res = densify(g, tile_rows=p["tile_rows"], tile_cols=p["tile_cols"], threshold=p["threshold"],
                          dtype=np.int8)
        plan = neighbor_grouping_plan(res, block_size=p["residual_block"])
        padded = tp.pad_runs(p["pack"])
        row = dict(dataset=args.dataset, n=n, m=m, plan=name, **p, tiles=tp.num_tiles, tiles_padded=padded.num_tiles,
                   tile_bytes=int(padded.a.nbytes), dense_edges=int(tp.num_dense_edges),
                   residual_edges=int(res.num_edges), residual_slots=int(plan.num_tasks * plan.block_size))
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


if __name__ == "__main__":
    main()
