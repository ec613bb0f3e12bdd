"""Fig7 analog: end-to-end 3-layer model forward times (GCN / GAT / SAGE).

Reference: Figure7/{our,dgl_prof,pyg}.py + run_our.sh — 3-layer pipelines at
dims 512->128->64->32 (our.py:92-95), mean forward time.  Counterpart of
``benchmarks/fig7_models.py``: each model runs with the framework's best
schedule (label propagation with a hub stripe on community graphs, degree
sort on RMAT; int8 count tiles at threshold 24 and an NG residual): the
GCN forward over B1, the GAT forward (fast) over B2, the SAGE-LSTM
aggregate (redundancy_bypass, float16 gates; plain PyTorch).  ``--reddit``
times the three at the V100 anchor's scale beside its "Ours" columns.

Run: python -m gnn_computing_tpu_torch.benchmarks.fig7_models [--quick | --reddit] [--device cpu]
"""

import dataclasses
import os

import numpy as np
import torch

from gnn_computing_tpu_torch.aggregator import Aggregator
from gnn_computing_tpu_torch.benchmarks import common
from gnn_computing_tpu_torch.benchmarks.capture_to_fig7 import SCALE_NM, V100_OURS
from gnn_computing_tpu_torch.graph.reorder import degree_sort, label_propagation_reorder
from gnn_computing_tpu_torch.graph.sample import presample_fixed_neighbors
from gnn_computing_tpu_torch.graph.synthetic import rmat_graph
from gnn_computing_tpu_torch.models import BENCH_DIMS, init_gat_params, init_gcn_params
from gnn_computing_tpu_torch.models.gat import gat_forward
from gnn_computing_tpu_torch.models.gcn import fast_layer_opts, gcn_forward_bench
from gnn_computing_tpu_torch.models.sage_lstm import BENCH_FEATURE_LEN, BENCH_NUM_NEIGHBORS
from gnn_computing_tpu_torch.ops.lstm import init_lstm_params, lstm_aggregate
from gnn_computing_tpu_torch.schedule.neighbor_grouping import neighbor_grouping_plan
from gnn_computing_tpu_torch.schedule.plan import AggregationPlan
from gnn_computing_tpu_torch.schedule.tiles import TilePlan, densify

REDDIT_N, REDDIT_M = SCALE_NM["reddit"]  # the V100 anchor's scale
# bench.py build_hybrid's plan for the reddit rows (fig7_models.py:48-51):
# degree sort, int8 count tiles [512, 128] (build_hybrid's tile_cols
# default) at threshold 24, residual block 4, runs padded to 16
REDDIT_PLAN = dict(tile_rows=512, tile_cols=128, threshold=24, residual_block=4, pack=16)
REDDIT_ITERS = 8
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "build", "bench_cache"
)


def _cache_paths() -> tuple:
    n, m, p = REDDIT_N, REDDIT_M, REDDIT_PLAN
    tag = f"rmat_n{n}_m{m}"
    return (
        os.path.join(CACHE_DIR, f"hybrid_{tag}_t{p['threshold']}_r{p['tile_rows']}_c{p['tile_cols']}"
                                f"_b{p['residual_block']}_int8_degree.npz"),
        os.path.join(CACHE_DIR, f"sample16_{tag}.npz"),
    )


def _savez(path: str, **arrays) -> None:
    """np.savez beside ``path``, then renamed into place: a cache's
    existence is taken as its validity."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def _fields(prefix: str, obj) -> dict:
    return {prefix + f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)
            if getattr(obj, f.name) is not None}


def _load(z, prefix: str, cls):
    kw = {}
    for f in dataclasses.fields(cls):
        v = z[prefix + f.name] if prefix + f.name in z else None
        if v is not None and f.name == "partition_starts":
            v = tuple(int(x) for x in v)
        elif v is not None and v.ndim == 0:
            v = v.item()
        kw[f.name] = v
    return cls(**kw)


def reddit_caches() -> tuple:
    """Build, where missing, the two host caches of the reddit rows under
    build/bench_cache/: the degree-sorted graph's hybrid plan (REDDIT_PLAN,
    tiles unpadded) and its presample-16 neighbors (seed 2, over the
    unsorted graph, as bench.py --model sage samples).  Returns their
    paths."""
    plan_path, nbr_path = _cache_paths()
    if os.path.exists(plan_path) and os.path.exists(nbr_path):
        return plan_path, nbr_path
    g = rmat_graph(REDDIT_N, REDDIT_M, seed=123, with_val=False)
    if not os.path.exists(nbr_path):
        _savez(nbr_path, nbr=presample_fixed_neighbors(g, k=BENCH_NUM_NEIGHBORS, seed=2))
    if not os.path.exists(plan_path):
        g2 = g.reorder(degree_sort(g))
        p = REDDIT_PLAN
        tile, res = densify(g2, tile_rows=p["tile_rows"], tile_cols=p["tile_cols"], threshold=p["threshold"],
                            dtype=np.int8)
        plan = neighbor_grouping_plan(res, block_size=p["residual_block"])
        _savez(plan_path, **_fields("t_", tile), **_fields("p_", plan))
    return plan_path, nbr_path


def reddit_plan(device) -> Aggregator:
    """The cached reddit hybrid plan as an Aggregator on ``device``."""
    with np.load(reddit_caches()[0]) as z:
        tile, plan = _load(z, "t_", TilePlan), _load(z, "p_", AggregationPlan)
    agg = Aggregator(plan=plan, num_nodes=tile.num_nodes, n_src=tile.n_src, num_edges=REDDIT_M,
                     tile=tile.pad_runs(REDDIT_PLAN["pack"]))
    return agg.to(device)


def reddit_entries(args):
    """Reddit-scale fig7 rows from the cached plans (reddit_caches; run
    build_all_plans.sh first, or the first run builds them), comparable to
    BASELINE.md's V100 table at the anchor scale."""
    n, m = REDDIT_N, REDDIT_M
    plan = reddit_plan(args.device)
    h = common.features(n, BENCH_DIMS[0], 123, args)
    gcn_params = init_gcn_params(BENCH_DIMS, common.generator(0, args), device=args.device)
    opts = fast_layer_opts(BENCH_DIMS)
    r = common.bench(args, "fig7.GCN", lambda hh, p, w: gcn_forward_bench(p, w, hh, layer_opts=opts),
                     h, plan, gcn_params, iters=REDDIT_ITERS)
    common.emit("fig7", dict(dataset="reddit_scale_rmat", model="GCN", seconds=r.min_s,
                             edges_per_s=3 * m / r.min_s, v100_ours_seconds=V100_OURS[("GCN", "reddit")]), args)
    gat_params = init_gat_params(BENCH_DIMS, common.generator(1, args), device=args.device)
    r = common.bench(args, "fig7.GAT", lambda hh, p, w: gat_forward(p, w, hh, fast=True),
                     h, plan, gat_params, iters=REDDIT_ITERS)
    common.emit("fig7", dict(dataset="reddit_scale_rmat", model="GAT", seconds=r.min_s,
                             edges_per_s=3 * m / r.min_s, v100_ours_seconds=V100_OURS[("GAT", "reddit")]), args)
    del plan, h
    with np.load(reddit_caches()[1]) as z:
        nbr = torch.from_numpy(z["nbr"]).to(args.device)
    x = common.features(n, BENCH_FEATURE_LEN, 3, args)
    lstm = init_lstm_params(BENCH_FEATURE_LEN, BENCH_FEATURE_LEN, common.generator(2, args), device=args.device)
    r = common.bench(
        args, "fig7.SAGE-LSTM",
        lambda xx, p, nb: lstm_aggregate(p, xx, nb, "redundancy_bypass", gate_gather_dtype=torch.float16),
        x, lstm, nbr, iters=REDDIT_ITERS,
    )
    common.emit("fig7", dict(dataset="reddit_scale_rmat", model="SAGE-LSTM", seconds=r.min_s,
                             edges_per_s=n * 16 / r.min_s, v100_ours_seconds=V100_OURS[("SAGE-LSTM", "reddit")]), args)


def reorder(name, g):
    """The framework's best order for a dataset: the hub stripe + LPA for
    community graphs (bench.py's hublpa), degree sort for RMAT."""
    if name.startswith("comm"):
        return label_propagation_reorder(g, hubs=max(256, g.num_nodes // 128))
    return degree_sort(g)


def run(name, g, args) -> None:
    """fig7's rows for one dataset: the framework's best schedule — reorder,
    int8 tiles and the gather residual (bench.py's recipe), exact fast
    modes."""
    g2 = g.reorder(reorder(name, g))
    plan = Aggregator.schedule_hybrid(
        g2, tile_rows=256, tile_cols=128, threshold=24, residual_block=common.pick_block(args, g),
        tile_dtype=np.int8, with_transpose=False, pack=16, device=args.device,
    )
    h = common.features(g.num_nodes, BENCH_DIMS[0], 1, args)
    ctx = dict(graph=g2, agg=plan)

    gcn_params = init_gcn_params(BENCH_DIMS, common.generator(0, args), device=args.device)
    opts = fast_layer_opts(BENCH_DIMS)
    r = common.bench(args, "fig7.GCN", lambda hh, p, w: gcn_forward_bench(p, w, hh, layer_opts=opts),
                     h, plan, gcn_params, ctx=dict(ctx, opts=opts))
    common.emit("fig7", dict(dataset=name, model="GCN", seconds=r.min_s,
                             edges_per_s=3 * g.num_edges / r.min_s), args)

    gat_params = init_gat_params(BENCH_DIMS, common.generator(1, args), device=args.device)
    r = common.bench(args, "fig7.GAT", lambda hh, p, w: gat_forward(p, w, hh, fast=True),
                     h, plan, gat_params, ctx=ctx)
    common.emit("fig7", dict(dataset=name, model="GAT", seconds=r.min_s,
                             edges_per_s=3 * g.num_edges / r.min_s), args)

    nbr = torch.from_numpy(presample_fixed_neighbors(g, k=BENCH_NUM_NEIGHBORS, seed=2)).to(args.device)
    x = common.features(g.num_nodes, BENCH_FEATURE_LEN, 3, args)
    lstm = init_lstm_params(BENCH_FEATURE_LEN, BENCH_FEATURE_LEN, common.generator(2, args), device=args.device)
    r = common.bench(
        args, "fig7.SAGE-LSTM",
        lambda xx, p, nb: lstm_aggregate(p, xx, nb, "redundancy_bypass", gate_gather_dtype=torch.float16),
        x, lstm, nbr, ctx=dict(gate_gather_dtype=torch.float16),
    )
    common.emit("fig7", dict(dataset=name, model="SAGE-LSTM", seconds=r.min_s,
                             edges_per_s=g.num_nodes * BENCH_NUM_NEIGHBORS / r.min_s), args)


def arg_parser():
    ap = common.parser(__doc__)
    ap.add_argument(
        "--reddit", action="store_true",
        help="emit reddit-scale rows from the cached plans (build/bench_cache/, built by build_all_plans.sh or "
        "on first use) instead of the synthetic sweep (run alone in a fresh process)",
    )
    return ap


def main(argv=None, check=None):
    args = common.parse_args(arg_parser(), argv, check)
    if args.reddit:
        reddit_entries(args)
        return
    for name, g in common.datasets(args):
        run(name, g, args)


if __name__ == "__main__":
    main()
