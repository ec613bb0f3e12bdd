"""Command-line interface: ``python -m gnn_computing_tpu_torch <subcommand>``.

Port of ``gnn_computing_tpu/utils/cli.py`` (the reference's argParse,
src/util.cu:24-147): the same flags — ``--dataset --datadir --syn --reorder
--nei --feature-len --outfea --schedule --partitions`` — and subcommands:

  info        dataset / graph statistics
  schedule    build a gather plan, print its task statistics
  reorder     cluster (MinHash-LSH), lpa or degree reorder ->
              ``<datadir>/<dset>.reorder<subfix>``
  presample   fixed-k neighbor sampling -> ``<dset>_sample_<k>`` graph files
  bench       timed forward aggregation (gcn, gat over a gather plan;
              sage_lstm over the fixed-k sample)
  tune        the autotune sweep (utils.autotune.tune)
  train       full-graph GCN training over a gather plan (Adam)

``info``, ``schedule``, ``reorder`` and ``presample`` are host work and
print the JAX CLI's JSON and write its files byte for byte.  ``bench``,
``tune`` and ``train`` take ``--device`` (default ``cuda``; without a card
it raises through device.resolve_device, there is no CPU fallback) and
print the JAX CLI's keys (``train`` adds each epoch's loss).  Datasets
resolve as the reference loader does: ``<datadir>/<dset>.config`` +
``.graph``; ``--syn {rmat|community}:<n>:<m>[:seed]`` builds a synthetic
graph instead.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from gnn_computing_tpu_torch.device import resolve_device


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--dataset", default=None, help="dataset name")
    p.add_argument("--datadir", default="data", help="dataset directory")
    p.add_argument("--syn", default=None, help="synthetic graph '{rmat|community}:<n>:<m>[:seed]'")
    p.add_argument("--reorder", default="", help="reorder file subfix (reference --reorder), e.g. _thres_0.2")
    p.add_argument("--nei", type=int, default=32, help="neighbor group / block size (reference --nei)")
    p.add_argument("--feature-len", type=int, default=32, dest="feature_len")
    p.add_argument("--outfea", type=int, default=32)
    p.add_argument(
        "--schedule",
        default="neighbor_grouping",
        choices=["neighbor_grouping", "locality", "locality_neighbor_grouping", "nop"],
    )
    p.add_argument("--partitions", type=int, default=8)


def _add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda", help="torch device (default cuda; cpu runs the plain versions)")


def _load(args):
    from gnn_computing_tpu_torch.graph.io import load_graph
    from gnn_computing_tpu_torch.graph.synthetic import community_graph, rmat_graph

    if args.syn:
        parts = args.syn.split(":")
        kind, n, m = parts[0], int(parts[1]), int(parts[2])
        seed = int(parts[3]) if len(parts) > 3 else 123
        if kind == "community":
            return community_graph(n, m, seed=seed), None
        if kind != "rmat":
            raise SystemExit(f"unknown synthetic kind {kind!r}")
        return rmat_graph(n, m, seed=seed), None
    if not args.dataset:
        raise SystemExit("--dataset or --syn required")
    return load_graph(args.datadir, args.dataset, args.reorder)


def _plan(args, g):
    from gnn_computing_tpu_torch.schedule import Schedule, make_plan

    kw = {}
    sched = Schedule(args.schedule)
    if sched in (Schedule.locality, Schedule.locality_neighbor_grouping):
        kw["num_partitions"] = args.partitions
    if sched is not Schedule.nop:
        kw["block_size"] = args.nei
    return make_plan(g, sched, **kw)


def cmd_info(args):
    g, rows = _load(args)
    deg = g.degrees
    print(json.dumps({
        "num_nodes": g.num_nodes,
        "num_edges": g.num_edges,
        "max_degree": int(deg.max()) if len(deg) else 0,
        "mean_degree": float(deg.mean()) if len(deg) else 0,
        "reordered": rows is not None,
    }))


def cmd_schedule(args):
    g, _ = _load(args)
    t0 = time.time()
    stats = _plan(args, g).stats()
    stats["schedule_seconds"] = time.time() - t0
    print(json.dumps(stats))


def cmd_reorder(args):
    from gnn_computing_tpu_torch.graph.reorder import cluster_reorder, degree_sort, label_propagation_reorder

    g, _ = _load(args)
    if args.method == "lpa":
        perm = label_propagation_reorder(g)
        subfix = "_lpa"
    elif args.method == "degree":
        perm = degree_sort(g)
        subfix = "_degree"
    else:
        perm = cluster_reorder(g, threshold=args.threshold, max_cluster=args.max_cluster)
        subfix = f"_thres_{args.threshold}"
    out = args.output or os.path.join(args.datadir, f"{args.dataset}.reorder{subfix}")
    with open(out, "w") as f:
        f.write("\n".join(str(int(x)) for x in perm))
    print(json.dumps({"output": out, "n": len(perm)}))


def cmd_presample(args):
    from gnn_computing_tpu_torch.graph.sample import presample_fixed_neighbors

    g, _ = _load(args)
    nbr = presample_fixed_neighbors(g, k=args.k, seed=args.seed)
    name = f"{args.dataset or 'syn'}_sample_{args.k}"
    cfg = os.path.join(args.datadir, name + ".config")
    gp = os.path.join(args.datadir, name + ".graph")
    os.makedirs(args.datadir, exist_ok=True)
    with open(cfg, "w") as f:
        f.write(f"{g.num_nodes} {g.num_nodes * args.k}\n")
    with open(gp, "w") as f:
        f.write(" ".join(str(i * args.k) for i in range(g.num_nodes + 1)) + "\n")
        f.write(" ".join(str(int(x)) for x in nbr.reshape(-1)) + "\n")
    print(json.dumps({"config": cfg, "graph": gp}))


def cmd_bench(args):
    import torch

    from gnn_computing_tpu_torch.graph.synthetic import normal_features
    from gnn_computing_tpu_torch.utils.flops import aggregation_gflops
    from gnn_computing_tpu_torch.utils.timing import benchmark_chained

    dev = resolve_device(args.device)
    g, _ = _load(args)
    f = args.feature_len
    h = torch.from_numpy(normal_features(g.num_nodes, f, seed=123) * 0.1).to(dev)

    if args.model in ("gcn", "gat"):
        plan = _plan(args, g).to(dev)
        if args.model == "gcn":
            from gnn_computing_tpu_torch.ops.spmm import spmm

            # the feature array first: benchmark_chained perturbs args[0]
            fn = lambda x, p: spmm(p, x)  # noqa: E731
            inputs = (h, plan)
        else:
            from gnn_computing_tpu_torch.ops.gat import gat_aggregate

            att = torch.from_numpy(normal_features(g.num_nodes, 2, seed=7) * 0.1).to(dev)
            fn = lambda x, p, a: gat_aggregate(p, x, a)  # noqa: E731
            inputs = (h, plan, att)
    else:
        from gnn_computing_tpu_torch.graph.sample import presample_fixed_neighbors
        from gnn_computing_tpu_torch.ops.lstm import init_lstm_params, lstm_aggregate

        nbr = torch.from_numpy(presample_fixed_neighbors(g, k=args.k)).to(dev)
        params = init_lstm_params(f, f, torch.Generator().manual_seed(0), device=dev)
        fn = lambda x, p, nb: lstm_aggregate(p, x, nb, args.strategy)  # noqa: E731
        inputs = (h, params, nbr)

    best = benchmark_chained(fn, *inputs, iters=args.iters, reps=3).min_s
    print(json.dumps({
        "model": args.model,
        "seconds": best,
        "edges_per_s": g.num_edges / best,
        "gflops": aggregation_gflops(g.num_edges, f, best),
    }))


def cmd_train(args):
    import torch

    from gnn_computing_tpu_torch.graph.synthetic import normal_features
    from gnn_computing_tpu_torch.models.gcn import gcn_forward, init_gcn_params
    from gnn_computing_tpu_torch.models.training import accuracy, make_train_step

    dev = resolve_device(args.device)
    g, _ = _load(args)
    plan = _plan(args, g).to(dev)
    dims = (args.feature_len, 64, args.classes)
    params = init_gcn_params(dims, torch.Generator().manual_seed(0), device=dev)
    h = torch.from_numpy(normal_features(g.num_nodes, dims[0], seed=1) * 0.1).to(dev)
    labels = torch.from_numpy(np.random.default_rng(0).integers(0, args.classes, g.num_nodes)).to(dev)

    step = make_train_step(lambda p, x: gcn_forward(p, params, x), torch.optim.Adam(params, lr=args.lr), device=dev)
    losses = []
    for epoch in range(args.epochs):
        lval = step((plan, h), labels)
        losses.append(lval)
        if epoch % max(args.epochs // 10, 1) == 0:
            with torch.no_grad():
                acc = accuracy(gcn_forward(plan, params, h), labels)
            print(f"epoch {epoch}: loss {float(lval):.4f} acc {float(acc):.4f}", file=sys.stderr)
    losses = [float(v) for v in losses]
    print(json.dumps({"final_loss": losses[-1], "epochs": args.epochs, "losses": losses}))


def cmd_tune(args):
    from gnn_computing_tpu_torch.utils.autotune import tune

    dev = resolve_device(args.device)
    g, _ = _load(args)
    r = tune(g, feature_len=args.feature_len, iters=args.iters, weighted=g.val is not None, device=dev)
    print(json.dumps({"best": r.best_config, "table": [{**cfg, "seconds": t} for cfg, t in r.table]}))


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="gnn_computing_tpu_torch", description="GNN message-passing framework CLI (PyTorch/CUDA port)"
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("info")
    _add_common(p)
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser("schedule")
    _add_common(p)
    p.set_defaults(fn=cmd_schedule)

    p = sub.add_parser("reorder")
    p.add_argument(
        "--method", default="cluster", choices=["cluster", "lpa", "degree"],
        help="cluster = reference cluster2.py semantics (LSH); lpa = community-contiguous label propagation "
        "(tile locality); degree = hub sort",
    )
    _add_common(p)
    p.add_argument("--threshold", type=float, default=0.2)
    p.add_argument("--max-cluster", type=int, default=64)
    p.add_argument("--output", default=None)
    p.set_defaults(fn=cmd_reorder)

    p = sub.add_parser("presample")
    _add_common(p)
    p.add_argument("--k", type=int, default=16)
    p.add_argument("--seed", type=int, default=123)
    p.set_defaults(fn=cmd_presample)

    p = sub.add_parser("bench")
    _add_common(p)
    _add_device(p)
    p.add_argument("--model", default="gcn", choices=["gcn", "gat", "sage_lstm"])
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--k", type=int, default=16)
    p.add_argument(
        "--strategy", default="redundancy_bypass", choices=["redundancy_bypass", "sparse_fetch", "materialize"]
    )
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("tune")
    _add_common(p)
    _add_device(p)
    p.add_argument("--iters", type=int, default=4)
    p.set_defaults(fn=cmd_tune)

    p = sub.add_parser("train")
    _add_common(p)
    _add_device(p)
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--classes", type=int, default=16)
    p.set_defaults(fn=cmd_train)

    args = ap.parse_args(argv)
    return args.fn(args)
