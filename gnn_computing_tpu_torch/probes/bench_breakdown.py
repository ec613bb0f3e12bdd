"""Probe: where the bench's GCN forward spends its time on the card.

Over the plan that ``python -m gnn_computing_tpu_torch.bench`` times with
the same flags (its build phase runs first, host only, into the bench's
cache), for each layer of the GCN forward, from that layer's input in the
forward: ``utils.profiling.decompose`` of its aggregation with the layer's
numeric modes (the tile pass, the residual pipeline, the residual's bare
row gather, the whole pass) and the layer's transform; then the whole
forward by the chained harness and, on the card, the profiler's device
time by kernel.
Prints one JSON line with the card's name and power limit.

Run: python -m gnn_computing_tpu_torch.probes.bench_breakdown [bench.py's gcn flags, e.g. --scale products]
"""

from __future__ import annotations

import json
import sys

import torch

from gnn_computing_tpu_torch import bench
from gnn_computing_tpu_torch.benchmarks.common import device_label
from gnn_computing_tpu_torch.device import resolve_device
from gnn_computing_tpu_torch.models import BENCH_DIMS, init_gcn_params
from gnn_computing_tpu_torch.models.gcn import LayerOpts, fast_layer_opts, gcn_layer
from gnn_computing_tpu_torch.utils.profiling import decompose
from gnn_computing_tpu_torch.utils.timing import benchmark_chained, device_ms


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = bench.arg_parser().parse_args(argv)
    if args.model != "gcn" or args.train or args.strategy != "hybrid" or args.threshold2 is not None:
        raise SystemExit("the breakdown takes the gcn forward over one hybrid plan")
    bench.main([*argv, "--phase", "build"])
    bench.resolve_defaults(args)
    dev = resolve_device(args.device)
    n, m = (bench.QUICK_N, bench.QUICK_M) if args.quick else bench.SCALE_NM[args.scale]
    sched = bench.build_hybrid(
        None, n, m, args.threshold, args.tile_rows, args.residual_block, tile_dtype=args.tile_dtype, pack=args.pack,
        reorder=args.reorder, graph_kind=args.graph, bit_tiles=args.bit_tiles, tile_cols=args.tile_cols,
    ).to(dev)
    params = init_gcn_params(BENCH_DIMS, torch.Generator(device=dev).manual_seed(0), device=dev)
    h = bench._features(n, BENCH_DIMS[0], 123, dev)
    if args.input_dtype == "bf16":
        h = h.to(torch.bfloat16)
    fast = args.layer_config == "fast"
    opts = fast_layer_opts(BENCH_DIMS) if fast else [LayerOpts(residual_gather_dtype=bench.residual_dtype(args))] * 3
    forward = bench.forward_fn(args)
    layers = []
    with torch.no_grad():
        x = h.float()
        for w, o in zip(params, opts):
            z = x @ w
            parts = decompose(sched, z, tile_h_mode=o.tile_h_mode, residual_gather_dtype=o.residual_gather_dtype,
                              iters=args.iters)
            transform = benchmark_chained(lambda xx, ww: xx @ ww, x, w, iters=args.iters, reps=3).min_s * 1e3
            layers.append(dict(f=z.shape[1], transform_ms=transform,
                               **{k: v["ms"] for k, v in parts.items() if k not in ("analytic", "transform")}))
            x = gcn_layer(sched, x, w, o)
        fwd = benchmark_chained(lambda hh, s, p: forward(s, p, hh), h, sched, params, iters=args.iters, reps=3)
        by_kernel = device_ms(lambda: forward(sched, params, h), iters=3) if dev.type == "cuda" else None
    out = dict(
        device=device_label(dev), argv=argv, n=n, m=m, forward_ms=fwd.min_s * 1e3, layers=layers,
        tiles=[(p.num_tiles, p.bits) for p in sched.tile_parts()], residual_edges=sched.plan.num_edges,
        residual_slots=sched.plan.num_tasks * sched.plan.block_size,
        device_ms=None if by_kernel is None else dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]),
    )
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
