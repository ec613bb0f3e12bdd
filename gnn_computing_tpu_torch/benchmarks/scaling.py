"""Multi-device scaling benchmark: edges/s at 1/2/4/.../N devices.

North-star metric (BASELINE.json): edges/s scaling efficiency at 1 device
and N >= 2, with the halo exchange beside the local aggregation.
Counterpart of ``benchmarks/scaling.py``: the ring-hybrid aggregation
(parallel/ring_tiles.py: plain PyTorch, no kernel) or, with
``--allgather``, the all-gather hybrid (parallel/allgather_tiles.py: one
all-gather, then B1 over each tile group on the card), over every power
of two of worlds of processes (parallel.launch.spawn_world): on the card
an NCCL world, one rank a card, up to torch.cuda.device_count(); on the
CPU a gloo world up to ``--world`` ranks (the counterpart of the JAX
docstring's CPU virtual mesh).  Each rank builds the plan, keeps its own
part on its device once (shard_ring_plan) and times its rank body with the
chained harness; a row takes the slowest rank's time.

CPU worlds only validate the plumbing: their compute/communication ratios
are not representative, so ``representative`` is true only for d distinct
cards.  On one H100 the sweep has one row, d = 1; its multi-card rows wait
for a machine with more cards.

Emits one JSONL record per device count to results/scaling.jsonl.

Run: python -m gnn_computing_tpu_torch.benchmarks.scaling [--allgather] [--device cpu --world 4]
"""

import numpy as np
import torch

from gnn_computing_tpu_torch.benchmarks import common
from gnn_computing_tpu_torch.graph.synthetic import normal_features, rmat_graph
from gnn_computing_tpu_torch.ops import cuda_bcsr
from gnn_computing_tpu_torch.parallel import make_mesh, shard_ring_plan, shard_rows
from gnn_computing_tpu_torch.parallel.allgather_tiles import allgather_hybrid_spmm, build_allgather_hybrid
from gnn_computing_tpu_torch.parallel.launch import spawn_world
from gnn_computing_tpu_torch.parallel.ring_tiles import build_ring_hybrid, ring_hybrid_spmm
from gnn_computing_tpu_torch.utils.timing import benchmark_chained

WORLD_TIMEOUT_S = 900.0


def rank_body(rank: int, world: int, cfg: dict) -> dict:
    """One rank of a world of ``world``: its plan part, its rows of h, one
    call (its output kept with ``cfg["keep"]``), then the chained timing.
    Returns the rank's seconds a call and its B1 launches."""
    dev = torch.device(f"cuda:{rank}" if cfg["device"] == "cuda" else "cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    mesh = make_mesh(num_graph=world, device=dev)
    g = rmat_graph(cfg["n"], cfg["m"], seed=123, with_val=False)
    if cfg["allgather"]:
        plan, gp = build_allgather_hybrid(
            g, world, tile_rows=256, tile_cols=128, threshold=max(cfg["threshold"] // 2, 4), residual_block=4,
            pack=8,
        )
        parts = (shard_ring_plan(mesh, plan),)

        def fn(hh, p):
            return allgather_hybrid_spmm(mesh, p, hh)
    else:
        rtp, ring, gp = build_ring_hybrid(g, world, tile_rows=128, tile_cols=128, threshold=cfg["threshold"])
        parts = (shard_ring_plan(mesh, rtp), shard_ring_plan(mesh, ring))

        def fn(hh, t, rg):
            return ring_hybrid_spmm(mesh, t, rg, hh)

    h = shard_rows(mesh, torch.from_numpy(normal_features(gp.num_nodes, cfg["feature_len"], seed=1) * 0.1))
    before = cuda_bcsr.launches
    with torch.no_grad():
        out = fn(h, *parts)
    per_call = cuda_bcsr.launches - before
    r = benchmark_chained(fn, h, *parts, iters=cfg["iters"])
    return dict(
        seconds=r.min_s, n=g.num_nodes, m=g.num_edges, n_pad=gp.num_nodes,
        out=out.cpu().numpy() if cfg["keep"] else None, launches_per_call=per_call, launches=cuda_bcsr.launches,
    )


def main(argv=None, check=None):
    ap = common.parser(__doc__)
    ap.add_argument("--n", type=int, default=1 << 16)
    ap.add_argument("--m", type=int, default=1 << 22)
    ap.add_argument("--threshold", type=int, default=24)
    ap.add_argument(
        "--allgather", action="store_true",
        help="sweep the all-gather distribution (parallel/allgather_tiles: B1 over each rank's tile groups "
        "behind one collective) instead of the ring; pair with --n 169343 --m 1166243 for the arxiv-scale "
        "plumbing curve",
    )
    ap.add_argument("--world", type=int, default=1,
                    help="on the CPU: the largest gloo world of the sweep (the card sweeps its cards)")
    args = common.parse_args(ap, argv, check)
    cuda = args.device.type == "cuda"
    ndev = torch.cuda.device_count() if cuda else args.world
    path = "allgather" if args.allgather else "ring"

    base_rate = None
    d = 1
    while d <= ndev:
        cfg = dict(device=args.device.type, n=args.n, m=args.m, threshold=args.threshold, allgather=args.allgather,
                   feature_len=args.feature_len, iters=args.iters, keep=args.check is not None)
        ranks = spawn_world(
            rank_body, d, cfg, backend="nccl" if cuda else "gloo", timeout=WORLD_TIMEOUT_S,
            threads=None if cuda else max(1, torch.get_num_threads() // d),
        )
        if args.check is not None:
            out = torch.from_numpy(np.concatenate([r["out"] for r in ranks]))
            args.check(f"scaling.{path}", lambda: out, (), dict(cfg, devices=d, ranks=ranks))
        seconds = max(r["seconds"] for r in ranks)
        m = ranks[0]["m"]
        rate = m / seconds
        if base_rate is None:
            base_rate = rate
        rec = dict(platform=args.device.type)
        if args.allgather:
            rec["path"] = "allgather"
        rec.update(
            devices=d,
            seconds=seconds,
            edges_per_s=rate,
            scaling_efficiency=rate / (base_rate * d),
            n=ranks[0]["n"],
            m=m,
            representative=cuda,
        )
        common.emit("scaling", rec, args)
        d *= 2


if __name__ == "__main__":
    main()
