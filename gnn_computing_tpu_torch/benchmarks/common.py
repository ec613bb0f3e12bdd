"""Shared harness for the figure benchmarks of the port.

Counterpart of ``benchmarks/common.py``: a dataset list swept per
benchmark, results appended as JSON lines under this package's
``results/`` (``benchmarks/results/`` keeps the JAX side's rows), plotted
by ``plot.py``.  The datasets are the same deterministic RMAT and community
graphs (numpy streams array-equal to the JAX package's).  Every row also
names the device it ran on: the card's name and power limit as nvidia-smi
gives them, or "cpu".  Times come from ``utils.timing.benchmark_chained``
(CUDA events on the card).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

from gnn_computing_tpu_torch.device import resolve_device
from gnn_computing_tpu_torch.utils.timing import benchmark_chained

RESULTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "results")

# name -> (num_vertices, num_edges): small/mid scales of the reference's
# 8-dataset sweep (arxiv..products, BASELINE.md); reddit-scale rows come
# from fig7_models --reddit
SYN_DATASETS = {
    "rmat_arxiv": (1 << 18, 1 << 21),  # ~arxiv scale
    "rmat_collab": (1 << 18, 1 << 22),
    "rmat_ddi": (1 << 12, 1 << 21),  # small+dense like ddi
    "rmat_mid": (1 << 16, 1 << 23),
    # community-structured analog (graph.synthetic.community_graph): the
    # shape of reddit/products (subreddit clusters + hub tail), which pure
    # RMAT lacks
    "comm_mid": (1 << 16, 1 << 23),
}
QUICK_DATASETS = {"rmat_quick": (1 << 12, 1 << 16)}


def parser(desc: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=desc)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--iters", type=int, default=48)
    ap.add_argument("--feature-len", type=int, default=32, dest="feature_len")
    ap.add_argument(
        "--nei", type=int, default=32,
        help="NG group size (reference run.sh sweeps 16/32/64); 0 = auto "
        "from mean degree — the reference's groups are CSR segments "
        "without padding, so the padded-slot analog should not exceed "
        "the typical degree (4x pad waste on mean-degree-8 graphs).",
    )
    ap.add_argument("--outfea", type=int, default=32)
    ap.add_argument("--out", default=None, help="results file override")
    ap.add_argument(
        "--only", default=None,
        help="comma-separated dataset-name filter (e.g. rmat_mid)",
    )
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu: the plain PyTorch versions")
    ap.add_argument("--results-dir", default=RESULTS_DIR, dest="results_dir",
                    help="directory of the <tag>.jsonl files (default: this package's results/)")
    return ap


def parse_args(ap: argparse.ArgumentParser, argv=None, check=None) -> argparse.Namespace:
    """``ap``'s arguments with ``device`` resolved (a card asked for and
    absent raises), the rows' ``device_label`` and ``check``: None, or a
    callable that ``bench`` hands each timed function first (chip_smoke.py
    holds the outputs to float64 oracles and counts the kernels' launches
    through it)."""
    args = ap.parse_args(argv)
    args.device = resolve_device(args.device)
    args.device_label = device_label(args.device)
    args.check = check
    return args


def device_label(dev: torch.device) -> str:
    """"cpu", or the card's name and power limit as nvidia-smi gives them."""
    if dev.type == "cpu":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", f"--id={dev.index or 0}", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout
    return out.strip().splitlines()[0]


def datasets(args):
    """(name, graph) over the quick or the full table, filtered by
    ``--only``."""
    table = QUICK_DATASETS if args.quick else SYN_DATASETS
    only = getattr(args, "only", None)
    if only:
        table = {k: v for k, v in table.items() if k in only.split(",")}
    from gnn_computing_tpu_torch.graph.synthetic import community_graph, rmat_graph

    for name, (n, m) in table.items():
        if name.startswith("comm"):
            yield name, community_graph(n, m, seed=123, with_val=False, min_comm=1024, max_comm=8192)
        else:
            yield name, rmat_graph(n, m, seed=123, with_val=False)


def pick_block(args, g) -> int:
    """--nei, or the nearest power of two to the mean degree (clamped
    [4, 32]) when --nei 0."""
    if args.nei:
        return args.nei
    mean_deg = max(g.num_edges / max(g.num_nodes, 1), 1.0)
    b = 1 << int(round(np.log2(mean_deg)))
    return int(min(32, max(4, b)))


def features(n: int, f: int, seed: int, args) -> torch.Tensor:
    """normal_features(n, f, seed) * 0.1 on the run's device."""
    from gnn_computing_tpu_torch.graph.synthetic import normal_features

    return torch.from_numpy(normal_features(n, f, seed=seed) * 0.1).to(args.device)


def generator(seed: int, args) -> torch.Generator:
    """A torch generator on the run's device seeded with ``seed``: the
    port's counterpart of ``jax.random.key(seed)`` for parameter inits."""
    return torch.Generator(device=args.device).manual_seed(seed)


def checked(args, what: str, fn, *inputs, ctx=None):
    """``fn`` as ``args.check`` gives it back after its check (``fn``
    itself without one)."""
    if args.check is None:
        return fn
    return args.check(what, fn, inputs, ctx or {})


def bench(args, what: str, fn, *inputs, iters=None, ctx=None):
    """benchmark_chained(fn, *inputs) over ``iters`` (default --iters)."""
    fn = checked(args, what, fn, *inputs, ctx=ctx)
    return benchmark_chained(fn, *inputs, iters=iters or args.iters)


def host_timed(args, what: str, fn, *inputs, ctx=None) -> float:
    """Min seconds of fn(*inputs) by the host clock, over max(--iters, 5)
    calls after one, the card synchronized after each: the JAX harness's
    block_until_ready loop, for pipelines of separate calls."""
    fn = checked(args, what, fn, *inputs, ctx=ctx)
    sync = torch.cuda.synchronize if args.device.type == "cuda" else (lambda: None)
    with torch.no_grad():
        fn(*inputs)
        sync()
        times = []
        for _ in range(max(args.iters, 5)):
            t0 = time.perf_counter()
            fn(*inputs)
            sync()
            times.append(time.perf_counter() - t0)
    return min(times)


def emit(tag: str, record: dict, args) -> None:
    os.makedirs(args.results_dir, exist_ok=True)
    path = args.out or os.path.join(args.results_dir, f"{tag}.jsonl")
    record = dict(record, device=args.device_label, ts=time.time())
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")
    print(json.dumps(record), flush=True)
