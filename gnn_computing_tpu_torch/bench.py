"""Headline benchmark of the port: bench.py's models, scales and plan flags
timed on the card from cached plans.

Port of the root ``bench.py``, section by section under its names: the
constants (the five scales, the V100 baselines), the host helpers, the
``Emitter`` and its one-line JSON result, the disk caches of graphs and
plans (``build_graph``, ``build_gather``, ``build_hybrid``,
``add_transpose``), ``run_train`` and ``main`` with every flag and choice of
bench.py, plus ``--device`` (default cuda; without a card it raises, there
is no CPU fallback; ``cpu`` runs the plain versions).

Two phases, as in bench.py: the ``build`` child is host-only (graphs, plans,
transposed plans, samples into ``build/bench_cache/``; it never initialises
CUDA and raises if something did), then a fresh ``timed`` child loads the
caches and times on the card with ``utils.timing.benchmark_chained`` (CUDA
events, the slope between chains of --iters and 2 --iters calls, 3 reps).
The timed child prints ``{"metric", "value", "unit", "vs_baseline"}`` after
the first rep; the orchestrator relays it as its first stdout line.  A timed
child that prints no metric line within BENCH_BUDGET_S seconds (default
1200) is killed and the run exits 3 naming the phase: there is no fall back
to --quick.

The capture row (``gnn_computing_tpu_torch/benchmarks/results/capture.jsonl``
or ``--capture``, read by ``benchmarks/capture_to_fig7``) adds ``time_s``,
``device`` (the card's name and power limit), the kernels' launches over the
timed run (``launches``), the timed function's calls (``calls``) and the
plan's tile parts.  Its ``scale`` is the metric's label, so a --quick row is
"quick" and never converts into a full-scale figure row.

Differences from bench.py:
  * weights: Glorot normals from a torch generator seeded 0 on the run's
    device (bench.py draws from jax.random.key(0), which the port cannot
    reproduce); the CPU tests carry the JAX weights across with convert.py;
  * no persistent compile cache (``_enable_compile_cache``): nothing is
    compiled per shape, and the kernels' libraries are cached by
    ops.cuda_build under build/kernels/;
  * the hybrid plan cache also stores the reordered graph's in-degrees
    (``in_degree``), which the GAT 'bound' shift reads; a 1-bit transposed
    part stays 1-bit below R = 256 (the JAX bench unpacks it: a Mosaic
    limit); the CUDA kernels take any run length, so ``--pack`` pads with
    filler tiles as bench.py does, and they only add work;
  * ``--model spmm --strategy gather`` and ``--train --strategy gather``
    exit non-zero (bench.py's spmm path runs ``Aggregator.run``, which a
    gather plan lacks, and its --train asserts the hybrid strategy).

Run: python -m gnn_computing_tpu_torch.bench [--model gcn|gat|sage|spmm|sddmm|edgemlp]
         [--train] [--scale reddit|products|citation|ppa|protein] [--quick] [--device cuda|cpu] ...
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import select
import subprocess
import sys
import time

import numpy as np
import torch

from gnn_computing_tpu_torch.aggregator import Aggregator
from gnn_computing_tpu_torch.benchmarks.common import device_label
from gnn_computing_tpu_torch.device import resolve_device
from gnn_computing_tpu_torch.graph.csr import CSRGraph
from gnn_computing_tpu_torch.graph.reorder import (
    cluster_reorder,
    cluster_reorder_exact,
    degree_sort,
    label_propagation_reorder,
)
from gnn_computing_tpu_torch.graph.sample import presample_fixed_neighbors
from gnn_computing_tpu_torch.graph.synthetic import community_graph, normal_features, rmat_graph
from gnn_computing_tpu_torch.models import BENCH_DIMS, init_gat_params, init_gcn_params
from gnn_computing_tpu_torch.models.gat import gat_forward
from gnn_computing_tpu_torch.models.gcn import fast_layer_opts, gcn_forward_bench
from gnn_computing_tpu_torch.models.training import make_train_step
from gnn_computing_tpu_torch.ops.bcsr_sddmm import hybrid_sddmm
from gnn_computing_tpu_torch.ops.edge_mlp import edge_mlp_chunked
from gnn_computing_tpu_torch.ops.lstm import init_lstm_params, lstm_aggregate
from gnn_computing_tpu_torch.ops.spmm import sddmm_slots
from gnn_computing_tpu_torch.schedule import make_plan
from gnn_computing_tpu_torch.schedule.neighbor_grouping import neighbor_grouping_plan
from gnn_computing_tpu_torch.schedule.plan import AggregationPlan
from gnn_computing_tpu_torch.schedule.tiles import TilePlan, densify, run_offsets, split_bit_tiles
from gnn_computing_tpu_torch.utils.profiling import launch_counts
from gnn_computing_tpu_torch.utils.timing import benchmark_chained

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE_DIR = os.path.join(REPO, "build", "bench_cache")
CAPTURE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "benchmarks", "results", "capture.jsonl")

REDDIT_N, REDDIT_M = 232_965, 114_615_891
# products: the reference's largest graph (util.py:33/:143)
PRODUCTS_N, PRODUCTS_M = 2_449_029, 123_718_280
# mid-size reference scales: edge counts from util.py:24-34, protein's
# vertices from util.py:88-143; citation's and ppa's from the OGB dataset
# cards (ogbn-citation2 2,927,963; ogbn-ppa 576,289)
CITATION_N, CITATION_M = 2_927_963, 30_387_995
PPA_N, PPA_M = 576_289, 42_463_862
PROTEIN_N, PROTEIN_M = 132_534, 79_122_504
QUICK_N, QUICK_M = 1 << 16, 1 << 22
BASELINE_EDGES_PER_S = 3 * REDDIT_M / 0.058089  # V100 GCN, draw_fig7.py:68
BASELINE_GAT_EDGES_PER_S = 3 * REDDIT_M / 0.055538  # V100 GAT, draw_fig7.py:75
SAGE_K = 16  # fixed-16-neighbor sampled graphs, run_our.sh:16-20
# V100 SAGE-LSTM reddit 0.014204 s (draw_fig7.py:84); edges = n*k
BASELINE_SAGE_EDGES_PER_S = 232_965 * SAGE_K / 0.014204
# V100 times per scale (draw_fig7.py:66-85, "ours" columns); SAGE-LSTM runs
# out of memory on the V100 at products (draw_fig7.py:84 '0'), so the reddit
# rate stands in there
SCALE_BASELINES = {
    "reddit": {
        "gcn": BASELINE_EDGES_PER_S,
        "spmm": BASELINE_EDGES_PER_S,
        "sddmm": BASELINE_EDGES_PER_S,
        "gat": BASELINE_GAT_EDGES_PER_S,
        "sage": BASELINE_SAGE_EDGES_PER_S,
    },
    "products": {
        "gcn": 3 * PRODUCTS_M / 0.092553,
        "spmm": 3 * PRODUCTS_M / 0.092553,
        "sddmm": 3 * PRODUCTS_M / 0.092553,
        "gat": 3 * PRODUCTS_M / 0.113309,
        "sage": BASELINE_SAGE_EDGES_PER_S,
    },
    "citation": {
        "gcn": 3 * CITATION_M / 0.068879,
        "spmm": 3 * CITATION_M / 0.068879,
        "sddmm": 3 * CITATION_M / 0.068879,
        "gat": 3 * CITATION_M / 0.089002,
        "sage": CITATION_N * SAGE_K / 0.178892,
    },
    "ppa": {
        "gcn": 3 * PPA_M / 0.030635,
        "spmm": 3 * PPA_M / 0.030635,
        "sddmm": 3 * PPA_M / 0.030635,
        "gat": 3 * PPA_M / 0.035884,
        "sage": PPA_N * SAGE_K / 0.035739,
    },
    "protein": {
        "gcn": 3 * PROTEIN_M / 0.035486,
        "spmm": 3 * PROTEIN_M / 0.035486,
        "sddmm": 3 * PROTEIN_M / 0.035486,
        "gat": 3 * PROTEIN_M / 0.034986,
        "sage": PROTEIN_N * SAGE_K / 0.008578,
    },
}
SCALE_NM = {
    "reddit": (REDDIT_N, REDDIT_M),
    "products": (PRODUCTS_N, PRODUCTS_M),
    "citation": (CITATION_N, CITATION_M),
    "ppa": (PPA_N, PPA_M),
    "protein": (PROTEIN_N, PROTEIN_M),
}
REPS = 3  # benchmark_chained reps of every timed path


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _cache_dir() -> str:
    os.makedirs(CACHE_DIR, exist_ok=True)
    return CACHE_DIR


def _atomic_savez(path: str, **arrays) -> None:
    """np.savez into a file named by this process, then renamed into place:
    the build phase takes a cache file's existence as its validity, so a
    build killed mid-write must leave no truncated file under the real
    name, and two builds of one key must each publish only their own."""
    tmp = f"{path}.tmp.{os.getpid()}.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def _atomic_save(path: str, arr) -> None:
    """np.save the same way as _atomic_savez."""
    tmp = f"{path}.tmp.{os.getpid()}.npy"
    np.save(tmp, arr)
    os.replace(tmp, path)


def _sweep_tmp_stragglers(d: str) -> None:
    """Delete '*.tmp.*' files left by builds killed between the write and
    the rename (never loaded); those younger than an hour may belong to a
    live writer and stay."""
    for p in glob.glob(os.path.join(d, "*.tmp.*.np[yz]")):
        try:
            if time.time() - os.path.getmtime(p) > 3600:
                os.remove(p)
        except OSError:
            pass


class Emitter:
    """Prints the JSON result line after the first measured rep (a run cut
    later still leaves its number), later reps to stderr; ``finish``
    appends the last, refined record to the capture log."""
    def __init__(self, metric, base, to_value, capture_extra=None, capture=None):
        self.metric = metric
        self.base = base
        self.to_value = to_value
        self.emitted = False
        self.last = None
        self.capture_extra = capture_extra or {}
        self.capture = capture or CAPTURE_PATH

    def record(self, min_s: float) -> str:
        value = self.to_value(min_s)
        rec = {"metric": self.metric, "value": value, "unit": "edges/s", "vs_baseline": value / self.base}
        self.last = dict(rec, time_s=min_s, **self.capture_extra)
        return json.dumps(rec)

    def on_rep(self, r, k, reps):
        line = self.record(r.min_s)
        if not self.emitted:
            print(line, flush=True)
            self.emitted = True
        else:
            log(f"[refine rep {k}/{reps}] {line}")

    def finish(self, **extra) -> None:
        """Append the final record, with ``extra``, to the capture log."""
        if self.last is None:
            return
        os.makedirs(os.path.dirname(self.capture), exist_ok=True)
        with open(self.capture, "a") as f:
            f.write(json.dumps(dict(self.last, **extra, ts=time.time())) + "\n")


def build_graph(n: int, m: int, kind: str = "rmat"):
    """The deterministic synthetic graph (seed 123, unweighted), cached as
    npz: ``rmat`` (power-law, no community structure) or ``community``
    (reddit's subreddit communities and co-comment neighbourhoods).  The
    numpy stream, as bench.py's host-pinned build phase draws it."""
    path = os.path.join(_cache_dir(), f"{kind}_n{n}_m{m}.edges.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            return CSRGraph(indptr=z["indptr"], indices=z["indices"])
    t0 = time.time()
    if kind == "community":
        g = community_graph(n, m, seed=123, with_val=False)
    else:
        g = rmat_graph(n, m, seed=123, with_val=False)
    log(f"graph gen: {time.time() - t0:.1f}s  n={g.num_nodes} m={g.num_edges}")
    _atomic_savez(path, indptr=g.indptr, indices=g.indices)
    return g


def lazy_graph(n: int, m: int, kind: str):
    """Memoized graph getter: neither the timed phase nor a fully cached
    build phase loads the edges just to hand plan builders an argument they
    do not touch on a cache hit."""
    box = []

    def get():
        if not box:
            box.append(build_graph(n, m, kind=kind))
        return box[0]

    return get


def gather_path(n: int, m: int, block_size: int, graph_kind: str) -> str:
    return os.path.join(_cache_dir(), f"gather_{graph_kind}_n{n}_m{m}_b{block_size}.npz")


def build_gather(g_fn, block_size: int, n=None, m=None, graph_kind: str = "rmat", check_only: bool = False):
    """Neighbor-grouping gather plan, disk-cached.  ``check_only`` (the
    build phase): an existing file is proof enough, nothing is loaded."""
    path = None if n is None else gather_path(n, m, block_size, graph_kind)
    if path and os.path.exists(path) and check_only:
        log(f"cache ok: {os.path.basename(path)}")
        return None
    if path and os.path.exists(path):
        log(f"loading cached gather plan {os.path.basename(path)}")
        with np.load(path) as z:
            return AggregationPlan(
                src=z["src"], count=z["count"], dst=z["dst"], val=z["val"] if "val" in z.files else None,
                edge_perm=None, num_nodes=int(z["num_nodes"]), n_src=int(z["n_src"]), block_size=block_size,
                num_tasks=int(z["num_tasks"]), num_edges=int(z["num_edges"]), sorted_by_dst=True,
                partition_starts=(0, int(z["num_tasks"])),
            )
    t0 = time.time()
    plan = neighbor_grouping_plan(g_fn(), block_size)
    log(f"gather plan: {time.time() - t0:.1f}s  {plan.stats()}")
    if path:
        kw = {} if plan.val is None else {"val": plan.val}
        _atomic_savez(
            path, src=plan.src, count=plan.count, dst=plan.dst, num_nodes=plan.num_nodes, n_src=plan.n_src,
            num_tasks=plan.num_tasks, num_edges=plan.num_edges, **kw,
        )
    return plan


def hybrid_tag(n, m, threshold, tile_rows, residual_block, tile_dtype, graph_kind, reorder, bit_tiles=False,
               tile_cols=128) -> str:
    tag = f"hybrid_n{n}_m{m}_t{threshold}_r{tile_rows}_b{residual_block}"
    if tile_cols != 128:
        tag += f"_c{tile_cols}"
    if tile_dtype != "bf16":
        tag += f"_{tile_dtype}"
    if bit_tiles:
        tag += "_bt"
    if graph_kind != "rmat":
        tag = f"{graph_kind}_{tag}"
    if reorder != "degree":
        tag += f"_{reorder}"
    return tag


def _save_tile(tp, prefix: str) -> dict:
    """TilePlan -> npz fields: 1-bit tiles as uint8 'a_u8', int8 counts as
    'a_i8', bfloat16 values as their bit pattern 'a_u16'."""
    a = np.asarray(tp.a)
    if tp.bits:
        a_kw = {f"{prefix}a_u8": a}
    elif a.dtype == np.int8:
        a_kw = {f"{prefix}a_i8": a}
    else:
        a_kw = {f"{prefix}a_u16": a.view(np.uint16)}
    return {
        **a_kw,
        f"{prefix}tile_col": tp.tile_col,
        f"{prefix}tile_row": tp.tile_row,
        f"{prefix}tile_rows": tp.tile_rows,
        f"{prefix}tile_cols": tp.tile_cols,
        f"{prefix}num_tiles": tp.num_tiles,
        f"{prefix}num_dense_edges": tp.num_dense_edges,
    }


def _load_tile(z, prefix: str, num_nodes: int, n_src: int):
    """Inverse of _save_tile; None when the part is absent."""
    bits = False
    if f"{prefix}a_u8" in z.files:
        a, bits = z[f"{prefix}a_u8"], True
    elif f"{prefix}a_i8" in z.files:
        a = z[f"{prefix}a_i8"]
    elif f"{prefix}a_u16" in z.files:
        a = z[f"{prefix}a_u16"]
    else:
        return None
    rows = z[f"{prefix}tile_row"]
    tile_rows = int(z[f"{prefix}tile_rows"])
    return TilePlan(
        a=a, tile_col=z[f"{prefix}tile_col"], tile_row=rows, run_start=run_offsets(rows, -(-num_nodes // tile_rows)),
        scale_dst=None, scale_src=None, num_nodes=num_nodes, n_src=n_src, tile_rows=tile_rows,
        tile_cols=int(z[f"{prefix}tile_cols"]), num_tiles=int(z[f"{prefix}num_tiles"]),
        num_dense_edges=int(z[f"{prefix}num_dense_edges"]), bits=bits,
    )


def _reorder_perm(g, n: int, m: int, reorder: str, graph_kind: str) -> np.ndarray:
    """The hybrid plan's row order, cached beside the plans."""
    perm_path = os.path.join(_cache_dir(), f"perm_{graph_kind}_n{n}_m{m}_{reorder}.npy")
    if os.path.exists(perm_path):
        return np.load(perm_path)
    if reorder == "hublpa":
        # a global hub stripe up front (cross-community mass), then the
        # label-propagation communities' diagonal blocks
        perm = label_propagation_reorder(g, hubs=max(256, g.num_nodes // 128))
    elif reorder == "lpa":
        perm = label_propagation_reorder(g)
    elif reorder == "cluster":
        perm = cluster_reorder(g)
    elif reorder == "cluster_exact":
        perm = cluster_reorder_exact(g)
    else:
        perm = degree_sort(g)
    _atomic_save(perm_path, perm)
    return perm


def build_hybrid(g_fn, n, m, threshold, tile_rows, residual_block, tile_dtype="bf16", pack=8, reorder="degree",
                 graph_kind="rmat", bit_tiles=False, check_only=False, tile_cols=128):
    """Reordered hybrid aggregator (host arrays), disk-cached unpadded and
    padded to ``pack`` at load.  reorder: 'degree' (hub stripes, RMAT),
    'lpa' / 'hublpa' (community-contiguous label propagation), 'cluster' /
    'cluster_exact' (MinHash-LSH).  bit_tiles splits the int8 count tiles
    into a 1-bit part and an int8 part (tiles.split_bit_tiles)."""
    tag = hybrid_tag(n, m, threshold, tile_rows, residual_block, tile_dtype, graph_kind, reorder, bit_tiles,
                     tile_cols)
    path = os.path.join(_cache_dir(), tag + ".npz")
    if os.path.exists(path) and check_only:
        log(f"cache ok: {tag}")
        return None
    if os.path.exists(path):
        log(f"loading cached hybrid plan {tag}")
        with np.load(path) as z:
            nn, ns = int(z["num_nodes"]), int(z["n_src"])
            tile, tile_b = _load_tile(z, "", nn, ns), _load_tile(z, "b_", nn, ns)
            plan = AggregationPlan(
                src=z["p_src"], count=z["p_count"], dst=z["p_dst"], val=z["p_val"], edge_perm=None,
                num_nodes=nn, n_src=ns, block_size=residual_block, num_tasks=int(z["p_num_tasks"]),
                num_edges=int(z["p_num_edges"]), sorted_by_dst=True, partition_starts=(0, int(z["p_num_tasks"])),
            )
            in_degree = z["in_degree"]
        return Aggregator(
            plan=plan, num_nodes=nn, n_src=ns, num_edges=m,
            tile=None if tile is None else tile.pad_runs(pack),
            tile_bits=None if tile_b is None else tile_b.pad_runs(pack), in_degree=in_degree,
        )

    if bit_tiles and tile_dtype != "int8":
        raise ValueError("bit_tiles needs integer count tiles (--tile-dtype int8)")
    t0 = time.time()
    g = g_fn()
    g2 = g.reorder(_reorder_perm(g, n, m, reorder, graph_kind))
    log(f"{reorder} reorder: {time.time() - t0:.1f}s")
    t0 = time.time()
    tile, res = densify(g2, tile_rows=tile_rows, tile_cols=tile_cols, threshold=threshold,
                        dtype=np.int8 if tile_dtype == "int8" else "bfloat16")
    tile_b = None
    if bit_tiles:
        tile_b, tile = split_bit_tiles(tile)
    plan = neighbor_grouping_plan(res, block_size=residual_block)
    parts = [t for t in (tile_b, tile) if t is not None]
    log(f"hybrid plan: {time.time() - t0:.1f}s  tiles={[(t.num_tiles, t.num_dense_edges) for t in parts]} "
        f"residual={plan.stats()}")
    tile_kw = {}
    if tile is not None:
        tile_kw.update(_save_tile(tile, ""))
    if tile_b is not None:
        tile_kw.update(_save_tile(tile_b, "b_"))
    _atomic_savez(
        path, **tile_kw, num_nodes=g2.num_nodes, n_src=g2.n_src, p_src=plan.src, p_count=plan.count,
        p_dst=plan.dst, p_val=plan.val, p_num_tasks=plan.num_tasks, p_num_edges=plan.num_edges,
        in_degree=g2.degrees,
    )
    return Aggregator(
        plan=plan, num_nodes=g2.num_nodes, n_src=g2.n_src, num_edges=m,
        tile=None if tile is None else tile.pad_runs(pack),
        tile_bits=None if tile_b is None else tile_b.pad_runs(pack), in_degree=g2.degrees,
    )


def transpose_path(cache_tag: str) -> str:
    return os.path.join(_cache_dir(), f"{cache_tag}.transpose.npz")


def transpose_cached(cache_tag: str) -> bool:
    return os.path.exists(transpose_path(cache_tag))


def add_transpose(agg, pack: int, cache_tag=None):
    """The cached forward-only hybrid aggregator with the transposed plans
    the training backward streams (tile parts, residual plan, edge map),
    disk-cached under ``cache_tag``: an O(m) host pass that must not run in
    the timed process.  The residual's edges come from the plan's slot grid;
    the tile parts are transposed as loaded (padded: the filler tiles are
    all-zero and transpose to all-zero tiles, as in bench.py)."""
    tpath = transpose_path(cache_tag) if cache_tag else None
    if tpath and os.path.exists(tpath):
        log(f"loading cached transpose plans {os.path.basename(tpath)}")
        with np.load(tpath) as z:
            nn, ns = int(z["num_nodes"]), int(z["n_src"])
            tile_t, tile_b_t = _load_tile(z, "", nn, ns), _load_tile(z, "b_", nn, ns)
            plan_t = AggregationPlan(
                src=z["p_src"], count=z["p_count"], dst=z["p_dst"], val=z["p_val"] if "p_val" in z.files else None,
                edge_perm=None, num_nodes=nn, n_src=ns, block_size=int(z["p_block_size"]),
                num_tasks=int(z["p_num_tasks"]), num_edges=int(z["p_num_edges"]), sorted_by_dst=True,
                partition_starts=(0, int(z["p_num_tasks"])),
            )
            edge_map = z["edge_map"]
    else:
        plan = agg.plan
        src = np.asarray(plan.src).reshape(plan.num_tasks_padded, plan.block_size)
        cnt = np.asarray(plan.count)
        mask = np.arange(src.shape[1])[None, :] < cnt[:, None]
        res = CSRGraph.from_edges(
            dst=np.repeat(np.asarray(plan.dst), cnt).astype(np.int64), src=src[mask].astype(np.int32),
            num_nodes=agg.num_nodes, val=np.ones(int(cnt.sum()), np.float32), n_src=agg.n_src,
        )
        gt, edge_map = res.transpose_with_map()
        edge_map = edge_map.astype(np.int32)
        plan_t = make_plan(gt, block_size=plan.block_size)
        tile_t = None if agg.tile is None else agg.tile.transpose()
        tile_b_t = None if agg.tile_bits is None else agg.tile_bits.transpose()
        if tpath:
            a_kw = {}
            if tile_t is not None:
                a_kw.update(_save_tile(tile_t, ""))
            if tile_b_t is not None:
                a_kw.update(_save_tile(tile_b_t, "b_"))
            if plan_t.val is not None:
                a_kw["p_val"] = plan_t.val
            _atomic_savez(
                tpath, **a_kw, edge_map=edge_map, num_nodes=plan_t.num_nodes, n_src=plan_t.n_src,
                p_src=plan_t.src, p_count=plan_t.count, p_dst=plan_t.dst, p_block_size=plan_t.block_size,
                p_num_tasks=plan_t.num_tasks, p_num_edges=plan_t.num_edges,
            )
    return dataclasses.replace(
        agg, plan_t=plan_t, edge_map_t=edge_map,
        tile_t=None if tile_t is None else tile_t.pad_runs(pack),
        tile_bits_t=None if tile_b_t is None else tile_b_t.pad_runs(pack),
    )


def kernel_launches() -> dict:
    """Every tile kernel's launch count (B1-B6), as the ops' wrappers keep
    them."""
    c = launch_counts()
    return {k: c[k] for k in ("B1", "B2", "B3", "B4", "B5", "B6")}


def timed_run(em: Emitter, fn, *inputs, iters: int, **extra):
    """benchmark_chained(fn, *inputs) through ``em``; the capture row gets
    the kernels' launches over the run and the calls of ``fn`` made."""
    calls = [0]

    def counted(*a):
        calls[0] += 1
        return fn(*a)

    before = kernel_launches()
    r = benchmark_chained(counted, *inputs, iters=iters, reps=REPS, on_rep=em.on_rep)
    launches = {k: v - before[k] for k, v in kernel_launches().items() if v != before[k]}
    log(f"first call: {r.compile_s:.1f}s  launches {launches} over {calls[0]} calls")
    em.finish(launches=launches, calls=calls[0], **extra)
    return r


def _features(n: int, f: int, seed: int, dev):
    return torch.from_numpy(normal_features(n, f, seed=seed) * 0.1).to(dev)


def _parts(agg) -> dict:
    return dict(tile_parts=len(agg.tile_parts()), tile_parts_t=len(agg.tile_parts_t()))


def run_train(args, g, n, m):
    """GCN / GAT full-graph training step (forward, backward, Adam) over
    the hybrid plan and its cached transposed plans.  Metric: aggregation
    passes a second x m, 6 passes a step (3 forward, 3 backward dH);
    vs_baseline against the V100's forward rate (the reference publishes no
    training number)."""
    tag = hybrid_tag(n, m, args.threshold, args.tile_rows, args.residual_block, args.tile_dtype, args.graph,
                     args.reorder, args.bit_tiles, args.tile_cols)
    need_t = not transpose_cached(tag)
    sched = build_hybrid(
        g, n, m, args.threshold, args.tile_rows, args.residual_block, tile_dtype=args.tile_dtype, pack=args.pack,
        reorder=args.reorder, graph_kind=args.graph, bit_tiles=args.bit_tiles, tile_cols=args.tile_cols,
        check_only=(args.phase == "build" and not need_t),
    )
    if args.phase != "build" or need_t:
        log("building transposed plans for backward...")
        t0 = time.time()
        sched = add_transpose(sched, args.pack, cache_tag=tag)
        log(f"transpose: {time.time() - t0:.1f}s")
    if args.phase == "build":
        log("[bench] build phase done (train plans cached)")
        return
    dev = args.device
    sched = sched.to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    if args.model == "gat":
        # stabilize='bound' on the training path: the un-shifted softmax
        # overflows on the wide logits training reaches; the O(n) global
        # bound replaces the per-destination row max
        params = init_gat_params(BENCH_DIMS, gen, device=dev)
        leaves = [t for p in params for t in p]

        def forward(hh):
            return gat_forward(sched, params, hh, fast=False, stabilize="bound", dot_mode=args.gat_dot_mode)
    else:
        params = leaves = init_gcn_params(BENCH_DIMS, gen, device=dev)

        def forward(hh):
            return gcn_forward_bench(sched, params, hh)

    h = _features(n, BENCH_DIMS[0], 123, dev)
    labels = torch.from_numpy(np.random.default_rng(7).integers(0, BENCH_DIMS[-1], n)).to(dev)
    step = make_train_step(forward, torch.optim.Adam(leaves, lr=1e-3), device=dev)

    def train_step(hh, yy):
        with torch.enable_grad():
            return step((hh,), yy)[None]

    log("warmup (train step)...")
    passes = 6  # 3 forward + 3 backward-dH aggregations
    em = Emitter(
        f"{args.model}3_train_{args.scale_label}_scale_step_agg_passes_edges_per_s_per_chip",
        SCALE_BASELINES[args.scale][args.model], lambda t: passes * m / t,
        capture_extra={"model": args.model, "train": True, "scale": args.scale_label, "device": args.device_label},
        capture=args.capture,
    )
    r = timed_run(em, train_step, h, labels, iters=args.iters, **_parts(sched))
    log(f"train step: {r.min_s * 1e3:.2f} ms")


def residual_dtype(args):
    """--residual-dtype as the residual gather takes it."""
    return {"f32": None, "f16": torch.float16, "bf16": torch.bfloat16, "bf16_split2": "bf16_split2",
            "f16_split2": "f16_split2"}[args.residual_dtype]


def forward_fn(args):
    """forward(sched, params, h) of the gcn or gat forward bench.py times:
    the GCN with fast_layer_opts (--layer-config fast over the hybrid plan)
    or the --residual-dtype mode, the GAT with fast residual gathers and
    --gat-dot-mode, un-stabilized; a bfloat16 input (--input-dtype bf16) is
    widened to float32 first."""
    fast = args.layer_config == "fast" and args.strategy == "hybrid"
    if args.model == "gat":
        def forward(s, p, hh):
            return gat_forward(s, p, hh.float(), fast=fast, dot_mode=args.gat_dot_mode)
    else:
        layer_opts = fast_layer_opts(BENCH_DIMS) if fast else None
        rdt = residual_dtype(args)

        def forward(s, p, hh):
            return gcn_forward_bench(s, p, hh.float(), layer_opts=layer_opts, residual_gather_dtype=rdt)

    return forward


def run_forward(args, g, n, m):
    """Every forward path of bench.py: sage, edgemlp, sddmm (hybrid and
    gather), spmm, and the gcn / gat forwards (hybrid or gather)."""
    build = args.phase == "build"
    dev = args.device
    baselines = SCALE_BASELINES[args.scale]

    def emitter(metric, base, to_value, **extra):
        return Emitter(metric, base, to_value, capture_extra=dict(extra, device=args.device_label),
                       capture=args.capture)

    if args.model == "sage":
        # SAGE-LSTM over the presampled fixed-16-neighbour graph (the
        # reference's "ours" strategy: redundancy bypass)

        f = 32
        spath = os.path.join(_cache_dir(), f"sample{SAGE_K}_{args.graph}_n{n}_m{m}.npz")
        if not os.path.exists(spath):
            _atomic_savez(spath, nbr=presample_fixed_neighbors(g(), k=SAGE_K, seed=2))
        if build:
            log("[bench] build phase done (sample cached)")
            return
        with np.load(spath) as z:
            nbr = torch.from_numpy(z["nbr"]).to(dev)
        x = _features(n, f, 3, dev)
        params = init_lstm_params(f, f, torch.Generator(device=dev).manual_seed(0), device=dev)
        gdt = None if args.layer_config == "exact" else torch.float16
        em = emitter(f"sagelstm_{args.scale_label}_scale_edges_per_s_per_chip", baselines["sage"],
                     lambda t: n * SAGE_K / t, model="sage", scale=args.scale_label)
        r = timed_run(em, lambda xx, p, nb: lstm_aggregate(p, xx, nb, "redundancy_bypass", gate_gather_dtype=gdt,
                                                            unroll=16), x, params, nbr, iters=args.iters)
        log(f"sage aggregate: {r.min_s * 1e3:.2f} ms")
        return

    if args.model == "edgemlp":
        # the per-edge MLP aggregation at the reference's 32 x 32 W; no V100
        # number exists for it, so the GCN per-pass anchor stands in

        f = 32
        plan = build_gather(g, args.block_size, n, m, args.graph, check_only=build)
        if build:
            log("[bench] build phase done (gather plan cached)")
            return
        plan = plan.to(dev)
        h, w = _features(n, f, 3, dev), _features(f, f, 4, dev)
        em = emitter(f"edgemlp_{args.scale_label}_scale_edges_per_s_per_chip", baselines["gcn"], lambda t: m / t,
                     model="edgemlp", scale=args.scale_label)
        r = timed_run(em, lambda hh, p, ww: edge_mlp_chunked(p, hh, ww), h, plan, w, iters=args.iters)
        log(f"edge_mlp pass: {r.min_s * 1e3:.2f} ms")
        return

    if args.model == "sddmm":
        # per-edge dots <a[src], b[dst]> at f = 32 over every edge; the
        # V100 per-pass SpMM rate stands in for the baseline

        f = 32
        gdt = "f16_split2" if args.layer_config == "fast" else None
        if args.strategy == "hybrid":
            sched = build_hybrid(
                g, n, m, args.threshold, args.tile_rows, args.residual_block, tile_dtype="int8", pack=args.pack,
                reorder=args.reorder, graph_kind=args.graph, bit_tiles=True, tile_cols=args.tile_cols,
                check_only=build,
            )
            if build:
                log("[bench] build phase done (hybrid plan cached)")
                return
            sched = sched.to(dev)
            a, b = _features(n, f, 3, dev), _features(n, f, 4, dev)

            def run(aa, s, bb):
                cells, res = hybrid_sddmm(s.tile_parts(), s.plan if s.plan.num_edges else None, aa, bb,
                                          gather_dtype=gdt, dot_mode=args.sddmm_dot_mode)
                # one element of every output into the chained harness's carry
                probe = sum(c.reshape(-1)[:1].float() for c in cells)
                if res is not None:
                    probe = probe + res.reshape(-1)[:1].float()
                return probe

            em = emitter(f"sddmm_{args.scale_label}_scale_edges_per_s_per_chip", baselines["sddmm"],
                         lambda t: m / t, model="sddmm", strategy="hybrid", tile_rows=args.tile_rows,
                         threshold=args.threshold, scale=args.scale_label)
            r = timed_run(em, run, a, sched, b, iters=args.iters, **_parts(sched))
            log(f"sddmm hybrid pass: {r.min_s * 1e3:.2f} ms")
            return
        plan = build_gather(g, args.block_size, n, m, args.graph, check_only=build)
        if build:
            log("[bench] build phase done (gather plan cached)")
            return
        plan = plan.to(dev)
        a, b = _features(n, f, 3, dev), _features(n, f, 4, dev)
        em = emitter(f"sddmm_{args.scale_label}_scale_edges_per_s_per_chip", baselines["sddmm"], lambda t: m / t,
                     model="sddmm", strategy="gather", scale=args.scale_label)
        r = timed_run(em, lambda aa, p, bb: sddmm_slots(p, aa, bb, gather_dtype=gdt), a, plan, b, iters=args.iters)
        log(f"sddmm pass: {r.min_s * 1e3:.2f} ms")
        return

    plan_kw = dict(tile_dtype=args.tile_dtype, pack=args.pack, reorder=args.reorder, graph_kind=args.graph,
                   bit_tiles=args.bit_tiles, tile_cols=args.tile_cols, check_only=build)
    if args.strategy == "hybrid":
        sched = build_hybrid(g, n, m, args.threshold, args.tile_rows, args.residual_block, **plan_kw)
    else:
        sched = build_gather(g, args.block_size, n, m, args.graph, check_only=build)
    sched2 = None
    if (args.strategy == "hybrid" and args.model == "gcn" and args.threshold2 is not None
            and args.threshold2 != args.threshold):
        # a denser plan for the narrow (f <= 64) layers: their tile cost
        # falls with width while the residual's slot cost does not
        sched2 = build_hybrid(g, n, m, args.threshold2, args.tile_rows, args.residual_block, **plan_kw)
    if build:
        log("[bench] build phase done (plan cached)")
        return
    sched = sched.to(dev)
    if sched2 is not None:
        sched2 = sched2.to(dev)

    rdt = residual_dtype(args)
    gen = torch.Generator(device=dev).manual_seed(0)
    if args.model == "spmm":
        # one aggregation pass out = A @ h at f = 128 over the headline plan
        h = _features(n, 128, 123, dev)
        thm = "split" if args.layer_config == "fast" else "auto"
        em = emitter(f"spmm_{args.scale_label}_scale_edges_per_s_per_chip", baselines["spmm"], lambda t: m / t,
                     model="spmm", scale=args.scale_label)
        r = timed_run(em, lambda hh, s: s.run(hh, residual_gather_dtype=rdt, tile_h_mode=thm), h, sched,
                      iters=args.iters, **_parts(sched))
        log(f"spmm pass: {r.min_s * 1e3:.2f} ms")
        return
    init = init_gat_params if args.model == "gat" else init_gcn_params
    params = init(BENCH_DIMS, gen, device=dev)
    forward = forward_fn(args)
    h = _features(n, BENCH_DIMS[0], 123, dev)
    if args.input_dtype == "bf16":
        h = h.to(torch.bfloat16)

    sched_arg = sched if sched2 is None else (sched, sched2, sched2)
    em = emitter(
        f"{args.model}3_{args.scale_label}_scale_edges_per_s_per_chip", baselines[args.model], lambda t: 3 * m / t,
        model=args.model, scale=args.scale_label, graph=args.graph, reorder=args.reorder, threshold=args.threshold,
        threshold2=args.threshold2, tile_rows=args.tile_rows, tile_cols=args.tile_cols, strategy=args.strategy,
        **({"gat_dot_mode": args.gat_dot_mode} if args.model == "gat" else {}),
    )
    parts = _parts(sched) if args.strategy == "hybrid" else {}
    if sched2 is not None:
        parts["tile_parts2"] = len(sched2.tile_parts())
    r = timed_run(em, lambda hh, s, p: forward(s, p, hh), h, sched_arg, params, iters=args.iters, **parts)
    log(f"forward: {r.min_s * 1e3:.2f} ms")


def arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help="small-graph smoke (RMAT 65,536 v / 4,194,304 e)")
    ap.add_argument("--train", action="store_true",
                    help="time a full training step (forward, backward, Adam) instead of the forward")
    ap.add_argument("--strategy", default="hybrid", choices=["hybrid", "gather"])
    ap.add_argument("--graph", default="rmat", choices=["community", "rmat"],
                    help="synthetic stand-in for reddit.dgl: rmat (the headline, power law without community "
                    "structure) or community (subreddit communities, co-comment neighbourhoods)")
    ap.add_argument("--reorder", default=None, choices=["degree", "lpa", "hublpa", "cluster", "cluster_exact"],
                    help="hybrid-plan reorder; default hublpa for --graph community, degree for rmat")
    ap.add_argument("--model", default="gcn", choices=["gcn", "gat", "sage", "spmm", "sddmm", "edgemlp"],
                    help="gcn/gat/sage: 3-layer model forwards; spmm: one aggregation pass at f=128 over the "
                    "hybrid plan; sddmm: per-edge feature dots at f=32 over every edge; edgemlp: the per-edge "
                    "MLP aggregation at f=32 over the gather plan")
    ap.add_argument("--block-size", type=int, default=32)
    ap.add_argument("--residual-block", type=int, default=None)
    ap.add_argument("--threshold", type=int, default=None)
    ap.add_argument("--threshold2", type=int, default=None,
                    help="denser tile threshold for the f<=64 layers (GCN hybrid only): a second plan used by "
                    "layers 2-3")
    ap.add_argument("--tile-rows", type=int, default=None)
    ap.add_argument("--tile-cols", type=int, default=None,
                    help="hybrid tile width C; default 256 for the reddit gcn/gat/spmm forwards and training, "
                    "else 128")
    ap.add_argument("--tile-dtype", default="int8", choices=["bf16", "int8"])
    ap.add_argument("--bit-tiles", default="auto", choices=["auto", "on", "off"],
                    help="split 0/1-only tiles into 1-bit storage; auto = on at products, citation, ppa and for "
                    "--train, off for the reddit and protein forwards")
    ap.add_argument("--pack", type=int, default=None)
    ap.add_argument("--residual-dtype", default="f32", choices=["f32", "f16", "bf16", "bf16_split2", "f16_split2"],
                    help="residual gather mode of every layer (overridden by --layer-config fast)")
    ap.add_argument("--layer-config", default="fast", choices=["exact", "fast"],
                    help="per-layer numeric modes: fast = models.gcn.fast_layer_opts (split tiles, f16_split2 "
                    "residual rows where f<=64); exact = float32 residual and tile operands everywhere")
    ap.add_argument("--sddmm-dot-mode", default="split23", choices=["exact", "split23", "split33"])
    ap.add_argument("--gat-dot-mode", default="split2", choices=["exact", "split2", "default"])
    ap.add_argument("--input-dtype", default=None, choices=["f32", "bf16"],
                    help="storage dtype of the [n, 512] input (compute stays float32); default bf16 at products, "
                    "citation and ppa, else f32")
    ap.add_argument("--scale", default="reddit", choices=["reddit", "products", "citation", "ppa", "protein"])
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu: the plain PyTorch versions")
    ap.add_argument("--cache-dir", default=None, dest="cache_dir",
                    help="graph and plan caches (default build/bench_cache/)")
    ap.add_argument("--capture", default=None,
                    help="capture log (default gnn_computing_tpu_torch/benchmarks/results/capture.jsonl)")
    # the two-phase harness (module doc): None orchestrates, 'build' builds
    # the host caches, 'timed' times from them in a fresh process
    ap.add_argument("--phase", choices=["build", "timed"], default=None, help=argparse.SUPPRESS)
    return ap


def resolve_defaults(args) -> None:
    """bench.py's per-model and per-scale defaults, in place."""
    args.bit_tiles = (
        args.tile_dtype == "int8" and (args.scale in ("products", "citation", "ppa") or args.train)
        if args.bit_tiles == "auto" else args.bit_tiles == "on"
    )
    args.scale_label = "quick" if args.quick else args.scale
    if args.reorder is None:
        args.reorder = "hublpa" if args.graph == "community" else "degree"
    if args.train:
        # [256, 256] tiles: the transposed plan keeps the forward's
        # geometry; t24, residual 4, pack 16 (bench.py:1086-1105)
        for k, v in dict(threshold=24, tile_rows=256, tile_cols=256, residual_block=4, pack=16).items():
            if getattr(args, k) is None:
                setattr(args, k, v)
        return
    if args.tile_cols is None:
        args.tile_cols = 256 if args.scale == "reddit" and args.model in ("gcn", "gat", "spmm") else 128
    if args.threshold is None and args.scale == "reddit" and args.tile_cols == 256:
        args.threshold = 32 if args.model == "gat" else 48
    if args.model == "sddmm" and args.strategy == "hybrid":
        # [256, C] tiles with 1-bit storage: the per-cell output is
        # tiles x R x C x 2 bytes (bench.py:1231-1243)
        if args.tile_rows in (None, 512):
            args.tile_rows = 256
        for k, v in dict(threshold=24, residual_block=4, pack=16).items():
            if getattr(args, k) is None:
                setattr(args, k, v)
        return
    if args.scale in ("products", "citation", "ppa"):
        # the sparse scales (mean degree 50 / 10 / 74): much sparser tiling
        if args.threshold is None:
            args.threshold = {"products": 384, "ppa": 96, "citation": 48}[args.scale]
        if args.tile_rows is None:
            args.tile_rows = 1024
        if args.pack is None:
            args.pack = 4
    if args.scale == "protein" and args.threshold is None:
        args.threshold = 48  # the densest graph (mean degree 597)
    for k, v in dict(threshold=24, tile_rows=512, residual_block=4, pack=16).items():
        if getattr(args, k) is None:
            setattr(args, k, v)
    if args.input_dtype is None:
        args.input_dtype = "bf16" if args.scale in ("products", "citation", "ppa") else "f32"


def orchestrate(argv: list) -> int:
    """Run the build child (host only), then the timed child in a fresh
    process, relaying its stdout; returns the exit code."""
    module = [sys.executable, "-m", "gnn_computing_tpu_torch.bench"]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    log("[bench] phase 1/2: building caches (host process)")
    rc = subprocess.call([*module, *argv, "--phase", "build"], env=env, stdout=sys.stderr)
    if rc:
        log(f"[bench] build phase failed (exit {rc})")
        return rc
    log("[bench] phase 2/2: timing from cached plans (fresh process)")
    budget = float(os.environ.get("BENCH_BUDGET_S", "1200"))
    p = subprocess.Popen([*module, *argv, "--phase", "timed"], env=env, stdout=subprocess.PIPE, text=True)
    got, deadline = False, time.time() + budget
    try:
        while True:
            wait = deadline - time.time()
            if not got and wait <= 0:
                log(f"[bench] timed phase over its budget ({budget:.0f} s, no metric line): killed")
                p.kill()
                return 3
            ready, _, _ = select.select([p.stdout], [], [], max(wait, 1.0) if not got else 60.0)
            if not ready:
                continue
            line = p.stdout.readline()
            if not line:
                break
            line = line.rstrip("\n")
            if line.startswith("{"):
                print(line, flush=True)
                got = True
            else:
                log(line)
    except BaseException:
        p.kill()  # an interrupted orchestrator leaves no timed child behind
        raise
    finally:
        p.wait()
    if p.returncode:
        log(f"[bench] timed phase failed (exit {p.returncode})")
        return p.returncode
    if not got:
        log("[bench] timed phase printed no metric line")
        return 3
    return 0


def main(argv=None) -> int:
    global CACHE_DIR
    argv = sys.argv[1:] if argv is None else list(argv)
    args = arg_parser().parse_args(argv)
    if args.cache_dir:
        CACHE_DIR = os.path.abspath(args.cache_dir)
    if args.train and (args.model not in ("gcn", "gat") or args.strategy != "hybrid"):
        raise SystemExit("--train times the gcn or gat step over the hybrid plan (bench.py:1087)")
    if args.model == "spmm" and args.strategy != "hybrid":
        raise SystemExit("--model spmm runs Aggregator.run over the hybrid plan; a gather plan has none")
    resolve_defaults(args)

    if args.phase is None:
        resolve_device(args.device)  # no card asked for and absent: raise before building
        return orchestrate(argv)
    if args.phase == "build":
        _sweep_tmp_stragglers(_cache_dir())
        args.device = args.device_label = None
    else:
        args.device = resolve_device(args.device)
        args.device_label = device_label(args.device)

    if args.quick:
        n, m = QUICK_N, QUICK_M
    else:
        n, m = SCALE_NM[args.scale]
    g = lazy_graph(n, m, args.graph)
    if args.train:
        run_train(args, g, n, m)
    else:
        run_forward(args, g, n, m)
    if args.phase == "build":
        if torch.cuda.is_initialized():
            raise RuntimeError("the build phase initialised CUDA: it must stay on the host")
    return 0


if __name__ == "__main__":
    sys.exit(main())
