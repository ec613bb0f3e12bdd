"""Schedule autotuning: measure and pick over the plan hyperparameters.

Port of ``gnn_computing_tpu/utils/autotune.py``: build candidate schedules,
time one forward aggregation per candidate with the chained harness
(utils.timing.benchmark_chained), return the winner and the whole table.
The sweep lists and their order are the JAX package's.  On the card the
hybrid candidates run B1 over their tiles.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from gnn_computing_tpu_torch.graph.csr import CSRGraph

# tile dtype name -> what the port's densify takes
TILE_DTYPES = {"int8": np.int8, "bf16": torch.bfloat16, "f32": np.float32}


@dataclasses.dataclass
class TuneResult:
    best: object  # the winning Aggregator
    best_config: dict
    table: list  # [(config dict, seconds)]


def _time_agg(agg, feature_len: int, iters: int, seed: int = 0) -> float:
    from gnn_computing_tpu_torch.utils.timing import benchmark_chained

    rng = np.random.default_rng(seed)
    h = torch.from_numpy(rng.normal(size=(agg.num_nodes, feature_len)).astype(np.float32)).to(agg.plan.src.device)
    r = benchmark_chained(lambda x, a: a.run(x), h, agg, iters=iters, reps=2)
    return r.min_s


def tune_gather(
    g: CSRGraph,
    feature_len: int = 128,
    block_sizes: Sequence[int] = (8, 16, 32, 64),
    iters: int = 4,
    device="cuda",
) -> TuneResult:
    """Sweep the neighbor-grouping block size (the reference's --nei)."""
    from gnn_computing_tpu_torch.aggregator import Aggregator

    table = []
    best = None
    for b in block_sizes:
        agg = Aggregator.schedule(g, block_size=b, with_transpose=False, device=device)
        t = _time_agg(agg, feature_len, iters)
        cfg = {"block_size": b}
        table.append((cfg, t))
        if best is None or t < best[1]:
            best = (agg, t, cfg)
    return TuneResult(best=best[0], best_config=best[2], table=table)


def tune_hybrid(
    g: CSRGraph,
    feature_len: int = 128,
    thresholds: Sequence[int] = (16, 24, 48),
    tile_rows: Sequence[int] = (256, 512),
    dtypes: Sequence[str] = ("int8", "bf16"),
    residual_block: int = 4,
    iters: int = 4,
    weighted: bool = False,
    device="cuda",
) -> TuneResult:
    """Sweep hybrid densification (tile height x threshold x tile dtype, in
    that nesting).  ``int8`` tiles hold exact counts, so a weighted graph
    skips them.  Candidates are scheduled with ``pack=1``, the port's rule:
    the CUDA kernels take runs of any length, so the TPU kernel's filler
    tiles (the JAX package packs 16) would only add work."""
    from gnn_computing_tpu_torch.aggregator import Aggregator

    table = []
    best = None
    for r in tile_rows:
        for thr in thresholds:
            for dts in dtypes:
                if dts == "int8" and weighted:
                    continue
                agg = Aggregator.schedule_hybrid(
                    g,
                    tile_rows=r,
                    threshold=thr,
                    residual_block=residual_block,
                    tile_dtype=TILE_DTYPES[dts],
                    with_transpose=False,
                    pack=1,
                    device=device,
                )
                t = _time_agg(agg, feature_len, iters)
                cfg = {"tile_rows": r, "threshold": thr, "tile_dtype": dts}
                table.append((cfg, t))
                if best is None or t < best[1]:
                    best = (agg, t, cfg)
    return TuneResult(best=best[0], best_config=best[2], table=table)


def tune(
    g: CSRGraph,
    feature_len: int = 128,
    iters: int = 4,
    weighted: bool = False,
    include_hybrid: bool = True,
    device="cuda",
) -> TuneResult:
    """Full sweep: gather block sizes, then the hybrid configurations;
    returns the overall winner (an Aggregator ready for run / run_gat) and
    the table, each config tagged with its strategy."""
    rg = tune_gather(g, feature_len, iters=iters, device=device)
    table = list(rg.table)
    best = (rg.best, dict(rg.best_config, strategy="gather"))
    best_t = min(t for _, t in rg.table)
    if include_hybrid:
        rh = tune_hybrid(g, feature_len, iters=iters, weighted=weighted, device=device)
        table += rh.table
        ht = min(t for _, t in rh.table)
        if ht < best_t:
            best = (rh.best, dict(rh.best_config, strategy="hybrid"))
    table = [(dict(c, strategy="hybrid" if "threshold" in c else "gather"), t) for c, t in table]
    return TuneResult(best=best[0], best_config=best[1], table=table)
