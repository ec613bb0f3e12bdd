"""Probe: B1's staged walk against its gather walk on the benchmark's plans.

For each traffic named (``portbench/traffic/<name>.json``: its graph drawn
on the card as the benchmark draws it, its reorder and its hybrid plan,
through ``harness.plan_graph``), each tile part of the plan and of its
transposes: the part's counts (tiles, live tiles, nonzero cells, tile rows
walked and those holding a cell, tiles of at least 1,024 cells and their
cells); the seconds its work list took to build; then B1's ms a launch
(CUDA events, median of 10) at f = 128, 64 and 32 with every chunk walked
by gathers, with the list's staged chunks (``cell_walk.STAGE_K``) staged,
and as the launch's rule (``cell_walk.stages``) chooses, each output
bitwise the gather walk's.  Logs as it goes and prints one JSON line
with the card's name and power limit.

Run: python -m portbench.staged_walk --traffic reddit-forward reddit-train
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time
from unittest import mock

import torch

from gnn_computing_tpu_torch.ops import cell_walk, cuda_bcsr
from gnn_computing_tpu_torch.utils.timing import cuda_time_ms
from portbench import harness

TRAFFIC_DIR = pathlib.Path(__file__).resolve().parent / "traffic"
DENSE_TILE = 1024  # cells of a tile counted as dense in the part's counts
WIDTHS = (128, 64, 32)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def part_counts(tp) -> dict:
    """The part's tiles, live tiles, nonzero cells, tile rows walked and
    those holding a cell, and its tiles of at least DENSE_TILE cells."""
    nnz = cell_walk.tile_nnz(tp)
    rows = 0
    for s in range(0, tp.num_tiles, 1024):
        c = tp.a[s : s + 1024]
        if tp.bits:
            rows += sum(int(((c >> b) & 1).any(dim=2).sum()) for b in range(8))
        else:
            rows += int((c != 0).any(dim=2).sum())
    dense = nnz >= DENSE_TILE
    cells = int(nnz.sum())
    return dict(format=tp.format, shape=[tp.tile_rows, tp.tile_cols], tiles=tp.num_tiles,
                live_tiles=int((nnz > 0).sum()), cells=cells, rows_walked=tp.num_tiles * tp.tile_rows,
                nonzero_rows=rows, cells_per_nonzero_row=cells / max(rows, 1), dense_tiles=int(dense.sum()),
                dense_cells=int(nnz[dense].sum()))


def time_part(tp) -> dict:
    """B1 over the part by path and f (module doc)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    sms = torch.cuda.get_device_properties(tp.a.device).multi_processor_count
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    walk = cell_walk.walk_for(tp)
    torch.cuda.synchronize()
    out = dict(staged_chunks=walk.num_staged, chunks=walk.num_chunks, staged_tiles=walk.num_stage_tiles,
               staged_cells=walk.staged_cells, build_s=time.perf_counter() - t0, ms={}, own_stages={},
               bitwise=True)
    rule = cell_walk.stages
    paths = (("gather", lambda *a: False), ("staged", lambda *a: True), ("own", rule))
    for f in WIDTHS:
        h = torch.randn((tp.n_src, f), generator=gen, device="cuda")
        ms, outs = {}, {}
        for path, stages in paths:
            with mock.patch.object(cell_walk, "stages", stages):
                outs[path] = cuda_bcsr.bcsr_spmm_cuda(tp, h)
                ms[path] = cuda_time_ms(lambda: cuda_bcsr.bcsr_spmm_cuda(tp, h), warmup=2, iters=10)
        out["bitwise"] &= all(torch.equal(outs[p], outs["gather"]) for p in outs)
        out["ms"][f] = ms
        out["own_stages"][f] = cell_walk.stageable(tp) and rule(walk, f, sms)
        del outs
    log(f"    {walk.num_staged} of {walk.num_chunks} chunks staged ({walk.staged_cells} of "
        f"{walk.total_cells} cells), list built in {out['build_s']:.3f} s; ms {out['ms']}; own launch staged "
        f"{out['own_stages']}; bitwise {out['bitwise']}")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--traffic", nargs="+", default=["reddit-forward"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the probe times B1 on a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    log(f"card: {card}")
    out = dict(card=card, stage_k=cell_walk.STAGE_K, stage_waves=cell_walk.STAGE_WAVES, traffic={})
    for name in args.traffic:
        traffic = json.loads((TRAFFIC_DIR / f"{name}.json").read_text())
        t0 = time.perf_counter()
        agg = harness.plan_graph(traffic, "cuda").agg
        log(f"{name}: plan in {time.perf_counter() - t0:.1f} s")
        parts = {}
        for side, ps in (("fwd", agg.tile_parts()), ("t", agg.tile_parts_t())):
            for tp in ps:
                label = f"{side} {tp.format}"
                counts = part_counts(tp)
                log(f"  {label}: {counts}")
                with torch.no_grad():
                    parts[label] = dict(counts=counts, **time_part(tp))
        out["traffic"][name] = parts
        del agg
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
