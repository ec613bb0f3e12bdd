"""Probe: are two builds of the B6 kernel bitwise equal?

B6 (``csrc/sddmm_bcsr.cu``) computes every cell's dot as one float32
``fmaf`` chain in ascending k from 0, whatever its grid and its loads, so
two designs of it should give the same float32 cells bit for bit.  This
probe runs ``sddmm_bcsr_cuda`` over the SDDMM path's plans (RMAT 65,536 v
/ 4,194,304 e, seed 123, degree-sorted: [256, 128] tiles at threshold 24
split into a 1-bit and an int8 part; the JAX default float32 [256, 128]
plan; the ``gcn_norm_val`` float32 [512, 256] t48 plan) with seeded a and
b at f = 32 and 128, float32 cells, and keeps one 64-bit hash a tile:

  python -m gnn_computing_tpu_torch.probes.sddmm_cells --out A.pt
  python -m gnn_computing_tpu_torch.probes.sddmm_cells --against A.pt

``--against`` compares with a saved run (made by another build of the
kernel, e.g. with an older tree first on PYTHONPATH) and prints, per plan
and f, the tiles whose cells differ; it exits 1 where any do.  It runs
only on the card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from gnn_computing_tpu_torch.graph import degree_sort, normal_features, rmat_graph
from gnn_computing_tpu_torch.ops import cuda_sddmm
from gnn_computing_tpu_torch.schedule.tiles import densify, split_bit_tiles

CHUNK = 2048  # tiles a launch


def plans(dev) -> dict:
    g = rmat_graph(1 << 16, 1 << 22, seed=123, with_val=False)
    g = g.reorder(degree_sort(g))
    bits, ints = split_bit_tiles(densify(g, dtype=np.int8, tile_rows=256, tile_cols=128, threshold=24)[0])
    return {
        "SDDMM 1-bit part": bits.to(dev),
        "SDDMM int8 part": ints.to(dev),
        "G1 float32 [256, 128]": densify(g)[0].to(dev),
        "gcn_norm_val float32 [512, 256] t48": densify(g, val=g.gcn_norm_val(), tile_rows=512, tile_cols=256,
                                                       threshold=48)[0].to(dev),
    }


def tile_hashes(tp, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int64 [T]: each tile's float32 cells' bits, weighted by fixed random
    odd int64 multipliers and summed (wrapping)."""
    r, c = tp.tile_rows, tp.tile_cols
    w = torch.from_numpy(np.random.default_rng(0).integers(1, 2**62, r * c, dtype=np.int64) | 1).to(a.device)
    out = []
    for s in range(0, tp.num_tiles, CHUNK):
        e = min(s + CHUNK, tp.num_tiles)
        sub = dataclasses.replace(tp, a=tp.a[s:e], tile_row=tp.tile_row[s:e], tile_col=tp.tile_col[s:e],
                                  num_tiles=e - s)
        cells = cuda_sddmm.sddmm_bcsr_cuda(sub, a, b, torch.float32)
        out.append((cells.view(torch.int32).reshape(e - s, -1).long() * w).sum(dim=1))
    return torch.cat(out).cpu()


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    group = ap.add_mutually_exclusive_group(required=True)
    group.add_argument("--out", help="save the tile hashes here")
    group.add_argument("--against", help="compare with the tile hashes saved here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sddmm_cells: no CUDA card; B6 runs only there", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    hashes = {}
    with torch.no_grad():
        for label, tp in plans(dev).items():
            for f in (32, 128):
                a = torch.from_numpy(normal_features(tp.n_src, f, seed=3)).to(dev)
                b = torch.from_numpy(normal_features(tp.num_nodes, f, seed=4)).to(dev)
                hashes[f"{label} f={f}"] = tile_hashes(tp, a, b)
    if args.out:
        torch.save(hashes, args.out)
        print(json.dumps({k: int(v.numel()) for k, v in hashes.items()}))
        return 0
    saved = torch.load(args.against)
    report = {k: dict(tiles=int(v.numel()), differ=int((v != saved[k]).sum())) for k, v in hashes.items()}
    print(json.dumps({"sddmm_cells": report}))
    return 0 if all(r["differ"] == 0 for r in report.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
