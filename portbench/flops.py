"""The table of peaks and the operations and bytes of a tile-kernel launch.

Peaks are NVIDIA's data sheet for one H100 SXM at its 700 W limit: 67
TFLOP/s in float32 outside the tensor cores (the configurations compute in
float32 with TF32 off) and 3.35 TB/s of HBM.

A launch's least time is the larger of its bytes over the bandwidth and
its operations over the float32 peak.  Bytes count each tile part's
stored bytes once (the tiles that hold an edge, with their column index;
all-zero filler tiles are left out), the feature rows that the part's
column tiles cover once, and the output rows that its row tiles cover
once.  Operations count one multiply-add (2) per nonzero cell and feature,
whatever the cell's count.  Both leave out what a kernel needs besides
(the attention vectors, the denominators): a bound that is too low, never
one above what the work needs.
"""

from __future__ import annotations

import dataclasses

import torch

PEAK_FLOPS_F32 = 67e12
PEAK_BYTES_S = 3.35e12


@dataclasses.dataclass(frozen=True)
class PartStats:
    """What one tile part holds, counted from its stored tiles."""

    live_tiles: int  # tiles with at least one edge
    live_bytes: int  # their stored bytes (tiles and column indices)
    nonzero_cells: int
    in_rows: int  # feature rows under its distinct column tiles
    out_rows: int  # output rows under its distinct row tiles


def _popcount_u8(x: torch.Tensor) -> torch.Tensor:
    x = x - ((x >> 1) & 0x55)
    x = (x & 0x33) + ((x >> 2) & 0x33)
    return (x + (x >> 4)) & 0x0F


def part_stats(tp, chunk: int = 4096) -> PartStats:
    """Counts of a port ``TilePlan`` (its ``a`` [T, R, C], or [T, R / 8, C]
    bytes of 1-bit tiles, ``tile_col``, ``tile_row``), read chunk by chunk."""
    t = int(tp.num_tiles)
    a = tp.a.reshape(t, -1)
    per_tile = []
    for k in range(0, t, chunk):
        blk = a[k:k + chunk]
        if tp.bits:
            per_tile.append(_popcount_u8(blk).sum(1, dtype=torch.int64))
        else:
            per_tile.append((blk != 0).sum(1, dtype=torch.int64))
    nz = torch.cat(per_tile) if per_tile else torch.zeros(0, dtype=torch.int64, device=a.device)
    live = nz > 0
    n_live = int(live.sum())
    tile_col = torch.as_tensor(tp.tile_col, device=a.device)[live].long()
    tile_row = torch.as_tensor(tp.tile_row, device=a.device)[live].long()
    r, c = int(tp.tile_rows), int(tp.tile_cols)

    def covered(idx, size, limit):
        starts = torch.unique(idx) * size
        return int(torch.clamp(limit - starts, max=size).sum()) if n_live else 0

    return PartStats(
        live_tiles=n_live,
        live_bytes=n_live * (a.shape[1] * a.element_size() + 4),
        nonzero_cells=int(nz.sum()),
        in_rows=covered(tile_col, c, int(tp.n_src)),
        out_rows=covered(tile_row, r, int(tp.num_nodes)),
    )


def launch_bound_s(ps: PartStats, f: int) -> float:
    """Least seconds of one launch over a part at feature width ``f``."""
    nbytes = ps.live_bytes + 4 * f * (ps.in_rows + ps.out_rows)
    return max(nbytes / PEAK_BYTES_S, 2.0 * ps.nonzero_cells * f / PEAK_FLOPS_F32)
