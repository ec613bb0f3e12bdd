// B2's walk, shared by its three bodies: maxdot (csrc/gat_bcsr.cu,
// dot_mode 'exact' / 'split2' and 'default') and the factored modes
// 'twodot' and 'merged' (csrc/gat_bcsr_factored.cu), and by B3
// (csrc/gat_bwd_dad.cu, whose weight is lrelu' times the score).  The bodies differ
// only in how a nonzero cell's weight and den term are formed, which their
// Cells policy supplies; the walk is the cell walk (csrc/cell_walk.cuh,
// which B1 shares: what it computes, its design and what bounds it).  A
// cell with value 0 is never weighed: select, never multiply (a non-edge's
// score may be inf, and 0 * inf = NaN).  The den terms are summed per
// tile, per chunk, then per run, and written by the f-slice 0; every
// mode's per-cell work is a handful of instructions beside the gather of
// one H row slice (twodot: of the one of its two operands its cell picks).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "bit_tiles.cuh"
#include "cell_walk.cuh"

namespace gat_walk {

// One launch of the walk (its Cells policy as cell_walk.cuh describes it,
// with kDen = true) over the plan's work list (work, num_chunks, num_multi:
// ops/cell_walk.py), with its finish pass; den is written even for f == 0.
// Returns a cudaError_t.
template <class Fmt, class Cells>
int launch(const void* a, const void* tile_col, const void* work, const void* h0, const void* h1, const void* rows,
           const void* cols, void* num, void* den, void* scratch, int num_chunks, int num_multi, int num_row_tiles,
           int R, int C, int n, int n_src, int f, float slope, int device, void* stream) {
  cell_walk::Args p{};
  p.a = static_cast<const uint8_t*>(a);
  p.tile_col = static_cast<const int32_t*>(tile_col);
  p.h0 = static_cast<const float*>(h0);
  p.h1 = static_cast<const float*>(h1);
  p.rows = static_cast<const float*>(rows);
  p.cols = static_cast<const float*>(cols);
  p.num = static_cast<float*>(num);
  p.den = static_cast<float*>(den);
  p.scratch = static_cast<float*>(scratch);
  p.R = R;
  p.C = C;
  p.n = n;
  p.n_src = n_src;
  p.f = f;
  p.slope = slope;
  return cell_walk::launch<Fmt, Cells>(p, static_cast<const int32_t*>(work), num_chunks, num_multi, num_row_tiles,
                                       device, stream);
}

}  // namespace gat_walk
