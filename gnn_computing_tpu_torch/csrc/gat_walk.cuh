// B2's walk, shared by its three bodies: maxdot (csrc/gat_bcsr.cu,
// dot_mode 'exact' / 'split2' and 'default') and the factored modes
// 'twodot' and 'merged' (csrc/gat_bcsr_factored.cu), and by the GAT
// backward: B3 (csrc/gat_bwd_dad.cu, whose weight is lrelu' times the
// score) and B4 (csrc/gat_bwd_dh_das.cu, the score and lrelu' times it as
// two branches kept apart over one gathered H).  The bodies differ
// only in how a nonzero cell's weight and den term are formed, which their
// Cells policy supplies; the walk is the cell walk (csrc/cell_walk.cuh,
// which B1 shares: what it computes, its design and what bounds it).  A
// cell with value 0 is never weighed: select, never multiply (a non-edge's
// score may be inf, and 0 * inf = NaN).  The den terms are summed per
// tile, per chunk, then per run, and written by the f-slice 0; every
// mode's per-cell work is a handful of instructions beside the gather of
// one H row slice (twodot: of the one of its two operands its cell picks).
// B3 and B4 end in dot_kernel, a row dot over the walk's sums.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "bit_tiles.cuh"
#include "cell_walk.cuh"

namespace gat_walk {

// One launch of the walk (its Cells policy as cell_walk.cuh describes it,
// with kDen = true) over the plan's work list (work, num_chunks, num_multi:
// ops/cell_walk.py), with its finish pass; den is written even for f == 0;
// num1 takes branch 1's sums of a kSplit policy.  Returns a cudaError_t.
template <class Fmt, class Cells>
int launch(const void* a, const void* tile_col, const void* work, const void* h0, const void* h1, const void* rows,
           const void* cols, void* num, void* den, void* scratch, int num_chunks, int num_multi, int num_row_tiles,
           int R, int C, int n, int n_src, int f, float slope, int device, void* stream, void* num1 = nullptr) {
  cell_walk::Args p{};
  p.a = static_cast<const uint8_t*>(a);
  p.tile_col = static_cast<const int32_t*>(tile_col);
  p.h0 = static_cast<const float*>(h0);
  p.h1 = static_cast<const float*>(h1);
  p.rows = static_cast<const float*>(rows);
  p.cols = static_cast<const float*>(cols);
  p.num = static_cast<float*>(num);
  p.num1 = static_cast<float*>(num1);
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

constexpr int kDotWarps = 8;  // rows per block of the dot, one warp each

// out_i = <x_i, num_i> - c_i * den_i (kScaled), or - den_i: lane l sums
// features l, l + 32, ... in order, then the butterfly.  A row without a
// cell has num = den = 0 and writes 0.
template <bool kScaled>
__global__ void __launch_bounds__(32 * kDotWarps)
dot_kernel(const float* __restrict__ x, const float* __restrict__ num, const float* __restrict__ den,
           const float* __restrict__ c, float* __restrict__ out, int n, int f) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kDotWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (i >= n) return;  // the whole warp leaves together
  const float* g = x + i * f;
  const float* y = num + i * f;
  float p = 0.f;
  for (int k = lane; k < f; k += 32) p = fmaf(g[k], y[k], p);
  p = tile_cells::warp_sum(p);
  if (lane == 0) out[i] = p - (kScaled ? c[i] * den[i] : den[i]);
}

// dot_kernel over n rows (c is read only if kScaled).  Returns a
// cudaError_t.
template <bool kScaled>
int launch_dot(const void* x, const void* num, const void* den, const void* c, void* out, int n, int f,
               void* stream) {
  dot_kernel<kScaled><<<(n + kDotWarps - 1) / kDotWarps, 32 * kDotWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(num), static_cast<const float*>(den),
      static_cast<const float*>(c), static_cast<float*>(out), n, f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gat_walk
