// B2's tile walk, shared by its three bodies: maxdot (csrc/gat_bcsr.cu,
// dot_mode 'exact' / 'split2' and 'default') and the factored modes
// 'twodot' and 'merged' (csrc/gat_bcsr_factored.cu).  The bodies differ
// only in how a nonzero cell's weight is formed, which the Cells policy
// supplies; the walk, the staging and the sums are this file's.
//
// What it computes: tiles are sorted by destination row-tile; the tiles of
// row-tile r are run_start[r] .. run_start[r+1].  For every destination
// row i, branch b < Cells::NB and tile column j of the run's tiles, with v
// the cell's value (count, or float value; 0 means no edge),
//   num_i = sum_b post_b,i sum_j stage_w(w_b,ij) * stage_h(H_b,j)
//   den_i = sum_b post_b,i sum_j d_b,ij
// where Cells::weigh gives the weight w and its den term d of the cells
// with v != 0, Cells::stage_w and stage_h round the staged weight and the
// staged operand H_b (h, or a factored mode's hv_b) as the mode rounds,
// and Cells::post gives the row post-scales.  A cell with v == 0 is never
// weighed: select, never multiply (a non-edge's score may be inf, and
// 0 * inf = NaN).
//
// Design (the shape of B1, csrc/bcsr_spmm.cu): one block owns a slab of kBR
// rows of one row-tile run and BF feature columns.  It walks the run's
// tiles; per staged [kBR, kBK] piece each thread weighs 8 cells of one row
// into shared memory (8 values in one load, bit_tiles.cuh
// tile_fmt::load8_tail: 8 count bytes, 16 bytes of bfloat16 or 32 of
// float32; the row operand in registers, the column operand read only for
// nonzero cells), the block stages the H tiles [kBK, BF], and FFMAs form
// each branch's tile product in registers.  Each tile's partial (num and
// the thread's den slice) is added to the run's sum when the tile is done:
// a single float32 sum over a hub run of ~10^5 columns drifts ~1e-5.
// Outputs are written once at the end, with no atomics; an empty run
// writes zeros.  The f-slice with blockIdx.y == 0 writes den.
//
// What the simple design leaves on the table: the tiles are ~1% full, so
// almost all FFMAs multiply zero weights (compacting each slab's nonzeros
// would cut the work ~100x); the longest run is ~7x the mean, so a few
// blocks finish last; the tensor cores are unused; the H loads are not
// overlapped with the FFMAs; f > 64 re-weighs the cells per f-slice.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "bit_tiles.cuh"

namespace gat_walk {

constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kBR = 64;        // destination rows per block (4 per thread)
constexpr int kBK = 32;        // tile columns staged per step
constexpr int kTM = 4;
constexpr int kStagers = kThreads / kBR;  // threads weighing one row's piece

// Cells policy:
//   NB                          branches (each with its own H and post-scale)
//   Row row(rows, i)            node i's row operand (Row{} past the rows)
//   weigh(cols, slope, row, v, src, w, d)
//                               a nonzero cell's weights w[b] and den
//                               terms d[b] (both 0 for the other cells)
//   float stage_w(w)            a weight as the mode stages it
//   float stage_h(x)            a staged H value as the mode rounds it
//   post(rows, i, us)           row i's post-scales us[b]
template <int BF, class Fmt, class Cells>
__global__ void __launch_bounds__(kThreads)
walk_kernel(const uint8_t* __restrict__ a, const int32_t* __restrict__ tile_col,
            const int32_t* __restrict__ run_start, const float* __restrict__ h0,
            const float* __restrict__ h1, const float* __restrict__ rows, const float* __restrict__ cols,
            float* __restrict__ num, float* __restrict__ den,
            int R, int C, int n, int n_src, int f, float slope, int slabs_per_run) {
  constexpr int TN = BF / 16;
  constexpr int NB = Cells::NB;
  // +4 pad keeps rows 16-byte aligned and the transposing stores free of
  // bank conflicts (32 consecutive rows per warp, one k)
  __shared__ __align__(16) float ss[NB][kBK][kBR + 4];
  __shared__ __align__(16) float hs[NB][kBK][BF];
  __shared__ float dsum[NB][kStagers][kBR];

  const int run = blockIdx.x / slabs_per_run;
  const int r0 = (blockIdx.x % slabs_per_run) * kBR;
  const int f0 = blockIdx.y * BF;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  // weighing: thread weighs 8 consecutive columns of one slab row
  const int ai = tid % kBR, aj = (tid / kBR) * 8;
  const bool vec_a = (C % 8) == 0;
  const int srow = r0 + ai;
  const int64_t sgrow = (int64_t)run * R + srow;
  const typename Cells::Row rw = (srow < R && sgrow < n) ? Cells::row(rows, sgrow) : typename Cells::Row{};
  int shift = 0;
  const int64_t row_off = srow < R ? Fmt::row_offset(srow, R, C, &shift) : 0;

  float acc[NB][kTM][TN];
  float den_acc[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    den_acc[b] = 0.f;
#pragma unroll
    for (int m = 0; m < kTM; ++m)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[b][m][j] = 0.f;
  }

  const int t_end = run_start[run + 1];
  for (int t = run_start[run]; t < t_end; ++t) {
    const uint8_t* arow = a + t * Fmt::tile_bytes(R, C) + row_off;
    const int64_t col0 = (int64_t)tile_col[t] * C;
    float part[NB][kTM][TN];
    float den_part[NB];
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      den_part[b] = 0.f;
#pragma unroll
      for (int m = 0; m < kTM; ++m)
#pragma unroll
        for (int j = 0; j < TN; ++j) part[b][m][j] = 0.f;
    }
    for (int k0 = 0; k0 < C; k0 += kBK) {
      const int kk = k0 + aj;
      // the cells' values (counts widened exactly; a float never passes
      // through an integer), 0 past the row or the tile
      float val[8];
      if (srow < R) {
        tile_fmt::load8_tail<Fmt>(arow, kk, C, vec_a, shift, val);
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q) val[q] = 0.f;
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int64_t src = col0 + kk + q;
        float w[NB], d[NB];
#pragma unroll
        for (int b = 0; b < NB; ++b) w[b] = d[b] = 0.f;
        if (val[q] != 0.f && src < n_src) Cells::weigh(cols, slope, rw, val[q], src, w, d);
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          ss[b][aj + q][ai] = Cells::stage_w(w[b]);
          den_part[b] += d[b];
        }
      }
      for (int e = tid; e < kBK * BF; e += kThreads) {
        const int k = e / BF, c = e % BF;
        const int64_t src = col0 + k0 + k;
        const bool in = k0 + k < C && src < n_src && f0 + c < f;
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          const float x = in ? (b == 0 ? h0 : h1)[src * f + f0 + c] : 0.f;
          hs[b][k][c] = Cells::stage_h(x);
        }
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kBK; ++k) {
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          const float4 s4 = *reinterpret_cast<const float4*>(&ss[b][k][ty * kTM]);
          const float sv[kTM] = {s4.x, s4.y, s4.z, s4.w};
          float hv[TN];
          if constexpr (TN == 4) {
            const float4 h4 = *reinterpret_cast<const float4*>(&hs[b][k][tx * TN]);
            hv[0] = h4.x; hv[1] = h4.y; hv[2] = h4.z; hv[3] = h4.w;
          } else {
            const float2 h2 = *reinterpret_cast<const float2*>(&hs[b][k][tx * TN]);
            hv[0] = h2.x; hv[1] = h2.y;
          }
#pragma unroll
          for (int m = 0; m < kTM; ++m)
#pragma unroll
            for (int j = 0; j < TN; ++j) part[b][m][j] = fmaf(sv[m], hv[j], part[b][m][j]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      den_acc[b] += den_part[b];
#pragma unroll
      for (int m = 0; m < kTM; ++m)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[b][m][j] += part[b][m][j];
    }
  }

  // each row's den sums are spread over its kStagers weighing threads
#pragma unroll
  for (int b = 0; b < NB; ++b) dsum[b][tid / kBR][ai] = den_acc[b];
  __syncthreads();
  if (blockIdx.y == 0 && tid < kBR) {
    const int r = r0 + tid;
    const int64_t grow = (int64_t)run * R + r;
    if (r < R && grow < n) {
      float us[NB];
      Cells::post(rows, grow, us);
      float d = 0.f;
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        float db = 0.f;
#pragma unroll
        for (int q = 0; q < kStagers; ++q) db += dsum[b][q][tid];
        d = b == 0 ? us[0] * db : d + us[b] * db;
      }
      den[grow] = d;
    }
  }

#pragma unroll
  for (int m = 0; m < kTM; ++m) {
    const int r = r0 + ty * kTM + m;
    const int64_t grow = (int64_t)run * R + r;
    if (r >= R || grow >= n) continue;
    float us[NB];
    Cells::post(rows, grow, us);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = f0 + tx * TN + j;
      if (c >= f) continue;
      float o = us[0] * acc[0][m][j];
#pragma unroll
      for (int b = 1; b < NB; ++b) o += us[b] * acc[b][m][j];
      num[grow * f + c] = o;
    }
  }
}

// One launch of the walk over num_row_tiles runs: at least one f-slice, so
// den is written even for f == 0.  Returns a cudaError_t.
template <class Fmt, class Cells>
int launch(const void* a, const void* tile_col, const void* run_start, const void* h0, const void* h1,
           const void* rows, const void* cols, void* num, void* den, int num_row_tiles, int R, int C, int n,
           int n_src, int f, float slope, int device, void* stream) {
  if (num_row_tiles == 0 || n == 0) return 0;
  // this library carries its own (static) CUDA runtime: select the caller's
  // card in it before launching on the caller's stream
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int slabs = (R + kBR - 1) / kBR;
  const dim3 block(kThreads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* a8 = static_cast<const uint8_t*>(a);
  const int32_t* col = static_cast<const int32_t*>(tile_col);
  const int32_t* rs = static_cast<const int32_t*>(run_start);
  const float* x0 = static_cast<const float*>(h0);
  const float* x1 = static_cast<const float*>(h1);
  const float* rw = static_cast<const float*>(rows);
  const float* cl = static_cast<const float*>(cols);
  float* o = static_cast<float*>(num);
  float* d = static_cast<float*>(den);
  if (f <= 32) {
    const dim3 grid(num_row_tiles * slabs, 1);
    walk_kernel<32, Fmt, Cells><<<grid, block, 0, s>>>(a8, col, rs, x0, x1, rw, cl, o, d, R, C, n, n_src, f, slope,
                                                       slabs);
  } else {
    const dim3 grid(num_row_tiles * slabs, (f + 63) / 64);
    walk_kernel<64, Fmt, Cells><<<grid, block, 0, s>>>(a8, col, rs, x0, x1, rw, cl, o, d, R, C, n, n_src, f, slope,
                                                       slabs);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gat_walk
