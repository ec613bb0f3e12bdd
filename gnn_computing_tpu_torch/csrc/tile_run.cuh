// One row-tile run's dense tile product: the tile walk of the fused
// residual probe (csrc/fused_hybrid.cu).
//
// run_sum<BF, Fmt>: a block of kThreads threads owns a slab of kBR rows
// (r0..) of one run and BF feature columns (f0..); it walks the run's tiles
// t_begin..t_end, stages each [kBR, kBK] piece of A (as float32, through
// Fmt::load8 / load1, bit_tiles.cuh) and the H tile [kBK, BF] in shared
// memory, and forms the product with FFMA in registers: thread (ty, tx)
// ends with the run's sum for rows r0 + ty*kTM.. and columns f0 + tx*BF/16...

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "bit_tiles.cuh"

namespace tile_run {

constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kBR = 64;        // destination rows per block (4 per thread)
constexpr int kBK = 32;        // tile columns staged per step
constexpr int kTM = 4;

// The run's sum acc[kTM][BF/16] for the block's slab rows r0.. and feature
// columns f0.., thread (ty, tx) owning rows ty*4.. and columns tx*BF/16..
template <int BF, class Fmt>
__device__ __forceinline__ void run_sum(const uint8_t* __restrict__ a, const int32_t* __restrict__ tile_col,
                                        int t_begin, int t_end, const float* __restrict__ h, int R, int C,
                                        int n_src, int f, int f0, int r0, float (&acc)[kTM][BF / 16],
                                        float (*as)[kBR + 4], float (*hs)[BF]) {
  constexpr int TN = BF / 16;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  // A staging: thread loads 8 consecutive columns of one slab row
  const int ai = tid % kBR, aj = (tid / kBR) * 8;
  const bool vec_a = (C % 8) == 0;
  const int row = r0 + ai;
  int shift = 0;
  const int64_t row_off = row < R ? Fmt::row_offset(row, R, C, &shift) : 0;

#pragma unroll
  for (int m = 0; m < kTM; ++m)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[m][j] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const uint8_t* arow = a + t * Fmt::tile_bytes(R, C) + row_off;
    const int64_t col0 = (int64_t)tile_col[t] * C;
    // one tile's product A_t @ H_t, added to the run's sum once the tile is
    // done (as the TPU kernel adds each tile's dot): a hub run spans ~10^5
    // columns, and one sequential float32 sum over them drifts ~1e-5
    float part[kTM][TN];
#pragma unroll
    for (int m = 0; m < kTM; ++m)
#pragma unroll
      for (int j = 0; j < TN; ++j) part[m][j] = 0.f;
    for (int k0 = 0; k0 < C; k0 += kBK) {
      const int kk = k0 + aj;
      if (vec_a && row < R && kk + 8 <= C) {
        float v[8];
        Fmt::load8(arow, kk, shift, v);
#pragma unroll
        for (int q = 0; q < 8; ++q) as[aj + q][ai] = v[q];
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q)
          as[aj + q][ai] = (row < R && kk + q < C) ? Fmt::load1(arow, kk + q, shift) : 0.f;
      }
      for (int e = tid; e < kBK * BF; e += kThreads) {
        const int k = e / BF, c = e % BF;
        const int64_t src = col0 + k0 + k;
        hs[k][c] = (k0 + k < C && src < n_src && f0 + c < f) ? h[src * f + f0 + c] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kBK; ++k) {
        const float4 a4 = *reinterpret_cast<const float4*>(&as[k][ty * kTM]);
        const float av[kTM] = {a4.x, a4.y, a4.z, a4.w};
        float hv[TN];
        if constexpr (TN == 8) {
          const float4 h4 = *reinterpret_cast<const float4*>(&hs[k][tx * TN]);
          const float4 h5 = *reinterpret_cast<const float4*>(&hs[k][tx * TN + 4]);
          hv[0] = h4.x; hv[1] = h4.y; hv[2] = h4.z; hv[3] = h4.w;
          hv[4] = h5.x; hv[5] = h5.y; hv[6] = h5.z; hv[7] = h5.w;
        } else if constexpr (TN == 4) {
          const float4 h4 = *reinterpret_cast<const float4*>(&hs[k][tx * TN]);
          hv[0] = h4.x; hv[1] = h4.y; hv[2] = h4.z; hv[3] = h4.w;
        } else {
          const float2 h2 = *reinterpret_cast<const float2*>(&hs[k][tx * TN]);
          hv[0] = h2.x; hv[1] = h2.y;
        }
#pragma unroll
        for (int m = 0; m < kTM; ++m)
#pragma unroll
          for (int j = 0; j < TN; ++j) part[m][j] = fmaf(av[m], hv[j], part[m][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int m = 0; m < kTM; ++m)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[m][j] += part[m][j];
  }
}

}  // namespace tile_run
