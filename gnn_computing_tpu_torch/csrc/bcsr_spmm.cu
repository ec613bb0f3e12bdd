// Block-sparse SpMM over count tiles (B1), hand-written for Hopper.
//
// Replaces the TPU kernel gnn_computing_tpu/ops/pallas_bcsr.py:
// bcsr_spmm_pallas (int8 and 1-bit tile formats, f32 operand after the
// h_mode rounding).  The A format is a template argument (bit_tiles.cuh):
// int8 counts, or 1-bit tiles whose row i lies in bit plane i / (R/8) of
// byte row i % (R/8); a 1-bit tile reads 8x fewer A bytes.
//
// What it computes: tiles are sorted by destination row-tile; the tiles of
// row-tile r are run_start[r] .. run_start[r+1].  For every row-tile,
//   out[r*R : r*R+R, :] = sum over its tiles t of A_t[R, C] @ H[col_t*C : +C, :]
// where A_t holds exact edge counts (<= 127).  The caller rounds H to its
// h_mode first ('split' = hi + lo bf16 chunks, 16 mantissa bits), so every
// product count * h is exact in f32 (7 + 16 bits) and only the f32
// accumulation rounds: the exactness class of the TPU's bf16 MXU products.
//
// Design: one block owns a slab of BR rows of one row-tile run and BF
// feature columns.  It walks the run's tiles, stages the A slab (int8 ->
// f32) and the H tile [BK, BF] in shared memory, forms each tile's product
// with FFMA in registers, adds it to the run's sum, and writes its output
// rows once at the end: no atomics and no ordering between blocks.  A run with no tiles writes zeros, so the output
// is fully written whether or not the plan covers every row-tile.
//
// Bound on the H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense): the function
// must read A (T*R*C bytes) and H and write the output once; the tile
// stream as the TPU kernel reads it is T*R*C + T*C*f*4 bytes.  The dense
// tile work is 2*T*R*C*f FLOPs, which a split-bf16 wgmma redesign could run
// on the tensor cores (two exact bf16 passes).  Both sit far below this
// kernel's time: it runs the dense tile product on the FP32 pipes (67
// TFLOP/s peak, 16 FFMA per 2 shared loads per k step).
//
// What the simple design leaves on the table: the tiles are ~1% full, so
// almost all FFMAs multiply zero counts — compacting each A slab's nonzeros
// (or skipping all-zero k columns) cuts the work by ~100x; split-bf16
// wgmma would use the tensor cores; cp.async/TMA double buffering would
// overlap the loads with the FFMAs; H tiles are re-read once per row slab.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bit_tiles.cuh"

namespace {

constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kBR = 64;        // destination rows per block (4 per thread)
constexpr int kBK = 32;        // tile columns staged per step
constexpr int kTM = 4;

template <int BF, class Fmt>
__global__ void __launch_bounds__(kThreads)
bcsr_spmm_kernel(const uint8_t* __restrict__ a,
                 const int32_t* __restrict__ tile_col,
                 const int32_t* __restrict__ run_start,
                 const float* __restrict__ h, float* __restrict__ out,
                 int R, int C, int n, int n_src, int f, int slabs_per_run) {
  constexpr int TN = BF / 16;
  // +4 pad keeps rows 16-byte aligned and the transposing stores free of
  // bank conflicts (32 consecutive rows per warp, one k)
  __shared__ __align__(16) float as[kBK][kBR + 4];
  __shared__ __align__(16) float hs[kBK][BF];

  const int run = blockIdx.x / slabs_per_run;
  const int r0 = (blockIdx.x % slabs_per_run) * kBR;
  const int f0 = blockIdx.y * BF;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  // A staging: thread loads 8 consecutive columns of one slab row
  const int ai = tid % kBR, aj = (tid / kBR) * 8;
  const bool vec_a = (C % 8) == 0;
  const int row = r0 + ai;
  int shift = 0;
  const int64_t row_off = row < R ? Fmt::row_offset(row, R, C, &shift) : 0;

  float acc[kTM][TN];
#pragma unroll
  for (int m = 0; m < kTM; ++m)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[m][j] = 0.f;

  const int t_end = run_start[run + 1];
  for (int t = run_start[run]; t < t_end; ++t) {
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
        const int2 v = *reinterpret_cast<const int2*>(arow + kk);
        const uint8_t* b = reinterpret_cast<const uint8_t*>(&v);
#pragma unroll
        for (int q = 0; q < 8; ++q) as[aj + q][ai] = (float)Fmt::count(b[q], shift);
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q)
          as[aj + q][ai] = (row < R && kk + q < C) ? (float)Fmt::count(arow[kk + q], shift) : 0.f;
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
        if constexpr (TN == 4) {
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

#pragma unroll
  for (int m = 0; m < kTM; ++m) {
    const int r = r0 + ty * kTM + m;
    const int64_t grow = (int64_t)run * R + r;
    if (r >= R || grow >= n) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = f0 + tx * TN + j;
      if (c < f) out[grow * f + c] = acc[m][j];
    }
  }
}

template <class Fmt>
int launch(const void* a, const void* tile_col, const void* run_start, const void* h, void* out,
           int num_row_tiles, int R, int C, int n, int n_src, int f, int device, void* stream) {
  if (num_row_tiles == 0 || f == 0) return 0;
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
  const float* hf = static_cast<const float*>(h);
  float* o = static_cast<float*>(out);
  if (f <= 32) {
    const dim3 grid(num_row_tiles * slabs, 1);
    bcsr_spmm_kernel<32, Fmt><<<grid, block, 0, s>>>(a8, col, rs, hf, o, R, C, n, n_src, f, slabs);
  } else {
    const dim3 grid(num_row_tiles * slabs, (f + 63) / 64);
    bcsr_spmm_kernel<64, Fmt><<<grid, block, 0, s>>>(a8, col, rs, hf, o, R, C, n, n_src, f, slabs);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int bcsr_spmm_i8_f32(const void* a, const void* tile_col, const void* run_start,
                                const void* h, void* out, int num_row_tiles, int R, int C, int n,
                                int n_src, int f, int device, void* stream) {
  return launch<CountTiles>(a, tile_col, run_start, h, out, num_row_tiles, R, C, n, n_src, f,
                            device, stream);
}

extern "C" int bcsr_spmm_b1_f32(const void* a, const void* tile_col, const void* run_start,
                                const void* h, void* out, int num_row_tiles, int R, int C, int n,
                                int n_src, int f, int device, void* stream) {
  if (R % 8) return static_cast<int>(cudaErrorInvalidValue);
  return launch<BitTiles>(a, tile_col, run_start, h, out, num_row_tiles, R, C, n, n_src, f,
                          device, stream);
}
