// The fused hybrid pass (P2): the dense tile product and the residual task
// sums from one launch, hand-written for Hopper.
//
// Replaces probes/overlap_dma_residual.py: fused_hybrid, the TPU probe that
// issues the residual gather's row DMAs from inside the tile kernel so they
// fly while the MXU works on the dense tiles.  What it computes:
//   dense_out = scale_dst o (A_tiles @ x),   x = the tile operand (h after
//               the h_mode rounding, times scale_src), as B1;
//   task_sums[t, :] = sum_b val[t, b] * h[src[t, b], :] of the raw h, as P1.
// The caller adds the task sums into their destination rows.  Count tiles
// (int8) and bfloat16 / float32 value tiles are taken; the TPU probe casts
// its tiles to the bf16 operand's type, which rounds a float32 value, while
// this kernel reads a float32 value as it is (counts agree either way).
// A 1-bit plan is refused (the TPU probe cannot take one either).
//
// Design: one grid.  Blocks [0, runs * slabs) of each f-slice walk one
// row-tile run's slab with a dense tile product (tile_run.cuh: run_sum)
// and write their rows once, scale_dst applied;
// the remaining blocks of the first f-slice each take 8 tasks over every
// feature (a warp a task, task_sums.cuh: task_row, shared with
// csrc/task_sums.cu, 16-byte row reads as P1's), so the gather runs beside
// the tile walk instead of after it: the overlap the TPU probe sought.
// PERF.md has its times against B1 then P1 (putting every residual block
// after both f-slices' dense blocks was slower).
//
// Bound on the H100 SXM (3.35 TB/s): B1's bytes (A, x read, dense_out
// written) plus P1's (each distinct source row the slots gather, read
// once, the indices and values, the task sums written); the FLOPs of both (2 nnz f and 2 slots f) lie far below 67
// TFLOP/s.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bit_tiles.cuh"
#include "task_sums.cuh"
#include "tile_run.cuh"

namespace {

using tile_run::kBK;
using tile_run::kBR;
using tile_run::kThreads;
using tile_run::kTM;
static_assert(kThreads == 32 * task_sums::kWarps, "a residual block is kWarps warps");

template <int BF, class Fmt>
__global__ void __launch_bounds__(kThreads)
fused_hybrid_kernel(const uint8_t* __restrict__ a, const int32_t* __restrict__ tile_col,
                    const int32_t* __restrict__ run_start, const float* __restrict__ x,
                    const float* __restrict__ scale_dst, float* __restrict__ out,
                    const float* __restrict__ h, const int64_t* __restrict__ src,
                    const float* __restrict__ val, float* __restrict__ ts,
                    int R, int C, int n, int n_src, int f, int slabs_per_run, int dense_blocks,
                    int64_t nt, int B, bool vec) {
  const int f0 = blockIdx.y * BF;
  if (static_cast<int>(blockIdx.x) >= dense_blocks) {
    // the residual blocks of the first f-slice take every feature (their
    // indices and values read once); those of the other slices have none
    if (blockIdx.y != 0) return;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int64_t t = (int64_t)(blockIdx.x - dense_blocks) * task_sums::kWarps + warp;
    if (t < nt) task_sums::task_row(h, src, val, ts, t, B, f, 0, f, lane, vec);
    return;
  }
  constexpr int TN = BF / 16;
  __shared__ __align__(16) float as[kBK][kBR + 4];
  __shared__ __align__(16) float hs[kBK][BF];
  const int run = blockIdx.x / slabs_per_run;
  const int r0 = (blockIdx.x % slabs_per_run) * kBR;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[kTM][TN];
  tile_run::run_sum<BF, Fmt>(a, tile_col, run_start[run], run_start[run + 1], x, R, C, n_src, f, f0, r0, acc, as, hs);
#pragma unroll
  for (int m = 0; m < kTM; ++m) {
    const int r = r0 + ty * kTM + m;
    const int64_t grow = (int64_t)run * R + r;
    if (r >= R || grow >= n) continue;
    const float sc = scale_dst != nullptr ? scale_dst[grow] : 1.f;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = f0 + tx * TN + j;
      if (c < f) out[grow * f + c] = scale_dst != nullptr ? acc[m][j] * sc : acc[m][j];
    }
  }
}

template <class Fmt>
int launch(const void* a, const void* tile_col, const void* run_start, const void* x, const void* scale_dst,
           void* out, const void* h, const void* src, const void* val, void* ts, int num_row_tiles, int R, int C,
           int n, int n_src, int f, long long nt, int B, int device, void* stream) {
  if (f == 0) return 0;
  // this library carries its own (static) CUDA runtime: select the caller's
  // card in it before launching on the caller's stream
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int slabs = (R + kBR - 1) / kBR;
  const long long dense = static_cast<long long>(num_row_tiles) * slabs;
  const long long blocks = dense + (nt + task_sums::kWarps - 1) / task_sums::kWarps;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* a8 = static_cast<const uint8_t*>(a);
  const int32_t* col = static_cast<const int32_t*>(tile_col);
  const int32_t* rs = static_cast<const int32_t*>(run_start);
  const float* xf = static_cast<const float*>(x);
  const float* sd = static_cast<const float*>(scale_dst);
  float* o = static_cast<float*>(out);
  const float* hf = static_cast<const float*>(h);
  const int64_t* si = static_cast<const int64_t*>(src);
  const float* vf = static_cast<const float*>(val);
  float* t = static_cast<float*>(ts);
  // P1's row reads (task_sums.cuh): 16-byte lanes where h and the task
  // sums allow them
  const bool vec = f % 4 == 0 && reinterpret_cast<uintptr_t>(h) % 16 == 0 && reinterpret_cast<uintptr_t>(ts) % 16 == 0;
  if (f <= 32) {
    const dim3 grid(static_cast<unsigned>(blocks), 1);
    fused_hybrid_kernel<32, Fmt><<<grid, kThreads, 0, s>>>(a8, col, rs, xf, sd, o, hf, si, vf, t, R, C, n, n_src, f,
                                                           slabs, static_cast<int>(dense), nt, B, vec);
  } else {
    const dim3 grid(static_cast<unsigned>(blocks), (f + 63) / 64);
    fused_hybrid_kernel<64, Fmt><<<grid, kThreads, 0, s>>>(a8, col, rs, xf, sd, o, hf, si, vf, t, R, C, n, n_src, f,
                                                           slabs, static_cast<int>(dense), nt, B, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define FUSED_HYBRID_ENTRY(tag, Fmt)                                                                        \
  extern "C" int fused_hybrid_##tag##_f32(const void* a, const void* tile_col, const void* run_start,      \
                                          const void* x, const void* scale_dst, void* out, const void* h,  \
                                          const void* src, const void* val, void* ts, int num_row_tiles,   \
                                          int R, int C, int n, int n_src, int f, long long nt, int B,      \
                                          int device, void* stream) {                                      \
    return launch<Fmt>(a, tile_col, run_start, x, scale_dst, out, h, src, val, ts, num_row_tiles, R, C, n,  \
                       n_src, f, nt, B, device, stream);                                                   \
  }

FUSED_HYBRID_ENTRY(i8, CountTiles)
FUSED_HYBRID_ENTRY(f32, F32Tiles)
FUSED_HYBRID_ENTRY(bf16, Bf16Tiles)
