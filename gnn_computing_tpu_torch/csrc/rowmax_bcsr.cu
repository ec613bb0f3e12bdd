// Per-destination-row max over dense tiles (B5), hand-written for Hopper.
//
// Replaces the TPU kernel gnn_computing_tpu/ops/pallas_bcsr.py:
// rowmax_bcsr_pallas (int8, 1-bit, float32 and bfloat16 tile formats).  The
// A format is a template argument (bit_tiles.cuh), as in B1: a row's bytes
// lie at Fmt::row_offset, and a cell counts where its value is nonzero:
// Fmt::count(byte, shift) != 0 for the count formats (for a 1-bit row,
// where the row's bit of the byte is set), the value read by Fmt::load8 /
// load1 != 0 for the float formats.
//
// What it computes: tiles are sorted by destination row-tile; the tiles of
// row-tile r are run_start[r] .. run_start[r+1].  For every destination row
// i, out_i = max of col_vals[j] over the cells (i, j) of the run's tiles
// whose value is nonzero, and -inf where there is none (rows of empty runs
// included).  It feeds the GAT softmax stabilizer (the exact per-row max of
// att_src over the cells GAT scores: a signed float plan's negative cells
// too, or their scores could overflow).  A max does not round, so the
// result equals any other order of the same max.
//
// Design: one block owns a slab of rows of one row-tile run and walks the
// run's tiles, as B1 and B2 do.  A warp owns kRowsPerWarp consecutive rows;
// its lanes stride a row's C columns, in 4-byte words of counts (coalesced
// byte loads, 128 bytes per warp instruction; an all-zero word is skipped
// in either count format) or in groups of 8 float cells (load8: 32 bytes of
// float32 or 16 of bfloat16 a lane), read col_vals only for nonzero cells,
// and keep a running max per row in registers across the run's tiles.  A
// __shfl_xor reduction finishes each row and lane 0 writes it once: no
// atomics.
//
// Bound on the H100 SXM (3.35 TB/s): the function reads A (T*R*C bytes) and
// col_vals (n_src*4) and writes out (n*4); one compare per cell is far below
// any compute limit.  At the quick scale (4,024 tiles of [512, 256]) that is
// about 0.16 ms, bytes-bound; a 1-bit part reads R/8*C bytes a tile, a
// bfloat16 or float32 tile 2 or 4 bytes a cell.  What the simple design
// leaves on the table: the longest run is ~7x the mean, so its blocks
// finish last; the A stream is not prefetched ahead of the max (no
// cp.async/TMA ring).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "bit_tiles.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 4;
constexpr int kBR = kWarps * kRowsPerWarp;  // destination rows per block

__device__ __forceinline__ float cell_max(float mx, int cnt, int64_t src,
                                          int n_src,
                                          const float* __restrict__ col_vals) {
  return (cnt != 0 && src < n_src) ? fmaxf(mx, col_vals[src]) : mx;
}

__device__ __forceinline__ float value_max(float mx, float v, int64_t src, int n_src,
                                           const float* __restrict__ col_vals) {
  return (v != 0.f && src < n_src) ? fmaxf(mx, col_vals[src]) : mx;
}

template <class Fmt>
__global__ void __launch_bounds__(kThreads)
rowmax_bcsr_kernel(const uint8_t* __restrict__ a,
                   const int32_t* __restrict__ tile_col,
                   const int32_t* __restrict__ run_start,
                   const float* __restrict__ col_vals,
                   float* __restrict__ out, int R, int C, int n, int n_src,
                   int slabs_per_run) {
  const int run = blockIdx.x / slabs_per_run;
  const int r0 = (blockIdx.x % slabs_per_run) * kBR + (threadIdx.x / 32) * kRowsPerWarp;
  const int lane = threadIdx.x % 32;
  const bool vec = (C % 4) == 0;
  const bool vec8 = (C % 8) == 0;

  float mx[kRowsPerWarp];
#pragma unroll
  for (int m = 0; m < kRowsPerWarp; ++m) mx[m] = -CUDART_INF_F;

  const int t_end = run_start[run + 1];
  for (int t = run_start[run]; t < t_end; ++t) {
    const uint8_t* at = a + t * Fmt::tile_bytes(R, C);
    const int64_t col0 = (int64_t)tile_col[t] * C;
#pragma unroll
    for (int m = 0; m < kRowsPerWarp; ++m) {
      const int r = r0 + m;
      if (r < R) {
        int shift = 0;
        const uint8_t* arow = at + Fmt::row_offset(r, R, C, &shift);
        float v = mx[m];
        if constexpr (Fmt::kValued) {
          if (vec8) {
            for (int c = 8 * lane; c < C; c += 8 * 32) {
              float val[8];
              Fmt::load8(arow, c, shift, val);
#pragma unroll
              for (int q = 0; q < 8; ++q) v = value_max(v, val[q], col0 + c + q, n_src, col_vals);
            }
          } else {
            for (int j = lane; j < C; j += 32) v = value_max(v, Fmt::load1(arow, j, shift), col0 + j, n_src, col_vals);
          }
        } else if (vec) {
          const int* words = reinterpret_cast<const int*>(arow);
          for (int w = lane; w < C / 4; w += 32) {
            const int word = words[w];
            if (word == 0) continue;
#pragma unroll
            for (int b = 0; b < 4; ++b)
              v = cell_max(v, Fmt::count(static_cast<uint8_t>(word >> (8 * b)), shift), col0 + 4 * w + b, n_src,
                           col_vals);
          }
        } else {
          for (int j = lane; j < C; j += 32) v = cell_max(v, Fmt::count(arow[j], shift), col0 + j, n_src, col_vals);
        }
        mx[m] = v;
      }
    }
  }

#pragma unroll
  for (int m = 0; m < kRowsPerWarp; ++m) {
    float v = mx[m];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    const int r = r0 + m;
    const int64_t grow = (int64_t)run * R + r;
    if (lane == 0 && r < R && grow < n) out[grow] = v;
  }
}

template <class Fmt>
int launch(const void* a, const void* tile_col, const void* run_start, const void* col_vals, void* out,
           int num_row_tiles, int R, int C, int n, int n_src, int device, void* stream) {
  if (num_row_tiles == 0 || n == 0) return 0;
  // this library carries its own (static) CUDA runtime: select the caller's
  // card in it before launching on the caller's stream
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int slabs = (R + kBR - 1) / kBR;
  rowmax_bcsr_kernel<Fmt><<<num_row_tiles * slabs, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), static_cast<const int32_t*>(tile_col),
      static_cast<const int32_t*>(run_start), static_cast<const float*>(col_vals),
      static_cast<float*>(out), R, C, n, n_src, slabs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rowmax_bcsr_i8_f32(const void* a, const void* tile_col, const void* run_start,
                                  const void* col_vals, void* out, int num_row_tiles, int R, int C, int n,
                                  int n_src, int device, void* stream) {
  return launch<CountTiles>(a, tile_col, run_start, col_vals, out, num_row_tiles, R, C, n, n_src, device, stream);
}

extern "C" int rowmax_bcsr_b1_f32(const void* a, const void* tile_col, const void* run_start,
                                  const void* col_vals, void* out, int num_row_tiles, int R, int C, int n,
                                  int n_src, int device, void* stream) {
  if (R % 8) return static_cast<int>(cudaErrorInvalidValue);
  return launch<BitTiles>(a, tile_col, run_start, col_vals, out, num_row_tiles, R, C, n, n_src, device, stream);
}

extern "C" int rowmax_bcsr_f32_f32(const void* a, const void* tile_col, const void* run_start,
                                   const void* col_vals, void* out, int num_row_tiles, int R, int C, int n,
                                   int n_src, int device, void* stream) {
  return launch<F32Tiles>(a, tile_col, run_start, col_vals, out, num_row_tiles, R, C, n, n_src, device, stream);
}

extern "C" int rowmax_bcsr_bf16_f32(const void* a, const void* tile_col, const void* run_start,
                                    const void* col_vals, void* out, int num_row_tiles, int R, int C, int n,
                                    int n_src, int device, void* stream) {
  return launch<Bf16Tiles>(a, tile_col, run_start, col_vals, out, num_row_tiles, R, C, n, n_src, device, stream);
}
