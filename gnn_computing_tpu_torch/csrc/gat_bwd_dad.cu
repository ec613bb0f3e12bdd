// GAT backward, d_att_dst over the forward tiles (B3), hand-written for
// Hopper.
//
// Replaces the TPU kernel gnn_computing_tpu/ops/pallas_bcsr.py:
// gat_bwd_dad_pallas (int8, 1-bit, float32 and bfloat16 tile formats,
// dot_mode 'exact' and 'split2'; both are computed here in float32, as B2
// computes the forward).  The A format is a template argument
// (bit_tiles.cuh): the row's bytes are found at Fmt::row_offset and
// tile_cells.cuh keeps the cells whose value is nonzero (compact_row for
// the count formats: a byte, or one bit of it; compact_row_vals for the
// float formats, which keeps each cell's float value beside its column).
//
// What it computes: tiles are sorted by destination row-tile; the tiles of
// row-tile r are run_start[r] .. run_start[r+1].  For every destination row
// i, over the cells (i, j) of its run's tiles whose value v_ij (a count, or
// a float tile's summed edge values, any sign) is nonzero,
//   z_ij = ad_i + as_j,  s_ij = v_ij * exp(max(z_ij, slope z_ij) - M_i)
//   lrelu'_ij = z_ij >= 0 ? 1 : slope
//   d_ad_i = sum_j lrelu'_ij * s_ij * (<gbar_i, h_j> - c_i)
// with the forward's scores: dm_i = (ad_i, M_i), M the softmax row shift,
// as_j the src half of att (gat_bcsr.cu), gbar_i = ct_i / den_i and
// c_i = <ct_i, out_i> / den_i; the score is one __expf, as in B2.  Cells
// whose value is 0 are skipped, never scored: a non-edge's unstabilized
// score can be inf, and 0 * inf = NaN.
//
// Design: sampled dense-dense product reduced to one value per row, done
// only where a cell holds an edge (~0.7% of the cells at the training
// plan).  One warp owns one row of one run; a block holds 8 such rows of
// one run.  The warp keeps gbar_i (4 features a lane, f <= 128; wider f
// reads the rest from memory), dm_i and c_i in registers and walks the
// run's tiles: per tile it loads the row's cells (8 a lane: 8 count bytes,
// 16 bytes of bfloat16 or 32 of float32), compacts the nonzero cells into
// a list in shared memory (tile_cells.cuh; a float format adds a parallel
// list of values, 8 KB a block),
// and takes them 8 at a time, so 8 rows of h are in flight at once: lanes
// across f form the 8 dot products, a butterfly sums them, and every lane
// adds the cells' terms to the tile's partial.  Each tile's partial is
// added to the run's sum when the tile is done (a single float32 sum over a
// hub run drifts); lane 0 writes d_ad_i once, with no atomics; a row whose
// run has no cell writes 0.
//
// Bound on the H100 SXM (3.35 TB/s, 67 TFLOP/s float32 outside the tensor
// cores): the function reads A (T*R*C bytes), h and gbar (n*f*4 each),
// dm and as (12 bytes a node) and c, and writes d_ad (n*4), against 2*cells*f
// FLOPs for the nonzero cells.  At the quick training plan (7,090 tiles of
// [256, 256], 3.3M nonzero cells, f = 128) that is about 0.16 ms,
// bytes-bound (A alone is 0.14 ms); a 1-bit part reads R/8*C bytes a tile,
// a bfloat16 or float32 plan 2 or 4 bytes a cell.
//
// What the simple design leaves on the table: a hub row's cells (14,305 at
// the quick training plan, against a mean of 50) are one warp's serial
// work, so the hub rows finish last; h rows are read once per cell through
// L1/L2, not staged per tile; the count loads are not prefetched across
// tiles; every row of a tile is scanned even where the tile holds few
// cells.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_cells.cuh"

namespace {

using tile_cells::kChunk;
using tile_cells::kFull;

constexpr int kWarps = 8;  // rows per block, one warp each
constexpr int kThreads = 32 * kWarps;
constexpr int kKPL = 4;    // features of gbar_i a lane holds in registers
constexpr int kG = 8;      // nonzero cells in flight per warp

template <class Fmt>
__global__ void __launch_bounds__(kThreads)
gat_bwd_dad_kernel(const uint8_t* __restrict__ a,
                   const int32_t* __restrict__ tile_col,
                   const int32_t* __restrict__ run_start,
                   const float* __restrict__ h,
                   const float* __restrict__ gbar,
                   const float* __restrict__ c,
                   const float2* __restrict__ dm,
                   const float* __restrict__ asrc,
                   float* __restrict__ out,
                   int R, int C, int n, int n_src, int f, float slope, int slabs_per_run) {
  __shared__ int lists[kWarps][kChunk];
  __shared__ float vlists[Fmt::kValued ? kWarps : 1][kChunk];  // float cells' values
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int run = blockIdx.x / slabs_per_run;
  const int r = (blockIdx.x % slabs_per_run) * kWarps + warp;
  const int64_t i = (int64_t)run * R + r;
  if (r >= R || i >= n) return;  // the whole warp leaves together
  int* list = lists[warp];
  float* vlist = vlists[Fmt::kValued ? warp : 0];
  const bool vec = (C % 8) == 0;
  int shift = 0;
  const int64_t row_off = Fmt::row_offset(r, R, C, &shift);

  const float2 u = dm[i];
  const float ci = c[i];
  const float* gi = gbar + i * f;
  float gr[kKPL];
#pragma unroll
  for (int m = 0; m < kKPL; ++m) gr[m] = lane + 32 * m < f ? gi[lane + 32 * m] : 0.f;

  float acc = 0.f;
  const int t_end = run_start[run + 1];
  for (int t = run_start[run]; t < t_end; ++t) {
    const uint8_t* row_a = a + t * Fmt::tile_bytes(R, C) + row_off;
    const int64_t col0 = (int64_t)tile_col[t] * C;
    float part = 0.f;
    for (int c0 = 0; c0 < C; c0 += kChunk) {
      int total;
      if constexpr (Fmt::kValued) {
        total = tile_cells::compact_row_vals<Fmt>(row_a, shift, C, c0, vec, lane, list, vlist);
      } else {
        total = tile_cells::compact_row<Fmt>(row_a, shift, C, c0, vec, lane, list);
      }
      for (int b0 = 0; b0 < total; b0 += kG) {
        float cv[kG];  // the cell's value: its count, or a float cell's value; 0 for none
        int64_t src[kG];
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          const bool in = b0 + g < total;
          if constexpr (Fmt::kValued) {
            cv[g] = in ? vlist[b0 + g] : 0.f;
            src[g] = col0 + (in ? list[b0 + g] : 0);
          } else {
            const int e = in ? list[b0 + g] : 0;
            cv[g] = (float)(e & 0xff);
            src[g] = col0 + (e >> 8);
          }
          if (src[g] >= n_src) cv[g] = 0.f;
        }
        float hv[kG][kKPL];
        float vv[kG];
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          vv[g] = cv[g] != 0.f ? asrc[src[g]] : 0.f;
#pragma unroll
          for (int m = 0; m < kKPL; ++m)
            hv[g][m] = cv[g] != 0.f && lane + 32 * m < f ? h[src[g] * f + lane + 32 * m] : 0.f;
        }
        float pd[kG];
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          float p = 0.f;
#pragma unroll
          for (int m = 0; m < kKPL; ++m) p = fmaf(gr[m], hv[g][m], p);
          if (cv[g] != 0.f)
            for (int k = 32 * kKPL + lane; k < f; k += 32) p = fmaf(gi[k], h[src[g] * f + k], p);
          pd[g] = p;
        }
#pragma unroll
        for (int d = 16; d > 0; d >>= 1)
#pragma unroll
          for (int g = 0; g < kG; ++g) pd[g] += __shfl_xor_sync(kFull, pd[g], d);
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          if (cv[g] == 0.f) continue;
          const float z = u.x + vv[g];
          const float s = cv[g] * __expf(fmaxf(z, slope * z) - u.y);
          const float lp = z >= 0.f ? 1.f : slope;
          part += lp * s * (pd[g] - ci);
        }
      }
    }
    acc += part;
  }
  if (lane == 0) out[i] = acc;
}

template <class Fmt>
int launch(const void* a, const void* tile_col, const void* run_start, const void* h, const void* gbar,
           const void* c, const void* dm, const void* asrc, void* out, int num_row_tiles, int R, int C,
           int n, int n_src, int f, float slope, int device, void* stream) {
  if (num_row_tiles == 0 || n == 0) return 0;
  // this library carries its own (static) CUDA runtime: select the caller's
  // card in it before launching on the caller's stream
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int slabs = (R + kWarps - 1) / kWarps;
  gat_bwd_dad_kernel<Fmt><<<dim3(num_row_tiles * slabs), dim3(kThreads), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), static_cast<const int32_t*>(tile_col),
      static_cast<const int32_t*>(run_start), static_cast<const float*>(h),
      static_cast<const float*>(gbar), static_cast<const float*>(c), static_cast<const float2*>(dm),
      static_cast<const float*>(asrc), static_cast<float*>(out), R, C, n, n_src, f, slope, slabs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int gat_bwd_dad_i8_f32(const void* a, const void* tile_col, const void* run_start,
                                  const void* h, const void* gbar, const void* c, const void* dm,
                                  const void* asrc, void* out, int num_row_tiles, int R, int C, int n,
                                  int n_src, int f, float slope, int device, void* stream) {
  return launch<CountTiles>(a, tile_col, run_start, h, gbar, c, dm, asrc, out, num_row_tiles, R, C, n,
                            n_src, f, slope, device, stream);
}

extern "C" int gat_bwd_dad_b1_f32(const void* a, const void* tile_col, const void* run_start,
                                  const void* h, const void* gbar, const void* c, const void* dm,
                                  const void* asrc, void* out, int num_row_tiles, int R, int C, int n,
                                  int n_src, int f, float slope, int device, void* stream) {
  if (R % 8) return static_cast<int>(cudaErrorInvalidValue);
  return launch<BitTiles>(a, tile_col, run_start, h, gbar, c, dm, asrc, out, num_row_tiles, R, C, n,
                          n_src, f, slope, device, stream);
}

extern "C" int gat_bwd_dad_f32_f32(const void* a, const void* tile_col, const void* run_start,
                                   const void* h, const void* gbar, const void* c, const void* dm,
                                   const void* asrc, void* out, int num_row_tiles, int R, int C, int n,
                                   int n_src, int f, float slope, int device, void* stream) {
  return launch<F32Tiles>(a, tile_col, run_start, h, gbar, c, dm, asrc, out, num_row_tiles, R, C, n,
                          n_src, f, slope, device, stream);
}

extern "C" int gat_bwd_dad_bf16_f32(const void* a, const void* tile_col, const void* run_start,
                                    const void* h, const void* gbar, const void* c, const void* dm,
                                    const void* asrc, void* out, int num_row_tiles, int R, int C, int n,
                                    int n_src, int f, float slope, int device, void* stream) {
  return launch<Bf16Tiles>(a, tile_col, run_start, h, gbar, c, dm, asrc, out, num_row_tiles, R, C, n,
                           n_src, f, slope, device, stream);
}
