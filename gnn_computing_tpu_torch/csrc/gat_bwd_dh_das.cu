// GAT backward, (dh, d_att_src) over the transposed tiles (B4),
// hand-written for Hopper.
//
// Replaces the TPU kernel gnn_computing_tpu/ops/pallas_bcsr.py:
// gat_bwd_dh_das_pallas (int8, 1-bit, float32 and bfloat16 tile formats,
// dot_mode 'exact' and 'split2'; both are computed here in float32, as B2
// computes the forward).  The A format is a template argument
// (bit_tiles.cuh), read as B3 reads it; a transposed 1-bit part packs the
// forward's C as its R.
//
// What it computes: the plan is the transposed one, so the rows are source
// nodes j and the columns the forward's destinations i; tiles are sorted by
// source row-tile, the tiles of row-tile r being run_start[r] ..
// run_start[r+1].  For every source row j, over the cells (j, i) of its
// run's tiles whose value v_ij (a count, or a float tile's summed edge
// values, any sign) is nonzero,
//   z_ij = ad_i + as_j,  s_ij = v_ij * exp(max(z_ij, slope z_ij) - M_i)
//   lrelu'_ij = z_ij >= 0 ? 1 : slope
//   dh_j   = sum_i s_ij * gbar_i
//   d_as_j = sum_i lrelu'_ij * s_ij * (<gbar_i, h_j> - c_i)
// with the forward's scores: dm_i = (ad_i, M_i) over the destinations (this
// plan's columns), as_j over the sources (its rows), gbar_i = ct_i / den_i
// and c_i = <ct_i, out_i> / den_i; the score is one __expf, as in B2.
// Cells whose value is 0 are skipped, never scored: a non-edge's
// unstabilized score can be inf, and 0 * inf = NaN.
//
// Design: B3's (gat_bwd_dad.cu) with the roles swapped.  One warp owns one
// source row of one run and a 128-wide slice of f (blockIdx.y); a block
// holds 8 such rows.  The warp keeps as_j and h_j in registers (4
// features a lane) and walks the run's tiles: per tile it compacts the
// row's nonzero cells (tile_cells.cuh; with their values in a parallel
// list for a float format) and takes them 8 at a time, loading
// the 8 gbar_i rows and dm_i at once.  Each lane adds s_ij * gbar_i into its 4 dh
// features; the slice with blockIdx.y == 0 also forms the full-f dot
// <gbar_i, h_j> (features past 128 read from memory), sums it over the warp
// and adds the d_as term.  One launch computes both outputs.  Each tile's
// partials are added to the run's sums when the tile is done; each output
// is written once, with no atomics; a row whose run has no cell (the
// transposed plan's coverage fillers) writes zeros.
//
// Bound on the H100 SXM (3.35 TB/s, 67 TFLOP/s float32 outside the tensor
// cores): the function reads A_t (T*R*C bytes), h and gbar (n*f*4 each),
// dm and as (12 bytes a node) and c, and writes dh (n_src*f*4) and d_as
// (n_src*4), against 4*cells*f FLOPs for the nonzero cells.  At the quick
// training plan (7,125 transposed tiles of [256, 256], 3.3M nonzero cells,
// f = 128) that is about 0.18 ms, bytes-bound; a 1-bit part reads R/8*C
// bytes a tile, a bfloat16 or float32 plan 2 or 4 bytes a cell.
//
// What the simple design leaves on the table: a hub row's cells (14,316 at
// the quick training plan) are one warp's serial work, so the hub rows
// finish last; gbar rows are read once per cell through L1/L2; for f > 128
// every f-slice rescans the counts and recomputes the scores; the count
// loads are not prefetched across tiles.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_cells.cuh"

namespace {

using tile_cells::kChunk;
using tile_cells::kFull;

constexpr int kWarps = 8;  // rows per block, one warp each
constexpr int kThreads = 32 * kWarps;
constexpr int kKPL = 4;    // features a lane holds: one f-slice is 128 wide
constexpr int kSlice = 32 * kKPL;
constexpr int kG = 8;      // nonzero cells in flight per warp

template <class Fmt>
__global__ void __launch_bounds__(kThreads)
gat_bwd_dh_das_kernel(const uint8_t* __restrict__ a,
                      const int32_t* __restrict__ tile_col,
                      const int32_t* __restrict__ run_start,
                      const float* __restrict__ h,
                      const float* __restrict__ gbar,
                      const float* __restrict__ c,
                      const float2* __restrict__ dm,
                      const float* __restrict__ asrc,
                      float* __restrict__ dh, float* __restrict__ d_as,
                      int R, int C, int n, int n_cols, int f, float slope, int slabs_per_run) {
  __shared__ int lists[kWarps][kChunk];
  __shared__ float vlists[Fmt::kValued ? kWarps : 1][kChunk];  // float cells' values
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int run = blockIdx.x / slabs_per_run;
  const int r = (blockIdx.x % slabs_per_run) * kWarps + warp;
  const int64_t j = (int64_t)run * R + r;
  if (r >= R || j >= n) return;  // the whole warp leaves together
  int* list = lists[warp];
  float* vlist = vlists[Fmt::kValued ? warp : 0];
  const bool vec = (C % 8) == 0;
  int shift = 0;
  const int64_t row_off = Fmt::row_offset(r, R, C, &shift);
  const bool with_das = blockIdx.y == 0;
  const int f0 = blockIdx.y * kSlice;

  const float v = asrc[j];
  const float* hj = h + j * f;
  float hr[kKPL];  // h_j over the first slice, for the d_as dot
#pragma unroll
  for (int m = 0; m < kKPL; ++m) hr[m] = with_das && lane + 32 * m < f ? hj[lane + 32 * m] : 0.f;

  float acc_h[kKPL], acc_s = 0.f;
#pragma unroll
  for (int m = 0; m < kKPL; ++m) acc_h[m] = 0.f;
  const int t_end = run_start[run + 1];
  for (int t = run_start[run]; t < t_end; ++t) {
    const uint8_t* row_a = a + t * Fmt::tile_bytes(R, C) + row_off;
    const int64_t col0 = (int64_t)tile_col[t] * C;
    float part_h[kKPL], part_s = 0.f;
#pragma unroll
    for (int m = 0; m < kKPL; ++m) part_h[m] = 0.f;
    for (int c0 = 0; c0 < C; c0 += kChunk) {
      int total;
      if constexpr (Fmt::kValued) {
        total = tile_cells::compact_row_vals<Fmt>(row_a, shift, C, c0, vec, lane, list, vlist);
      } else {
        total = tile_cells::compact_row<Fmt>(row_a, shift, C, c0, vec, lane, list);
      }
      for (int b0 = 0; b0 < total; b0 += kG) {
        float cv[kG];  // the cell's value: its count, or a float cell's value; 0 for none
        int64_t dst[kG];
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          const bool in = b0 + g < total;
          if constexpr (Fmt::kValued) {
            cv[g] = in ? vlist[b0 + g] : 0.f;
            dst[g] = col0 + (in ? list[b0 + g] : 0);
          } else {
            const int e = in ? list[b0 + g] : 0;
            cv[g] = (float)(e & 0xff);
            dst[g] = col0 + (e >> 8);
          }
          if (dst[g] >= n_cols) cv[g] = 0.f;
        }
        float gv[kG][kKPL];
        float2 uu[kG];
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          uu[g] = cv[g] != 0.f ? dm[dst[g]] : make_float2(0.f, 0.f);
#pragma unroll
          for (int m = 0; m < kKPL; ++m) {
            const int k = f0 + lane + 32 * m;
            gv[g][m] = cv[g] != 0.f && k < f ? gbar[dst[g] * f + k] : 0.f;
          }
        }
        float s[kG], lp[kG];
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          const float z = uu[g].x + v;
          s[g] = cv[g] != 0.f ? cv[g] * __expf(fmaxf(z, slope * z) - uu[g].y) : 0.f;
          lp[g] = z >= 0.f ? 1.f : slope;
#pragma unroll
          for (int m = 0; m < kKPL; ++m) part_h[m] = fmaf(s[g], gv[g][m], part_h[m]);
        }
        if (!with_das) continue;
        float pd[kG];
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          float p = 0.f;
#pragma unroll
          for (int m = 0; m < kKPL; ++m) p = fmaf(gv[g][m], hr[m], p);
          if (cv[g] != 0.f)
            for (int k = kSlice + lane; k < f; k += 32) p = fmaf(gbar[dst[g] * f + k], hj[k], p);
          pd[g] = p;
        }
#pragma unroll
        for (int d = 16; d > 0; d >>= 1)
#pragma unroll
          for (int g = 0; g < kG; ++g) pd[g] += __shfl_xor_sync(kFull, pd[g], d);
#pragma unroll
        for (int g = 0; g < kG; ++g)
          if (cv[g] != 0.f) part_s += lp[g] * s[g] * (pd[g] - c[dst[g]]);
      }
    }
#pragma unroll
    for (int m = 0; m < kKPL; ++m) acc_h[m] += part_h[m];
    acc_s += part_s;
  }
#pragma unroll
  for (int m = 0; m < kKPL; ++m) {
    const int k = f0 + lane + 32 * m;
    if (k < f) dh[j * f + k] = acc_h[m];
  }
  if (with_das && lane == 0) d_as[j] = acc_s;
}

template <class Fmt>
int launch(const void* a, const void* tile_col, const void* run_start, const void* h, const void* gbar,
           const void* c, const void* dm, const void* asrc, void* dh, void* d_as, int num_row_tiles, int R,
           int C, int n, int n_cols, int f, float slope, int device, void* stream) {
  if (num_row_tiles == 0 || n == 0) return 0;
  // this library carries its own (static) CUDA runtime: select the caller's
  // card in it before launching on the caller's stream
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int slabs = (R + kWarps - 1) / kWarps;
  // at least one f-slice, so d_as is written even for f == 0
  const dim3 grid(num_row_tiles * slabs, f > kSlice ? (f + kSlice - 1) / kSlice : 1);
  gat_bwd_dh_das_kernel<Fmt><<<grid, dim3(kThreads), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), static_cast<const int32_t*>(tile_col),
      static_cast<const int32_t*>(run_start), static_cast<const float*>(h),
      static_cast<const float*>(gbar), static_cast<const float*>(c), static_cast<const float2*>(dm),
      static_cast<const float*>(asrc), static_cast<float*>(dh), static_cast<float*>(d_as), R, C, n,
      n_cols, f, slope, slabs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int gat_bwd_dh_das_i8_f32(const void* a, const void* tile_col, const void* run_start,
                                     const void* h, const void* gbar, const void* c, const void* dm,
                                     const void* asrc, void* dh, void* d_as, int num_row_tiles, int R,
                                     int C, int n, int n_cols, int f, float slope, int device,
                                     void* stream) {
  return launch<CountTiles>(a, tile_col, run_start, h, gbar, c, dm, asrc, dh, d_as, num_row_tiles, R, C,
                            n, n_cols, f, slope, device, stream);
}

extern "C" int gat_bwd_dh_das_b1_f32(const void* a, const void* tile_col, const void* run_start,
                                     const void* h, const void* gbar, const void* c, const void* dm,
                                     const void* asrc, void* dh, void* d_as, int num_row_tiles, int R,
                                     int C, int n, int n_cols, int f, float slope, int device,
                                     void* stream) {
  if (R % 8) return static_cast<int>(cudaErrorInvalidValue);
  return launch<BitTiles>(a, tile_col, run_start, h, gbar, c, dm, asrc, dh, d_as, num_row_tiles, R, C, n,
                          n_cols, f, slope, device, stream);
}

extern "C" int gat_bwd_dh_das_f32_f32(const void* a, const void* tile_col, const void* run_start,
                                      const void* h, const void* gbar, const void* c, const void* dm,
                                      const void* asrc, void* dh, void* d_as, int num_row_tiles, int R,
                                      int C, int n, int n_cols, int f, float slope, int device,
                                      void* stream) {
  return launch<F32Tiles>(a, tile_col, run_start, h, gbar, c, dm, asrc, dh, d_as, num_row_tiles, R, C, n,
                          n_cols, f, slope, device, stream);
}

extern "C" int gat_bwd_dh_das_bf16_f32(const void* a, const void* tile_col, const void* run_start,
                                       const void* h, const void* gbar, const void* c, const void* dm,
                                       const void* asrc, void* dh, void* d_as, int num_row_tiles, int R,
                                       int C, int n, int n_cols, int f, float slope, int device,
                                       void* stream) {
  return launch<Bf16Tiles>(a, tile_col, run_start, h, gbar, c, dm, asrc, dh, d_as, num_row_tiles, R, C, n,
                           n_cols, f, slope, device, stream);
}
