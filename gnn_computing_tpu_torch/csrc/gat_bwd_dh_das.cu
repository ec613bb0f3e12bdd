// GAT backward, (dh, d_att_src) over the transposed tiles (B4),
// hand-written for Hopper.
//
// Replaces the TPU kernel gnn_computing_tpu/ops/pallas_bcsr.py:
// gat_bwd_dh_das_pallas (int8, 1-bit, float32 and bfloat16 tile formats,
// dot_mode 'exact' and 'split2'; both are computed here in float32, as B2
// computes the forward).  The A format is a template argument
// (bit_tiles.cuh); a transposed 1-bit part packs the forward's C as its R.
//
// What it computes: the plan is the transposed one, so the rows are source
// nodes j and the columns the forward's destinations i; tiles are sorted by
// source row-tile, the tiles of row-tile r being run_start[r] ..
// run_start[r+1].  For every source row j, over the cells (j, i) of its
// run's tiles whose value v_ij (a count, or a float tile's summed edge
// values, any sign: C6) is nonzero,
//   z_ij = ad_i + as_j,  s_ij = v_ij * exp(max(z_ij, slope z_ij) - M_i)
//   lrelu'_ij = z_ij >= 0 ? 1 : slope,  w_ij = lrelu'_ij * s_ij
//   dh_j   = sum_i s_ij * gbar_i
//   d_as_j = sum_i w_ij * (<gbar_i, h_j> - c_i)
// with the forward's scores: (ad_i, M_i) over the destinations (this plan's
// columns), as_j over the sources (its rows), gbar_i = ct_i / den_i and
// c_i = <ct_i, out_i> / den_i; the score is one __expf, as in B2.  Cells
// whose value is 0 are skipped, never scored: a non-edge's unstabilized
// score can be inf, and 0 * inf = NaN (C1: select, never multiply).
//
// Design: the sum is taken apart as B3's (gat_bwd_dad.cu) is,
//   d_as_j = <h_j, sum_i w_ij gbar_i> - sum_i w_ij c_i
// so both outputs are sums over one gather of gbar_i a cell, which is what
// the cell walk takes (csrc/cell_walk.cuh through gat_walk.cuh: only the
// nonzero cells, a run's tiles cut into chunks bounded in cells, so the
// transposed plan's hub row, 14,316 cells at the quick training plan, is
// spread over many blocks; per-tile partials; a run's chunk partials added
// in a fixed order).  DhDasCells below is its policy with two branches
// over the one gathered H = gbar (kShared): branch 0 weighs s and gives dh
// [n, f], branch 1 weighs w and gives num1 [n, f], kept apart (kSplit);
// the den term w * c gives den [n].  A cell costs one 16-byte load of its
// column's (ad, M, c) beside the gather of its gbar row slice, and 2 *
// KPL FMAs a lane.  The walk runs over the transposed plan's own work list
// (ops/cell_walk.py, the one B1's backward walks); f > 128 takes the walk's
// 128-wide f-slices.  The row dot follows (gat_walk::dot_kernel, B3's, with
// c = 1): d_as_j = <h_j, num1_j> - den_j.  No atomics: two calls give
// bitwise equal output; a row whose run has no cell (the transposed plan's
// coverage fillers) writes zeros.  The reassociation changes only the
// float32 summation order.
//
// Bound on the H100 SXM (3.35 TB/s, 67 TFLOP/s float32 outside the tensor
// cores): the function reads A_t (T*R*C bytes), h and gbar (n*f*4 each),
// (ad, M, c) and as (16 + 4 bytes a node), and writes dh (n_src*f*4) and
// d_as (n_src*4), against 4*cells*f FLOPs for the nonzero cells.  At the
// quick training plan (7,125 transposed tiles of [256, 256], 3.3M nonzero
// cells, f = 128) that is about 0.17 ms, bytes-bound; a 1-bit part reads
// R/8*C bytes a tile, a bfloat16 or float32 plan 2 or 4 bytes a cell.
//
// What the design leaves on the table: num1 makes a round trip through
// device memory (n*f*4 bytes written and read again) where the walk's row
// write could take the dot itself, as B3's could; the rest is the walk's
// (the visit of every tile row, one gather of a gbar row slice a cell).

#include <cuda_runtime.h>
#include <stdint.h>

#include "bit_tiles.cuh"
#include "gat_walk.cuh"

namespace {

// rows: as (per source, this plan's row); cols: (ad_i, M_i, c_i, 0) as
// float4 (per destination, its column); two branches over one gathered
// H = gbar, kept apart: weight s (dh) and lrelu' * s (num1); den term
// lrelu' * s * c
struct DhDasCells {
  static constexpr int NB = 2;
  static constexpr bool kDen = true;
  static constexpr bool kSplit = true;
  static constexpr bool kShared = true;
  using Row = float;
  static __device__ __forceinline__ Row row(const float* rows, int64_t j) { return rows[j]; }
  static __device__ __forceinline__ void weigh(const float* cols, float slope, const Row& as, float v, int64_t i,
                                               float* w, float* d) {
    const float4 u = __ldg(reinterpret_cast<const float4*>(cols) + i);
    const float z = u.x + as;
    const float s = v * __expf(fmaxf(z, slope * z) - u.y);
    const float ws = (z >= 0.f ? 1.f : slope) * s;
    w[0] = s;
    w[1] = ws;
    d[0] = ws * u.z;
  }
  static __device__ __forceinline__ float stage_w(float w) { return w; }
  static __device__ __forceinline__ float stage_h(float x) { return x; }
  static __device__ __forceinline__ void post(const float* rows, int64_t j, float* us) { us[0] = us[1] = 1.f; }
};

template <class Fmt>
int launch(const void* a, const void* tile_col, const void* work, const void* h, const void* gbar,
           const void* cols, const void* asrc, void* dh, void* num1, void* den, void* scratch, void* d_as,
           int num_chunks, int num_multi, int num_row_tiles, int R, int C, int n, int n_src, int f, float slope,
           int device, void* stream) {
  if (num_row_tiles == 0 || n == 0) return 0;
  const int err = gat_walk::launch<Fmt, DhDasCells>(a, tile_col, work, gbar, nullptr, asrc, cols, dh, den, scratch,
                                                     num_chunks, num_multi, num_row_tiles, R, C, n, n_src, f, slope,
                                                     device, stream, num1);
  if (err != 0) return err;
  return gat_walk::launch_dot<false>(h, num1, den, nullptr, d_as, n, f, stream);
}

}  // namespace

// work: the transposed plan's work list (ops/cell_walk.py), num_chunks /
// num_multi its sizes; cols [n_src, 4]: (ad, M, c, 0) per destination;
// num1 [n, f] and den [n]: the walk's d_as sums; scratch: its chunk
// partials (null when no run has two chunks)
#define GAT_BWD_DH_DAS_ENTRY(tag, Fmt, check)                                                                    \
  extern "C" int gat_bwd_dh_das_##tag##_f32(const void* a, const void* tile_col, const void* work, const void* h, \
                                            const void* gbar, const void* cols, const void* asrc, void* dh,      \
                                            void* num1, void* den, void* scratch, void* d_as, int num_chunks,     \
                                            int num_multi, int num_row_tiles, int R, int C, int n, int n_src,    \
                                            int f, float slope, int device, void* stream) {                      \
    if (check) return static_cast<int>(cudaErrorInvalidValue);                                                 \
    return launch<Fmt>(a, tile_col, work, h, gbar, cols, asrc, dh, num1, den, scratch, d_as, num_chunks,         \
                       num_multi, num_row_tiles, R, C, n, n_src, f, slope, device, stream);                      \
  }

// 1-bit tiles need R % 8 == 0
GAT_BWD_DH_DAS_ENTRY(i8, CountTiles, false)
GAT_BWD_DH_DAS_ENTRY(b1, BitTiles, R % 8)
GAT_BWD_DH_DAS_ENTRY(f32, F32Tiles, false)
GAT_BWD_DH_DAS_ENTRY(bf16, Bf16Tiles, false)
