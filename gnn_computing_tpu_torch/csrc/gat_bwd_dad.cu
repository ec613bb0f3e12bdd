// GAT backward, d_att_dst over the forward tiles (B3), hand-written for
// Hopper.
//
// Replaces the TPU kernel gnn_computing_tpu/ops/pallas_bcsr.py:
// gat_bwd_dad_pallas (int8, 1-bit, float32 and bfloat16 tile formats,
// dot_mode 'exact' and 'split2'; both are computed here in float32, as B2
// computes the forward).  The A format is a template argument
// (bit_tiles.cuh).
//
// What it computes: tiles are sorted by destination row-tile; the tiles of
// row-tile r are run_start[r] .. run_start[r+1].  For every destination row
// i, over the cells (i, j) of its run's tiles whose value v_ij (a count, or
// a float tile's summed edge values, any sign: C6) is nonzero,
//   z_ij = ad_i + as_j,  s_ij = v_ij * exp(max(z_ij, slope z_ij) - M_i)
//   lrelu'_ij = z_ij >= 0 ? 1 : slope,  w_ij = lrelu'_ij * s_ij
//   d_ad_i = sum_j w_ij * (<gbar_i, h_j> - c_i)
// with the forward's scores: dm_i = (ad_i, M_i), M the softmax row shift,
// as_j the src half of att (gat_bcsr.cu), gbar_i = ct_i / den_i and
// c_i = <ct_i, out_i> / den_i; the score is one __expf, as in B2.  Cells
// whose value is 0 are skipped, never scored: a non-edge's unstabilized
// score can be inf, and 0 * inf = NaN (C1: select, never multiply).
//
// Design: the sum is taken apart as
//   d_ad_i = <gbar_i, sum_j w_ij h_j> - c_i * sum_j w_ij
// whose two sums are what B2's maxdot walk computes, num and den, with the
// weight lrelu' * s in place of s.  So the walk is the cell walk
// (csrc/cell_walk.cuh through gat_walk.cuh: only the nonzero cells, a run's
// tiles cut into chunks bounded in cells, so a hub row's cells are spread
// over many blocks; per-tile partials; a run's chunk partials added in a
// fixed order), with DadCells below as its policy, writing num [n, f] and
// den [n] to scratch the wrapper allocates; f > 128 takes the walk's
// 128-wide f-slices.  The dot follows in a second small kernel
// (gat_walk::dot_kernel, which B4 shares), one warp a row with the lanes
// over f, in a fixed order: d_ad_i = <gbar_i, num_i> - c_i * den_i; a row
// without a cell has num = den = 0 and writes 0.  Two
// calls give bitwise equal output.  The reassociation changes only the
// float32 summation order; rows whose true d_ad is 0 (every logit >= 0 and
// only tile edges: <ct, out> - <ct, out>) lose to cancellation in either
// form.
//
// Bound on the H100 SXM (3.35 TB/s, 67 TFLOP/s float32 outside the tensor
// cores): the function reads A (T*R*C bytes), h and gbar (n*f*4 each),
// dm and as (12 bytes a node) and c, and writes d_ad (n*4), against 2*cells*f
// FLOPs for the nonzero cells.  At the quick training plan (7,090 tiles of
// [256, 256], 3.3M nonzero cells, f = 128) that is about 0.16 ms,
// bytes-bound (A alone is 0.14 ms); a 1-bit part reads R/8*C bytes a tile,
// a bfloat16 or float32 plan 2 or 4 bytes a cell.
//
// What the design leaves on the table: num makes a round trip through
// device memory (n*f*4 bytes written and read again, 33.5 MB at f = 128)
// where the walk's row write could take the dot itself; the rest is the
// walk's (cell_walk.cuh: the visit of every tile row, one gather of an h
// row slice per cell).

#include <cuda_runtime.h>
#include <stdint.h>

#include "bit_tiles.cuh"
#include "gat_walk.cuh"

namespace {

// rows: dm (ad_i, M_i) as float2; cols: as; one branch, no post-scale; a
// nonzero cell's weight and den term are lrelu' * s
struct DadCells {
  static constexpr int NB = 1;
  static constexpr bool kDen = true;
  using Row = float2;
  static __device__ __forceinline__ Row row(const float* rows, int64_t i) {
    return reinterpret_cast<const float2*>(rows)[i];
  }
  static __device__ __forceinline__ void weigh(const float* cols, float slope, const Row& u, float v, int64_t src,
                                               float* w, float* d) {
    const float z = u.x + cols[src];
    const float s = v * __expf(fmaxf(z, slope * z) - u.y);
    w[0] = d[0] = (z >= 0.f ? 1.f : slope) * s;
  }
  static __device__ __forceinline__ float stage_w(float w) { return w; }
  static __device__ __forceinline__ float stage_h(float x) { return x; }
  static __device__ __forceinline__ void post(const float* rows, int64_t i, float* us) { us[0] = 1.f; }
};

template <class Fmt>
int launch(const void* a, const void* tile_col, const void* work, const void* h, const void* gbar, const void* c,
           const void* dm, const void* asrc, void* num, void* den, void* scratch, void* out, int num_chunks,
           int num_multi, int num_row_tiles, int R, int C, int n, int n_src, int f, float slope, int device,
           void* stream) {
  if (num_row_tiles == 0 || n == 0) return 0;
  const int err = gat_walk::launch<Fmt, DadCells>(a, tile_col, work, h, nullptr, dm, asrc, num, den, scratch,
                                                  num_chunks, num_multi, num_row_tiles, R, C, n, n_src, f, slope,
                                                  device, stream);
  if (err != 0) return err;
  return gat_walk::launch_dot<true>(gbar, num, den, c, out, n, f, stream);
}

}  // namespace

// work: the plan's work list (ops/cell_walk.py), num_chunks / num_multi its
// sizes; num [n, f] and den [n]: the walk's sums; scratch: its chunk
// partials (null when no run has two chunks)
#define GAT_BWD_DAD_ENTRY(tag, Fmt, check)                                                                     \
  extern "C" int gat_bwd_dad_##tag##_f32(const void* a, const void* tile_col, const void* work, const void* h, \
                                         const void* gbar, const void* c, const void* dm, const void* asrc,    \
                                         void* num, void* den, void* scratch, void* out, int num_chunks,       \
                                         int num_multi, int num_row_tiles, int R, int C, int n, int n_src,     \
                                         int f, float slope, int device, void* stream) {                       \
    if (check) return static_cast<int>(cudaErrorInvalidValue);                                               \
    return launch<Fmt>(a, tile_col, work, h, gbar, c, dm, asrc, num, den, scratch, out, num_chunks, num_multi, \
                       num_row_tiles, R, C, n, n_src, f, slope, device, stream);                               \
  }

// 1-bit tiles need R % 8 == 0
GAT_BWD_DAD_ENTRY(i8, CountTiles, false)
GAT_BWD_DAD_ENTRY(b1, BitTiles, R % 8)
GAT_BWD_DAD_ENTRY(f32, F32Tiles, false)
GAT_BWD_DAD_ENTRY(bf16, Bf16Tiles, false)
