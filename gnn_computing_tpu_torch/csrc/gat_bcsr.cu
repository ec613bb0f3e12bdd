// GAT attention aggregation over dense tiles (B2), hand-written for Hopper.
//
// Replaces the TPU kernel gnn_computing_tpu/ops/pallas_bcsr.py:
// gat_bcsr_pallas in mode 'maxdot' (int8, 1-bit, float32 and bfloat16 tile
// formats, dot_mode 'exact' and 'split2', both computed here in float32,
// see below, and 'default', the template flag kBf16Dot).  The A format is a template argument
// (bit_tiles.cuh), as in B1: a scoring thread finds its row's bytes at
// Fmt::row_offset and reads 8 cells' values (counts, or float values) with
// tile_fmt::load8_tail, one load for all four formats.  A 1-bit row's
// shift (its bit plane) comes from its own row.
//
// What it computes: tiles are sorted by destination row-tile; the tiles of
// row-tile r are run_start[r] .. run_start[r+1].  For every destination
// row i and tile column j of the run's tiles, with v_ij the cell's value
// (its edge count, or a float tile's summed edge values, any sign),
//   z_ij  = ad_i + as_j
//   s_ij  = v_ij != 0 ? v_ij * exp(max(z_ij, slope*z_ij) - M_i) : 0
//   num_i = sum_j s_ij * h_j          den_i = sum_j s_ij
// with dm_i = (ad_i, M_i) (M the softmax row shift, 0 unstabilized) and
// as_j the src half of att: exp(leaky_relu(z) - M), the edge's attention
// score.  With the exact or the bound shift every |s_ij| <= |v_ij|.
//
// Numerics: a count is an exact integer (<= 127; 0 or 1 in a 1-bit tile),
// a float cell its float32 value (a bfloat16 widens exactly, and neither
// passes through an integer), and the score is one __expf (the MUFU ex2
// unit: relative error ~2^-21 plus |x| * 2^-24 for the argument x <= 0 of a
// shifted score, results below float32's normal range flushed to 0) of a
// float32 argument; num and den are float32 sums.  That meets the TPU's
// 'split2' dot (score and h rounded to ~16 mantissa bits, error ~2^-16) and
// its 'exact' f32 dot alike.  Two traps, both designed around:
//   - select, never multiply, on v == 0: in the unstabilized form the
//     score of a non-edge can overflow to inf, and 0 * inf = NaN;
//   - the score is formed from ad, as and M, never from per-node factors.
//     The TPU kernel multiplies u1_i = exp(ad_i - M_i) by v1_j = exp(as_j),
//     and v1_j is inf once as_j > ~88.7 whatever the shift; its q = u2/u1
//     is NaN once u1 underflows under a loose shift.
//
// dot_mode 'default' (kBf16Dot, pallas_bcsr.py:668-683): the TPU's single
// bf16 MXU pass.  The staged score and the staged h are each rounded once
// to bfloat16 (__float2bfloat16_rn, nearest even, as PyTorch's
// .to(torch.bfloat16)) before the FFMAs, which sum their exact products in
// float32; den adds the unrounded scores.  The rounding costs a conversion
// a weighed cell and one a gathered h value, and no extra bytes.
//
// Design: B2's walk (csrc/gat_walk.cuh over the cell walk,
// csrc/cell_walk.cuh, shared with the factored modes'
// csrc/gat_bcsr_factored.cu and with B1), with MaxdotCells below as its
// cell policy: a nonzero cell's weight is its score, formed once from dm of
// its row (in registers) and as of its column, one __expf a nonzero cell.
//
// Bound on the H100 SXM (3.35 TB/s, 67 TFLOP/s float32 outside the tensor
// cores): the function reads A (T*R*C bytes), h (n_src*f*4), dm and as
// (12 bytes a node) and writes num and den (n*(f+1)*4), against 2*nnz*(f+1)
// FLOPs for the nnz nonzero cells.  At the quick scale (4,024 tiles of
// [512, 256], f = 128) that is about 0.18 ms, bytes-bound.  A 1-bit part
// reads R/8*C A bytes a tile, a bfloat16 or float32 tile 2 or 4 bytes a
// cell.  The walk reads the A stream once and gathers one h row slice
// (f*4 bytes, from L2) per nonzero cell: 467 MB and 1.70 GB at that plan.
//
// What the design leaves on the table is the walk's (cell_walk.cuh); f >
// 128 recomputes the scores per 128-wide f-slice.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bit_tiles.cuh"
#include "gat_walk.cuh"

namespace {

// rows: dm (ad_i, M_i) as float2; cols: as; one branch, no post-scale
template <bool kBf16Dot>
struct MaxdotCells {
  static constexpr int NB = 1;
  static constexpr bool kDen = true;
  using Row = float2;
  static __device__ __forceinline__ Row row(const float* rows, int64_t i) {
    return reinterpret_cast<const float2*>(rows)[i];
  }
  static __device__ __forceinline__ void weigh(const float* cols, float slope, const Row& u, float v, int64_t src,
                                               float* w, float* d) {
    const float z = u.x + cols[src];
    w[0] = d[0] = v * __expf(fmaxf(z, slope * z) - u.y);
  }
  static __device__ __forceinline__ float stage_w(float w) { return kBf16Dot ? tile_fmt::bf16_round(w) : w; }
  static __device__ __forceinline__ float stage_h(float x) { return kBf16Dot ? tile_fmt::bf16_round(x) : x; }
  static __device__ __forceinline__ void post(const float* rows, int64_t i, float* us) { us[0] = 1.f; }
};

template <class Fmt>
int launch_mode(const void* a, const void* tile_col, const void* work, const void* h, const void* dm,
                const void* asrc, void* num, void* den, void* scratch, int num_chunks, int num_multi,
                int num_row_tiles, int R, int C, int n, int n_src, int f, float slope, int bf16_dot, int device,
                void* stream) {
  return bf16_dot
             ? gat_walk::launch<Fmt, MaxdotCells<true>>(a, tile_col, work, h, nullptr, dm, asrc, num, den, scratch,
                                                        num_chunks, num_multi, num_row_tiles, R, C, n, n_src, f,
                                                        slope, device, stream)
             : gat_walk::launch<Fmt, MaxdotCells<false>>(a, tile_col, work, h, nullptr, dm, asrc, num, den, scratch,
                                                         num_chunks, num_multi, num_row_tiles, R, C, n, n_src, f,
                                                         slope, device, stream);
}

}  // namespace

// bf16_dot != 0: dot_mode 'default' (the staged score and h rounded to
// bf16); work: the plan's work list (ops/cell_walk.py), num_chunks /
// num_multi its sizes; scratch: its chunk partials (null when no run has
// two chunks)
#define GAT_BCSR_ENTRY(tag, Fmt, check)                                                                       \
  extern "C" int gat_bcsr_##tag##_f32(const void* a, const void* tile_col, const void* work, const void* h, \
                                      const void* dm, const void* asrc, void* num, void* den, void* scratch, \
                                      int num_chunks, int num_multi, int num_row_tiles, int R, int C, int n, \
                                      int n_src, int f, float slope, int bf16_dot, int device,               \
                                      void* stream) {                                                      \
    if (check) return static_cast<int>(cudaErrorInvalidValue);                                              \
    return launch_mode<Fmt>(a, tile_col, work, h, dm, asrc, num, den, scratch, num_chunks, num_multi,        \
                            num_row_tiles, R, C, n, n_src, f, slope, bf16_dot, device, stream);             \
  }

// 1-bit tiles need R % 8 == 0
GAT_BCSR_ENTRY(i8, CountTiles, false)
GAT_BCSR_ENTRY(b1, BitTiles, R % 8)
GAT_BCSR_ENTRY(f32, F32Tiles, false)
GAT_BCSR_ENTRY(bf16, Bf16Tiles, false)
