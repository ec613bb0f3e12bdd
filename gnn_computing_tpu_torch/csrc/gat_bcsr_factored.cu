// GAT attention aggregation over dense tiles in the factored modes 'twodot'
// and 'merged' (B2's other two bodies), hand-written for Hopper.
//
// Replaces gnn_computing_tpu/ops/pallas_bcsr.py: gat_bcsr_pallas in mode
// 'merged' (:724-790) and mode 'twodot' (:792-866), over int8, 1-bit,
// float32 and bfloat16 tiles (the A format is a template argument,
// bit_tiles.cuh, read as B2 reads it).
//
// What it computes (ops/bcsr_gat.py's module doc has the derivation): the
// per-node factors are formed once per node before the launch, on the
// device (ops/bcsr_gat.py: factored_terms), and passed as
//   rows[i] = (ad_i, u1_i, u2_i, q_i)      cols[j] = (as_j, v1_j, v2_j, r_j)
// with hv1 = v1 o h and (twodot) hv2 = v2 o h already rounded to their
// bf16 residue chunks and the chunks added in float32 (hv_chunks 1 or 2
// changes only that operand, not this kernel).  Per nonzero cell (value
// v != 0; a zero cell is never touched: select, never multiply) the
// kernel does one compare, z = ad_i + as_j > 0, and a select:
//   twodot: a1 = z > 0 ? v : 0, a2 = z > 0 ? 0 : v;
//           num_i = u1_i sum_j bf16(a1) hv1_j + u2_i sum_j bf16(a2) hv2_j,
//           den_i = u1_i sum_j a1 v1_j + u2_i sum_j a2 v2_j;
//   merged: a_m = z > 0 ? v : v (q_i r_j);
//           num_i = u1_i sum_j bf16(a_m) hv1_j,  den_i = u1_i sum_j a_m v1_j.
// bf16() rounds once to nearest even (__float2bfloat16_rn); a count is
// exact, a float32 value rounds, as the TPU kernel's .astype(bf16).  No
// __expf per cell: that is what sets these modes apart from maxdot.  The
// row post-scales u_b apply once, after the run's sums.  Rows whose
// factors float32 cannot hold are found before the launch and rescued by
// the caller (ops/bcsr_gat.py: gat_bcsr_tiles); this kernel computes them
// like any other (they may come out inf or NaN and are replaced).
//
// Design: B2's walk (csrc/gat_walk.cuh over the cell walk,
// csrc/cell_walk.cuh, shared with maxdot's csrc/gat_bcsr.cu and with B1),
// with TwodotCells or MergedCells below as its cell policy: rows[i] in
// registers, cols[j] read only for nonzero cells, each weighed once; two
// branches (two weights and accumulators, two post-scales) for twodot, of
// which a cell's weight is nonzero in one, so only that branch's hv row is
// gathered; one branch for merged.
//
// Bound on the H100 SXM (3.35 TB/s, 67 TFLOP/s float32 outside the tensor
// cores): A (T*R*C cells of 1, 2 or 4 bytes; R*C/8 a 1-bit tile), the hv
// operands (one or two of n_src*f*4 bytes), rows and cols (16 bytes a node
// each), num and den written (n*(f+1)*4); 2*nnz*(f+1) FLOPs, the same
// function as B2's, so the same bound.  What it leaves on the table is the
// walk's (cell_walk.cuh); twodot holds two accumulators a lane.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bit_tiles.cuh"
#include "gat_walk.cuh"

namespace {

// rows[i] = (ad_i, u1_i, u2_i, q_i), cols[j] = (as_j, v1_j, v2_j, r_j)
__device__ __forceinline__ float4 factors(const float* p, int64_t i) { return reinterpret_cast<const float4*>(p)[i]; }

// branch 0 holds the cells with z > 0 (a1), branch 1 the others (a2)
struct TwodotCells {
  static constexpr int NB = 2;
  static constexpr bool kDen = true;
  using Row = float4;
  static __device__ __forceinline__ Row row(const float* rows, int64_t i) { return factors(rows, i); }
  static __device__ __forceinline__ void weigh(const float* cols, float slope, const Row& rw, float v, int64_t src,
                                               float* w, float* d) {
    const float4 cf = factors(cols, src);
    if (rw.x + cf.x > 0.f) {
      w[0] = v;
      d[0] = v * cf.y;
    } else {
      w[1] = v;
      d[1] = v * cf.z;
    }
  }
  static __device__ __forceinline__ float stage_w(float w) { return tile_fmt::bf16_round(w); }
  static __device__ __forceinline__ float stage_h(float x) { return x; }
  static __device__ __forceinline__ void post(const float* rows, int64_t i, float* us) {
    const float4 u = factors(rows, i);
    us[0] = u.y;
    us[1] = u.z;
  }
};

struct MergedCells {
  static constexpr int NB = 1;
  static constexpr bool kDen = true;
  using Row = float4;
  static __device__ __forceinline__ Row row(const float* rows, int64_t i) { return factors(rows, i); }
  static __device__ __forceinline__ void weigh(const float* cols, float slope, const Row& rw, float v, int64_t src,
                                               float* w, float* d) {
    const float4 cf = factors(cols, src);
    w[0] = rw.x + cf.x > 0.f ? v : v * (rw.w * cf.w);
    d[0] = w[0] * cf.y;
  }
  static __device__ __forceinline__ float stage_w(float w) { return tile_fmt::bf16_round(w); }
  static __device__ __forceinline__ float stage_h(float x) { return x; }
  static __device__ __forceinline__ void post(const float* rows, int64_t i, float* us) { us[0] = factors(rows, i).y; }
};

template <class Fmt>
int launch_mode(const void* a, const void* tile_col, const void* work, const void* hv1, const void* hv2,
                const void* rows, const void* cols, void* num, void* den, void* scratch, int num_chunks,
                int num_multi, int num_row_tiles, int R, int C, int n, int n_src, int f, int merged, int device,
                void* stream) {
  return merged ? gat_walk::launch<Fmt, MergedCells>(a, tile_col, work, hv1, nullptr, rows, cols, num, den, scratch,
                                                     num_chunks, num_multi, num_row_tiles, R, C, n, n_src, f, 0.f,
                                                     device, stream)
                : gat_walk::launch<Fmt, TwodotCells>(a, tile_col, work, hv1, hv2, rows, cols, num, den, scratch,
                                                     num_chunks, num_multi, num_row_tiles, R, C, n, n_src, f, 0.f,
                                                     device, stream);
}

}  // namespace

// merged != 0: mode 'merged' (hv2 unused, may be null); else 'twodot';
// work, num_chunks, num_multi and scratch as gat_bcsr.cu's
#define GAT_FACTORED_ENTRY(tag, Fmt, check)                                                                   \
  extern "C" int gat_bcsr_factored_##tag##_f32(const void* a, const void* tile_col, const void* work,        \
                                               const void* hv1, const void* hv2, const void* rows,           \
                                               const void* cols, void* num, void* den, void* scratch,        \
                                               int num_chunks, int num_multi, int num_row_tiles, int R,      \
                                               int C, int n, int n_src, int f, int merged, int device,       \
                                               void* stream) {                                             \
    if (check) return static_cast<int>(cudaErrorInvalidValue);                                              \
    return launch_mode<Fmt>(a, tile_col, work, hv1, hv2, rows, cols, num, den, scratch, num_chunks,          \
                            num_multi, num_row_tiles, R, C, n, n_src, f, merged, device, stream);           \
  }

// 1-bit tiles need R % 8 == 0
GAT_FACTORED_ENTRY(i8, CountTiles, false)
GAT_FACTORED_ENTRY(b1, BitTiles, R % 8)
GAT_FACTORED_ENTRY(f32, F32Tiles, false)
GAT_FACTORED_ENTRY(bf16, Bf16Tiles, false)
