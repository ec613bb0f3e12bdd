// SDDMM over dense tiles (B6), hand-written for Hopper.
//
// Replaces the TPU kernel gnn_computing_tpu/ops/bcsr_sddmm.py:
// sddmm_bcsr_pallas (its 'exact', 'split23' and 'split33' dot modes; int8,
// 1-bit, float32 and bfloat16 tile formats, as template arguments from
// bit_tiles.cuh).
//
// What it computes: for every tile t and cell (i, j) of its [R, C] block,
//   out[t, i, j] = <b[tile_row[t]*R + i, :], a[tile_col[t]*C + j, :]>
// where the cell holds an edge, and +0 where it holds none.  A cell holds an
// edge where its value is > 0, the JAX package's rule (bcsr_sddmm.py): a
// count > 0, or a float cell's value > 0 (so a negative-valued cell of a
// signed float plan comes out +0, as the JAX package gives it).
// The output is float32 or bfloat16 [T, R, C] (round to nearest even, as
// torch and JAX round).  Every dot mode is one sequential f32 FFMA dot of
// the f32 operands, ascending in k from 0: exact f32 products, within the
// error class of the TPU's split23 (16-bit chunks) and split33 (24-bit
// chunks) bf16 passes.  No TF32 and no tensor-core shortcut rounds the
// operands.
//
// Design: a streamed pass over the tile's cells, 8 a thread.  One block per
// tile (it owns its output block: no atomics, no order between blocks);
// thread k of the block takes groups k, k + 256, ... of 8 consecutive cells
// of a row in the tile's row-major order, so a warp covers 256 contiguous
// cells: one tile row at C = 256, two at C = 128.  A thread reads its 8
// cells in one vector load (Fmt::Raw: 8 bytes of int8 or bits, 16 of
// bfloat16, 32 of float32), and Fmt::nonzero8 with a > 0 test on the
// nonzero ones gives the group's edge mask; only a cell that holds an edge
// gets a dot, computed by the thread that holds it as one ascending-k fmaf
// chain (a_j in 16-byte loads, b_i through the read-only path, from L2
// where the tiles of a run share it), one cell after the other.  The thread
// writes its 8 cells, zeros included, as one 16-byte store in bfloat16 or
// two in float32, streaming (evict first), so a warp writes 512 or 1024
// contiguous bytes.  A thread without an edge does no dot; a hub tile's
// dense rows put every thread to work.  No shared memory.  Filler tiles
// come out all zero; a row past n or a column past n_src holds no edge.  A
// C that is not a multiple of 8 reads and writes cell by cell, an f that is
// not a multiple of 4 reads a and b float by float, in the same order.  The
// kernel is small (48 registers), so 5 blocks share an SM: the pass over
// sparse tiles is bound by how many groups are in flight, and the forms
// that held more of them in registers (load batches, four dot chains a
// thread, a 1-bit byte row read once for its 8 rows) cost occupancy and
// were slower over the 1-bit part and the bfloat16 plan on the card.
//
// Bound on the H100 SXM (3.35 TB/s; 67 TFLOP/s f32 outside the tensor
// cores): bytes.  The function must write every cell (T*R*C*2 bytes in
// bf16, 4 in f32) and read A once (T*R*C, T*R*C/8 for 1-bit tiles, 2 or 4
// times T*R*C for bfloat16 or float32 tiles) plus a and b; the dots are
// 2*nnz*f FLOPs, ~1% of the cells.
//
// What the design leaves on the table: a thread's next A load waits for
// its stores and dots (one group in flight a thread); a thread's dots run
// one after the other (a hub tile's dense rows wait on their longest
// thread); a and b rows are read from L2 once per edge cell, never staged.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bit_tiles.cuh"

namespace {

constexpr int kThreads = 256;

// <b_row, a_row>: one fmaf chain in ascending k from 0 (vec: f % 4 == 0,
// both rows 16-byte aligned)
__device__ __forceinline__ float dot(const float* __restrict__ brow, const float* __restrict__ arow, int f,
                                     bool vec) {
  float d = 0.f;
  if (vec) {
    const float4* a4 = reinterpret_cast<const float4*>(arow);
    const float4* b4 = reinterpret_cast<const float4*>(brow);
#pragma unroll 4
    for (int k = 0; k < f / 4; ++k) {
      const float4 x = __ldg(a4 + k), y = __ldg(b4 + k);
      d = fmaf(y.x, x.x, d);
      d = fmaf(y.y, x.y, d);
      d = fmaf(y.z, x.z, d);
      d = fmaf(y.w, x.w, d);
    }
  } else {
    for (int k = 0; k < f; ++k) d = fmaf(__ldg(brow + k), __ldg(arow + k), d);
  }
  return d;
}

// 8 cells at p (32-byte aligned): two streaming 16-byte stores
__device__ __forceinline__ void store8(float* p, const float (&d)[8]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(d[0], d[1], d[2], d[3]));
  __stcs(reinterpret_cast<float4*>(p) + 1, make_float4(d[4], d[5], d[6], d[7]));
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x the lower column
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 8 cells at p (16-byte aligned): one streaming 16-byte store
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&d)[8]) {
  __stcs(reinterpret_cast<uint4*>(p),
         make_uint4(bf16x2(d[0], d[1]), bf16x2(d[2], d[3]), bf16x2(d[4], d[5]), bf16x2(d[6], d[7])));
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <class Fmt, class Out>
__global__ void __launch_bounds__(kThreads)
sddmm_bcsr_kernel(const uint8_t* __restrict__ a_tiles, const int32_t* __restrict__ tile_row,
                  const int32_t* __restrict__ tile_col, const float* __restrict__ a,
                  const float* __restrict__ b, Out* __restrict__ out, int R, int C, int n,
                  int n_src, int f, bool vec_f) {
  const int t = blockIdx.x;
  const uint8_t* at = a_tiles + t * Fmt::tile_bytes(R, C);
  const int64_t row0 = static_cast<int64_t>(tile_row[t]) * R;
  const int64_t col0 = static_cast<int64_t>(tile_col[t]) * C;
  Out* ot = out + static_cast<int64_t>(t) * R * C;
  const int G = (C + 7) / 8;        // groups of 8 cells a row
  const bool vec_c = (C % 8) == 0;  // a group is one aligned load and store
  for (int gi = threadIdx.x; gi < R * G; gi += kThreads) {
    const int i = gi / G, c = (gi - i * G) * 8;
    int shift;
    const uint8_t* arow = at + Fmt::row_offset(i, R, C, &shift);
    unsigned edge = 0;  // bit q: cell c + q holds an edge (value > 0)
    if (vec_c) {
      const typename Fmt::Raw w = Fmt::load_raw(arow, c);
      const unsigned nz = Fmt::nonzero8(w, shift);
      if (nz) {
#pragma unroll
        for (int q = 0; q < 8; ++q) edge |= ((nz >> q) & 1u) && Fmt::cell(w, q, shift) > 0.f ? 1u << q : 0u;
      }
    } else {
#pragma unroll
      for (int q = 0; q < 8; ++q) edge |= c + q < C && Fmt::load1(arow, c + q, shift) > 0.f ? 1u << q : 0u;
    }
    // rows at or past n and columns at or past n_src hold no edge
    const int64_t grow = row0 + i;
    const int64_t lim = n_src - (col0 + c);
    if (grow >= n) edge = 0;
    if (lim < 8) edge &= lim <= 0 ? 0u : (1u << lim) - 1u;
    float d[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) d[q] = 0.f;
    if (edge) {
      const float* brow = b + grow * f;
      const float* arow0 = a + (col0 + c) * f;
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if ((edge >> q) & 1u) d[q] = dot(brow, arow0 + static_cast<int64_t>(q) * f, f, vec_f);
    }
    Out* o = ot + static_cast<int64_t>(i) * C + c;
    if (vec_c) {
      store8(o, d);
    } else {
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (c + q < C) store1(o + q, d[q]);
    }
  }
}

template <class Fmt, class Out>
int launch(const void* a_tiles, const void* tile_row, const void* tile_col, const void* a,
           const void* b, void* out, int num_tiles, int R, int C, int n, int n_src, int f,
           int device, void* stream) {
  if (num_tiles == 0 || R == 0 || C == 0) return 0;
  // this library carries its own (static) CUDA runtime: select the caller's
  // card in it before launching on the caller's stream
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const auto aligned = [](const void* q) { return reinterpret_cast<uintptr_t>(q) % 16 == 0; };
  const bool vec_f = f % 4 == 0 && aligned(a) && aligned(b);
  sddmm_bcsr_kernel<Fmt, Out><<<num_tiles, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a_tiles), static_cast<const int32_t*>(tile_row),
      static_cast<const int32_t*>(tile_col), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<Out*>(out), R, C, n, n_src, f, vec_f);
  return static_cast<int>(cudaGetLastError());
}

// out_bf16: 0 for a float32 output, 1 for bfloat16
template <class Fmt>
int launch_out(const void* a_tiles, const void* tile_row, const void* tile_col, const void* a, const void* b,
               void* out, int num_tiles, int R, int C, int n, int n_src, int f, int out_bf16, int device,
               void* stream) {
  return out_bf16 ? launch<Fmt, __nv_bfloat16>(a_tiles, tile_row, tile_col, a, b, out, num_tiles, R, C, n, n_src,
                                               f, device, stream)
                  : launch<Fmt, float>(a_tiles, tile_row, tile_col, a, b, out, num_tiles, R, C, n, n_src, f,
                                       device, stream);
}

}  // namespace

// One entry point per A format: int8 counts, 1-bit (R % 8 == 0), float32,
// bfloat16.
#define SDDMM_ENTRY(tag, Fmt, check)                                                                         \
  extern "C" int sddmm_bcsr_##tag##_f32(const void* a_tiles, const void* tile_row, const void* tile_col,    \
                                        const void* a, const void* b, void* out, int num_tiles, int R,      \
                                        int C, int n, int n_src, int f, int out_bf16, int device,           \
                                        void* stream) {                                                      \
    if (check) return static_cast<int>(cudaErrorInvalidValue);                                               \
    return launch_out<Fmt>(a_tiles, tile_row, tile_col, a, b, out, num_tiles, R, C, n, n_src, f, out_bf16,   \
                           device, stream);                                                                  \
  }

SDDMM_ENTRY(i8, CountTiles, false)
SDDMM_ENTRY(b1, BitTiles, R % 8 != 0)
SDDMM_ENTRY(f32, F32Tiles, false)
SDDMM_ENTRY(bf16, Bf16Tiles, false)
