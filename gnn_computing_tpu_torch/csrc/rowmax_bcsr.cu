// Per-destination-row max over the tiles' nonzero cells (B5), hand-written
// for Hopper.
//
// Replaces the TPU kernel gnn_computing_tpu/ops/pallas_bcsr.py:
// rowmax_bcsr_pallas (int8, 1-bit, float32 and bfloat16 tile formats).  The
// A format is a template argument (bit_tiles.cuh): a cell counts where its
// value is nonzero (Fmt::nonzero8: a count byte != 0, the row's bit of a
// 1-bit byte, a float32 or bfloat16 value other than +-0), every such cell,
// whatever its sign (C6).
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
// Design: a max walk over the plan's work list (ops/cell_walk.py), the
// list of B1, B2 and B3, bounded in cells only: B5 gathers nothing, so its
// time is the tile rows a warp walks one after another, but on the H100 a
// further cut every 128 tiles gave the same time (the cell bound already
// cuts the long runs) and every 8 or 32 tiles a slower one.  The block
// layout is the cell walk's (csrc/cell_walk.cuh): a block owns 8 rows of
// one chunk, one warp a row; for 1-bit tiles the 8 rows that share a byte
// row (one per bit plane), so the block reads each A byte once.  The row's cells arrive 8 a
// lane in batches of the walk's ring (cell_walk::ring_fill: the cells of
// kAhead tiles, 32 bytes a lane), two batches in turn, so one is in flight
// while the other is read (a ring that shifts its registers waits at each
// shift for the load still in flight in the register it moves).  Per tile
// row a vote on a cheap any-cell test (any8) skips a row without a cell;
// otherwise each lane loads col_vals of its own nonzero cells (columns at
// or past n_src masked), up to 8 at once, and takes their max.  No
// compaction and no ballot scan: a max does not care about order.  A
// warp-max ends the chunk.
// A run of one chunk writes its rows directly (an empty run's chunk writes
// -inf); the chunks of a longer run meet in out, filled with -inf first, by
// an atomic max on the float's order-preserving integer image (signed max
// for a value with the sign bit clear, unsigned min for one with it set).
// Two calls give bitwise equal output: a max does not round, and +0 beats
// -0 in either order.
//
// Bound on the H100 SXM (3.35 TB/s): the function reads A (T*R*C bytes; R*C/8
// a 1-bit tile, 2 or 4 bytes a cell for bfloat16 or float32) and col_vals
// (n_src*4) and writes out (n*4); one compare per cell is far below any
// compute limit.  At the quick GAT plan (4,024 int8 tiles of [512, 256])
// that is about 0.16 ms, bytes-bound; its 1-bit part's about 0.015 ms.
// On the card (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py phase 38's
// profiler) it takes about 0.19 ms over that plan and 0.10-0.12 ms over its
// 1-bit part: the instructions of 1.5M warp tile rows there, each warp of a
// 1-bit block repeating its neighbours' load and test.  What the design
// leaves on the table: every tile row of a chunk is still visited (a vote
// each), where an index of each tile's nonzero rows would skip the empty
// ones unread; a 1-bit block's 8 warps test the same bytes 8 times.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

#include "bit_tiles.cuh"
#include "cell_walk.cuh"

namespace {

using cell_walk::kThreads;
using cell_walk::Work;
using tile_cells::kChunk;
using tile_cells::kFull;

// *p = max(*p, v) for float p, v (neither NaN): a float with the sign bit
// clear orders as a signed int, one with it set in reverse as an unsigned
__device__ __forceinline__ void atomic_max(float* p, float v) {
  if (__float_as_uint(v) >> 31)
    atomicMin(reinterpret_cast<unsigned*>(p), __float_as_uint(v));
  else
    atomicMax(reinterpret_cast<int*>(p), __float_as_int(v));
}

// whether any of the 8 cells of w is nonzero: the same as
// Fmt::nonzero8(w, shift) != 0, in fewer instructions for the count formats
template <class Fmt>
__device__ __forceinline__ bool any8(const typename Fmt::Raw& w, int shift) {
  if constexpr (std::is_same<Fmt, CountTiles>::value) {
    return (w.x | w.y) != 0;
  } else if constexpr (std::is_same<Fmt, BitTiles>::value) {
    return ((static_cast<unsigned>(w.x | w.y) >> shift) & 0x01010101u) != 0;
  } else {
    return Fmt::nonzero8(w, shift) != 0;
  }
}

__global__ void fill_neg_inf(float* __restrict__ out, int n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) out[i] = -CUDART_INF_F;
}

template <class Fmt>
__global__ void __launch_bounds__(kThreads)
rowmax_walk_kernel(const uint8_t* __restrict__ a, const int32_t* __restrict__ tile_col,
                   const float* __restrict__ col_vals, float* __restrict__ out, const Work wk, int R, int C, int n,
                   int n_src, int slabs) {
  using Raw = typename Fmt::Raw;
  constexpr int D = cell_walk::kAhead<Fmt>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k = blockIdx.x / slabs;
  const int r = cell_walk::block_row<Fmt>(blockIdx.x % slabs, warp, R);
  const int run = wk.chunk_run[k];
  const int64_t grow = static_cast<int64_t>(run) * R + r;
  if (r >= R || grow >= n) return;  // the whole warp leaves together
  const int t_begin = wk.chunk_tile[k], t_end = wk.chunk_tile[k + 1];
  int shift = 0;
  const uint8_t* a_row = a + Fmt::row_offset(r, R, C, &shift);
  const int64_t tile_bytes = Fmt::tile_bytes(R, C);
  const bool vec_a = (C % 8) == 0;
  const bool lane_in = lane * 8 < C;
  float mx = -CUDART_INF_F;
  // the lane's cells base .. base + 7 of a tile row whose first column is
  // col0, after the warp's vote (any: the lane holds a nonzero cell): bit q
  // of nz_of() marks a nonzero cell base + q; their col_vals are loaded
  // together, then mx takes their max
  const auto take = [&](bool any, const auto& nz_of, int base, int64_t col0) {
    if (!__any_sync(kFull, any)) return;  // most tile rows hold no cell
    unsigned nz = nz_of();
    // columns at or past n_src hold no edge
    const int64_t lim = n_src - col0;
    if (lim < base + 8) nz &= lim <= base ? 0u : (1u << (lim - base)) - 1u;
    const float* cv = col_vals + col0 + base;
    float x[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) x[q] = (nz >> q) & 1u ? __ldg(cv + q) : -CUDART_INF_F;
#pragma unroll
    for (int q = 0; q < 8; ++q) mx = fmaxf(mx, x[q]);
  };
  // the D tiles t0 .. t0 + D - 1 (those before t_end) from ring slots raw / col
  const auto batch = [&](const Raw (&raw)[D], const int (&col)[D], int t0) {
#pragma unroll
    for (int i = 0; i < D; ++i) {
      if (t0 + i >= t_end) break;
      take(any8<Fmt>(raw[i], shift), [&] { return Fmt::nonzero8(raw[i], shift); }, lane * 8,
           static_cast<int64_t>(col[i]) * C);
    }
  };
  if (vec_a && C <= kChunk) {
    // a row of at most kChunk cells, 8 a lane in one aligned load: two
    // batches of the ring in turn, one in flight while the other is read
    Raw ra[D], rb[D];
    int ca[D], cb[D];
    cell_walk::ring_fill<Fmt>(ra, ca, a_row, tile_col, tile_bytes, t_begin, t_end, lane * 8, true, lane_in);
    for (int t0 = t_begin; t0 < t_end; t0 += 2 * D) {
      cell_walk::ring_fill<Fmt>(rb, cb, a_row, tile_col, tile_bytes, t0 + D, t_end, lane * 8, true, lane_in);
      batch(ra, ca, t0);
      cell_walk::ring_fill<Fmt>(ra, ca, a_row, tile_col, tile_bytes, t0 + 2 * D, t_end, lane * 8, true, lane_in);
      batch(rb, cb, t0 + D);
    }
  } else {  // any other row loads each tile's cells in place
    for (int t = t_begin; t < t_end; ++t) {
      const int64_t col0 = static_cast<int64_t>(tile_col[t]) * C;
      for (int c0 = 0; c0 < C; c0 += kChunk) {
        float v[8];
        tile_fmt::load8_tail<Fmt>(a_row + t * tile_bytes, c0 + lane * 8, C, vec_a, shift, v);
        unsigned nz = 0;
#pragma unroll
        for (int q = 0; q < 8; ++q) nz |= (v[q] != 0.f ? 1u : 0u) << q;
        take(nz != 0, [&] { return nz; }, c0 + lane * 8, col0);
      }
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, d));
  if (lane != 0) return;
  if (wk.chunk_slot[k] < 0)  // the run's only chunk
    out[grow] = mx;
  else if (mx != -CUDART_INF_F)
    atomic_max(out + grow, mx);
}

template <class Fmt>
int launch(const void* a, const void* tile_col, const void* work, const void* col_vals, void* out, int num_chunks,
           int num_multi, int num_row_tiles, int R, int C, int n, int n_src, int device, void* stream) {
  if (num_row_tiles == 0 || n == 0) return 0;
  // this library carries its own (static) CUDA runtime: select the caller's
  // card in it before launching on the caller's stream
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (num_multi > 0) {  // the rows the chunks of a longer run meet in
    fill_neg_inf<<<(n + 255) / 256, 256, 0, s>>>(o, n);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const Work wk(static_cast<const int32_t*>(work), num_chunks, num_multi, num_row_tiles);
  const int slabs = cell_walk::num_slabs<Fmt>(R);
  rowmax_walk_kernel<Fmt><<<dim3(num_chunks * slabs), dim3(kThreads), 0, s>>>(
      static_cast<const uint8_t*>(a), static_cast<const int32_t*>(tile_col), static_cast<const float*>(col_vals), o,
      wk, R, C, n, n_src, slabs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// work: the plan's work list (ops/cell_walk.py), num_chunks /
// num_multi its sizes
#define ROWMAX_ENTRY(tag, Fmt, check)                                                                          \
  extern "C" int rowmax_bcsr_##tag##_f32(const void* a, const void* tile_col, const void* work,              \
                                         const void* col_vals, void* out, int num_chunks, int num_multi,      \
                                         int num_row_tiles, int R, int C, int n, int n_src, int device,       \
                                         void* stream) {                                                      \
    if (check) return static_cast<int>(cudaErrorInvalidValue);                                              \
    return launch<Fmt>(a, tile_col, work, col_vals, out, num_chunks, num_multi, num_row_tiles, R, C, n, n_src, \
                       device, stream);                                                                       \
  }

// 1-bit tiles need R % 8 == 0
ROWMAX_ENTRY(i8, CountTiles, false)
ROWMAX_ENTRY(b1, BitTiles, R % 8)
ROWMAX_ENTRY(f32, F32Tiles, false)
ROWMAX_ENTRY(bf16, Bf16Tiles, false)
