// Nonzero cells of one row of a tile, compacted by one warp.
//
// Shared by the GAT backward kernels (gat_bwd_dad.cu, gat_bwd_dh_das.cu),
// which walk a row's tiles with one warp and do work only for the cells
// whose value is nonzero (the tiles are ~99% zero).  Each pass scans kChunk
// columns, 8 per lane, and writes the nonzero ones, in ascending column
// order, to the warp's list.  The A format is a template argument
// (bit_tiles.cuh), read 8 cells a lane by tile_fmt::load8_tail (8 count
// bytes, 16 bytes of bfloat16 or 32 of float32; a 1-bit row's cells are
// 0 or 1).  compact_row takes the count formats, each entry (column << 8)
// | count; compact_row_vals takes the float formats (kValued), each entry a
// column in one list and its value in a parallel float list, so a value
// never passes through an integer.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "bit_tiles.cuh"

namespace tile_cells {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kChunk = 256;  // tile columns scanned per pass, 8 per lane

// x summed over the warp; every lane gets the same bits (each butterfly
// step adds the same two partial sums, in either order).
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x += __shfl_xor_sync(kFull, x, d);
  return x;
}

// Compacts the nonzero cells among columns [c0, c0 + kChunk) of the tile
// row whose bytes start at row_a (shift: the row's bit plane, from
// Fmt::row_offset) and returns their number, the same in every lane.  Each
// lane reads its 8 cells' values with tile_fmt::load8_tail (vec: C % 8 ==
// 0, so they are one aligned load), and the warp's scan of the lanes'
// nonzero counts gives each lane its place in the list; emit(pos, column,
// value) writes one cell there.  The leading __syncwarp lets the warp
// finish reading the previous list before it is overwritten.
template <class Fmt, class Emit>
__device__ __forceinline__ int compact_cells(const uint8_t* __restrict__ row_a, int shift, int C, int c0,
                                             bool vec, int lane, Emit emit) {
  const int base = c0 + lane * 8;
  float v[8];
  tile_fmt::load8_tail<Fmt>(row_a, base, C, vec, shift, v);
  int nz = 0;
#pragma unroll
  for (int q = 0; q < 8; ++q) nz += v[q] != 0.f;
  int incl = nz;  // inclusive scan of the lanes' counts
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int x = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += x;
  }
  const int total = __shfl_sync(kFull, incl, 31);
  int pos = incl - nz;
  __syncwarp();
#pragma unroll
  for (int q = 0; q < 8; ++q)
    if (v[q] != 0.f) emit(pos++, base + q, v[q]);
  __syncwarp();
  return total;
}

// The count formats: each entry of list is (column << 8) | count.
template <class Fmt>
__device__ __forceinline__ int compact_row(const uint8_t* __restrict__ row_a, int shift, int C, int c0,
                                           bool vec, int lane, int* list) {
  return compact_cells<Fmt>(row_a, shift, C, c0, vec, lane,
                            [=](int p, int col, float v) { list[p] = (col << 8) | static_cast<int>(v); });
}

// The float formats: the columns go to cols and the values to vals.
template <class Fmt>
__device__ __forceinline__ int compact_row_vals(const uint8_t* __restrict__ row_a, int shift, int C, int c0,
                                                bool vec, int lane, int* cols, float* vals) {
  return compact_cells<Fmt>(row_a, shift, C, c0, vec, lane, [=](int p, int col, float v) {
    cols[p] = col;
    vals[p] = v;
  });
}

}  // namespace tile_cells
