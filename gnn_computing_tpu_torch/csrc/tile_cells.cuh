// Nonzero cells of one row of a tile, compacted by one warp.
//
// Shared by the GAT backward kernel B4 (gat_bwd_dh_das.cu) and the cell
// walk of B1, B2 and B3 (cell_walk.cuh), which walk a row's tiles
// with one warp and do work only for the cells whose value is nonzero (the
// tiles are ~99% zero).  Each pass scans kChunk
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

// Compacts the cells among 8 a lane that bit q of `mask` marks (the cells
// base .. base + 7 of the lane, base = c0 + lane * 8; value(q) gives cell
// base + q's value) and returns their number, the same in every lane.  Each
// lane's place in the list is the number of marked cells of the lanes below
// it, from four ballots over the bits of the lanes' counts (0..8);
// emit(pos, column, value) writes one cell there, in ascending column
// order.  The leading __syncwarp lets the warp finish reading the previous
// list before it is overwritten.
template <class Value, class Emit>
__device__ __forceinline__ int compact_mask(unsigned mask, int base, int lane, Value value, Emit emit) {
  const int nz = __popc(mask);
  const unsigned below = (1u << lane) - 1u;
  int pos = 0, total = 0;
#pragma unroll
  for (int bit = 0; bit < 4; ++bit) {
    const unsigned b = __ballot_sync(kFull, (nz >> bit) & 1);
    pos += __popc(b & below) << bit;
    total += __popc(b) << bit;
  }
  __syncwarp();
#pragma unroll
  for (int q = 0; q < 8; ++q)
    if ((mask >> q) & 1u) emit(pos++, base + q, value(q));
  __syncwarp();
  return total;
}

// compact_mask over the nonzero ones among the lane's 8 cells v
template <class Emit>
__device__ __forceinline__ int compact_values(const float (&v)[8], int base, int lane, Emit emit) {
  unsigned mask = 0;
#pragma unroll
  for (int q = 0; q < 8; ++q) mask |= (v[q] != 0.f ? 1u : 0u) << q;
  return compact_mask(mask, base, lane, [&](int q) { return v[q]; }, emit);
}

// Compacts the nonzero cells among columns [c0, c0 + kChunk) of the tile
// row whose bytes start at row_a (shift: the row's bit plane, from
// Fmt::row_offset) with compact_values.  Each lane reads its 8 cells'
// values with tile_fmt::load8_tail (vec: C % 8 == 0, so they are one
// aligned load).
template <class Fmt, class Emit>
__device__ __forceinline__ int compact_cells(const uint8_t* __restrict__ row_a, int shift, int C, int c0,
                                             bool vec, int lane, Emit emit) {
  const int base = c0 + lane * 8;
  float v[8];
  tile_fmt::load8_tail<Fmt>(row_a, base, C, vec, shift, v);
  return compact_values(v, base, lane, emit);
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
