// Nonzero cells of one row of a tile, compacted by one warp.
//
// Used by the cell walk (cell_walk.cuh) of B1, B2, B3 and B4, which walks a
// row's tiles with one warp and does work only for the cells whose value is
// nonzero (the tiles are ~99% zero).  compact_mask takes the lane's mask of
// its 8 cells (c0 + lane * 8 .. + 7, kChunk columns a pass) and writes the
// marked ones, in ascending column order, to the warp's list through a
// callback; warp_sum adds a value over the warp.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

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

}  // namespace tile_cells
