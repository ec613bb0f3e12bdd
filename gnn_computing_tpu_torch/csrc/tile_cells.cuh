// Nonzero cells of one row of a count tile, compacted by one warp.
//
// Shared by the GAT backward kernels (gat_bwd_dad.cu, gat_bwd_dh_das.cu),
// which walk a row's tiles with one warp and do work only for the cells
// that hold an edge (the tiles are ~99% zero).  Each pass scans kChunk
// columns, 8 per lane (one 8-byte load where C is a multiple of 8), and
// writes the nonzero ones, in ascending column order, to the warp's list as
// (column << 8) | count.  The A format is a template argument
// (bit_tiles.cuh): a row's bytes are C consecutive bytes in both formats,
// so the load is the same, and a 1-bit row keeps the cells whose bit is set,
// with count 1.

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
// row whose C bytes start at row_a (shift: the row's bit plane, from
// Fmt::row_offset) into list and returns their number, the same in every
// lane.  vec: C % 8 == 0, so each lane's 8 bytes are one aligned 8-byte
// word.  The leading __syncwarp lets the warp finish reading the previous
// list before it is overwritten.
template <class Fmt>
__device__ __forceinline__ int compact_row(const uint8_t* __restrict__ row_a, int shift, int C, int c0,
                                           bool vec, int lane, int* list) {
  const int base = c0 + lane * 8;
  int cnt[8];
  if (vec && base + 8 <= C) {
    const int2 v = *reinterpret_cast<const int2*>(row_a + base);
    const uint8_t* b = reinterpret_cast<const uint8_t*>(&v);
#pragma unroll
    for (int q = 0; q < 8; ++q) cnt[q] = Fmt::count(b[q], shift);
  } else {
#pragma unroll
    for (int q = 0; q < 8; ++q) cnt[q] = base + q < C ? Fmt::count(row_a[base + q], shift) : 0;
  }
  int nz = 0;
#pragma unroll
  for (int q = 0; q < 8; ++q) nz += cnt[q] > 0;
  int incl = nz;  // inclusive scan of the lanes' counts
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += v;
  }
  const int total = __shfl_sync(kFull, incl, 31);
  int pos = incl - nz;
  __syncwarp();
#pragma unroll
  for (int q = 0; q < 8; ++q)
    if (cnt[q] > 0) list[pos++] = ((base + q) << 8) | cnt[q];
  __syncwarp();
  return total;
}

}  // namespace tile_cells
