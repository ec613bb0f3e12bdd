// Nonzero cells of one row of an int8 count tile, compacted by one warp.
//
// Shared by the GAT backward kernels (gat_bwd_dad.cu, gat_bwd_dh_das.cu),
// which walk a row's tiles with one warp and do work only for the cells
// that hold an edge (the tiles are ~99% zero).  Each pass scans kChunk
// columns, 8 per lane (one 8-byte load where C is a multiple of 8), and
// writes the nonzero ones, in ascending column order, to the warp's list as
// (column << 8) | count.

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

// Compacts the nonzero cells among columns [c0, c0 + kChunk) of the tile
// row at row_a (C counts) into list and returns their number, the same in
// every lane.  vec: C % 8 == 0, so each lane's 8 counts are one aligned
// 8-byte word.  The leading __syncwarp lets the warp finish reading the
// previous list before it is overwritten.
__device__ __forceinline__ int compact_row(const int8_t* __restrict__ row_a, int C, int c0, bool vec,
                                           int lane, int* list) {
  const int base = c0 + lane * 8;
  int8_t cnt[8];
  if (vec && base + 8 <= C) {
    const int2 v = *reinterpret_cast<const int2*>(row_a + base);
    const int8_t* b = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
    for (int q = 0; q < 8; ++q) cnt[q] = b[q];
  } else {
#pragma unroll
    for (int q = 0; q < 8; ++q) cnt[q] = base + q < C ? row_a[base + q] : int8_t(0);
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
