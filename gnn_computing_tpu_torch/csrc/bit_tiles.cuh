// The two A formats of the tile kernels, as template arguments.
//
// CountTiles: int8 [T, R, C]; a[t, i, c] is the edge count of cell (i, c).
// BitTiles:   uint8 [T, R/8, C], plane-major along rows (R % 8 == 0): bit b
//             of a[t, r, c] is cell (b*R/8 + r, c), every count 0 or 1 (the
//             layout of gnn_computing_tpu_torch/schedule/tiles.py
//             pack_bit_tiles, as the JAX package packs it).
//
// A kernel finds the bytes of tile row i at tile_base + row_offset(i) and
// reads the count of column c as count(byte at column c, shift): the
// shift is 0 for CountTiles and the bit plane of row i for BitTiles.  For
// both formats a tile row's bytes are C consecutive bytes, so a kernel
// loads them the same way (8 at a time where C % 8 == 0).

#pragma once

#include <stdint.h>

struct CountTiles {
  static __host__ __device__ __forceinline__ int64_t tile_bytes(int R, int C) {
    return static_cast<int64_t>(R) * C;
  }
  static __device__ __forceinline__ int64_t row_offset(int i, int R, int C, int* shift) {
    *shift = 0;
    return static_cast<int64_t>(i) * C;
  }
  static __device__ __forceinline__ int count(uint8_t byte, int shift) {
    return static_cast<int8_t>(byte);
  }
};

struct BitTiles {
  static __host__ __device__ __forceinline__ int64_t tile_bytes(int R, int C) {
    return static_cast<int64_t>(R / 8) * C;
  }
  static __device__ __forceinline__ int64_t row_offset(int i, int R, int C, int* shift) {
    const int r8 = R / 8;
    *shift = i / r8;
    return static_cast<int64_t>(i - *shift * r8) * C;
  }
  static __device__ __forceinline__ int count(uint8_t byte, int shift) {
    return (byte >> shift) & 1;
  }
};
