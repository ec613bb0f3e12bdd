// The A formats of the tile kernels, as template arguments.
//
// CountTiles: int8 [T, R, C]; a[t, i, c] is the edge count of cell (i, c).
// BitTiles:   uint8 [T, R/8, C], plane-major along rows (R % 8 == 0): bit b
//             of a[t, r, c] is cell (b*R/8 + r, c), every count 0 or 1 (the
//             layout of gnn_computing_tpu_torch/schedule/tiles.py
//             pack_bit_tiles, as the JAX package packs it).
// F32Tiles:   float32 [T, R, C] edge values (weighted graphs).
// Bf16Tiles:  bfloat16 [T, R, C] edge values, widened exactly to float32.
//
// A kernel finds the bytes of tile row i at tile_base + row_offset(i)
// (shift: 0, or the bit plane of row i for BitTiles).  Every format loads
// the values of 8 consecutive cells c..c+7 of a row as floats with
// load8(row, c, shift, v) (C % 8 == 0 and c % 8 == 0: one 8-byte load for
// the byte formats, 16 bytes for bf16, 32 for f32) and one cell with
// load1(row, c, shift); tile_fmt::load8_tail does either, up to column C.
// The kernels that skip zero cells keep the cells whose value is nonzero
// (v != 0; a non-edge cell is exactly 0), or, for the SDDMM, > 0.  The
// count formats also read a cell's count as count(byte at column c, shift):
// a row of either is C consecutive bytes, which B5 scans a 4-byte word at a
// time, skipping zero words; the float formats (kValued) have no count.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tile_fmt {

// x rounded once to bfloat16 (nearest even, as PyTorch's
// .to(torch.bfloat16)), widened back
__device__ __forceinline__ float bf16_round(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

// load8 of a count format: 8 bytes, one per column
template <class Fmt>
__device__ __forceinline__ void load8_bytes(const uint8_t* row, int c, int shift, float* v) {
  const int2 w = *reinterpret_cast<const int2*>(row + c);
  const uint8_t* b = reinterpret_cast<const uint8_t*>(&w);
#pragma unroll
  for (int q = 0; q < 8; ++q) v[q] = static_cast<float>(Fmt::count(b[q], shift));
}

// Values of cells c..c+7 of a row, 0 past column C: one load8 where the
// row is vector-aligned (vec: C % 8 == 0; c % 8 == 0) and all 8 lie
// inside it, else load1 per cell
template <class Fmt>
__device__ __forceinline__ void load8_tail(const uint8_t* row, int c, int C, bool vec, int shift, float* v) {
  if (vec && c + 8 <= C) {
    Fmt::load8(row, c, shift, v);
  } else {
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] = c + q < C ? Fmt::load1(row, c + q, shift) : 0.f;
  }
}

}  // namespace tile_fmt

struct CountTiles {
  static constexpr bool kValued = false;
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
  static __device__ __forceinline__ void load8(const uint8_t* row, int c, int shift, float* v) {
    tile_fmt::load8_bytes<CountTiles>(row, c, shift, v);
  }
  static __device__ __forceinline__ float load1(const uint8_t* row, int c, int shift) {
    return static_cast<float>(count(row[c], shift));
  }
};

struct BitTiles {
  static constexpr bool kValued = false;
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
  static __device__ __forceinline__ void load8(const uint8_t* row, int c, int shift, float* v) {
    tile_fmt::load8_bytes<BitTiles>(row, c, shift, v);
  }
  static __device__ __forceinline__ float load1(const uint8_t* row, int c, int shift) {
    return static_cast<float>(count(row[c], shift));
  }
};

struct F32Tiles {
  static constexpr bool kValued = true;
  static __host__ __device__ __forceinline__ int64_t tile_bytes(int R, int C) {
    return static_cast<int64_t>(R) * C * 4;
  }
  static __device__ __forceinline__ int64_t row_offset(int i, int R, int C, int* shift) {
    *shift = 0;
    return static_cast<int64_t>(i) * C * 4;
  }
  static __device__ __forceinline__ void load8(const uint8_t* row, int c, int shift, float* v) {
    const float4* p = reinterpret_cast<const float4*>(row) + c / 4;
    const float4 x = p[0], y = p[1];
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
    v[4] = y.x; v[5] = y.y; v[6] = y.z; v[7] = y.w;
  }
  static __device__ __forceinline__ float load1(const uint8_t* row, int c, int shift) {
    return reinterpret_cast<const float*>(row)[c];
  }
};

// bfloat16 is the high half of a float32: widening is a 16-bit shift
struct Bf16Tiles {
  static constexpr bool kValued = true;
  static __host__ __device__ __forceinline__ int64_t tile_bytes(int R, int C) {
    return static_cast<int64_t>(R) * C * 2;
  }
  static __device__ __forceinline__ int64_t row_offset(int i, int R, int C, int* shift) {
    *shift = 0;
    return static_cast<int64_t>(i) * C * 2;
  }
  static __device__ __forceinline__ void load8(const uint8_t* row, int c, int shift, float* v) {
    const uint4 w = *reinterpret_cast<const uint4*>(row + 2 * c);
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {  // little-endian: the low half is the lower column
      v[2 * q] = __uint_as_float(words[q] << 16);
      v[2 * q + 1] = __uint_as_float(words[q] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ float load1(const uint8_t* row, int c, int shift) {
    return __uint_as_float(static_cast<uint32_t>(reinterpret_cast<const uint16_t*>(row)[c]) << 16);
  }
};
