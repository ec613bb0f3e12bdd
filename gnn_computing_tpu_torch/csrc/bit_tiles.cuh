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
// load8 reads the 8 cells of load_raw(row, c) with cell(raw, q, shift): a
// kernel may hold the raw bytes (Fmt::Raw; a zero Raw holds 8 zero cells)
// to prefetch them, and read from them nonzero8(raw, shift) (bit q set
// where cell c + q's value is nonzero) and one cell's value.
// The kernels that skip zero cells keep the cells whose value is nonzero
// (v != 0; a non-edge cell is exactly 0), or, for the SDDMM, > 0.  The
// count formats also read a cell's count as count(byte at column c, shift)
// (a row of either is C consecutive bytes); the float formats (kValued)
// have no count.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tile_fmt {

// x rounded once to bfloat16 (nearest even, as PyTorch's
// .to(torch.bfloat16)), widened back
__device__ __forceinline__ float bf16_round(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

// the 8 cells' values of a Raw
template <class Fmt>
__device__ __forceinline__ void unpack8(const typename Fmt::Raw& w, int shift, float* v) {
#pragma unroll
  for (int q = 0; q < 8; ++q) v[q] = Fmt::cell(w, q, shift);
}

// 8 float32 cells as loaded
struct F32x8 {
  float4 x, y;
};

// bit q set where byte q of w (the 8 bytes as two words) is nonzero
__device__ __forceinline__ unsigned nonzero_bytes(const int2& w) {
  const unsigned lo = (__vcmpne4(static_cast<unsigned>(w.x), 0u) & 0x08040201u) * 0x01010101u >> 24;
  const unsigned hi = (__vcmpne4(static_cast<unsigned>(w.y), 0u) & 0x08040201u) * 0x01010101u >> 24;
  return lo | hi << 4;
}

// byte q of w as an unsigned value
__device__ __forceinline__ unsigned byte_of(const int2& w, int q) {
  return (static_cast<unsigned>(q < 4 ? w.x : w.y) >> (8 * (q & 3))) & 0xffu;
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
  using Raw = int2;
  static __device__ __forceinline__ Raw load_raw(const uint8_t* row, int c) {
    return *reinterpret_cast<const int2*>(row + c);
  }
  static __device__ __forceinline__ unsigned nonzero8(const Raw& w, int shift) { return tile_fmt::nonzero_bytes(w); }
  static __device__ __forceinline__ float cell(const Raw& w, int q, int shift) {
    return static_cast<float>(static_cast<int8_t>(tile_fmt::byte_of(w, q)));
  }
  static __device__ __forceinline__ void load8(const uint8_t* row, int c, int shift, float* v) {
    tile_fmt::unpack8<CountTiles>(load_raw(row, c), shift, v);
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
  using Raw = int2;
  static __device__ __forceinline__ Raw load_raw(const uint8_t* row, int c) {
    return *reinterpret_cast<const int2*>(row + c);
  }
  static __device__ __forceinline__ unsigned nonzero8(const Raw& w, int shift) {
    const int2 b = make_int2((static_cast<unsigned>(w.x) >> shift) & 0x01010101u,
                             (static_cast<unsigned>(w.y) >> shift) & 0x01010101u);
    return tile_fmt::nonzero_bytes(b);
  }
  static __device__ __forceinline__ float cell(const Raw& w, int q, int shift) {
    return static_cast<float>((tile_fmt::byte_of(w, q) >> shift) & 1u);
  }
  static __device__ __forceinline__ void load8(const uint8_t* row, int c, int shift, float* v) {
    tile_fmt::unpack8<BitTiles>(load_raw(row, c), shift, v);
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
  using Raw = tile_fmt::F32x8;
  static __device__ __forceinline__ Raw load_raw(const uint8_t* row, int c) {
    const float4* p = reinterpret_cast<const float4*>(row) + c / 4;
    return Raw{p[0], p[1]};
  }
  static __device__ __forceinline__ float cell(const Raw& w, int q, int shift) {
    const float4& h = q < 4 ? w.x : w.y;
    const int i = q & 3;
    return i == 0 ? h.x : i == 1 ? h.y : i == 2 ? h.z : h.w;
  }
  static __device__ __forceinline__ unsigned nonzero8(const Raw& w, int shift) {
    unsigned m = 0;
#pragma unroll
    for (int q = 0; q < 8; ++q) m |= (cell(w, q, shift) != 0.f ? 1u : 0u) << q;
    return m;
  }
  static __device__ __forceinline__ void load8(const uint8_t* row, int c, int shift, float* v) {
    tile_fmt::unpack8<F32Tiles>(load_raw(row, c), shift, v);
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
  using Raw = uint4;
  static __device__ __forceinline__ Raw load_raw(const uint8_t* row, int c) {
    return *reinterpret_cast<const uint4*>(row + 2 * c);
  }
  static __device__ __forceinline__ void load8(const uint8_t* row, int c, int shift, float* v) {
    tile_fmt::unpack8<Bf16Tiles>(load_raw(row, c), shift, v);
  }
  // little-endian: the low half of a word is the lower column
  static __device__ __forceinline__ float cell(const Raw& w, int q, int shift) {
    const uint32_t word = q < 2 ? w.x : q < 4 ? w.y : q < 6 ? w.z : w.w;
    return __uint_as_float(q % 2 ? word & 0xffff0000u : word << 16);
  }
  // a cell is nonzero unless its 15 bits beside the sign are (+0 or -0)
  static __device__ __forceinline__ unsigned nonzero8(const Raw& w, int shift) {
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
    unsigned m = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      m |= ((words[q] & 0x7fffu) != 0u ? 1u : 0u) << (2 * q) | ((words[q] & 0x7fff0000u) != 0u ? 2u : 0u) << (2 * q);
    return m;
  }
  static __device__ __forceinline__ float load1(const uint8_t* row, int c, int shift) {
    return __uint_as_float(static_cast<uint32_t>(reinterpret_cast<const uint16_t*>(row)[c]) << 16);
  }
};
