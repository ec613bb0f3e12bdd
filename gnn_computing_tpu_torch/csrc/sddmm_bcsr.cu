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
// the f32 operands: exact f32 products, within the error class of the TPU's
// split23 (16-bit chunks) and split33 (24-bit chunks) bf16 passes.  No
// TF32 and no tensor-core shortcut rounds the operands.
//
// Design: one block per tile (the tile owns its output block: no atomics,
// no order between blocks).  The block stages the tile's a rows k-major
// ([f][C + pad]) and its b rows ([R][f]) in shared memory, in column and
// row chunks that fit the shared-memory budget.  A warp takes one tile row
// at a time, a lane two neighbouring columns: it reads their two cells'
// values by Fmt::load1 (a count widened exactly, or a float value),
// computes the two dots only if either holds an edge (b broadcast, a as one
// float2 a step), selects on the value (a non-edge's dot may be inf, and
// 0 * inf is NaN) and writes both cells, zeros included, as one 64-bit
// (float32) or 32-bit (bfloat16) store: a warp writes 64 contiguous cells.
// Filler tiles come out all zero.
//
// Bound on the H100 SXM (3.35 TB/s; 67 TFLOP/s f32 outside the tensor
// cores): bytes.  The function must write every cell (T*R*C*2 bytes in
// bf16) and read A once (T*R*C, T*R*C/8 for 1-bit tiles, 2 or 4 times
// T*R*C for bfloat16 or float32 tiles) plus a and b;
// the dots are 2*nnz*f FLOPs, ~1% of the cells.  The dot loop runs only
// where a lane has an edge, so sparse tiles cost little more than their
// stores; dense (hub) tiles run it on every lane.
//
// What the simple design leaves on the table: b rows are staged per tile
// although consecutive tiles of a run share them; a tile's a block is read
// from L2 per tile; there is no cp.async/TMA overlap of staging with the
// dots, and the output could be written with 16-byte stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bit_tiles.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSmemBudget = 96 * 1024;  // dynamic shared memory a block
constexpr int kAChunkBudget = 64 * 1024;  // of which the a chunk at most

__device__ __forceinline__ void store2(float* p, float x, float y, bool pair, bool vec) {
  if (pair && vec) {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
  } else {
    p[0] = x;
    if (pair) p[1] = y;
  }
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y, bool pair, bool vec) {
  if (pair && vec) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
  } else {
    p[0] = __float2bfloat16_rn(x);
    if (pair) p[1] = __float2bfloat16_rn(y);
  }
}

// Columns c0 .. c0 + CC of every tile are done with a chunk of a staged in
// as[f][ccp] (ccp even, >= CC + 1), rows r0 .. r0 + RB with b staged in
// bs[RB][f].
template <class Fmt, class Out>
__global__ void __launch_bounds__(kThreads)
sddmm_bcsr_kernel(const uint8_t* __restrict__ a_tiles, const int32_t* __restrict__ tile_row,
                  const int32_t* __restrict__ tile_col, const float* __restrict__ a,
                  const float* __restrict__ b, Out* __restrict__ out, int R, int C, int n,
                  int n_src, int f, int CC, int ccp, int RB) {
  extern __shared__ __align__(16) float smem[];
  float* as = smem;
  float* bs = smem + static_cast<int64_t>(f) * ccp;

  const int t = blockIdx.x;
  const uint8_t* at = a_tiles + t * Fmt::tile_bytes(R, C);
  const int64_t row0 = static_cast<int64_t>(tile_row[t]) * R;
  const int64_t col0 = static_cast<int64_t>(tile_col[t]) * C;
  Out* ot = out + static_cast<int64_t>(t) * R * C;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const bool vec = (C % 2) == 0;

  for (int c0 = 0; c0 < C; c0 += CC) {
    const int cw = min(CC, C - c0);
    for (int r0 = 0; r0 < R; r0 += RB) {
      const int rh = min(RB, R - r0);
      __syncthreads();  // the previous chunk's readers are done
      if (r0 == 0) {
        for (int e = tid; e < cw * f; e += kThreads) {
          const int j = e / f, k = e - j * f;
          const int64_t col = col0 + c0 + j;
          as[k * ccp + j] = col < n_src ? a[col * f + k] : 0.f;
        }
      }
      for (int e = tid; e < rh * f; e += kThreads) {
        const int64_t row = row0 + r0 + e / f;
        bs[e] = row < n ? b[row * f + e % f] : 0.f;
      }
      __syncthreads();
      for (int i = r0 + warp; i < r0 + rh; i += kWarps) {
        int shift;
        const uint8_t* arow = at + Fmt::row_offset(i, R, C, &shift);
        const float* brow = bs + (i - r0) * f;
        for (int j = c0 + 2 * lane; j < c0 + cw; j += 64) {
          const bool pair = j + 1 < c0 + cw;
          // the JAX rule: a cell holds an edge where its value is > 0
          const bool e0 = Fmt::load1(arow, j, shift) > 0.f;
          const bool e1 = pair && Fmt::load1(arow, j + 1, shift) > 0.f;
          float d0 = 0.f, d1 = 0.f;
          if (e0 || e1) {
            // column j - c0 is even and ccp is even: an aligned float2
            const float* ak = as + (j - c0);
#pragma unroll 4
            for (int k = 0; k < f; ++k) {
              const float2 av = *reinterpret_cast<const float2*>(ak + k * ccp);
              const float bv = brow[k];
              d0 = fmaf(bv, av.x, d0);
              d1 = fmaf(bv, av.y, d1);
            }
          }
          store2(ot + static_cast<int64_t>(i) * C + j, e0 ? d0 : 0.f, e1 ? d1 : 0.f, pair, vec);
        }
      }
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
  // f == 0: every dot is 0; one float of staging keeps the layout valid
  const int64_t fb = 4 * static_cast<int64_t>(f > 0 ? f : 1);
  // the a chunk: all C columns if they fit its budget, else a multiple of
  // 64 columns (even, so a lane's float2 stays aligned)
  int CC = C;
  if ((C + 2) * fb > kAChunkBudget) {
    const int64_t fit = kAChunkBudget / fb - 2;
    CC = static_cast<int>(fit >= 64 ? fit / 64 * 64 : fit / 2 * 2);
    if (CC < 2) return static_cast<int>(cudaErrorInvalidValue);
  }
  const int ccp = (CC + 1) / 2 * 2 + 2;
  const int64_t a_bytes = ccp * fb;
  int RB = static_cast<int>((kSmemBudget - a_bytes) / fb);
  if (RB > R) RB = R;
  if (RB < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(a_bytes + RB * fb);
  auto kernel = sddmm_bcsr_kernel<Fmt, Out>;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<num_tiles, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a_tiles), static_cast<const int32_t*>(tile_row),
      static_cast<const int32_t*>(tile_col), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<Out*>(out), R, C, n, n_src, f, CC, ccp, RB);
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
