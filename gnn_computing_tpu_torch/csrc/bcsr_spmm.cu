// Block-sparse SpMM over dense tiles (B1), hand-written for Hopper.
//
// Replaces the TPU kernel gnn_computing_tpu/ops/pallas_bcsr.py:
// bcsr_spmm_pallas (int8 count, 1-bit, float32 and bfloat16 tile formats,
// f32 operand after the h_mode rounding; optional w_epilogue).  The A
// format is a template argument (bit_tiles.cuh): int8 counts, 1-bit tiles
// whose row i lies in bit plane i / (R/8) of byte row i % (R/8) (8x fewer
// A bytes), or float32 / bfloat16 edge values (4x / 2x the int8 bytes).
// Every format loads 8 cells of a row as floats (Fmt::load8), so the tile
// walk and the FFMAs are the same for all four.
//
// What it computes: tiles are sorted by destination row-tile; the tiles of
// row-tile r are run_start[r] .. run_start[r+1].  For every row-tile,
//   out[r*R : r*R+R, :] = sum over its tiles t of A_t[R, C] @ H[col_t*C : +C, :]
// Count tiles hold exact edge counts (<= 127).  The caller rounds H to its
// h_mode first ('split' = hi + lo bf16 chunks, 16 mantissa bits), so every
// product count * h is exact in f32 (7 + 16 bits) and only the f32
// accumulation rounds: the exactness class of the TPU's bf16 MXU products.
// Float tiles multiply in f32 FFMA: bf16 values widen exactly, so a bf16
// tile times f32 h is the TPU's 'split3' class (24-bit operand, exact bf16
// products) and an f32 tile its 'native' HIGHEST dot.
//
// w_epilogue (bcsr_spmm_nn_*): with W [f, f_out] the kernel also writes
// trans = agg @ W for its rows, from the run's accumulator before it leaves
// the block, the reference's fused aggregate+GEMM (pallas_bcsr.py:285-296,
// 388-404).  That GEMM needs a row's whole f, so the epilogue variant's
// block owns all f <= 128 columns of its 64 rows (one f-slab), stages the
// [64, f] accumulator in shared memory (in the space the tile walk used)
// and streams W in [32, 64] chunks; f32 FFMA, k ascending.  A factored
// plan's scale_dst multiplies the accumulator before both outputs (the
// reference asserts there instead).
//
// Design: one block owns a slab of BR rows of one row-tile run and BF
// feature columns (the walk is tile_run::run_sum, tile_run.cuh, which the
// fused residual probe, fused_hybrid.cu, shares).  It walks the run's tiles, stages the A slab (as f32)
// and the H tile [BK, BF] in shared memory, forms each tile's product
// with FFMA in registers, adds it to the run's sum, and writes its output
// rows once at the end: no atomics and no ordering between blocks.  A run
// with no tiles writes zeros, so the output is fully written whether or not
// the plan covers every row-tile.
//
// Bound on the H100 SXM (3.35 TB/s, 67 TFLOP/s f32 outside the tensor
// cores): the function must read A (T*R*C cells of 1, 2 or 4 bytes; R*C/8
// bytes a 1-bit tile) and H and write the output once (the epilogue adds
// W's reads, trans's writes and 2*n*f*f_out FLOPs); the tile stream as the
// TPU kernel reads it is A + T*C*f*4 bytes.  The dense tile work is
// 2*T*R*C*f FLOPs, which a split-bf16 wgmma redesign could run on the
// tensor cores.  Both sit far below this kernel's time: it runs the dense
// tile product on the FP32 pipes (16 FFMA per 2 shared loads per k step).
//
// What the simple design leaves on the table: the tiles are ~1% full, so
// almost all FFMAs multiply zero cells — compacting each A slab's nonzeros
// (or skipping all-zero k columns) cuts the work by ~100x; split-bf16
// wgmma would use the tensor cores; cp.async/TMA double buffering would
// overlap the loads with the FFMAs; H tiles are re-read once per row slab.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bit_tiles.cuh"
#include "tile_run.cuh"

namespace {

using tile_run::kBK;
using tile_run::kBR;
using tile_run::kThreads;
using tile_run::kTM;
using tile_run::run_sum;
constexpr int kWO = 64;        // W columns per epilogue chunk (4 per thread)
constexpr int kMaxEpiF = 128;  // widest f the epilogue variant holds

template <int BF, class Fmt>
__global__ void __launch_bounds__(kThreads)
bcsr_spmm_kernel(const uint8_t* __restrict__ a,
                 const int32_t* __restrict__ tile_col,
                 const int32_t* __restrict__ run_start,
                 const float* __restrict__ h, float* __restrict__ out,
                 int R, int C, int n, int n_src, int f, int slabs_per_run) {
  constexpr int TN = BF / 16;
  // +4 pad keeps rows 16-byte aligned and the transposing stores free of
  // bank conflicts (32 consecutive rows per warp, one k)
  __shared__ __align__(16) float as[kBK][kBR + 4];
  __shared__ __align__(16) float hs[kBK][BF];

  const int run = blockIdx.x / slabs_per_run;
  const int r0 = (blockIdx.x % slabs_per_run) * kBR;
  const int f0 = blockIdx.y * BF;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[kTM][TN];
  run_sum<BF, Fmt>(a, tile_col, run_start[run], run_start[run + 1], h, R, C, n_src, f, f0, r0, acc, as, hs);

#pragma unroll
  for (int m = 0; m < kTM; ++m) {
    const int r = r0 + ty * kTM + m;
    const int64_t grow = (int64_t)run * R + r;
    if (r >= R || grow >= n) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = f0 + tx * TN + j;
      if (c < f) out[grow * f + c] = acc[m][j];
    }
  }
}

// The w_epilogue variant: one f-slab of BF >= f columns; writes agg (the
// accumulator times scale_dst where given) and trans = agg @ W.
template <int BF, class Fmt>
__global__ void __launch_bounds__(kThreads)
bcsr_spmm_nn_kernel(const uint8_t* __restrict__ a,
                    const int32_t* __restrict__ tile_col,
                    const int32_t* __restrict__ run_start,
                    const float* __restrict__ h, const float* __restrict__ w,
                    const float* __restrict__ scale_dst,
                    float* __restrict__ out, float* __restrict__ trans,
                    int R, int C, int n, int n_src, int f, int f_out, int slabs_per_run) {
  constexpr int TN = BF / 16;
  // the tile walk's buffers and the epilogue's share one array: the
  // [64, BF] accumulator tile plus a [32, 64] chunk of W (41 KB at BF = 128)
  constexpr int kWalk = kBK * (kBR + 4) + kBK * BF;
  constexpr int kEpi = kBR * (BF + 4) + kBK * kWO;
  __shared__ __align__(16) float smem[kWalk > kEpi ? kWalk : kEpi];
  auto as = reinterpret_cast<float (*)[kBR + 4]>(smem);
  auto hs = reinterpret_cast<float (*)[BF]>(smem + kBK * (kBR + 4));

  const int run = blockIdx.x / slabs_per_run;
  const int r0 = (blockIdx.x % slabs_per_run) * kBR;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  float acc[kTM][TN];
  run_sum<BF, Fmt>(a, tile_col, run_start[run], run_start[run + 1], h, R, C, n_src, f, 0, r0, acc, as, hs);

  __syncthreads();  // the walk's buffers are free
  auto accs = reinterpret_cast<float (*)[BF + 4]>(smem);
  auto ws = reinterpret_cast<float (*)[kWO]>(smem + kBR * (BF + 4));
#pragma unroll
  for (int m = 0; m < kTM; ++m) {
    const int r = r0 + ty * kTM + m;
    const int64_t grow = (int64_t)run * R + r;
    const bool valid = r < R && grow < n;
    const float sc = (valid && scale_dst != nullptr) ? scale_dst[grow] : 1.f;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = tx * TN + j;
      const float v = acc[m][j] * sc;
      accs[ty * kTM + m][c] = v;
      if (valid && c < f) out[grow * f + c] = v;
    }
  }
  for (int o0 = 0; o0 < f_out; o0 += kWO) {
    float tr[kTM][4];
#pragma unroll
    for (int m = 0; m < kTM; ++m)
#pragma unroll
      for (int q = 0; q < 4; ++q) tr[m][q] = 0.f;
    for (int k0 = 0; k0 < f; k0 += kBK) {
      __syncthreads();  // accs written; the previous W chunk consumed
      for (int e = tid; e < kBK * kWO; e += kThreads) {
        const int k = e / kWO, o = e % kWO;
        ws[k][o] = (k0 + k < f && o0 + o < f_out) ? w[(int64_t)(k0 + k) * f_out + o0 + o] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < kBK; ++k) {
        const float4 w4 = *reinterpret_cast<const float4*>(&ws[k][tx * 4]);
#pragma unroll
        for (int m = 0; m < kTM; ++m) {
          const float av = accs[ty * kTM + m][k0 + k];
          tr[m][0] = fmaf(av, w4.x, tr[m][0]);
          tr[m][1] = fmaf(av, w4.y, tr[m][1]);
          tr[m][2] = fmaf(av, w4.z, tr[m][2]);
          tr[m][3] = fmaf(av, w4.w, tr[m][3]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < kTM; ++m) {
      const int r = r0 + ty * kTM + m;
      const int64_t grow = (int64_t)run * R + r;
      if (r >= R || grow >= n) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int o = o0 + tx * 4 + q;
        if (o < f_out) trans[grow * f_out + o] = tr[m][q];
      }
    }
  }
}

template <class Fmt>
int launch(const void* a, const void* tile_col, const void* run_start, const void* h, void* out,
           int num_row_tiles, int R, int C, int n, int n_src, int f, int device, void* stream) {
  if (num_row_tiles == 0 || f == 0) return 0;
  // this library carries its own (static) CUDA runtime: select the caller's
  // card in it before launching on the caller's stream
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int slabs = (R + kBR - 1) / kBR;
  const dim3 block(kThreads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* a8 = static_cast<const uint8_t*>(a);
  const int32_t* col = static_cast<const int32_t*>(tile_col);
  const int32_t* rs = static_cast<const int32_t*>(run_start);
  const float* hf = static_cast<const float*>(h);
  float* o = static_cast<float*>(out);
  if (f <= 32) {
    const dim3 grid(num_row_tiles * slabs, 1);
    bcsr_spmm_kernel<32, Fmt><<<grid, block, 0, s>>>(a8, col, rs, hf, o, R, C, n, n_src, f, slabs);
  } else {
    const dim3 grid(num_row_tiles * slabs, (f + 63) / 64);
    bcsr_spmm_kernel<64, Fmt><<<grid, block, 0, s>>>(a8, col, rs, hf, o, R, C, n, n_src, f, slabs);
  }
  return static_cast<int>(cudaGetLastError());
}

template <class Fmt>
int launch_nn(const void* a, const void* tile_col, const void* run_start, const void* h, const void* w,
              const void* scale_dst, void* out, void* trans, int num_row_tiles, int R, int C, int n, int n_src,
              int f, int f_out, int device, void* stream) {
  if (f > kMaxEpiF) return static_cast<int>(cudaErrorInvalidValue);
  if (num_row_tiles == 0 || f == 0 || f_out == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int slabs = (R + kBR - 1) / kBR;
  const dim3 grid(num_row_tiles * slabs), block(kThreads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* a8 = static_cast<const uint8_t*>(a);
  const int32_t* col = static_cast<const int32_t*>(tile_col);
  const int32_t* rs = static_cast<const int32_t*>(run_start);
  const float* hf = static_cast<const float*>(h);
  const float* wf = static_cast<const float*>(w);
  const float* sd = static_cast<const float*>(scale_dst);
  float* o = static_cast<float*>(out);
  float* t = static_cast<float*>(trans);
  if (f <= 32)
    bcsr_spmm_nn_kernel<32, Fmt><<<grid, block, 0, s>>>(a8, col, rs, hf, wf, sd, o, t, R, C, n, n_src, f, f_out, slabs);
  else if (f <= 64)
    bcsr_spmm_nn_kernel<64, Fmt><<<grid, block, 0, s>>>(a8, col, rs, hf, wf, sd, o, t, R, C, n, n_src, f, f_out, slabs);
  else
    bcsr_spmm_nn_kernel<128, Fmt><<<grid, block, 0, s>>>(a8, col, rs, hf, wf, sd, o, t, R, C, n, n_src, f, f_out, slabs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define BCSR_SPMM_ENTRY(tag, Fmt, check)                                                                  \
  extern "C" int bcsr_spmm_##tag##_f32(const void* a, const void* tile_col, const void* run_start,      \
                                       const void* h, void* out, int num_row_tiles, int R, int C, int n, \
                                       int n_src, int f, int device, void* stream) {                     \
    if (check) return static_cast<int>(cudaErrorInvalidValue);                                           \
    return launch<Fmt>(a, tile_col, run_start, h, out, num_row_tiles, R, C, n, n_src, f, device, stream); \
  }                                                                                                      \
  extern "C" int bcsr_spmm_nn_##tag##_f32(const void* a, const void* tile_col, const void* run_start,   \
                                          const void* h, const void* w, const void* scale_dst, void* out, \
                                          void* trans, int num_row_tiles, int R, int C, int n, int n_src, \
                                          int f, int f_out, int device, void* stream) {                  \
    if (check) return static_cast<int>(cudaErrorInvalidValue);                                           \
    return launch_nn<Fmt>(a, tile_col, run_start, h, w, scale_dst, out, trans, num_row_tiles, R, C, n,    \
                          n_src, f, f_out, device, stream);                                              \
  }

// 1-bit tiles need R % 8 == 0
BCSR_SPMM_ENTRY(i8, CountTiles, false)
BCSR_SPMM_ENTRY(b1, BitTiles, R % 8)
BCSR_SPMM_ENTRY(f32, F32Tiles, false)
BCSR_SPMM_ENTRY(bf16, Bf16Tiles, false)
