// Block-sparse SpMM over dense tiles (B1), hand-written for Hopper.
//
// Replaces the TPU kernel gnn_computing_tpu/ops/pallas_bcsr.py:
// bcsr_spmm_pallas (int8 count, 1-bit, float32 and bfloat16 tile formats,
// f32 operand after the h_mode rounding; optional w_epilogue).  The A
// format is a template argument (bit_tiles.cuh): int8 counts, 1-bit tiles
// whose row i lies in bit plane i / (R/8) of byte row i % (R/8) (8x fewer
// A bytes), or float32 / bfloat16 edge values (4x / 2x the int8 bytes).
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
// Design: the cell walk (csrc/cell_walk.cuh, shared with B2), with its
// StagedSumCells as the cell policy: a nonzero cell's weight is its value,
// no den, no post-scale.  Only the nonzero cells are touched (a warp
// compacts each tile row's cells and gathers one H row slice per cell), and
// a run's tiles are cut into chunks bounded in nonzero cells (the plan's
// work list, ops/cell_walk.py), so the hub run is spread over many blocks;
// each tile's partial joins its chunk's sum, and a run's chunk partials
// are added in chunk order by the walk's finish pass.  No atomics.  Over
// int8 tiles the list's dense chunks take the staged walk (cell_walk.cuh):
// each live tile's H column block is loaded into shared memory once, for
// all the rows of a 256-row block, in place of one gather a cell, and its
// cells come from the plan's list in place of each launch's decode; the
// sums and their order are the same, so the output is bitwise the same.
//
// w_epilogue (bcsr_spmm_nn_*): with W [f, f_out] the launch also writes
// trans = agg @ W, the reference's fused aggregate+GEMM (pallas_bcsr.py:
// 285-296, 388-404).  Its pass (epilogue_kernel) replaces the walk's finish
// pass and runs over every run: a block owns 64 rows of one run and all
// f <= 128 columns, finishes each row (the run's chunk partials added in
// chunk order, or the row the walk wrote), applies a factored plan's
// scale_dst (the reference asserts there instead), writes agg, and forms
// agg @ W from the finished rows in shared memory, W streamed in [32, 64]
// chunks; f32 FFMA, k ascending.
//
// Bound on the H100 SXM (3.35 TB/s, 67 TFLOP/s f32 outside the tensor
// cores): the function must read A (T*R*C cells of 1, 2 or 4 bytes; R*C/8
// bytes a 1-bit tile) and H and write the output once (the epilogue adds
// W's reads, trans's writes and 2*n*f*f_out FLOPs), against 2*nnz*f FLOPs
// for the nnz nonzero cells: bytes bind.  The walk reads the A stream once
// and gathers one H row slice (f*4 bytes) per nonzero cell, from L2 where
// H fits it (33.5 MB at the quick scale, f = 128): at the quick GCN plan
// (3,562 int8 [512, 256] tiles, 3.30M cells) 467 MB of A and 1.69 GB of
// gathers.  What it leaves on the table is the walk's (cell_walk.cuh).

#include <cuda_runtime.h>
#include <stdint.h>

#include "bit_tiles.cuh"
#include "cell_walk.cuh"

namespace {

using cell_walk::Args;
using cell_walk::StagedSumCells;
using cell_walk::Work;

constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kBR = 64;        // rows per epilogue block (4 per thread)
constexpr int kTM = 4;
constexpr int kBK = 32;        // W rows per staged chunk
constexpr int kWO = 64;        // W columns per chunk (4 per thread)
constexpr int kMaxEpiF = 128;  // widest f the epilogue holds

template <int BF>
__global__ void __launch_bounds__(kThreads)
epilogue_kernel(const Args p, const Work wk, const float* __restrict__ w, const float* __restrict__ scale_dst,
                float* __restrict__ trans, int f_out, int slabs_per_run) {
  constexpr int TN = BF / 16;
  __shared__ __align__(16) float accs[kBR][BF + 4];
  __shared__ __align__(16) float ws[kBK][kWO];
  const int run = blockIdx.x / slabs_per_run;
  const int r0 = (blockIdx.x % slabs_per_run) * kBR;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int f = p.f;
  const int kb = wk.run_chunk[run];
  const int nk = wk.run_chunk[run + 1] - kb;
  const int64_t stride = cell_walk::slot_floats<StagedSumCells>(p.R, f);
  const float* s0 = nk > 1 ? p.scratch + wk.chunk_slot[kb] * stride : nullptr;
#pragma unroll
  for (int m = 0; m < kTM; ++m) {
    const int r = r0 + ty * kTM + m;
    const int64_t grow = static_cast<int64_t>(run) * p.R + r;
    const bool valid = r < p.R && grow < p.n;
    const float sc = (valid && scale_dst != nullptr) ? scale_dst[grow] : 1.f;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = tx * TN + j;
      float v = 0.f;
      if (valid && c < f) {
        if (s0 != nullptr) {  // the run's chunk partials, in chunk order
          for (int q = 0; q < nk; ++q) v += s0[q * stride + static_cast<int64_t>(r) * f + c];
        } else {  // the row the walk wrote
          v = p.num[grow * f + c];
        }
        v *= sc;
        p.num[grow * f + c] = v;
      }
      accs[ty * kTM + m][c] = v;
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
        ws[k][o] = (k0 + k < f && o0 + o < f_out) ? w[static_cast<int64_t>(k0 + k) * f_out + o0 + o] : 0.f;
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
      const int64_t grow = static_cast<int64_t>(run) * p.R + r;
      if (r >= p.R || grow >= p.n) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int o = o0 + tx * 4 + q;
        if (o < f_out) trans[grow * f_out + o] = tr[m][q];
      }
    }
  }
}

Args make_args(const void* a, const void* tile_col, const void* h, void* out, void* scratch, int R, int C, int n,
               int n_src, int f) {
  Args p{};
  p.a = static_cast<const uint8_t*>(a);
  p.tile_col = static_cast<const int32_t*>(tile_col);
  p.h0 = static_cast<const float*>(h);
  p.num = static_cast<float*>(out);
  p.scratch = static_cast<float*>(scratch);
  p.R = R;
  p.C = C;
  p.n = n;
  p.n_src = n_src;
  p.f = f;
  return p;
}

template <class Fmt>
int launch(const void* a, const void* tile_col, const void* work, const void* h, void* out, void* scratch,
           int num_chunks, int num_multi, int num_staged, int num_stage_tiles, int num_row_tiles, int R, int C, int n,
           int n_src, int f, int device, void* stream) {
  if (f == 0) return 0;
  return cell_walk::launch<Fmt, StagedSumCells>(make_args(a, tile_col, h, out, scratch, R, C, n, n_src, f),
                                                static_cast<const int32_t*>(work), num_chunks, num_multi,
                                                num_row_tiles, device, stream, num_staged, num_stage_tiles);
}

template <class Fmt>
int launch_nn(const void* a, const void* tile_col, const void* work, const void* h, const void* w,
              const void* scale_dst, void* out, void* trans, void* scratch, int num_chunks, int num_multi,
              int num_staged, int num_stage_tiles, int num_row_tiles, int R, int C, int n, int n_src, int f,
              int f_out, int device, void* stream) {
  if (f > kMaxEpiF) return static_cast<int>(cudaErrorInvalidValue);
  if (num_row_tiles == 0 || n == 0 || f == 0 || f_out == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const Args p = make_args(a, tile_col, h, out, scratch, R, C, n, n_src, f);
  const int32_t* list = static_cast<const int32_t*>(work);
  const Work wk(list, num_chunks, num_multi, num_row_tiles);
  const cell_walk::Stage st(list, num_chunks, num_multi, num_row_tiles, num_staged, num_stage_tiles, R);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = cell_walk::launch_walk_staged<Fmt, StagedSumCells>(p, wk, st, s);
  if (err != 0) return err;
  const int slabs = (R + kBR - 1) / kBR;
  const dim3 grid(num_row_tiles * slabs), block(kThreads);
  const float* wf = static_cast<const float*>(w);
  const float* sd = static_cast<const float*>(scale_dst);
  float* t = static_cast<float*>(trans);
  if (f <= 32)
    epilogue_kernel<32><<<grid, block, 0, s>>>(p, wk, wf, sd, t, f_out, slabs);
  else if (f <= 64)
    epilogue_kernel<64><<<grid, block, 0, s>>>(p, wk, wf, sd, t, f_out, slabs);
  else
    epilogue_kernel<128><<<grid, block, 0, s>>>(p, wk, wf, sd, t, f_out, slabs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// work: the plan's work list (ops/cell_walk.py), num_chunks / num_multi /
// num_staged / num_stage_tiles its sizes (K, M, S, L); scratch: its chunk
// partials (null when no run has two chunks)
#define BCSR_SPMM_ENTRY(tag, Fmt, check)                                                                     \
  extern "C" int bcsr_spmm_##tag##_f32(const void* a, const void* tile_col, const void* work, const void* h, \
                                       void* out, void* scratch, int num_chunks, int num_multi,            \
                                       int num_staged, int num_stage_tiles, int num_row_tiles, int R, int C, \
                                       int n, int n_src, int f, int device, void* stream) {                \
    if (check) return static_cast<int>(cudaErrorInvalidValue);                                             \
    return launch<Fmt>(a, tile_col, work, h, out, scratch, num_chunks, num_multi, num_staged,              \
                       num_stage_tiles, num_row_tiles, R, C, n, n_src, f, device, stream);                 \
  }                                                                                                        \
  extern "C" int bcsr_spmm_nn_##tag##_f32(const void* a, const void* tile_col, const void* work,           \
                                          const void* h, const void* w, const void* scale_dst, void* out,   \
                                          void* trans, void* scratch, int num_chunks, int num_multi,       \
                                          int num_staged, int num_stage_tiles, int num_row_tiles, int R,   \
                                          int C, int n, int n_src, int f, int f_out, int device,           \
                                          void* stream) {                                                  \
    if (check) return static_cast<int>(cudaErrorInvalidValue);                                             \
    return launch_nn<Fmt>(a, tile_col, work, h, w, scale_dst, out, trans, scratch, num_chunks, num_multi,   \
                          num_staged, num_stage_tiles, num_row_tiles, R, C, n, n_src, f, f_out, device,    \
                          stream);                                                                         \
  }

// 1-bit tiles need R % 8 == 0
BCSR_SPMM_ENTRY(i8, CountTiles, false)
BCSR_SPMM_ENTRY(b1, BitTiles, R % 8)
BCSR_SPMM_ENTRY(f32, F32Tiles, false)
BCSR_SPMM_ENTRY(bf16, Bf16Tiles, false)
