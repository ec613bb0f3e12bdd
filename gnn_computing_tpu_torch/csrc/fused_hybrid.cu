// The fused hybrid pass (P2): the dense tile product and the residual task
// sums from one grid, hand-written for Hopper.
//
// Replaces probes/overlap_dma_residual.py: fused_hybrid, the TPU probe that
// issues the residual gather's row DMAs from inside the tile kernel so they
// fly while the MXU works on the dense tiles.  What it computes:
//   dense_out = scale_dst o (A_tiles @ x),   x = the tile operand (h after
//               the h_mode rounding, times scale_src), as B1;
//   task_sums[t, :] = sum_b val[t, b] * h[src[t, b], :] of the raw h, as P1.
// The caller adds the task sums into their destination rows.  Count tiles
// (int8) and bfloat16 / float32 value tiles are taken; the TPU probe casts
// its tiles to the bf16 operand's type, which rounds a float32 value, while
// this kernel reads a float32 value as it is (counts agree either way).
// A 1-bit plan is refused (the TPU probe cannot take one either).
//
// Design: one grid over B1's cell walk (csrc/cell_walk.cuh) and P1's task
// rows (csrc/task_sums.cuh).  Each f-slice of the grid holds the walk's
// blocks (chunk x row block of the plan's work list, ops/cell_walk.py) and
// the residual blocks, 8 tasks each (a warp a task, over every feature, so
// only the first f-slice's residual blocks have work).  The walk's blocks
// run walk_block with ScaledSumCells: B1's SumCells with scale_dst as the
// row post-scale, so a run of one chunk writes its scaled rows at once, and
// the walk's finish pass, launched right after by the same call, adds a
// longer run's chunk partials in chunk order and scales them.  dense_out is
// therefore bitwise B1's output times scale_dst, and the task sums bitwise
// P1's.  The residual blocks come after the walk's blocks, the TPU probe's
// order (spread evenly among them they were no faster: PERF.md).
//
// Bound on the H100 SXM (3.35 TB/s): B1's bytes (A, x read, dense_out
// written) plus P1's (each distinct source row the slots gather, read
// once, the indices and values, the task sums written); the FLOPs of both
// (2 nnz f and 2 slots f) lie far below 67 TFLOP/s.  What sets its time is
// B1's walk (cell_walk.cuh); the residual blocks add about P1's own time,
// its gather through L2: one grid hides little of it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bit_tiles.cuh"
#include "cell_walk.cuh"
#include "task_sums.cuh"

namespace {

using cell_walk::Args;
using cell_walk::Work;
static_assert(cell_walk::kThreads == 32 * task_sums::kWarps, "a residual block is a walk block's warps");

// B1's policy with row i post-scaled by rows[i] (scale_dst) when given
struct ScaledSumCells : cell_walk::SumCells {
  static __device__ __forceinline__ void post(const float* rows, int64_t i, float* us) {
    us[0] = rows != nullptr ? rows[i] : 1.f;
  }
};

// The residual half of a launch.
struct Residual {
  const float* h;      // [n_src, f] raw h
  const int64_t* src;  // [nt * B]
  const float* val;    // [nt * B]
  float* ts;           // [nt, f]
  int64_t nt;
  int B;
  bool vec;            // task_sums.cuh: 16-byte row reads
};

template <int KPL, class Fmt>
__global__ void __launch_bounds__(cell_walk::kThreads)
fused_hybrid_kernel(const Args p, const Work wk, int slabs, const Residual r, unsigned walk_blocks) {
  // blocks [0, walk_blocks) walk, the rest take 8 tasks each
  if (blockIdx.x < walk_blocks) {
    cell_walk::walk_block<KPL, Fmt, ScaledSumCells>(p, wk, slabs, blockIdx.x, blockIdx.y);
    return;
  }
  if (blockIdx.y != 0) return;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t t = static_cast<int64_t>(blockIdx.x - walk_blocks) * task_sums::kWarps + warp;
  if (t < r.nt) task_sums::task_row(r.h, r.src, r.val, r.ts, t, r.B, p.f, 0, p.f, lane, r.vec);
}

template <class Fmt>
int launch(const void* a, const void* tile_col, const void* work, const void* x, const void* scale_dst, void* out,
           void* scratch, const void* h, const void* src, const void* val, void* ts, int num_chunks, int num_multi,
           int num_row_tiles, int R, int C, int n, int n_src, int f, long long nt, int B, int device, void* stream) {
  if (f == 0) return 0;
  // this library carries its own (static) CUDA runtime: select the caller's
  // card in it before launching on the caller's stream
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  Args p{};
  p.a = static_cast<const uint8_t*>(a);
  p.tile_col = static_cast<const int32_t*>(tile_col);
  p.h0 = static_cast<const float*>(x);
  p.rows = static_cast<const float*>(scale_dst);
  p.num = static_cast<float*>(out);
  p.scratch = static_cast<float*>(scratch);
  p.R = R;
  p.C = C;
  p.n = n;
  p.n_src = n_src;
  p.f = f;
  const Work wk(static_cast<const int32_t*>(work), num_chunks, num_multi, num_row_tiles);
  const Residual r{static_cast<const float*>(h), static_cast<const int64_t*>(src), static_cast<const float*>(val),
                   static_cast<float*>(ts), nt, B,
                   f % 4 == 0 && reinterpret_cast<uintptr_t>(h) % 16 == 0 && reinterpret_cast<uintptr_t>(ts) % 16 == 0};
  const int slabs = cell_walk::num_slabs<Fmt>(R);
  const long long walk_blocks = n == 0 ? 0 : static_cast<long long>(num_chunks) * slabs;
  const long long res_blocks = (nt + task_sums::kWarps - 1) / task_sums::kWarps;
  if (walk_blocks + res_blocks == 0) return 0;
  if (walk_blocks + res_blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int kpl = cell_walk::lane_features(p);
  const dim3 grid(static_cast<unsigned>(walk_blocks + res_blocks), cell_walk::f_slices(f, kpl));
  const dim3 block(cell_walk::kThreads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned wb = static_cast<unsigned>(walk_blocks);
  if (kpl == 1)
    fused_hybrid_kernel<1, Fmt><<<grid, block, 0, s>>>(p, wk, slabs, r, wb);
  else if (kpl == 2)
    fused_hybrid_kernel<2, Fmt><<<grid, block, 0, s>>>(p, wk, slabs, r, wb);
  else
    fused_hybrid_kernel<4, Fmt><<<grid, block, 0, s>>>(p, wk, slabs, r, wb);
  const int err = static_cast<int>(cudaGetLastError());
  return err != 0 || walk_blocks == 0 ? err : cell_walk::launch_finish<ScaledSumCells>(p, wk, s);
}

}  // namespace

// work: the plan's work list (ops/cell_walk.py), num_chunks / num_multi its
// sizes; scratch: its chunk partials (null when no run has two chunks)
#define FUSED_HYBRID_ENTRY(tag, Fmt)                                                                           \
  extern "C" int fused_hybrid_##tag##_f32(                                                                     \
      const void* a, const void* tile_col, const void* work, const void* x, const void* scale_dst, void* out,  \
      void* scratch, const void* h, const void* src, const void* val, void* ts, int num_chunks, int num_multi, \
      int num_row_tiles, int R, int C, int n, int n_src, int f, long long nt, int B, int device,               \
      void* stream) {                                                                                          \
    return launch<Fmt>(a, tile_col, work, x, scale_dst, out, scratch, h, src, val, ts, num_chunks, num_multi,  \
                       num_row_tiles, R, C, n, n_src, f, nt, B, device, stream);                               \
  }

FUSED_HYBRID_ENTRY(i8, CountTiles)
FUSED_HYBRID_ENTRY(f32, F32Tiles)
FUSED_HYBRID_ENTRY(bf16, Bf16Tiles)
