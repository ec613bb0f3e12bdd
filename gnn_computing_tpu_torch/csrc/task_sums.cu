// Residual task sums (P1), hand-written for Hopper.
//
// Replaces probes/overlap_dma_residual.py: dma_task_sums, the TPU probe
// that gathers the residual plan's source rows with per-row DMAs into VMEM
// and sums them per task.  What it computes:
//   task_sums[t, :] = sum_b val[t, b] * h[src[t, b], :]   (t < nt_p, b < B)
// over the plan's own flat layout (src int64 and val float32 [nt_p * B],
// schedule/plan.py); the TPU probe's step padding of the task axis is not
// carried over.  Its plain version is ops/spmm.py: weighted_task_sums.
//
// Design: a warp a task (task_sums.cuh: task_row), 8 tasks a 256-thread
// block.  The gather is the whole cost: B random rows of f floats a task,
// each read as one coalesced row segment (512 bytes a warp at f = 128);
// the sums are FFMAs in registers and each task's row is written once.  No
// shared memory, no atomics (the destination sum of the tasks is the
// caller's: P1 stays off the main path, where the hybrid op's residual is
// R1, csrc/residual_spmm.cu, which also sums each destination's tasks in
// registers and adds them into the tile output once).
//
// Bound on the H100 SXM (3.35 TB/s; the FLOPs, 2*slots*f, are far below
// 67 TFLOP/s): each distinct source row that the slots gather read once,
// distinct*f*4 bytes (a row that many slots gather need not leave the
// 50 MB L2; the gather itself moves slots*f*4 bytes through it; pad slots
// read row 0), the indices and values (8 bytes a slot with int32 indices;
// this kernel reads the plan's int64 ones, 12), and the task sums written,
// nt_p*f*4.  At the probe's --small plan (65,536 nodes, 280,192 slots, f =
// 128) the distinct rows are fewer than the nodes: chip_smoke.py phase 36
// prints their count and the bound.

#include <cuda_runtime.h>
#include <stdint.h>

#include "task_sums.cuh"

namespace {

__global__ void __launch_bounds__(32 * task_sums::kWarps)
task_sums_kernel(const float* __restrict__ h, const int64_t* __restrict__ src, const float* __restrict__ val,
                 float* __restrict__ out, int64_t nt, int B, int f, bool vec) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t t = (int64_t)blockIdx.x * task_sums::kWarps + warp;
  if (t < nt) task_sums::task_row(h, src, val, out, t, B, f, 0, f, lane, vec);
}

}  // namespace

extern "C" int task_sums_f32(const void* h, const void* src, const void* val, void* out, long long nt, int B,
                             int f, int device, void* stream) {
  if (nt == 0 || f == 0) return 0;
  // this library carries its own (static) CUDA runtime: select the caller's
  // card in it before launching on the caller's stream
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const bool vec = f % 4 == 0 && reinterpret_cast<uintptr_t>(h) % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long blocks = (nt + task_sums::kWarps - 1) / task_sums::kWarps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  task_sums_kernel<<<static_cast<unsigned>(blocks), 32 * task_sums::kWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(h), static_cast<const int64_t*>(src), static_cast<const float*>(val),
      static_cast<float*>(out), nt, B, f, vec);
  return static_cast<int>(cudaGetLastError());
}
