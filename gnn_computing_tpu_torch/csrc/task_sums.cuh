// One residual task's weighted row sum, the per-warp device code of the
// task-sum kernels (csrc/task_sums.cu, P1, and the residual blocks of
// csrc/fused_hybrid.cu, P2).
//
// task_row: the 32 lanes of a warp compute out[t, f0:f1] = sum over the
// task's B slots b of val[t*B + b] * h[src[t*B + b], f0:f1], the slots in
// order, one FFMA a slot and feature.  Every lane reads the slot's source
// and value (one broadcast load each), then its features of the source row:
// with vec (f, f0 and the base of h 16-byte aligned) 4 consecutive floats
// a lane, a warp covering 128 features with one 512-byte coalesced row
// read a slot, else 1 float a lane (128 bytes a warp).  Pad slots hold
// value 0 and source 0 and are summed like any other, as the plain version
// sums them.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace task_sums {

constexpr int kWarps = 8;  // tasks a 256-thread block takes at once

__device__ __forceinline__ void task_row(const float* __restrict__ h, const int64_t* __restrict__ src,
                                         const float* __restrict__ val, float* __restrict__ out, int64_t t,
                                         int B, int f, int f0, int f1, int lane, bool vec) {
  const int64_t s0 = t * B;
  if (vec) {
    for (int c = f0 + 4 * lane; c < f1; c += 128) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int b = 0; b < B; ++b) {
        const float v = val[s0 + b];
        const float4 x = *reinterpret_cast<const float4*>(h + src[s0 + b] * f + c);
        acc.x = fmaf(v, x.x, acc.x);
        acc.y = fmaf(v, x.y, acc.y);
        acc.z = fmaf(v, x.z, acc.z);
        acc.w = fmaf(v, x.w, acc.w);
      }
      *reinterpret_cast<float4*>(out + t * f + c) = acc;
    }
  } else {
    for (int c = f0 + lane; c < f1; c += 32) {
      float acc = 0.f;
      for (int b = 0; b < B; ++b) acc = fmaf(val[s0 + b], h[src[s0 + b] * f + c], acc);
      out[t * f + c] = acc;
    }
  }
}

}  // namespace task_sums
