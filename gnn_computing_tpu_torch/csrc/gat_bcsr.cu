// GAT attention aggregation over dense tiles (B2), hand-written for Hopper.
//
// Replaces the TPU kernel gnn_computing_tpu/ops/pallas_bcsr.py:
// gat_bcsr_pallas in mode 'maxdot' (int8, 1-bit, float32 and bfloat16 tile
// formats, dot_mode 'exact' and 'split2'; both are computed here in
// float32, see below).  The A format is a template argument
// (bit_tiles.cuh), as in B1: a scoring thread finds its row's bytes at
// Fmt::row_offset and reads 8 cells' values (counts, or float values) with
// tile_fmt::load8_tail, one load for all four formats.  A 64-row slab of a 1-bit
// tile with R = 256 spans two bit planes, so the shift comes from each
// thread's own row.
//
// What it computes: tiles are sorted by destination row-tile; the tiles of
// row-tile r are run_start[r] .. run_start[r+1].  For every destination
// row i and tile column j of the run's tiles, with v_ij the cell's value
// (its edge count, or a float tile's summed edge values, any sign),
//   z_ij  = ad_i + as_j
//   s_ij  = v_ij != 0 ? v_ij * exp(max(z_ij, slope*z_ij) - M_i) : 0
//   num_i = sum_j s_ij * h_j          den_i = sum_j s_ij
// with dm_i = (ad_i, M_i) (M the softmax row shift, 0 unstabilized) and
// as_j the src half of att: exp(leaky_relu(z) - M), the edge's attention
// score.  With the exact or the bound shift every |s_ij| <= |v_ij|.
//
// Numerics: a count is an exact integer (<= 127; 0 or 1 in a 1-bit tile),
// a float cell its float32 value (a bfloat16 widens exactly, and neither
// passes through an integer), and the score is one __expf (the MUFU ex2
// unit: relative error ~2^-21 plus |x| * 2^-24 for the argument x <= 0 of a
// shifted score, results below float32's normal range flushed to 0) of a
// float32 argument; num and den are float32 sums.  That meets the TPU's
// 'split2' dot (score and h rounded to ~16 mantissa bits, error ~2^-16) and
// its 'exact' f32 dot alike.  Two traps, both designed around:
//   - select, never multiply, on v == 0: in the unstabilized form the
//     score of a non-edge can overflow to inf, and 0 * inf = NaN;
//   - the score is formed from ad, as and M, never from per-node factors.
//     The TPU kernel multiplies u1_i = exp(ad_i - M_i) by v1_j = exp(as_j),
//     and v1_j is inf once as_j > ~88.7 whatever the shift; its q = u2/u1
//     is NaN once u1 underflows under a loose shift.
//
// Design (the shape of B1, csrc/bcsr_spmm.cu): one block owns a slab of BR
// rows of one row-tile run and BF feature columns.  It walks the run's tiles;
// per staged [BR, BK] piece each thread scores 8 cells of one row into shared
// memory (8 cells in one load: 8 count bytes, 16 bytes of bfloat16 or 32 of
// float32; dm of its row in registers, as read and one __expf taken only
// for nonzero cells), the block stages the H tile [BK, BF], and FFMAs form the tile's
// product in registers.  Each tile's partial (num and the thread's den slice)
// is added to the run's sum when the tile is done: a single float32 sum over
// a hub run of ~10^5 columns drifts ~1e-5.  Outputs are written once at the
// end, with no atomics; an empty run writes zeros.  The f-slice with
// blockIdx.y == 0 writes den.
//
// Bound on the H100 SXM (3.35 TB/s, 67 TFLOP/s float32 outside the tensor
// cores): the function reads A (T*R*C bytes), h (n_src*f*4), dm and as
// (12 bytes a node) and writes num and den (n*(f+1)*4), against 2*nnz*(f+1)
// FLOPs for the nnz nonzero cells.  At the quick scale (4,024 tiles of
// [512, 256], f = 128) that is about 0.18 ms, bytes-bound.  A 1-bit part
// reads R/8*C A bytes a tile, a bfloat16 or float32 tile 2 or 4 bytes a
// cell.
//
// What the simple design leaves on the table: the tiles are ~1% full, so
// almost all FFMAs multiply zero scores (compacting each slab's nonzeros
// would cut the work ~100x); the longest run is ~7x the mean, so a few
// blocks finish last; the tensor cores are unused; the H loads are not
// overlapped with the FFMAs; f > 64 recomputes the scores per f-slice.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bit_tiles.cuh"

namespace {

constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kBR = 64;        // destination rows per block (4 per thread)
constexpr int kBK = 32;        // tile columns staged per step
constexpr int kTM = 4;
constexpr int kStagers = kThreads / kBR;  // threads scoring one row's piece

template <int BF, class Fmt>
__global__ void __launch_bounds__(kThreads)
gat_bcsr_kernel(const uint8_t* __restrict__ a,
                const int32_t* __restrict__ tile_col,
                const int32_t* __restrict__ run_start,
                const float* __restrict__ h,
                const float2* __restrict__ dm,
                const float* __restrict__ asrc,
                float* __restrict__ num, float* __restrict__ den,
                int R, int C, int n, int n_src, int f, float slope, int slabs_per_run) {
  constexpr int TN = BF / 16;
  // +4 pad keeps rows 16-byte aligned and the transposing stores free of
  // bank conflicts (32 consecutive rows per warp, one k)
  __shared__ __align__(16) float ss[kBK][kBR + 4];
  __shared__ __align__(16) float hs[kBK][BF];
  __shared__ float dsum[kStagers][kBR];

  const int run = blockIdx.x / slabs_per_run;
  const int r0 = (blockIdx.x % slabs_per_run) * kBR;
  const int f0 = blockIdx.y * BF;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  // scoring: thread scores 8 consecutive columns of one slab row
  const int ai = tid % kBR, aj = (tid / kBR) * 8;
  const bool vec_a = (C % 8) == 0;
  const int srow = r0 + ai;
  const int64_t sgrow = (int64_t)run * R + srow;
  const float2 u = (srow < R && sgrow < n) ? dm[sgrow] : make_float2(0.f, 0.f);
  int shift = 0;
  const int64_t row_off = srow < R ? Fmt::row_offset(srow, R, C, &shift) : 0;

  float acc[kTM][TN];
#pragma unroll
  for (int m = 0; m < kTM; ++m)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[m][j] = 0.f;
  float den_acc = 0.f;

  const int t_end = run_start[run + 1];
  for (int t = run_start[run]; t < t_end; ++t) {
    const uint8_t* arow = a + t * Fmt::tile_bytes(R, C) + row_off;
    const int64_t col0 = (int64_t)tile_col[t] * C;
    float part[kTM][TN];
#pragma unroll
    for (int m = 0; m < kTM; ++m)
#pragma unroll
      for (int j = 0; j < TN; ++j) part[m][j] = 0.f;
    float den_part = 0.f;
    for (int k0 = 0; k0 < C; k0 += kBK) {
      const int kk = k0 + aj;
      // the cells' values (counts widened exactly; a float never passes
      // through an integer), 0 past the row or the tile
      float val[8];
      if (srow < R) {
        tile_fmt::load8_tail<Fmt>(arow, kk, C, vec_a, shift, val);
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q) val[q] = 0.f;
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int64_t src = col0 + kk + q;
        float s = 0.f;
        if (val[q] != 0.f && src < n_src) {
          const float z = u.x + asrc[src];
          s = val[q] * __expf(fmaxf(z, slope * z) - u.y);
        }
        ss[aj + q][ai] = s;
        den_part += s;
      }
      for (int e = tid; e < kBK * BF; e += kThreads) {
        const int k = e / BF, c = e % BF;
        const int64_t src = col0 + k0 + k;
        hs[k][c] = (k0 + k < C && src < n_src && f0 + c < f) ? h[src * f + f0 + c] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kBK; ++k) {
        const float4 s4 = *reinterpret_cast<const float4*>(&ss[k][ty * kTM]);
        const float sv[kTM] = {s4.x, s4.y, s4.z, s4.w};
        float hv[TN];
        if constexpr (TN == 4) {
          const float4 h4 = *reinterpret_cast<const float4*>(&hs[k][tx * TN]);
          hv[0] = h4.x; hv[1] = h4.y; hv[2] = h4.z; hv[3] = h4.w;
        } else {
          const float2 h2 = *reinterpret_cast<const float2*>(&hs[k][tx * TN]);
          hv[0] = h2.x; hv[1] = h2.y;
        }
#pragma unroll
        for (int m = 0; m < kTM; ++m)
#pragma unroll
          for (int j = 0; j < TN; ++j) part[m][j] = fmaf(sv[m], hv[j], part[m][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int m = 0; m < kTM; ++m)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[m][j] += part[m][j];
    den_acc += den_part;
  }

  // each row's den is spread over its kStagers scoring threads
  dsum[tid / kBR][ai] = den_acc;
  __syncthreads();
  if (blockIdx.y == 0 && tid < kBR) {
    const int r = r0 + tid;
    const int64_t grow = (int64_t)run * R + r;
    if (r < R && grow < n) {
      float d = 0.f;
#pragma unroll
      for (int q = 0; q < kStagers; ++q) d += dsum[q][tid];
      den[grow] = d;
    }
  }

#pragma unroll
  for (int m = 0; m < kTM; ++m) {
    const int r = r0 + ty * kTM + m;
    const int64_t grow = (int64_t)run * R + r;
    if (r >= R || grow >= n) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = f0 + tx * TN + j;
      if (c < f) num[grow * f + c] = acc[m][j];
    }
  }
}

template <class Fmt>
int launch(const void* a, const void* tile_col, const void* run_start, const void* h, const void* dm,
           const void* asrc, void* num, void* den, int num_row_tiles, int R, int C, int n, int n_src, int f,
           float slope, int device, void* stream) {
  if (num_row_tiles == 0 || n == 0) return 0;
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
  const float2* u = static_cast<const float2*>(dm);
  const float* v = static_cast<const float*>(asrc);
  float* o = static_cast<float*>(num);
  float* d = static_cast<float*>(den);
  // at least one f-slice, so den is written even for f == 0
  if (f <= 32) {
    const dim3 grid(num_row_tiles * slabs, 1);
    gat_bcsr_kernel<32, Fmt><<<grid, block, 0, s>>>(a8, col, rs, hf, u, v, o, d, R, C, n, n_src, f, slope, slabs);
  } else {
    const dim3 grid(num_row_tiles * slabs, (f + 63) / 64);
    gat_bcsr_kernel<64, Fmt><<<grid, block, 0, s>>>(a8, col, rs, hf, u, v, o, d, R, C, n, n_src, f, slope, slabs);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int gat_bcsr_i8_f32(const void* a, const void* tile_col, const void* run_start, const void* h,
                               const void* dm, const void* asrc, void* num, void* den, int num_row_tiles,
                               int R, int C, int n, int n_src, int f, float slope, int device, void* stream) {
  return launch<CountTiles>(a, tile_col, run_start, h, dm, asrc, num, den, num_row_tiles, R, C, n, n_src, f,
                            slope, device, stream);
}

extern "C" int gat_bcsr_b1_f32(const void* a, const void* tile_col, const void* run_start, const void* h,
                               const void* dm, const void* asrc, void* num, void* den, int num_row_tiles,
                               int R, int C, int n, int n_src, int f, float slope, int device, void* stream) {
  if (R % 8) return static_cast<int>(cudaErrorInvalidValue);
  return launch<BitTiles>(a, tile_col, run_start, h, dm, asrc, num, den, num_row_tiles, R, C, n, n_src, f,
                          slope, device, stream);
}

extern "C" int gat_bcsr_f32_f32(const void* a, const void* tile_col, const void* run_start, const void* h,
                                const void* dm, const void* asrc, void* num, void* den, int num_row_tiles,
                                int R, int C, int n, int n_src, int f, float slope, int device, void* stream) {
  return launch<F32Tiles>(a, tile_col, run_start, h, dm, asrc, num, den, num_row_tiles, R, C, n, n_src, f,
                          slope, device, stream);
}

extern "C" int gat_bcsr_bf16_f32(const void* a, const void* tile_col, const void* run_start, const void* h,
                                 const void* dm, const void* asrc, void* num, void* den, int num_row_tiles,
                                 int R, int C, int n, int n_src, int f, float slope, int device, void* stream) {
  return launch<Bf16Tiles>(a, tile_col, run_start, h, dm, asrc, num, den, num_row_tiles, R, C, n, n_src, f,
                           slope, device, stream);
}
