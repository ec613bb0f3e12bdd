// The cell walk: the device code of B1 (csrc/bcsr_spmm.cu), B2 (its
// three bodies, csrc/gat_bcsr.cu and csrc/gat_bcsr_factored.cu, through
// csrc/gat_walk.cuh), B3 (csrc/gat_bwd_dad.cu) and B4
// (csrc/gat_bwd_dh_das.cu, over the transposed plan), both through
// gat_walk.cuh, and the walk blocks of P2 (csrc/fused_hybrid.cu, B1's
// policy with a row post-scale).  They differ only in how a nonzero cell
// is weighed, which a Cells policy supplies; the walk, the work split and
// the sums are this file's.  B5's max walk (csrc/rowmax_bcsr.cu) shares
// its block layout, its Work list and its look-ahead loads (ring_fill).
//
// What it computes: tiles are sorted by destination row-tile; the tiles of
// row-tile r are run_start[r] .. run_start[r+1].  For every destination
// row i, branch b < Cells::NB and nonzero cell (i, j) of the run's tiles
// (value v != 0; a zero cell is never touched: select, never multiply),
//   num_i = sum_b post_b,i * sum_j stage_w(w_b,ij) * stage_h(H_b,j)
//   den_i = sum_b post_b,i * sum_j d_b,ij                 (Cells::kDen)
// where Cells::weigh gives a cell's weights w and den terms d, stage_w and
// stage_h round the weight and the gathered H_b (h, or a factored mode's
// hv_b) as the mode rounds, and post gives the row post-scales.  Two
// switches of a policy, both off unless it sets them, change that: kSplit
// keeps the branches apart (branch b's post_b,i * sum_j ... goes to num for
// b = 0 and num1 for b = 1; den is branch 0's), and kShared gives every
// branch branch 0's gathered H (one gather a cell, h1 unused).  Both are
// compile-time paths of their own, so a policy without them compiles to the
// code it had.
//
// Why this shape.  The tiles are ~1% full (0.6-0.7% at the quick scale),
// so a dense tile product does ~140x the useful work; and one run (the hub
// row-tile) holds a large share of all cells, so a grid of one block per
// run slab waits on it.  Here the work is the nonzero cells, and the unit of work is
// a chunk (ops/cell_walk.py): a run's tiles cut into consecutive ranges
// bounded in nonzero cells, so the hub run is spread over many blocks.
//
// Design.  A block owns 8 rows of one chunk, one warp a row; for 1-bit
// tiles the 8 rows that share a byte row (one per bit plane), so the block
// reads each A byte once.  The warp walks the chunk's tiles.  Per tile it
// takes its row's cells, 8 a lane, from one 8-, 16- or 32-byte load that
// ran up to 4 tiles ahead in registers (~1 KB of the row in flight a warp,
// Fmt::Raw), with the tile's column.  A tile row without a nonzero cell
// (most of them) costs a vote and nothing more.
// Otherwise the warp compacts the nonzero cells in ascending column order
// (tile_cells::compact_mask) and each lane weighs its own cells once as
// it writes them to the warp's list.  Then it takes the list kG cells at a
// time: the kG rows of H gathered at once in 16-byte loads (KPL features a
// lane, up to 128 a warp; a cell whose staged weight is 0 loads nothing)
// and weight * H added into the lane's registers in column order.  Each
// tile's partial (num, and den summed over the warp) is finished before it
// joins the chunk's sum: a hub run's single float32 sum drifts ~2e-5 *
// max.  A run of one chunk writes its rows directly, post-scaled (an empty
// run's chunk writes zeros); the chunks of a longer run write their
// partials to a scratch slot each, and the finish kernel, launched right
// after, adds a run's slots in chunk order, post-scales and writes each
// row once.  No atomics: two calls give bitwise equal output.  f > 128
// takes 128-wide f-slices (blockIdx.y), each compacting and weighing the
// cells again; the slice 0 writes den.
//
// What bounds it (H100 SXM, 3.35 TB/s): the A stream (every cell of every
// tile is read once, 1, 2 or 4 bytes, or 1 bit) and the gather of one H
// row slice per nonzero cell (f * 4 bytes, from L2 where H fits its 50 MB),
// against 2 * f FLOPs a cell.  What sets its time on the card is neither:
// it is the walk over tile rows (1.82M at the quick GCN plan), each a
// vote, and where it holds cells a ballot scan and a dependent L2 gather
// before the next.  Left on the table: a warp walks one row, ~2 cells a
// tile on average; an index of each tile's nonzero rows, built once per
// plan, would skip the empty rows without reading them.
//
// The staged walk (B1 only: a policy with kStage, over int8 tiles).  In a
// dense tile the gathers repeat: a [256, 256] tile of 4,096 cells gathers
// 4,096 H row slices of its 256 distinct source rows; and every tile row is
// decoded, an empty one too, at each launch.  So the work list marks the
// chunks whose live tiles hold at least STAGE_K * C cells each on average,
// and lists their live tiles' nonzero cells once per plan, row by row in
// column order (ops/cell_walk.py: stage_cells), and B1 walks them with
// stage_kernel: a block of kStageWarps<KPL> warps owns 256 rows of one
// staged chunk, kStageRowsPerWarp<KPL> a warp, and walks the chunk's live
// tiles (its all-zero fillers skipped).  It copies each tile's C source
// rows of H (the block's f-slice) into a shared-memory ring of kUnits units
// with cp.async, kUnitFloats floats a unit, so the next units load while
// this tile's cells are summed; each warp reads its rows' cells from the
// list (a row without one costs two loads) and adds each cell's weight
// times its H row slice from the ring with the same fmaf, in the same
// column order, into the tile's partial, the partial then added to the
// row's sum.  Same chunks, same order: the output is bitwise the gather
// walk's.  The other chunks run walk_block from a second grid over the
// list of them (walk_list_kernel): a grid has one block size and one
// shared-memory size, and the ring's 192 KB would leave the gather blocks
// one block an SM.  For the same reason a launch stages the chunks only
// where their blocks fill the card several times over (ops/cell_walk.py:
// stages); in a wave or two the last one leaves SMs idle.  What bounds
// the staged walk: shared-memory reads, f * 4 bytes a cell (128 B a cycle
// an SM), and the ring's copies, C * f * 4 bytes a tile and row group: at
// the reddit forward plan's int8 part, f = 128, about a third of its time
// on the H100 (PERF.md, B1).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "bit_tiles.cuh"
#include "tile_cells.cuh"

namespace cell_walk {

using tile_cells::kChunk;
constexpr int kWarps = 8;  // rows per block, one warp each
constexpr int kThreads = 32 * kWarps;
constexpr int kFinishThreads = 256;

// Cells policy:
//   NB                          branches (each with its own H and post-scale)
//   kDen                        the walk also sums den terms
//   Row row(rows, i)            node i's row operand
//   weigh(cols, slope, row, v, src, w, d)
//                               a nonzero cell's weights w[b] and den
//                               terms d[b] (both arrive zeroed)
//   float stage_w(w)            a weight as the mode stages it
//   float stage_h(x)            a gathered H value as the mode rounds it
//   post(rows, i, us)           row i's post-scales us[b]
//   kSplit, kShared             optional switches (above), default false
//   kStage                      optional, default false: the launch walks the
//                               plan's staged chunks with stage_kernel (B1)

template <class C, class = void>
struct split_of : std::false_type {};
template <class C>
struct split_of<C, std::void_t<decltype(C::kSplit)>> : std::bool_constant<C::kSplit> {};
template <class C, class = void>
struct shared_of : std::false_type {};
template <class C>
struct shared_of<C, std::void_t<decltype(C::kShared)>> : std::bool_constant<C::kShared> {};
template <class C, class = void>
struct stage_of : std::false_type {};
template <class C>
struct stage_of<C, std::void_t<decltype(C::kStage)>> : std::bool_constant<C::kStage> {};

// B1's policy (csrc/bcsr_spmm.cu; P2's, csrc/fused_hybrid.cu, with a
// post-scale): a cell's weight is its value (a count, or a float tile's
// value)
struct SumCells {
  static constexpr int NB = 1;
  static constexpr bool kDen = false;
  struct Row {};
  static __device__ __forceinline__ Row row(const float* rows, int64_t i) { return Row{}; }
  static __device__ __forceinline__ void weigh(const float* cols, float slope, const Row& u, float v, int64_t src,
                                               float* w, float* d) {
    w[0] = v;
  }
  static __device__ __forceinline__ float stage_w(float w) { return w; }
  static __device__ __forceinline__ float stage_h(float x) { return x; }
  static __device__ __forceinline__ void post(const float* rows, int64_t i, float* us) { us[0] = 1.f; }
};

// B1's own: SumCells with the staged walk (P2 keeps SumCells' gather walk)
struct StagedSumCells : SumCells {
  static constexpr bool kStage = true;
};

// The launch's operands.
struct Args {
  const uint8_t* a;         // tiles (bit_tiles.cuh formats)
  const int32_t* tile_col;  // [T]
  const float* h0;          // [n_src, f] H of branch 0
  const float* h1;          // [n_src, f] H of branch 1 (NB == 2), else unused
  const float* rows;        // row operands (Cells::row), may be null
  const float* cols;        // column operands (Cells::weigh), may be null
  float* num;               // [n, f]
  float* num1;              // [n, f] branch 1's sums (Cells::kSplit), else unused
  float* den;               // [n] (Cells::kDen)
  float* scratch;           // num_slots slots of slot_floats floats, may be null
  int R, C, n, n_src, f;
  float slope;
  bool vec_h;               // a lane's KPL features of an H row are one aligned vector load
};

// The plan's work list (ops/cell_walk.py: CellWalk), one int32 array:
//   chunk_run[K] | chunk_tile[K + 1] | chunk_slot[K] | run_chunk[nrt + 1] | multi_run[M]
// chunk k walks tiles chunk_tile[k] .. chunk_tile[k + 1] of run
// chunk_run[k] and writes its rows directly (chunk_slot[k] < 0: the run's
// only chunk) or to scratch slot chunk_slot[k]; run r's chunks are
// run_chunk[r] .. run_chunk[r + 1] with consecutive slots; multi_run lists
// the runs of more than one chunk.
struct Work {
  const int32_t* chunk_run;
  const int32_t* chunk_tile;
  const int32_t* chunk_slot;
  const int32_t* run_chunk;
  const int32_t* multi_run;
  int num_chunks, num_multi;
  Work(const int32_t* w, int K, int M, int nrt)
      : chunk_run(w), chunk_tile(w + K), chunk_slot(w + 2 * K + 1), run_chunk(w + 3 * K + 1),
        multi_run(w + 3 * K + nrt + 2), num_chunks(K), num_multi(M) {}
};

// B1's part of the work list, after Work's arrays:
//   stage_chunk[S] | stage_start[S + 1] | stage_tile[L] | gather_chunk[K - S] |
//   stage_row[L * R + 1] | stage_cells[N]
// staged chunk s walks the live tiles stage_tile[stage_start[s] ..
// stage_start[s + 1]] of chunk stage_chunk[s]; gather_chunk lists the
// other chunks.  Row i of the l-th staged tile holds the cells
// stage_cells[stage_row[l * R + i] .. stage_row[l * R + i + 1]], in
// ascending column order, each its column | its weight's float32 bits above
// the lower 16 (ops/cell_walk.py: stage_cells).
struct Stage {
  const int32_t* chunk;
  const int32_t* start;
  const int32_t* tile;
  const int32_t* gather;
  const int32_t* row;
  const int32_t* cells;
  int num, num_gather;
  Stage(const int32_t* w, int K, int M, int nrt, int S, int L, int R)
      : chunk(w + 3 * K + nrt + 2 + M), start(chunk + S), tile(start + S + 1), gather(tile + L),
        row(gather + K - S), cells(row + static_cast<int64_t>(L) * R + 1), num(S), num_gather(K - S) {}
};

// Floats of one scratch slot: num [NB][R][f], then den [NB][R], rounded up
// to 4 so every slot starts 16-byte aligned (ops/cell_walk.py: slot_floats).
template <class Cells>
__host__ __device__ __forceinline__ int64_t slot_floats(int R, int f) {
  const int64_t x = static_cast<int64_t>(Cells::NB) * R * (f + (Cells::kDen ? 1 : 0));
  return (x + 3) / 4 * 4;
}

template <class Fmt>
constexpr bool kPlanes = std::is_same<Fmt, BitTiles>::value;

// Blocks a chunk needs, kWarps rows each
template <class Fmt>
__host__ __device__ __forceinline__ int num_slabs(int R) {
  return kPlanes<Fmt> ? R / kWarps : (R + kWarps - 1) / kWarps;
}

// The tile row of warp `warp` in row block `slab`: kWarps consecutive
// rows, or for 1-bit tiles (kWarps divides 8) kWarps rows of one byte row,
// each in its own bit plane
template <class Fmt>
__device__ __forceinline__ int block_row(int slab, int warp, int R) {
  if constexpr (kPlanes<Fmt>) {
    const int r8 = R / 8;
    return slab % r8 + ((slab / r8) * kWarps + warp) * r8;
  } else {
    return slab * kWarps + warp;
  }
}

// x[m] = row[k0 + m] for k0 + m < f, 0 past f or where !on (no load)
template <int KPL>
__device__ __forceinline__ void gather(const float* __restrict__ row, int k0, int f, bool vec, bool on,
                                       float (&x)[KPL]) {
  if (on && vec && k0 + KPL <= f) {
    if constexpr (KPL == 4) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(row + k0));
      x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
    } else if constexpr (KPL == 2) {
      const float2 v = __ldg(reinterpret_cast<const float2*>(row + k0));
      x[0] = v.x; x[1] = v.y;
    } else {
      x[0] = __ldg(row + k0);
    }
  } else {
#pragma unroll
    for (int m = 0; m < KPL; ++m) x[m] = on && k0 + m < f ? __ldg(row + k0 + m) : 0.f;
  }
}

// row[k0 + m] = x[m] for k0 + m < f
template <int KPL>
__device__ __forceinline__ void store(float* __restrict__ row, int k0, int f, const float (&x)[KPL]) {
  if (f % KPL == 0 && k0 + KPL <= f) {
    if constexpr (KPL == 4) {
      *reinterpret_cast<float4*>(row + k0) = make_float4(x[0], x[1], x[2], x[3]);
    } else if constexpr (KPL == 2) {
      *reinterpret_cast<float2*>(row + k0) = make_float2(x[0], x[1]);
    } else {
      row[k0] = x[0];
    }
  } else {
#pragma unroll
    for (int m = 0; m < KPL; ++m)
      if (k0 + m < f) row[k0 + m] = x[m];
  }
}

// Tiles a warp's A loads run ahead of its walk: Raw registers a lane
// holds for them (8 bytes of int8 or bits, 16 of bfloat16, 32 of float32),
// so a warp keeps ~1 KB of its row in flight whatever the format.
template <class Fmt>
constexpr int kAhead = sizeof(typename Fmt::Raw) >= 32 ? 1 : 32 / static_cast<int>(sizeof(typename Fmt::Raw));

// The look-ahead ring of a warp's A loads over the tiles t_begin ..
// t_end of its chunk: raw holds the Raw cells of its tile row (8 a lane,
// from column c) and col the tile_col of the next D = kAhead tiles, so each
// load is issued D tiles before the walk reaches it.  Off (!ahead: a row
// of more than kChunk cells or not 8-aligned), it loads no cells and
// ring_pop gives the tile's column only.  ring_fill starts the ring.
template <class Fmt, int D>
__device__ __forceinline__ void ring_fill(typename Fmt::Raw (&raw)[D], int (&col)[D], const uint8_t* a_row,
                                          const int32_t* tile_col, int64_t tile_bytes, int t_begin, int t_end,
                                          int c, bool ahead, bool lane_in) {
  using Raw = typename Fmt::Raw;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    const bool in = ahead && t_begin + i < t_end;
    raw[i] = in && lane_in ? Fmt::load_raw(a_row + (t_begin + i) * tile_bytes, c) : Raw{};
    col[i] = in ? tile_col[t_begin + i] : 0;
  }
}

// tile t's cells (with ahead) in cur and its column in tcol; issues the
// loads of tile t + D
template <class Fmt, int D>
__device__ __forceinline__ void ring_pop(typename Fmt::Raw (&raw)[D], int (&col)[D], typename Fmt::Raw& cur,
                                         int& tcol, const uint8_t* a_row, const int32_t* tile_col,
                                         int64_t tile_bytes, int t, int t_end, int c, bool ahead, bool lane_in) {
  using Raw = typename Fmt::Raw;
  if (ahead) {
    cur = raw[0];
    tcol = col[0];
#pragma unroll
    for (int i = 0; i + 1 < D; ++i) {
      raw[i] = raw[i + 1];
      col[i] = col[i + 1];
    }
    const bool in = t + D < t_end;
    raw[D - 1] = in && lane_in ? Fmt::load_raw(a_row + (t + D) * tile_bytes, c) : Raw{};
    col[D - 1] = in ? tile_col[t + D] : 0;
  } else {
    tcol = tile_col[t];
  }
}

// One block of the walk: block bx of the chunk x slab axis (chunk bx /
// slabs, row block bx % slabs) and f-slice by.  walk_kernel runs it over
// its grid; P2 (csrc/fused_hybrid.cu) runs it in the walk blocks of its
// own grid.  bx and by are unsigned, as blockIdx is: walk_kernel then
// compiles to the code it had as one function.
template <int KPL, class Fmt, class Cells>
__device__ __forceinline__ void walk_block(const Args& p, const Work& wk, int slabs, unsigned bx, unsigned by) {
  constexpr int NB = Cells::NB;
  constexpr bool kSplit = split_of<Cells>::value;
  constexpr bool kShared = shared_of<Cells>::value;
  constexpr int ND = kSplit ? 1 : NB;   // branches that sum den terms
  constexpr int NH = kShared ? 1 : NB;  // H rows gathered a cell
  constexpr int kG = KPL == 1 ? 4 : 2;  // cells in flight per warp (more cost registers)
  constexpr int D = kAhead<Fmt>;
  using Raw = typename Fmt::Raw;
  __shared__ int lcol[kWarps][kChunk];
  __shared__ float lw[kWarps][NB][kChunk];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k = bx / slabs;
  const int r = block_row<Fmt>(bx % slabs, warp, p.R);
  const int run = wk.chunk_run[k];
  const int64_t grow = static_cast<int64_t>(run) * p.R + r;
  if (r >= p.R || grow >= p.n) return;  // the whole warp leaves together
  const int k0 = by * 32 * KPL + lane * KPL;  // the lane's first feature
  const bool lead = by == 0;                  // the f-slice that sums den
  const int t_begin = wk.chunk_tile[k], t_end = wk.chunk_tile[k + 1];
  int shift = 0;
  const uint8_t* a_row = p.a + Fmt::row_offset(r, p.R, p.C, &shift);
  const int64_t tile_bytes = Fmt::tile_bytes(p.R, p.C);
  const bool vec_a = (p.C % 8) == 0;
  // a row of at most kChunk cells, 8 a lane in one aligned load: its loads
  // run D tiles ahead; any other row loads each tile's cells in place
  const bool ahead = vec_a && p.C <= kChunk;
  const bool lane_in = lane * 8 < p.C;
  const typename Cells::Row rw = Cells::row(p.rows, grow);
  int* cl = lcol[warp];

  float acc[NB][KPL], dacc[ND];
#pragma unroll
  for (int b = 0; b < ND; ++b) dacc[b] = 0.f;
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int m = 0; m < KPL; ++m) acc[b][m] = 0.f;
  Raw ring[D];
  int col_ring[D];  // tile_col of the same tiles
  ring_fill<Fmt>(ring, col_ring, a_row, p.tile_col, tile_bytes, t_begin, t_end, lane * 8, ahead, lane_in);
  for (int t = t_begin; t < t_end; ++t) {
    int tcol;
    Raw cur;
    ring_pop<Fmt>(ring, col_ring, cur, tcol, a_row, p.tile_col, tile_bytes, t, t_end, lane * 8, ahead, lane_in);
    const int64_t col0 = static_cast<int64_t>(tcol) * p.C;
    float part[NB][KPL], dl[ND];
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if (b < ND) dl[b] = 0.f;
#pragma unroll
      for (int m = 0; m < KPL; ++m) part[b][m] = 0.f;
    }
    bool any = false;
    // one pass over the lane's cells base .. base + 7 of this tile row:
    // bit q of nz marks a nonzero cell base + q, value(q) gives its value
    const auto take = [&](unsigned nz, int base, const auto& value) {
      if (!__any_sync(tile_cells::kFull, nz != 0)) return;  // most tile rows hold no cell
      // columns at or past n_src hold no edge
      const int64_t lim = p.n_src - col0;
      if (lim < base + 8) nz &= lim <= base ? 0u : (1u << (lim - base)) - 1u;
      any = true;
      const int total = tile_cells::compact_mask(nz, base, lane, value, [&](int pos, int col, float val) {
        float w[NB], d[NB];
#pragma unroll
        for (int b = 0; b < NB; ++b) w[b] = d[b] = 0.f;
        Cells::weigh(p.cols, p.slope, rw, val, col0 + col, w, d);
        cl[pos] = col;
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          lw[warp][b][pos] = Cells::stage_w(w[b]);
          if constexpr (Cells::kDen) {
            if (b < ND) dl[b] += d[b];
          }
        }
      });
      for (int g0 = 0; g0 < total; g0 += kG) {
        float wg[kG][NB];
        float x[kG][NH][KPL];
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          const bool in = g0 + g < total;
          const int e = in ? g0 + g : g0;
          const int64_t src = col0 + cl[e];
          if constexpr (kShared) {  // one gather while some branch weighs the cell
            bool on = false;
#pragma unroll
            for (int b = 0; b < NB; ++b) {
              wg[g][b] = in ? lw[warp][b][e] : 0.f;
              on = on || wg[g][b] != 0.f;
            }
            gather<KPL>(p.h0 + src * p.f, k0, p.f, p.vec_h, on, x[g][0]);
          } else {
#pragma unroll
            for (int b = 0; b < NB; ++b) {
              wg[g][b] = in ? lw[warp][b][e] : 0.f;
              gather<KPL>((b == 0 ? p.h0 : p.h1) + src * p.f, k0, p.f, p.vec_h, wg[g][b] != 0.f, x[g][b]);
            }
          }
        }
#pragma unroll
        for (int g = 0; g < kG; ++g)
#pragma unroll
          for (int b = 0; b < NB; ++b)
#pragma unroll
            for (int m = 0; m < KPL; ++m)
              part[b][m] = fmaf(wg[g][b], Cells::stage_h(x[g][kShared ? 0 : b][m]), part[b][m]);
      }
    };
    if (ahead) {
      take(Fmt::nonzero8(cur, shift), lane * 8, [&](int q) { return Fmt::cell(cur, q, shift); });
    } else {
      for (int c0 = 0; c0 < p.C; c0 += kChunk) {
        float v[8];
        tile_fmt::load8_tail<Fmt>(a_row + t * tile_bytes, c0 + lane * 8, p.C, vec_a, shift, v);
        unsigned nz = 0;
#pragma unroll
        for (int q = 0; q < 8; ++q) nz |= (v[q] != 0.f ? 1u : 0u) << q;
        take(nz, c0 + lane * 8, [&](int q) { return v[q]; });
      }
    }
    if (!any) continue;
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int m = 0; m < KPL; ++m) acc[b][m] += part[b][m];
    if constexpr (Cells::kDen) {
      if (lead && any) {
#pragma unroll
        for (int b = 0; b < ND; ++b) dacc[b] += tile_cells::warp_sum(dl[b]);
      }
    }
  }

  const int slot = wk.chunk_slot[k];
  if (slot < 0) {  // the run's only chunk: the finished row
    float us[NB];
    Cells::post(p.rows, grow, us);
    if constexpr (kSplit) {
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        float o[KPL];
#pragma unroll
        for (int m = 0; m < KPL; ++m) o[m] = us[b] * acc[b][m];
        store<KPL>((b == 0 ? p.num : p.num1) + grow * p.f, k0, p.f, o);
      }
      if constexpr (Cells::kDen) {
        if (lead && lane == 0) p.den[grow] = us[0] * dacc[0];
      }
    } else {
      float o[KPL];
#pragma unroll
      for (int m = 0; m < KPL; ++m) {
        o[m] = us[0] * acc[0][m];
#pragma unroll
        for (int b = 1; b < NB; ++b) o[m] += us[b] * acc[b][m];
      }
      store<KPL>(p.num + grow * p.f, k0, p.f, o);
      if constexpr (Cells::kDen) {
        if (lead && lane == 0) {
          float d = us[0] * dacc[0];
#pragma unroll
          for (int b = 1; b < NB; ++b) d += us[b] * dacc[b];
          p.den[grow] = d;
        }
      }
    }
  } else {
    float* s = p.scratch + slot * slot_floats<Cells>(p.R, p.f);
#pragma unroll
    for (int b = 0; b < NB; ++b) store<KPL>(s + (static_cast<int64_t>(b) * p.R + r) * p.f, k0, p.f, acc[b]);
    if constexpr (Cells::kDen) {
      if (lead && lane == 0) {
#pragma unroll
        for (int b = 0; b < ND; ++b) s[static_cast<int64_t>(NB) * p.R * p.f + b * p.R + r] = dacc[b];
      }
    }
  }
}

template <int KPL, class Fmt, class Cells>
__global__ void __launch_bounds__(kThreads) walk_kernel(const Args p, const Work wk, int slabs) {
  walk_block<KPL, Fmt, Cells>(p, wk, slabs, blockIdx.x, blockIdx.y);
}

// The runs of more than one chunk: one thread a row element (then a row's
// den), the run's slots added in chunk order, post-scaled, written once
// (kSplit: each branch's to its own output, den branch 0's).
template <class Cells>
__global__ void __launch_bounds__(kFinishThreads) finish_kernel(const Args p, const Work wk) {
  constexpr int NB = Cells::NB;
  constexpr bool kSplit = split_of<Cells>::value;
  const int run = wk.multi_run[blockIdx.y];
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kFinishThreads + threadIdx.x;
  const int64_t nf = static_cast<int64_t>(p.R) * p.f;
  const int kb = wk.run_chunk[run], nk = wk.run_chunk[run + 1] - kb;
  const int64_t stride = slot_floats<Cells>(p.R, p.f);
  const float* s0 = p.scratch + wk.chunk_slot[kb] * stride;
  int r;
  int64_t at;  // the element's offset in a slot, per branch b: at + b * step
  int64_t step;
  if (e < nf) {
    r = static_cast<int>(e / p.f);
    at = e;
    step = nf;
  } else if (Cells::kDen && e < nf + p.R) {
    r = static_cast<int>(e - nf);
    at = NB * nf + r;
    step = p.R;
  } else {
    return;
  }
  const int64_t grow = static_cast<int64_t>(run) * p.R + r;
  if (grow >= p.n) return;
  const int nb = kSplit && e >= nf ? 1 : NB;  // branches summed
  float s[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) s[b] = 0.f;
  for (int q = 0; q < nk; ++q)
#pragma unroll
    for (int b = 0; b < NB; ++b)
      if (b < nb) s[b] += s0[q * stride + at + b * step];
  float us[NB];
  Cells::post(p.rows, grow, us);
  if constexpr (kSplit) {
    if (e < nf) {
      const int64_t at_row = grow * p.f + (e - static_cast<int64_t>(r) * p.f);
#pragma unroll
      for (int b = 0; b < NB; ++b) (b == 0 ? p.num : p.num1)[at_row] = us[b] * s[b];
    } else {
      p.den[grow] = us[0] * s[0];
    }
    return;
  }
  float o = us[0] * s[0];
#pragma unroll
  for (int b = 1; b < NB; ++b) o += us[b] * s[b];
  if (e < nf)
    p.num[grow * p.f + (e - static_cast<int64_t>(r) * p.f)] = o;
  else
    p.den[grow] = o;
}

// ------------------------------------------------------------ the staged walk
// a staged block: kStageWarps warps of kStageRowsPerWarp rows each, 256 rows
// (registers: KPL features of every row a lane, 64 at KPL = 4)
template <int KPL>
constexpr int kStageWarps = KPL == 4 ? 16 : 32;
template <int KPL>
constexpr int kStageRowsPerWarp = KPL == 4 ? 16 : 8;
template <int KPL>
constexpr int kStageRows = kStageWarps<KPL> * kStageRowsPerWarp<KPL>;
constexpr int kUnitFloats = 8192;                     // a ring unit: 32 KB of H rows
constexpr int kUnits = 6;                             // the ring's units
constexpr int kStageSmem = kUnits * kUnitFloats * 4;  // the ring: 192 KB

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(to), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(to), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// until at most n of this thread's copy groups are pending
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  static_assert(kUnits <= 8, "one case per pending count below kUnits");
  switch (n) {
    case 7: cp_async_wait<7>(); break;
    case 6: cp_async_wait<6>(); break;
    case 5: cp_async_wait<5>(); break;
    case 4: cp_async_wait<4>(); break;
    case 3: cp_async_wait<3>(); break;
    case 2: cp_async_wait<2>(); break;
    case 1: cp_async_wait<1>(); break;
    default: cp_async_wait<0>(); break;
  }
}

// x[m] = q[m], q a shared-memory address aligned to KPL floats
template <int KPL>
__device__ __forceinline__ void lds(const float* q, float (&x)[KPL]) {
  if constexpr (KPL == 4) {
    const float4 v = *reinterpret_cast<const float4*>(q);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else if constexpr (KPL == 2) {
    const float2 v = *reinterpret_cast<const float2*>(q);
    x[0] = v.x; x[1] = v.y;
  } else {
    x[0] = *q;
  }
}

// One block of the staged walk: staged chunk blockIdx.x / groups, its
// kStageRows rows from (blockIdx.x % groups) * kStageRows, f-slice
// blockIdx.y.  Warp w owns rows w + q * kStageWarps, q < kStageRowsPerWarp.
//
// The ring's units, in order: unit u holds rows (u % nsplit) * CS .. + CS
// of live tile u / nsplit's H column block (CS rows of the slice's FS
// floats fill a unit), in ring slot u % kUnits, so a tile's C rows lie at
// consecutive ring rows, modulo the ring.  Each thread commits one copy
// group a unit, kUnits ahead of the tile being summed (an empty group past
// the last unit), so before tile i every thread waits until at most kUnits
// - nsplit groups are pending.
//
// A warp takes its rows one at a time, from the plan's cell list (Stage):
// 32 cells at a time, one a lane, each turned into its ring offset beside
// its weight's upper 16 bits; then each cell in turn, broadcast from its
// lane, adds its weight times its row slice of H from the ring (KPL
// features a lane) into the row's tile partial, one fmaf a feature, in
// list order.  The first 32 cells of the warp's rows in the next tile, and
// the row bounds of the tile after it, load while this tile is summed.
template <int KPL, class Cells>
__global__ void __launch_bounds__(32 * kStageWarps<KPL>, 1) stage_kernel(const Args p, const Work wk, const Stage st,
                                                                        int groups) {
  static_assert(Cells::NB == 1 && !Cells::kDen, "the staged walk sums one branch and no den");
  static_assert(kUnits * kUnitFloats <= 65536, "a ring offset fits 16 bits");
  constexpr int FS = 32 * KPL;          // features of an f-slice
  constexpr int CS = kUnitFloats / FS;  // H rows a unit
  constexpr int RING = kUnits * CS;     // H rows the ring holds
  constexpr int NW = kStageWarps<KPL>, RW = kStageRowsPerWarp<KPL>, NT = 32 * NW;
  static_assert(RW <= 32, "a lane holds one row's bounds");
  extern __shared__ __align__(16) float stage_smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* ring_lane = stage_smem + lane * KPL;
  const int s = blockIdx.x / groups;
  const int r0 = (blockIdx.x % groups) * kStageRows<KPL> + warp;  // row q of the warp: r0 + q * NW
  const int k = st.chunk[s];
  const int run = wk.chunk_run[k];
  const int tb = st.start[s], nt = st.start[s + 1] - tb;
  const int C = p.C;
  const int nsplit = (C + CS - 1) / CS;
  const int units = nt * nsplit;
  const int f0 = blockIdx.y * FS;
  const int fw = min(FS, p.f - f0);  // features of this slice
  const bool vec = p.f % 4 == 0 && reinterpret_cast<uintptr_t>(p.h0) % 16 == 0;
  const int64_t grow0 = static_cast<int64_t>(run) * p.R;

  const auto copy_unit = [&](int u) {
    if (u < units) {
      const int c0 = u % nsplit * CS;
      const int64_t src0 = static_cast<int64_t>(p.tile_col[st.tile[tb + u / nsplit]]) * C + c0;
      // columns at or past n_src hold no edge: their rows are never read
      const int64_t left = p.n_src - src0;
      const int rows = left < min(CS, C - c0) ? static_cast<int>(left) : min(CS, C - c0);
      float* dst = stage_smem + u % kUnits * kUnitFloats;
      const float* src = p.h0 + src0 * p.f + f0;
      if (vec && fw == FS) {  // whole rows of the slice: FS / 4 16-byte copies a row
        constexpr int Q4 = FS / 4;
        for (int e = threadIdx.x; e < rows * Q4; e += NT) {
          const int r = e / Q4, q = e % Q4;
          cp_async16(dst + r * FS + 4 * q, src + static_cast<int64_t>(r) * p.f + 4 * q);
        }
      } else if (vec) {
        const int q4 = fw / 4;
        for (int e = threadIdx.x; e < rows * q4; e += NT) {
          const int r = e / q4, q = e - r * q4;
          cp_async16(dst + r * FS + 4 * q, src + static_cast<int64_t>(r) * p.f + 4 * q);
        }
      } else {
        for (int e = threadIdx.x; e < rows * fw; e += NT) {
          const int r = e / fw, q = e - r * fw;
          cp_async4(dst + r * FS + q, src + static_cast<int64_t>(r) * p.f + q);
        }
      }
    }
    cp_async_commit();
  };
  // the warp's rows of the l-th staged tile: lane q < RW gets row q's list
  // bounds [beg, end)
  const auto load_bounds = [&](int l, int& beg, int& end) {
    const int r = r0 + lane * NW;
    beg = end = 0;
    if (lane < RW && r < p.R) {
      const int64_t at = static_cast<int64_t>(l) * p.R + r;
      beg = st.row[at];
      end = st.row[at + 1];
    }
  };
  // v[q]: row q's cell at beg + lane (0 past end), for those bounds
  const auto load_cells = [&](int beg, int end, int (&v)[RW]) {
#pragma unroll
    for (int q = 0; q < RW; ++q) {
      const int b = __shfl_sync(tile_cells::kFull, beg, q), e = __shfl_sync(tile_cells::kFull, end, q);
      v[q] = b + lane < e ? st.cells[b + lane] : 0;
    }
  };
  // cell e's ring offset (16 bits) beside its weight's upper 16 bits
  const auto packed = [&](int v, int base) {
    int row = base + (v & 0xffff);
    row -= row >= RING ? RING : 0;
    return row * FS | (v & static_cast<int>(0xffff0000u));
  };

  for (int u = 0; u < kUnits; ++u) copy_unit(u);
  // the next tile's bounds and first cells, and the bounds of the one after
  int nbeg = 0, nend = 0, nv[RW], bb = 0, be = 0;
  if (nt > 0) {
    load_bounds(tb, nbeg, nend);
    load_cells(nbeg, nend, nv);
  }
  if (nt > 1) load_bounds(tb + 1, bb, be);
  float acc[RW][KPL];
#pragma unroll
  for (int q = 0; q < RW; ++q)
#pragma unroll
    for (int m = 0; m < KPL; ++m) acc[q][m] = 0.f;
  for (int i = 0; i < nt; ++i) {
    const int beg = nbeg, end = nend;
    int v0[RW];
#pragma unroll
    for (int q = 0; q < RW; ++q) v0[q] = nv[q];
    if (i + 1 < nt) {
      load_cells(bb, be, nv);
      nbeg = bb;
      nend = be;
      if (i + 2 < nt) load_bounds(tb + i + 2, bb, be);
    }
    const int base = i * nsplit % kUnits * CS;  // the ring row of the tile's column 0
    cp_async_wait_upto(kUnits - nsplit);
    __syncthreads();  // every thread's copies of tile i landed
#pragma unroll
    for (int q = 0; q < RW; ++q) {
      const int b = __shfl_sync(tile_cells::kFull, beg, q), e = __shfl_sync(tile_cells::kFull, end, q);
      if (b == e) continue;  // a tile row without a cell
      float part[KPL];
#pragma unroll
      for (int m = 0; m < KPL; ++m) part[m] = 0.f;
      for (int c0 = b; c0 < e; c0 += 32) {
        const int pk = packed(c0 == b ? v0[q] : c0 + lane < e ? st.cells[c0 + lane] : 0, base);
        const int n = min(32, e - c0);
        int j = 0;
        for (; j + 4 <= n; j += 4) {  // four cells' loads in flight, summed in column order
          float x[4][KPL];
          int w[4];
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            w[g] = __shfl_sync(tile_cells::kFull, pk, j + g);
            lds<KPL>(ring_lane + (w[g] & 0xffff), x[g]);
          }
#pragma unroll
          for (int g = 0; g < 4; ++g)
#pragma unroll
            for (int m = 0; m < KPL; ++m)
              part[m] = fmaf(Cells::stage_w(__int_as_float(w[g] & static_cast<int>(0xffff0000u))),
                             Cells::stage_h(x[g][m]), part[m]);
        }
        for (; j < n; ++j) {
          float x[KPL];
          const int w = __shfl_sync(tile_cells::kFull, pk, j);
          lds<KPL>(ring_lane + (w & 0xffff), x);
#pragma unroll
          for (int m = 0; m < KPL; ++m)
            part[m] = fmaf(Cells::stage_w(__int_as_float(w & static_cast<int>(0xffff0000u))), Cells::stage_h(x[m]),
                           part[m]);
        }
      }
#pragma unroll
      for (int m = 0; m < KPL; ++m) acc[q][m] += part[m];
    }
    __syncthreads();  // tile i's ring slots read by every warp
    for (int j = 0; j < nsplit; ++j) copy_unit(kUnits + i * nsplit + j);
  }
  cp_async_wait<0>();

  const int slot = wk.chunk_slot[k];
  const int k0 = f0 + lane * KPL;
#pragma unroll
  for (int q = 0; q < RW; ++q) {
    const int r = r0 + q * NW;
    const int64_t grow = grow0 + r;
    if (r >= p.R || grow >= p.n) continue;
    if (slot < 0) {  // the run's only chunk: the finished row
      float us[1], o[KPL];
      Cells::post(p.rows, grow, us);
#pragma unroll
      for (int m = 0; m < KPL; ++m) o[m] = us[0] * acc[q][m];
      store<KPL>(p.num + grow * p.f, k0, p.f, o);
    } else {
      store<KPL>(p.scratch + slot * slot_floats<Cells>(p.R, p.f) + static_cast<int64_t>(r) * p.f, k0, p.f, acc[q]);
    }
  }
}

// walk_block over the chunks a list names (the gather chunks beside a
// staged walk)
template <int KPL, class Fmt, class Cells>
__global__ void __launch_bounds__(kThreads) walk_list_kernel(const Args p, const Work wk, const int32_t* chunks,
                                                             int slabs) {
  const unsigned k = chunks[blockIdx.x / slabs];
  walk_block<KPL, Fmt, Cells>(p, wk, slabs, k * slabs + blockIdx.x % slabs, blockIdx.y);
}

// Features a lane takes at width p.f: 1, 2 or 4, a warp covering up to 32,
// 64 or 128 (a wider f takes 128-wide f-slices, f_slices); sets p.vec_h to
// match.
inline int lane_features(Args& p) {
  const auto aligned = [](const float* q, int bytes) {
    return q == nullptr || reinterpret_cast<uintptr_t>(q) % bytes == 0;
  };
  if (p.f <= 32) {
    p.vec_h = true;
    return 1;
  }
  if (p.f <= 64) {
    p.vec_h = p.f % 2 == 0 && aligned(p.h0, 8) && aligned(p.h1, 8);
    return 2;
  }
  p.vec_h = p.f % 4 == 0 && aligned(p.h0, 16) && aligned(p.h1, 16);
  return 4;
}

inline int f_slices(int f, int kpl) { return kpl == 4 ? (f + 127) / 128 : 1; }

// The walk over every chunk (no finish pass).  Returns a cudaError_t.
template <class Fmt, class Cells>
int launch_walk(Args p, const Work& wk, cudaStream_t s) {
  const int slabs = num_slabs<Fmt>(p.R);
  const int kpl = lane_features(p);
  const dim3 grid(wk.num_chunks * slabs, f_slices(p.f, kpl)), block(kThreads);
  if (kpl == 1)
    walk_kernel<1, Fmt, Cells><<<grid, block, 0, s>>>(p, wk, slabs);
  else if (kpl == 2)
    walk_kernel<2, Fmt, Cells><<<grid, block, 0, s>>>(p, wk, slabs);
  else
    walk_kernel<4, Fmt, Cells><<<grid, block, 0, s>>>(p, wk, slabs);
  return static_cast<int>(cudaGetLastError());
}

// The finish pass over the runs of more than one chunk, if there are any.
// Returns a cudaError_t.
template <class Cells>
int launch_finish(const Args& p, const Work& wk, cudaStream_t s) {
  if (wk.num_multi == 0) return 0;
  const int64_t elems = static_cast<int64_t>(p.R) * p.f + (Cells::kDen ? p.R : 0);
  const dim3 grid(static_cast<unsigned>((elems + kFinishThreads - 1) / kFinishThreads), wk.num_multi);
  finish_kernel<Cells><<<grid, dim3(kFinishThreads), 0, s>>>(p, wk);
  return static_cast<int>(cudaGetLastError());
}

template <int KPL, class Cells>
int launch_stage(const Args& p, const Work& wk, const Stage& st, int slices, cudaStream_t s) {
  const int groups = (p.R + kStageRows<KPL> - 1) / kStageRows<KPL>;
  const dim3 grid(st.num * groups, slices);
  const cudaError_t set =
      cudaFuncSetAttribute(stage_kernel<KPL, Cells>, cudaFuncAttributeMaxDynamicSharedMemorySize, kStageSmem);
  if (set != cudaSuccess) return static_cast<int>(set);
  stage_kernel<KPL, Cells><<<grid, dim3(32 * kStageWarps<KPL>), kStageSmem, s>>>(p, wk, st, groups);
  return static_cast<int>(cudaGetLastError());
}

// The walk with a kStage policy (no finish pass): the list's staged chunks
// (the caller passes S > 0 only for an int8 plan, ops/cell_walk.py) by
// stage_kernel, then the others by walk_list_kernel; with S = 0 every
// chunk as launch_walk.  Returns a cudaError_t.
template <class Fmt, class Cells>
int launch_walk_staged(Args p, const Work& wk, const Stage& st, cudaStream_t s) {
  if (st.num == 0) return launch_walk<Fmt, Cells>(p, wk, s);
  if constexpr (!std::is_same<Fmt, CountTiles>::value) {
    return static_cast<int>(cudaErrorInvalidValue);  // the staged walk reads int8 counts
  } else {
    if (p.C > kChunk) return static_cast<int>(cudaErrorInvalidValue);  // the ring holds a tile and a unit
    const int kpl = lane_features(p);
    const int slices = f_slices(p.f, kpl);
    int err = kpl == 1   ? launch_stage<1, Cells>(p, wk, st, slices, s)
              : kpl == 2 ? launch_stage<2, Cells>(p, wk, st, slices, s)
                         : launch_stage<4, Cells>(p, wk, st, slices, s);
    if (err != 0 || st.num_gather == 0) return err;
    const int slabs = num_slabs<Fmt>(p.R);
    const dim3 rest(st.num_gather * slabs, slices), block(kThreads);
    if (kpl == 1)
      walk_list_kernel<1, Fmt, Cells><<<rest, block, 0, s>>>(p, wk, st.gather, slabs);
    else if (kpl == 2)
      walk_list_kernel<2, Fmt, Cells><<<rest, block, 0, s>>>(p, wk, st.gather, slabs);
    else
      walk_list_kernel<4, Fmt, Cells><<<rest, block, 0, s>>>(p, wk, st.gather, slabs);
    return static_cast<int>(cudaGetLastError());
  }
}

// The walk, then the finish pass; num_staged / num_stage_tiles: the sizes
// of the list's Stage part, read by a kStage policy only.  Returns a
// cudaError_t.
template <class Fmt, class Cells>
int launch(const Args& p, const int32_t* work, int num_chunks, int num_multi, int num_row_tiles, int device,
           void* stream, int num_staged = 0, int num_stage_tiles = 0) {
  if (num_row_tiles == 0 || p.n == 0) return 0;
  // this library carries its own (static) CUDA runtime: select the caller's
  // card in it before launching on the caller's stream
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const Work wk(work, num_chunks, num_multi, num_row_tiles);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if constexpr (stage_of<Cells>::value) {
    err = launch_walk_staged<Fmt, Cells>(
        p, wk, Stage(work, num_chunks, num_multi, num_row_tiles, num_staged, num_stage_tiles, p.R), s);
  } else {
    err = launch_walk<Fmt, Cells>(p, wk, s);
  }
  return err != 0 ? err : launch_finish<Cells>(p, wk, s);
}

}  // namespace cell_walk
