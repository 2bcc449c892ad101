// What K5 on bf16 streams shares (gru_fwd_bf16.cu, gru_bwd_bf16.cu): the
// grid, h_{t-1} staged by the TMA straight from hs, and the recurrent
// product h_{t-1} @ W_hh^T on the tensor cores.
//
// The grid: H/8 groups of UNITS=8 hidden units, i.e. 24 gate rows (gate q,
// unit j is W_hh's row q*H + u0 + j), and two blocks on each group, block
// h taking rows [32 h, 32 h + 32) of every 64-row batch tile: H/4 blocks
// of one persistent cooperative grid, one an SM (128 at H=512, 132 at
// H=528). Two blocks of 32 rows rather than one of 64 (H/8 blocks): each
// block then stages, multiplies and exchanges half the rows on twice the
// SMs, and holds half the W_hh fragments a thread. Measured in turns on an
// H100 at gate 3's shape, 64 rows a block took 0.696 ms against 0.513 in
// K5-fwd and 1.460 against 0.782 in K5-bwd, whose 64-row build spilled at
// 255 registers (PERF.md section 6).
//   - h_{t-1} = hs[t_prev] is exactly the bf16 h the product takes, so it
//     comes straight from hs: a 3-D tensor map over hs (H, B, T), boxes of
//     64 columns x 32 rows with the 128-byte swizzle, rows past B and
//     columns past H zero-filled, one mbarrier a box. The block's 32 x H
//     tile lands whole in shared memory (32 KB at H=512).
//   - The product's warps: warp w takes m-tile w % 2 and K part w / 2 of
//     four parts of the H/16 k-steps, holding W_hh's 24 rows over its
//     k-steps as mma B fragments in registers for the whole sequence; it
//     waits for each box as it reaches it. The n-tile of an mma is one
//     gate's eight units, so a lane's accumulators hold all three gates of
//     units 2t, 2t+1 at rows g and g+8 of its m-tile: the cell layout
//     follows the fragment layout. The four parts' sums meet in shared
//     memory; the cell thread (m-tile m, part kp, lane) takes one of the
//     lane's four (row, unit) places, row 16 m + g + 8 (kp & 1) and unit
//     2t + (kp >> 1), adding the parts in order.
//   - gh_n stays apart from gx_n: the cell adds b_hh to the product and
//     puts r in front of gh_n.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_sync.cuh"
#include "mma_tma.cuh"

namespace grubf {

using fused::bf16;

constexpr int UNITS = 8;               // hidden units a group of blocks owns
constexpr int GATES = 3;               // r, z, n: an mma n-tile each
constexpr int BT = 64;                 // batch rows a tile
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BOX = fused::HALF;       // columns of a TMA box
constexpr int KB = BOX / 16;           // mma k-steps of a box
constexpr int MAX_H = 528;             // H/8 * 2 blocks within 132 SMs
constexpr int MAX_KSTEPS = MAX_H / 16;
constexpr int RB = 32;                 // rows of each batch tile a block
constexpr int SPLIT = BT / RB;         // blocks on one group of units
constexpr int MT = RB / 16;            // m-tiles of a block's rows
constexpr int KP = WARPS / MT;         // K parts of the product
constexpr int KMAX = (MAX_KSTEPS + KP - 1) / KP;  // k-steps of a part
constexpr int BOX_BYTES = RB * BOX * 2;
// the K parts' sums: a float2 a gate, row half and lane of each warp; the
// backward's exchange sums (an m-tile, row half and lane) fit in them
constexpr int PART_FLOAT2 = WARPS * GATES * 2 * 32;
static_assert(WARPS * MT * 2 * 32 <= PART_FLOAT2, "exchange sums");

__host__ __device__ inline int n_boxes(int cols) {
  return (cols + BOX - 1) / BOX;
}

// The launch checks of both builds.
inline bool takes(int T, int B, int H) {
  return H >= 16 && H % 16 == 0 && H <= MAX_H && T >= 1 && B >= 1;
}

inline int grid_blocks(int H) { return H / UNITS * SPLIT; }

__device__ __forceinline__ uint32_t ldg32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// K part kp's k-steps [lo, hi) of H/16, in order.
__device__ __forceinline__ void k_part(int H, int kp, int& lo, int& hi) {
  const int n = H / 16;
  const int per = (n + KP - 1) / KP;
  lo = min(n, kp * per);
  hi = min(n, lo + per);
}

// The cell thread's row within its block's rows of a tile, and its unit.
__device__ __forceinline__ int cell_row() {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return 16 * (warp % MT) + (lane >> 2) + 8 * ((warp / MT) & 1);
}

__device__ __forceinline__ int cell_unit() {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return 2 * (lane & 3) + (warp / MT >> 1);
}

// The cell thread's place among its lane's float2s of sums: which row
// half, and which of the two units.
__device__ __forceinline__ int cell_half() {
  return (threadIdx.x >> 5) / MT & 1;
}
__device__ __forceinline__ float cell_pick(float2 v) {
  return (threadIdx.x >> 5) / MT >> 1 ? v.y : v.x;
}

// This warp's B fragments of W_hh's 24 block rows over its k-steps [lo,
// hi): wf[i][q] = {b0, b1} of k-step lo + i and gate q (the n-tile of
// eight units): b0 = W[q*H + u0 + g][c .. c+1], b1 the same 8 columns on,
// c = 16 (lo + i) + 2 t; zero past hi.
__device__ inline void load_w_frags(uint32_t (&wf)[KMAX][GATES][2],
                                    const bf16* __restrict__ w_hh, int H,
                                    int u0, int lo, int hi) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < KMAX; ++i)
#pragma unroll
    for (int q = 0; q < GATES; ++q) {
      const int k = lo + i;
      const bf16* p = w_hh + (size_t)(q * H + u0 + g) * H + 16 * k + 2 * t;
      wf[i][q][0] = k < hi ? ldg32(p) : 0u;
      wf[i][q][1] = k < hi ? ldg32(p + 8) : 0u;
    }
}

// The TMA copies of the block's h_{t-1}: rows [b0, b0 + RB) of hs[tp], all
// nb boxes, each on its mbarrier. By one thread. Other blocks wrote
// hs[tp] with plain stores: the async proxy must see them, and this
// block's own plain reads of the tile (the last product) come before the
// copies.
__device__ inline void stage_h(bf16* tile, const CUtensorMap* map_h,
                               uint64_t* bar, int nb, int tp, int b0) {
  asm volatile("fence.proxy.async.global;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  for (int j = 0; j < nb; ++j) {
    mbar_expect(&bar[j], BOX_BYTES);
    fused::tma_half(tile + (size_t)j * RB * BOX,
                    fused::Chunk{map_h, j * BOX, b0, tp}, 0, &bar[j]);
  }
}

// The recurrent product of the block's tile (every thread calls it):
// thread 0 issues the copies of hs[tp] rows [b0, b0 + RB) unless `issued`;
// each warp multiplies its m-tile over its k-steps as their boxes land and
// stores its sums; after a block barrier, `after()` (the tile is free
// again: the backward issues its next copies there) and each cell thread
// gathers pre[q], gate q of its unit, the parts added in order.
// `staged` counts the tile's stagings (the mbarriers' parity). `part`
// stays taken until the caller's next block barrier.
template <class Mark, class After>
__device__ inline void recurrent_product(
    float (&pre)[GATES], bf16* tile, float2* part, uint64_t* bar,
    const CUtensorMap* map, const uint32_t (&wf)[KMAX][GATES][2], int lo,
    int hi, int nb, int tp, int b0, unsigned int& staged, Mark mark,
    After after, bool issued = false) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0 && !issued) stage_h(tile, map, bar, nb, tp, b0);
  const unsigned int parity = staged & 1;
  const int arow = 16 * (warp % MT) + (lane & 7) + 8 * ((lane >> 3) & 1);
  const int acol = 8 * (lane >> 4);
  float acc[GATES][4];
#pragma unroll
  for (int q = 0; q < GATES; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[q][e] = 0.0f;
#pragma unroll
  for (int i = 0; i < KMAX; ++i) {
    const int k = lo + i;
    if (k < hi) {
      if (i == 0 || k % KB == 0) {
        mbar_wait(&bar[k / KB], parity);
        if (i == 0) mark(0);  // staged
      }
      uint32_t a[4];
      fused::ldsm_x4(a, fused::swz_at<RB>(tile, arow, 16 * k + acol));
#pragma unroll
      for (int q = 0; q < GATES; ++q)
        fused::mma16816(acc[q], a[0], a[1], a[2], a[3], wf[i][q][0],
                        wf[i][q][1]);
    }
  }
#pragma unroll
  for (int q = 0; q < GATES; ++q)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      part[((warp * GATES + q) * 2 + h) * 32 + lane] =
          make_float2(acc[q][2 * h], acc[q][2 * h + 1]);
  ++staged;
  __syncthreads();
  after();
  const int h = cell_half();
#pragma unroll
  for (int q = 0; q < GATES; ++q) pre[q] = 0.0f;
#pragma unroll
  for (int p = 0; p < KP; ++p) {
    const int w = warp % MT + p * MT;
#pragma unroll
    for (int q = 0; q < GATES; ++q)
      pre[q] += cell_pick(part[((w * GATES + q) * 2 + h) * 32 + lane]);
  }
  mark(1);  // product
}

}  // namespace grubf
