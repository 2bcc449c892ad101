// What the wide K1 builds on bf16 streams share (lstm_fwd_wide_bf16.cu,
// lstm_bwd_wide_bf16.cu): the block's layout for every H % 128 == 0 up to
// 1024, h_{t-1} staged whole by the TMA, and the recurrent product
// h_{t-1} @ W_hh^T of one 64-row batch tile on the tensor cores.
//
// As the f32 wide builds (lstm_wide.cuh), one persistent cooperative grid
// of H/8 blocks (128 at H=1024, one an SM); a block owns UNITS=8 hidden
// units, i.e. ROWS=32 gate rows (gate q, unit j is W_hh's row q*H + u0 +
// j). In bf16 the layout differs:
//   - h_{t-1} = hs[t_prev] is exactly the bf16 h the product takes, so it
//     comes straight from hs: a 3-D tensor map over hs (H, B, T), boxes of
//     64 columns x 64 batch rows with the 128-byte swizzle (lstm_fused_tma
//     .cuh's chunk tiles), rows past B zero-filled. The whole 64 x H tile
//     lands in shared memory (128 KB at H=1024) as NK = H/128 K slices of
//     16 KB, one mbarrier a slice.
//   - Warp w takes K slice w (H=1024: eight slices for eight warps; at
//     H=640 warps 5-7 have none). It holds W_hh's 32 rows over its 128
//     columns as mma B fragments in registers for the whole sequence (8 KB
//     a warp, 64 registers a thread), waits for its slice only, and forms
//     the tile's 64 x 32 pre-activations over its slice with mma.sync
//     m16n8k16 (bf16 operands, f32 sums): 4 x 4 tiles x 8 k-steps, 128
//     mma a step. A fragments come from the swizzled slice by ldmatrix.
//   - Its 64 x 32 f32 sums overwrite the first 8 KB of its own slice once
//     the slice is read (no other warp reads it), laid out so that the
//     cell thread of a (row, unit pair) reads its eight pre-activations of
//     a slice as two float4s; the cell adds the slices in slice order.
// The n-tile of an mma is one gate's eight units, so a lane's accumulators
// already hold all four gates of units 2t, 2t+1 at rows g and g+8 of each
// m-tile: the cell layout follows the fragment layout (warp w: m-tile
// w >> 1, rows 8 (w & 1) + g; lane g = lane >> 2, t = lane & 3).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_sync.cuh"
#include "lstm_fused_tma.cuh"

namespace widebf {

using fused::bf16;

constexpr int UNITS = 8;             // hidden units owned by one block
constexpr int GATES = 4;             // i, f, g, o
constexpr int ROWS = GATES * UNITS;  // gate rows owned by one block
constexpr int BT = 64;               // batch rows a tile
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int KSLICE = 128;          // columns of a K slice
constexpr int KSTEPS = KSLICE / 16;  // mma k-steps of a slice
constexpr int SLICE = BT * KSLICE;   // bf16 elements of a slice tile (16 KB)
constexpr int MAX_H = 1024;
constexpr int MAX_SLICES = MAX_H / KSLICE;
static_assert(fused::BT == BT && fused::KCB == KSLICE &&
                  fused::TILE == SLICE,
              "a K slice is one of lstm_fused_tma.cuh's chunk tiles");
static_assert(MAX_SLICES == WARPS, "one K slice a warp");
static_assert(WARPS == 2 * (BT / 16), "cell layout: a warp a half m-tile");
static_assert(BT * ROWS * sizeof(float) <= SLICE * sizeof(bf16) / 2,
              "a warp's sums fit in the first half of its slice");

__host__ __device__ inline int n_slices(int H) { return H / KSLICE; }

// The launch checks of both builds: H a multiple of 128 up to MAX_H.
inline bool takes(int T, int B, int H) {
  return H >= KSLICE && H % KSLICE == 0 && H <= MAX_H && T >= 1 && B >= 1;
}

__device__ __forceinline__ uint32_t ldg32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// This warp's B fragments of W_hh's 32 block rows over K slice ks:
// wf[k][q] = {b0, b1} of k-step k and gate q (the n-tile of eight units):
// b0 = W[q*H + u0 + g][c .. c+1], b1 the same 8 columns on, c = ks*128 +
// 16 k + 2 t.
__device__ inline void load_w_frags(uint32_t (&wf)[KSTEPS][GATES][2],
                                    const bf16* __restrict__ w_hh, int H,
                                    int u0, int ks) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int k = 0; k < KSTEPS; ++k)
#pragma unroll
    for (int q = 0; q < GATES; ++q) {
      const bf16* p = w_hh + (size_t)(q * H + u0 + g) * H + ks * KSLICE +
                      16 * k + 2 * t;
      wf[k][q][0] = ldg32(p);
      wf[k][q][1] = ldg32(p + 8);
    }
}

// The TMA copies of the tile's h_{t-1}: rows [b0, b0 + 64) of hs[tp], all
// NK slices, each slice's two 64-column halves on its mbarrier. By one
// thread. Other blocks wrote hs[tp] with plain stores: the async proxy
// must see them, and this block's own plain accesses of the tile's memory
// (the sums of the last product) come before the copies.
__device__ inline void stage_h(bf16* tile, const CUtensorMap* map_h,
                               uint64_t* bar, int nk, int tp, int b0) {
  asm volatile("fence.proxy.async.global;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  for (int ks = 0; ks < nk; ++ks) {
    const fused::Chunk c{map_h, ks * KSLICE, b0, tp};
    bf16* dst = tile + (size_t)ks * SLICE;
    mbar_expect(&bar[ks], SLICE * sizeof(bf16));
    fused::tma_half(dst, c, 0, &bar[ks]);
    fused::tma_half(dst + BT * fused::HALF, c, 1, &bar[ks]);
  }
}

// The product of one staged slice: acc[m][q] (m-tile m, gate q) = the
// slice's rows 16 m .. 16 m + 15 times W_hh's rows of gate q, over its
// 128 columns, 16 at a time in column order.
__device__ __forceinline__ void slice_product(
    float (&acc)[4][GATES][4], const bf16* slice,
    const uint32_t (&wf)[KSTEPS][GATES][2]) {
  const int lane = threadIdx.x & 31;
  const int arow = (lane & 7) + 8 * ((lane >> 3) & 1);
  const int acol = 8 * (lane >> 4);
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int q = 0; q < GATES; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][q][e] = 0.0f;
#pragma unroll
  for (int k = 0; k < KSTEPS; ++k) {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      uint32_t a[4];
      fused::ldsm_x4(a, fused::tile_at(slice, 16 * m + arow, acol + 16 * k));
#pragma unroll
      for (int q = 0; q < GATES; ++q)
        fused::mma16816(acc[m][q], a[0], a[1], a[2], a[3], wf[k][q][0],
                        wf[k][q][1]);
    }
  }
}

// Slice ks's sums as the cell reads them: float4 index ((m * 2 + half) * 2
// + p) * 32 + lane holds gates 2p, 2p + 1 of units 2t, 2t + 1 at row
// 16 m + 8 half + g.
__device__ __forceinline__ float4* slice_sums(bf16* tile, int ks) {
  return reinterpret_cast<float4*>(tile + (size_t)ks * SLICE);
}

// After the warp's product of slice ks (all its lanes past their reads):
// its sums over the slice's first 8 KB.
__device__ __forceinline__ void store_sums(bf16* tile, int ks,
                                           const float (&acc)[4][GATES][4]) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  float4* dst = slice_sums(tile, ks);
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int p = 0; p < 2; ++p)
        dst[((m * 2 + h) * 2 + p) * 32 + lane] =
            make_float4(acc[m][2 * p][2 * h], acc[m][2 * p][2 * h + 1],
                        acc[m][2 * p + 1][2 * h],
                        acc[m][2 * p + 1][2 * h + 1]);
}

// The cell thread's recurrent sums pre[q][e] (gate q, unit 2t + e of its
// row), the nk slices added in slice order, after a barrier that follows
// every warp's store_sums.
__device__ __forceinline__ void gather_sums(float (&pre)[GATES][2],
                                            bf16* tile, int nk) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int at = (warp * 2) * 32 + lane;  // (m * 2 + half) = warp
#pragma unroll
  for (int q = 0; q < GATES; ++q) pre[q][0] = pre[q][1] = 0.0f;
  for (int ks = 0; ks < nk; ++ks) {
    const float4* src = slice_sums(tile, ks);
    const float4 a = src[at], b = src[at + 32];
    pre[0][0] = __fadd_rn(pre[0][0], a.x);
    pre[0][1] = __fadd_rn(pre[0][1], a.y);
    pre[1][0] = __fadd_rn(pre[1][0], a.z);
    pre[1][1] = __fadd_rn(pre[1][1], a.w);
    pre[2][0] = __fadd_rn(pre[2][0], b.x);
    pre[2][1] = __fadd_rn(pre[2][1], b.y);
    pre[3][0] = __fadd_rn(pre[3][0], b.z);
    pre[3][1] = __fadd_rn(pre[3][1], b.w);
  }
}

// The whole recurrent product of one tile (every thread calls it): thread
// 0 issues the copies of hs[tp] rows [b0, b0 + 64), warp w < nk waits for
// its slice, multiplies and stores its sums; after a block barrier every
// cell thread gathers its pre-activations' recurrent parts. `staged`
// counts the tile's stagings so far (the mbarriers' parity). The tile's
// memory stays taken until every thread has gathered: the caller's next
// block barrier frees it. W_hh's rows come from the register fragments
// wf. `issued`: thread 0 has already issued the copies (stage_h) while the
// tile was free.
template <class Mark>
__device__ inline void recurrent_product(
    float (&pre)[GATES][2], bf16* tile, uint64_t* bar, const CUtensorMap* map,
    const uint32_t (&wf)[KSTEPS][GATES][2], int nk, int tp, int b0,
    unsigned int& staged, Mark mark, bool issued = false) {
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0 && !issued) stage_h(tile, map, bar, nk, tp, b0);
  if (warp < nk) {
    mbar_wait(&bar[warp], staged & 1);
    mark(0);  // staged
    float acc[4][GATES][4];
    slice_product(acc, tile + (size_t)warp * SLICE, wf);
    store_sums(tile, warp, acc);
  }
  ++staged;
  __syncthreads();
  gather_sums(pre, tile, nk);
  mark(1);  // product
}

}  // namespace widebf
