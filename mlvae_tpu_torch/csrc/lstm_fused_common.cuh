// Shared pieces of the fused-projection LSTM kernels (K3/K4-fwd in
// lstm_fused_fwd.cu, K3-bwd in lstm_fused_bwd.cu, K4-bwd in
// lstm_semi_bwd.cu, K7b in lstm_unroll_fused_fwd.cu): bf16 streams, f32
// carries and sums.
//
// Layout, as K1's (lstm_fwd.cu, lstm_bwd.cu): one persistent cooperative
// grid of H/4 blocks; block k owns UNITS=4 hidden units, i.e. ROWS=16 gate
// rows (row q = gate * 4 + unit), and keeps those rows of [W_ih | W_hh] in
// shared memory as bf16, one row of In + H columns after another. The gate
// pre-activations of a step are one product over the concatenated input
// [x_t | h_{t-1}] of In + H columns, so the input projection never reaches
// memory. x_t and h_{t-1} (the bf16 hs of the step before) are staged in
// chunks of KC columns, 64 batch rows at a time, as bf16 rows: the
// decoder's In=1024 x_t tile would not fit in shared memory whole. The
// product runs on the tensor cores (mma.sync m16n8k16, bf16 operands, f32
// sums), as the Pallas kernels' MXU dots take bf16 operands with f32
// accumulation: the block's 64 x 16 output is eight 16 x 8 tiles, one per
// warp, each warp walking the chunk's columns 16 at a time. K7b stages
// its chunks so; K3/K4-fwd and the backwards stage theirs with the TMA
// (lstm_fused_tma.cuh) and run the same mma operations in the same order.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_sync.cuh"
#include "mma_tma.cuh"

namespace fused {

constexpr int UNITS = 4;             // hidden units owned by one block
constexpr int GATES = 4;             // i, f, g, o
constexpr int ROWS = GATES * UNITS;  // gate rows owned by one block
constexpr int BT = 64;               // batch rows per tile
constexpr int THREADS = 256;         // eight warps
constexpr int KC = 256;              // columns per staged chunk
constexpr int LDT = KC + 8;          // bf16 row pitch of the staged chunk
constexpr int RED = 4;               // lanes that sum one row's partials
constexpr size_t SMEM_LIMIT = 232448;  // an H100 block's shared memory
static_assert(THREADS == BT * UNITS, "cell layout");
static_assert(THREADS / 32 == (BT / 16) * (ROWS / 8), "one mma tile a warp");
static_assert(KC == (THREADS / 32) * 4 * 8,
              "column phase: four 8-column tiles a warp");
static_assert(RED == UNITS, "a reducing lane ends with its own unit");

// bf16 row pitch of the weights in shared memory: In + H columns and 8 of
// padding, which puts the 8 rows a fragment load touches on 8 different
// bank quads.
__host__ __device__ inline int weight_pitch(int In, int H) {
  return In + H + 8;
}

// Stage columns [c0, c0 + width) of rows [0, nb) of a bf16 matrix with row
// stride `stride` as tile[b][k] (row pitch LDT), zero for rows [nb, BT) and
// for columns [width, KC). width and c0 are multiples of 8 and the rows
// 16-byte aligned: one 16-byte load moves 8 columns of one row, a warp one
// 512-byte row. Reads go through L2 (__ldcg): hs is written by other
// blocks during the launch. Each thread issues all its loads before its
// first store, so their latencies overlap.
__device__ __forceinline__ void stage_bf16(bf16* tile, const bf16* src,
                                           size_t stride, int c0, int width,
                                           int nb) {
  constexpr int PER_ROW = KC / 8;
  constexpr int ITERS = BT * PER_ROW / THREADS;
  uint4 v[ITERS];
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int u = it * THREADS + threadIdx.x;
    const int b = u / PER_ROW;
    const int k = 8 * (u % PER_ROW);
    v[it] = make_uint4(0u, 0u, 0u, 0u);
    if (b < nb && k < width)
      v[it] = __ldcg(reinterpret_cast<const uint4*>(
          src + (size_t)b * stride + c0 + k));
  }
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int u = it * THREADS + threadIdx.x;
    *reinterpret_cast<uint4*>(tile + (size_t)(u / PER_ROW) * LDT +
                              8 * (u % PER_ROW)) = v[it];
  }
}

// This block's rows of [W_ih | W_hh] (In + H columns) into w_s[q][k] (row
// pitch weight_pitch), bf16 as they are; the padding is zero.
__device__ __forceinline__ void load_weights(bf16* w_s, const bf16* w_ih,
                                             const bf16* w_hh, int In, int H,
                                             int u0) {
  const int K = In + H;
  const int LDW = weight_pitch(In, H);
  for (int idx = threadIdx.x; idx < ROWS * LDW; idx += THREADS) {
    const int k = idx % LDW;
    const int q = idx / LDW;
    const size_t row = (size_t)(q / UNITS) * H + u0 + q % UNITS;
    w_s[idx] = k < In  ? w_ih[row * In + k]
               : k < K ? w_hh[row * H + (k - In)]
                       : __float2bfloat16_rn(0.0f);
  }
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += the chunk's rows 16 mi .. (A) times the weight rows 8 ni .. (B,
// k = column), 16 columns at a time.
__device__ __forceinline__ void mma_chunk(float (&c)[4], const bf16* tile,
                                          const bf16* w_s, int LDW, int wcol,
                                          int width, int mi, int ni) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const bf16* a = tile + (size_t)(mi * 16 + g) * LDT + 2 * t;
  const bf16* b = w_s + (size_t)(ni * 8 + g) * LDW + wcol + 2 * t;
  for (int k0 = 0; k0 < width; k0 += 16)
    mma16816(c, ld32(a + k0), ld32(a + 8 * LDT + k0), ld32(a + k0 + 8),
             ld32(a + 8 * LDT + k0 + 8), ld32(b + k0), ld32(b + k0 + 8));
}

// c += rows [0, nb) of the bf16 matrix src (row stride `cols`) times the
// weight columns [wcol, wcol + cols), staged KC columns at a time; each
// chunk starts with __syncthreads (the tile is free again). A chunk of
// width w runs to the next multiple of 16; the columns past w are zero in
// the tile.
__device__ __forceinline__ void chunked_product(float (&c)[4], bf16* tile,
                                                const bf16* w_s, int LDW,
                                                const bf16* src, int cols,
                                                int wcol, int nb, int mi,
                                                int ni) {
  for (int c0 = 0; c0 < cols; c0 += KC) {
    const int width = min(KC, cols - c0);
    __syncthreads();
    stage_bf16(tile, src, cols, c0, width, nb);
    __syncthreads();
    mma_chunk(c, tile, w_s, LDW, wcol + c0, width, mi, ni);
  }
}

// The warp's 16 x 8 accumulator tile into red_s[b][q], then __syncthreads.
__device__ __forceinline__ void store_preacts(float* red_s,
                                              const float (&c)[4], int mi,
                                              int ni) {
  const int lane = threadIdx.x & 31;
  const int r = mi * 16 + (lane >> 2);
  const int q = ni * 8 + 2 * (lane & 3);
  red_s[r * ROWS + q] = c[0];
  red_s[r * ROWS + q + 1] = c[1];
  red_s[(r + 8) * ROWS + q] = c[2];
  red_s[(r + 8) * ROWS + q + 1] = c[3];
  __syncthreads();
}

// Pre-activation of gate `gate` for the cell thread's (row cb, unit cj):
// the product plus the f32 bias.
__device__ __forceinline__ float preact(const float* red_s, int cb, int gate,
                                        int cj, float bias) {
  return bias + red_s[cb * ROWS + gate * UNITS + cj];
}

}  // namespace fused
