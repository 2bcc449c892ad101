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
// chunks of columns, 64 batch rows at a time, by the TMA
// (lstm_fused_tma.cuh): the decoder's In=1024 x_t tile would not fit in
// shared memory whole. The product runs on the tensor cores (mma.sync
// m16n8k16, bf16 operands, f32 sums), as the Pallas kernels' MXU dots
// take bf16 operands with f32 accumulation.
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
constexpr size_t SMEM_LIMIT = 232448;  // an H100 block's shared memory
static_assert(THREADS == BT * UNITS, "cell layout");
static_assert(THREADS / 32 == (BT / 16) * (ROWS / 8), "one mma tile a warp");

// bf16 row pitch of the weights in shared memory: In + H columns and 8 of
// padding, which puts the 8 rows a fragment load touches on 8 different
// bank quads.
__host__ __device__ inline int weight_pitch(int In, int H) {
  return In + H + 8;
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

// Pre-activation of gate `gate` for the cell thread's (row cb, unit cj):
// the product plus the f32 bias.
__device__ __forceinline__ float preact(const float* red_s, int cb, int gate,
                                        int cj, float bias) {
  return bias + red_s[cb * ROWS + gate * UNITS + cj];
}

}  // namespace fused
