// Shared pieces of the f32 GRU recurrence kernels (K5-fwd in gru_fwd.cu,
// K5-bwd in gru_bwd.cu): the block layout (K1's with three gates), the TMA
// copy of h_{t-1} from hs, the recurrent product of a 64-row batch tile and
// the gate math both kernels run. K5 on bf16 streams has builds of its own
// (gru_mma.cuh).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_sync.cuh"
#include "mbarrier.cuh"

namespace gru {

constexpr int UNITS = 4;                  // hidden units owned by one block
constexpr int GATES = 3;                  // r, z, n
constexpr int ROWS = GATES * UNITS;       // gate rows owned by one block
constexpr int BT = 64;                    // batch rows per tile
constexpr int KSPLIT = 4;                 // the product's K split four ways
constexpr int THREADS = 256;
constexpr int BOXC = 32;                  // columns of a TMA box: 128 bytes
constexpr int BOX = BT * BOXC;            // floats of a box (8 KB)
constexpr int WP = 4;                     // w_s floats a (k, unit): r, z, n, 0
constexpr int RP = BT + 8;                // row pitch of red_s
constexpr size_t SMEM_LIMIT = 232448;     // an H100 block's shared memory
// the product's register tiles: thread -> (K slice tid / 64, unit tid % 4,
// batch rows b4 + 16 r for b4 = (tid / 4) % 16), that unit's three gates;
// the gate math: thread -> (batch row tid / 4, unit tid % 4)
static_assert(THREADS == KSPLIT * UNITS * (BT / 4), "product layout");
static_assert(THREADS == BT * UNITS, "gate layout");

__host__ __device__ inline int n_boxes(int H) {
  return (H + BOXC - 1) / BOXC;
}

// f32 of the h_{t-1} tile [box][BT][BOXC], W_hh's rows [k][unit][WP] and
// the split-K sums red_s [KSPLIT][ROWS][RP]; the boxes' mbarriers follow.
__host__ __device__ inline size_t common_floats(int H) {
  return (size_t)n_boxes(H) * BOX + (size_t)H * UNITS * WP +
         (size_t)KSPLIT * ROWS * RP;
}

// Offset of element (b, k) in the tile: box k / 32, row b of 128 bytes,
// 16-byte unit (k / 4) % 8 at that unit ^ (b % 8), as the TMA's 128-byte
// swizzle writes it.
__device__ __forceinline__ int tile_off(int b, int k) {
  return (k >> 5) * BOX + b * BOXC + ((((k >> 2) & 7) ^ (b & 7)) << 2) +
         (k & 3);
}

// This block's W_hh rows as w_s[k][unit][gate] (one float4 = the three
// gates of one unit at one k, and a zero).
__device__ __forceinline__ void load_w(float* w_s, const float* w_hh,
                                       int u0, int H) {
  for (int idx = threadIdx.x; idx < H * UNITS * WP; idx += THREADS) {
    const int g = idx % WP;
    const int j = (idx / WP) % UNITS;
    const int k = idx / (WP * UNITS);
    w_s[idx] = g < GATES ? w_hh[(size_t)(g * H + u0 + j) * H + k] : 0.0f;
  }
}

// Thread 0: rows [b0, b0 + 64) of hs at position tp into the tile, a box of
// 32 columns an mbarrier, the K slices' first boxes first. Where this
// launch wrote those rows (K5-fwd), its writers and thread 0 fence them
// for the TMA's async proxy first.
__device__ __forceinline__ void issue_tile(const CUtensorMap* map,
                                           float* tile, uint64_t* mb,
                                           int nbox, int tp, int b0) {
  if (threadIdx.x != 0) return;
  const int per = (nbox + KSPLIT - 1) / KSPLIT;  // boxes a slice, at most
  for (int q = 0; q < per; ++q)
    for (int ks = 0; ks < KSPLIT; ++ks) {
      const int j = ks * per + q;
      if (j >= nbox) continue;
      mbar_expect(&mb[j], BOX * sizeof(float));
      asm volatile(
          "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
          "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(
              smem_u32(tile + (size_t)j * BOX)),
          "l"(map), "r"(j * BOXC), "r"(b0), "r"(tp), "r"(smem_u32(&mb[j]))
          : "memory");
    }
}

// The K columns [k_lo, k_hi) of this thread's slice: each product's sum
// runs over them in k order, from zero.
__device__ __forceinline__ int slice_lo(int H) {
  return (threadIdx.x / (THREADS / KSPLIT)) * (H / KSPLIT);
}

__device__ __forceinline__ void zero_acc(float (&acc)[4][GATES]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int g = 0; g < GATES; ++g) acc[r][g] = 0.0f;
}

// h_{t-1} @ W_hh^T over the landed columns [kb, kend) of one box of the
// staged tile, added to acc[r][gate] (rows b4 + 16 r, this thread's unit)
// in k order. The recurrences walk their slice box by box, waiting for
// each box's mbarrier first:
//   for (kb = slice_lo(H); kb < slice_lo(H) + H / KSPLIT; kb = kend)
//     kend = min(slice end, (kb / BOXC + 1) * BOXC), wait, box_product.
__device__ __forceinline__ void box_product(float (&acc)[4][GATES],
                                            const float* tile,
                                            const float* w_s, int kb,
                                            int kend) {
  const int tid = threadIdx.x;
  const int j = tid % UNITS;
  const int b4 = (tid / UNITS) % (BT / 4);
  const float4* w4 = reinterpret_cast<const float4*>(w_s) + j;
  const int sw = b4 & 7;  // the swizzle of rows b4 + 16 r
  const float* tb = tile + (size_t)(kb / BOXC) * BOX + b4 * BOXC;
#pragma unroll 4
  for (int k = kb; k < kend; k += 4) {
    const int u = (((k >> 2) & 7) ^ sw) << 2;
    float hb[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float4 v =
          *reinterpret_cast<const float4*>(tb + r * 16 * BOXC + u);
      hb[r][0] = v.x;
      hb[r][1] = v.y;
      hb[r][2] = v.z;
      hb[r][3] = v.w;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float4 wv = w4[(size_t)(k + c) * UNITS];
      const float wg[GATES] = {wv.x, wv.y, wv.z};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int g = 0; g < GATES; ++g)
          acc[r][g] = fmaf(hb[r][c], wg[g], acc[r][g]);
    }
  }
}

// acc into red_s [K slice][gate row][row].
__device__ __forceinline__ void store_red(float* red_s,
                                          const float (&acc)[4][GATES]) {
  const int tid = threadIdx.x;
  const int ks = tid / (THREADS / KSPLIT);
  const int j = tid % UNITS;
  const int b4 = (tid / UNITS) % (BT / 4);
#pragma unroll
  for (int g = 0; g < GATES; ++g)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      red_s[((size_t)ks * ROWS + g * UNITS + j) * RP + b4 + 16 * r] =
          acc[r][g];
}

// gh = h_{t-1} @ W_hh^T + b_hh of row cb, unit cj: the four K slices'
// sums in slice order from zero (none where h_{t-1} = 0), then the bias.
__device__ __forceinline__ void gate_inputs(float (&gh)[GATES],
                                            const float* red_s,
                                            const float (&bias)[GATES],
                                            bool zero_h, int cb, int cj) {
#pragma unroll
  for (int q = 0; q < GATES; ++q) {
    float sum = 0.0f;
    if (!zero_h) {
#pragma unroll
      for (int kk = 0; kk < KSPLIT; ++kk)
        sum = __fadd_rn(
            sum, red_s[((size_t)kk * ROWS + q * UNITS + cj) * RP + cb]);
    }
    gh[q] = __fadd_rn(sum, bias[q]);
  }
}

// n = tanh(gx_n + r * gh_n), its contraction pinned as the single-copy
// design compiled it.
__device__ __forceinline__ float new_gate(float gx_n, float r, float hn) {
  return tanhf(__fmaf_rn(r, hn, gx_n));
}

// The 3-D tensor map over hs (T, B, H) f32: boxes of 32 columns x 64 rows
// of one position, zeros past B and H, 128-byte swizzled.
inline cudaError_t hs_map(CUtensorMap* map, const float* hs, int T, int B,
                          int H) {
  PFN_cuTensorMapEncodeTiled_v12000 encode;
  cudaError_t err = tensor_map_encoder(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[3] = {(cuuint64_t)H, (cuuint64_t)B, (cuuint64_t)T};
  const cuuint64_t strides[2] = {(cuuint64_t)H * sizeof(float),
                                 (cuuint64_t)B * H * sizeof(float)};
  const cuuint32_t box[3] = {BOXC, BT, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(hs),
             dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// What a launch plan reports (the *_plan entry points): out[0] blocks,
// [1] threads, [2] dynamic shared memory bytes, [3] resident blocks an SM,
// [4] TMA boxes of the h_{t-1} tile (one mbarrier each), [5] rows of a
// batch tile, [6] registers a thread, [7] local memory bytes a thread.
inline cudaError_t launch_plan(const void* kernel, int H, size_t smem,
                               int* out) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int occ = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, THREADS,
                                                      smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  out[0] = H / UNITS;
  out[1] = THREADS;
  out[2] = static_cast<int>(smem);
  out[3] = occ;
  out[4] = n_boxes(H);
  out[5] = BT;
  out[6] = attr.numRegs;
  out[7] = static_cast<int>(attr.localSizeBytes);
  return cudaSuccess;
}

}  // namespace gru
