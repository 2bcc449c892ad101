// The tensor-core and TMA pieces that the bf16 recurrences share: the fused
// LSTM kernels (lstm_fused_common.cuh, lstm_fused_tma.cuh), the wide K1 on
// bf16 streams (lstm_wide_mma.cuh) and K5 on bf16 streams (gru_mma.cuh).
// mma.sync m16n8k16 with bf16 operands and f32 sums; ldmatrix; 3-D TMA
// copies of boxes 64 columns (128 bytes) wide with the 128-byte swizzle,
// completing on an mbarrier; and the tensor maps behind them.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mbarrier.cuh"

namespace fused {

typedef __nv_bfloat16 bf16;

constexpr int HALF = 64;  // columns of a TMA box: one 128-byte swizzle span

// d += A (16 x 16) * B (16 x 8) on the tensor cores, bf16 operands, f32
// sums, in the PTX fragment layouts of mma.m16n8k16 (lane = 4 * g + t:
// a0 = A[g][2t, 2t+1], a1 = A[g+8][..], a2 = A[g][2t+8, 2t+9], a3 =
// A[g+8][2t+8, ..]; b0 = B[2t, 2t+1][g], b1 = B[2t+8, 2t+9][g]; d0, d1 =
// D[g][2t, 2t+1], d2, d3 = D[g+8][..]), the lower half of each register
// holding the first of its pair.
__device__ __forceinline__ void mma16816(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// ldmatrix: four 8x8 bf16 matrices from shared memory, lanes 8m .. 8m+7
// giving the row addresses of matrix m (16-byte aligned); .trans gives
// each its transpose, which turns a row-major [k][n] tile into the k16 x n8
// B fragments of mma.m16n8k16.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned int a =
      static_cast<unsigned int>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  const unsigned int a =
      static_cast<unsigned int>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

// Element (r, c) of a tile of boxes of ROWS rows x 64 columns, box c / 64
// after box c / 64 - 1, each row 128 bytes with the 16-byte unit u of row r
// at u ^ (r & 7), as the TMA's 128-byte swizzle writes them; an ldmatrix
// row (8 columns from c, a multiple of 8) is one unit, and the 8 rows a
// matrix touches fall on 8 different bank groups. A box must start on
// 1024 bytes (the swizzle's atom of 8 rows).
template <int ROWS>
__device__ __forceinline__ const bf16* swz_at(const bf16* tile, int r,
                                              int c) {
  return tile + (c >> 6) * (ROWS * HALF) + r * HALF +
         ((((c >> 3) & 7) ^ (r & 7)) << 3);
}

// One box of a 3-D bf16 tensor: columns [c0, c0 + 64) (per 64-column half
// `half` on, see tma_half) of rows [b0, b0 + box rows) of slice z, behind
// the TMA descriptor `map` (columns, rows, slices innermost first); rows
// and columns past the tensor's ends arrive as zeros.
struct Chunk {
  const CUtensorMap* map;
  int c0, b0, z;
};

// One TMA copy of the box at column c.c0 + 64 * half into dst, completing
// the mbarrier `bar` (which counts the whole box's bytes, zeros included).
__device__ __forceinline__ void tma_half(bf16* dst, const Chunk& c, int half,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(smem_u32(dst)),
      "l"(c.map), "r"(c.c0 + half * HALF), "r"(c.b0), "r"(c.z),
      "r"(smem_u32(bar))
      : "memory");
}

// A TMA descriptor of the 3-D bf16 tensor `base`: `cols` columns of rows
// `pitch` elements apart (pitch >= cols; the columns past `cols` read as
// zeros), `rows` rows a slice, `slices` slices, dense; boxes of 64
// columns x `box_rows` rows of one slice, 128-byte swizzled. The base and
// the pitch in bytes must be multiples of 16.
inline cudaError_t tensor_map(CUtensorMap* map, const void* base, int cols,
                              int pitch, int rows, int slices,
                              int box_rows) {
  PFN_cuTensorMapEncodeTiled_v12000 encode;
  const cudaError_t err = tensor_map_encoder(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)slices};
  const cuuint64_t strides[2] = {(cuuint64_t)pitch * sizeof(bf16),
                                 (cuuint64_t)pitch * rows * sizeof(bf16)};
  const cuuint32_t box[3] = {HALF, (cuuint32_t)box_rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace fused
