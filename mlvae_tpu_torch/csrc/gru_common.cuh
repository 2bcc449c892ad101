// Shared pieces of the GRU recurrence kernels (K5-fwd in gru_fwd.cu, K5-bwd
// in gru_bwd.cu): the block layout, K1's with three gates, and the
// conversions between the stream dtype (f32 or bf16) and the f32 the
// kernels compute in.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "grid_sync.cuh"

namespace gru {

typedef __nv_bfloat16 bf16;

constexpr int UNITS = 4;                  // hidden units owned by one block
constexpr int GATES = 3;                  // r, z, n
constexpr int ROWS = GATES * UNITS;       // gate rows owned by one block
constexpr int BT = 64;                    // batch rows per tile
constexpr int KSPLIT = 4;                 // the product's K split four ways
constexpr int THREADS = 256;
// the product's 4x4 register tiles: (K slice, gate, 4 batch rows) for 192
// threads; the gate update takes all 256, (batch row, unit)
constexpr int PRODUCT_THREADS = KSPLIT * GATES * (BT / 4);
static_assert(PRODUCT_THREADS <= THREADS, "product layout");
static_assert(THREADS == BT * UNITS, "gate-update layout");

template <typename S>
constexpr bool is_bf16 = std::is_same<S, bf16>::value;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
// v as a stream of the pointer's dtype holds it, widened back to f32
__device__ __forceinline__ float rounded(float v, float*) { return v; }
__device__ __forceinline__ float rounded(float v, bf16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

}  // namespace gru
