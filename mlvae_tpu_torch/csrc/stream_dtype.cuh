// The stream dtypes of a kernel that takes f32 or bf16 streams (the wide K1
// builds): a stream value widened to f32, an f32 value stored in the
// stream's dtype (round to nearest even), an f32 value as the stream's
// dtype holds it, and four consecutive stream values widened at once. A
// bf16 value widens to f32 exactly; for f32 every helper is the identity.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace stream_dtype {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// v as a stream of the pointer's dtype holds it, widened back to f32
__device__ __forceinline__ float rounded(float v, const float*) { return v; }
__device__ __forceinline__ float rounded(float v, const bf16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// p[0 .. 3] widened: one 16-byte load in f32, one 8-byte load in bf16 (p
// aligned to four elements)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

}  // namespace stream_dtype
