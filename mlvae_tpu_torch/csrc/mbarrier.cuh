// mbarriers and tensor maps for the kernels that stage shared memory with
// the Tensor Memory Accelerator (K1-fwd in lstm_fwd.cu; K3/K4-fwd, K3-bwd
// and K4-bwd through lstm_fused_tma.cuh): a TMA copy completes the bytes
// it was given on an mbarrier in shared memory, and its consumers wait on
// that mbarrier's phase.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ unsigned int smem_u32(const void* p) {
  return static_cast<unsigned int>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar,
                                            unsigned int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Until the phase of parity `ph` of `bar` has completed. A wait far past
// any step (2^24 polls) traps: a fault, not a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned int ph) {
  const unsigned int a = smem_u32(bar);
  for (unsigned int n = 0;; ++n) {
    unsigned int done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(a), "r"(ph)
        : "memory");
    if (done) return;
    if (n > (1u << 24)) __trap();
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime, so the
// libraries link nothing more.
inline cudaError_t tensor_map_encoder(PFN_cuTensorMapEncodeTiled_v12000* out) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || !fn)
      return cudaErrorSymbolNotFound;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  *out = encode;
  return cudaSuccess;
}
