// Shared pieces of the persistent recurrence kernels (K1 in lstm_fwd.cu and
// lstm_bwd.cu, K3/K4 through lstm_fused_common.cuh, K5 in gru_fwd.cu and
// gru_bwd.cu): the step barrier across the grid (and, for K1-fwd, K3/K4-fwd,
// K3-bwd and K4-bwd, the same barrier split in an arrival and a wait), the
// cooperative launch that makes it safe, and the logistic function they
// all apply.
#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// Every block arrives once per barrier; barrier n ends when the counter
// reaches n * gridDim.x. The counter is zeroed by the wrapper for every
// launch, so the barrier's whole state belongs to that launch. The block's
// writes before the first __syncthreads are published by thread 0's
// release (GPU scope); its acquire while polling and the second
// __syncthreads make every block's writes visible to all of this block's
// threads. It orders memory as cooperative_groups' grid.sync() does.
__device__ __forceinline__ void grid_barrier(unsigned int* count,
                                             unsigned int target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(count),
                 "r"(1u)
                 : "memory");
    unsigned int seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                   : "=r"(seen)
                   : "l"(count)
                   : "memory");
    } while (seen < target);
  }
  __syncthreads();
}

// grid_barrier split in two, so that a block can run work that needs no
// other block's writes between its arrival and its wait (K1-fwd, K3-bwd,
// K4-bwd). grid_arrive (every thread of the block) publishes the block's
// writes before it: thread 0's release after __syncthreads. grid_wait
// returns once every block has arrived `target / gridDim.x` times, with
// their published writes visible to the threads that call it: thread 0
// polls with acquire, then named barrier `bar` joins the `nthreads`
// callers (thread 0 among them; a multiple of 32). Writes made between the
// two are not published by this barrier.
__device__ __forceinline__ void grid_arrive(unsigned int* count) {
  __syncthreads();
  if (threadIdx.x == 0)
    asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(count),
                 "r"(1u)
                 : "memory");
}

// grid_arrive for part of the block (K3/K4-fwd's warps 0-3): the
// `nthreads` threads that call it (thread 0 among them; a multiple of 32)
// join on named barrier `bar`, then thread 0's release publishes their
// writes.
__device__ __forceinline__ void grid_arrive_by(unsigned int* count, int bar,
                                               int nthreads) {
  asm volatile("bar.sync %0, %1;" ::"r"(bar), "r"(nthreads) : "memory");
  if (threadIdx.x == 0)
    asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(count),
                 "r"(1u)
                 : "memory");
}

__device__ __forceinline__ void grid_wait(unsigned int* count,
                                          unsigned int target, int bar,
                                          int nthreads) {
  if (threadIdx.x == 0) {
    unsigned int seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                   : "=r"(seen)
                   : "l"(count)
                   : "memory");
    } while (seen < target);
  }
  asm volatile("bar.sync %0, %1;" ::"r"(bar), "r"(nthreads) : "memory");
}

// Launch `kernel` as one cooperative grid with `smem` bytes of dynamic
// shared memory. cudaLaunchCooperativeKernel refuses a grid whose blocks
// cannot all be resident at once (the barrier above would deadlock);
// every error comes back as a cudaError_t for the wrapper to raise.
template <typename Kernel>
inline cudaError_t launch_cooperative(Kernel* kernel, int blocks,
                                      int threads, void** args, size_t smem,
                                      cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks),
                                    dim3(threads), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
