// K5-fwd: the GRU forward recurrence over precomputed input gates, f32
// streams (bf16 streams: gru_fwd_bf16.cu).
//
// Replaces the TPU kernel mlvae_tpu/ops/gru_pallas.py `_fwd_kernel`
// (launched by `_run_fwd`): with gh = h_{t-1} @ W_hh^T + b_hh in torch gate
// order (r, z, n), r = sigmoid(gx_r + gh_r), z = sigmoid(gx_z + gh_z),
// n = tanh(gx_n + r * gh_n) (b_hn inside the reset product, so b_hh is a
// kernel input and cannot be folded into gx) and h_t = (1 - z) * n +
// z * h_{t-1}, with zero initial state, an f32 carry, and `reverse` handled
// by indexing (processing order t = T-1 .. 0, outputs in natural order).
//
// What bounds it on an H100: at B=64, H=512, T=160 the recurrent products
// are 2*B*H*3H*T = 16.1 GFLOP, 0.240 ms at the f32 rate of 67 TFLOP/s
// (0.016 ms at the bf16 tensor-core peak of 989 TFLOP/s), against ~84 MB of
// gx/hs/W_hh traffic in f32 (25 us at 3.35 TB/s): the floor is the
// operations. Every product runs on the CUDA cores in f32 FMAs, so the f32
// floor is this design's. What keeps it far even from that floor is the
// serial dependence between steps: every step needs all of h_{t-1} before
// any of h_t can start, and W_hh (3 MB in f32) does not fit in one SM.
//
// Design, K1-fwd's (lstm_fwd.cu) with three gates: one persistent
// cooperative grid of H/4 blocks. Block k owns UNITS=4 hidden units and
// keeps their r/z/n rows of W_hh in shared memory for the whole sequence
// (gru_common.cuh). h_{t-1} comes straight from hs by the TMA, a box of 32
// columns x 64 rows an mbarrier (rows past B arrive as zeros), 128-byte
// swizzled into one tile, the K slices' first boxes issued first, so that
// a slice's warps start on their first box while the rest land. All 256
// threads take the product: thread (K slice, unit, rows b4 + 16 r) forms
// the three gates of its unit for four rows, each sum over its slice in k
// order from zero; the gate thread (row, unit) adds the four slices' sums
// in order and the bias. It keeps h_{t-1} in registers (batch tiles below
// MAXG; hs above), writes hs, fences it for the next step's copies in
// other blocks and arrives at the split grid barrier; between the arrival
// and the wait it loads the next step's gx. B > 64 runs the 64-row tiles
// in series, the next tile's copies issued as soon as every thread has
// read the tile. The products, the sums and the gate math (its contraction
// pinned as the single-copy design compiled it) are that design's, so the
// outputs are bit-identical to it. Shared memory is 174 KB at H=512 (183
// KB at 528); the H/4 blocks must all be resident, one per SM, which
// limits H to 528 on an H100 (132 SMs).
#include "fwd_timeline.cuh"
#include "gru_common.cuh"

using namespace gru;

namespace {

constexpr int MAXG = 4;  // batch tiles whose gx and h carry stay in registers

size_t fwd_smem_bytes(int H) {
  return sizeof(float) * common_floats(H) + sizeof(uint64_t) * n_boxes(H);
}

// h_t = (1 - z) * n + z * h_{t-1}, its contraction pinned as the
// single-copy design compiled it.
__device__ __forceinline__ float new_state(float z, float n, float h_old) {
  return __fmaf_rn(__fsub_rn(1.0f, z), n, __fmul_rn(z, h_old));
}

bool takes(int T, int B, int H) {
  return H % (UNITS * KSPLIT) == 0 && T >= 1 && B >= 1 &&
         fwd_smem_bytes(H) <= SMEM_LIMIT;
}

__global__ void __launch_bounds__(THREADS, 1)
gru_fwd_kernel(const float* __restrict__ gx, const float* __restrict__ w_hh,
               const float* __restrict__ b_hh, float* hs,
               unsigned int* barrier, int T, int B, int H, int reverse,
               const __grid_constant__ CUtensorMap map_h FWD_TIMELINE_ARG) {
  extern __shared__ __align__(1024) float4 smem4[];
  const int nbox = n_boxes(H);
  float* tile = reinterpret_cast<float*>(smem4);
  float* w_s = tile + (size_t)nbox * BOX;
  float* red_s = w_s + (size_t)H * UNITS * WP;
  uint64_t* mb = reinterpret_cast<uint64_t*>(red_s + KSPLIT * ROWS * RP);
  if (smem_u32(tile) & 1023) __trap();  // the swizzle's 1024-byte atoms

  const int tid = threadIdx.x;
  const int u0 = blockIdx.x * UNITS;
  const int G = GATES * H;
  load_w(w_s, w_hh, u0, H);
  if (tid == 0) {
    for (int i = 0; i < nbox; ++i) mbar_init(&mb[i]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // gate layout: thread -> (batch row, unit), with that unit's hidden-side
  // biases
  const int cb = tid / UNITS;
  const int cj = tid % UNITS;
  float bias[GATES];
#pragma unroll
  for (int q = 0; q < GATES; ++q) bias[q] = b_hh[q * H + u0 + cj];
  __syncthreads();

  const int ntiles = (B + BT - 1) / BT;
  // the gate thread's gx of step s and its h_{t-1}, tiles below MAXG
  float gxv[MAXG][GATES];
  float h_keep[MAXG];
  auto load_gx = [&](int s) {
    const int t = reverse ? T - 1 - s : s;
#pragma unroll
    for (int i = 0; i < MAXG; ++i) {
      const int b = i * BT + cb;
      if (i < ntiles && b < B) {
        const float* gxr = gx + ((size_t)t * B + b) * G + u0 + cj;
#pragma unroll
        for (int q = 0; q < GATES; ++q) gxv[i][q] = gxr[(size_t)q * H];
      }
    }
  };
  load_gx(0);
  FWD_CLOCK;
  const int k_lo = slice_lo(H);
  const int k_hi = k_lo + H / KSPLIT;
  unsigned int staged = 0;  // tiles copied so far: the mbarriers' phase

  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    const int tp = reverse ? t + 1 : t - 1;  // previous processed position
    FWD_BEGIN();
    if (s > 0) {
      // h_{t-1} was written by plain stores of every block: the TMA's
      // async proxy must see them
      if (tid == 0) asm volatile("fence.proxy.async.global;" ::: "memory");
      issue_tile(&map_h, tile, mb, nbox, tp, 0);
    }
    for (int i = 0; i < ntiles; ++i) {
      const int b0 = i * BT;
      float acc[4][GATES];
      if (s > 0) {
        // the slice box by box as they land
        zero_acc(acc);
        for (int kb = k_lo, kend; kb < k_hi; kb = kend) {
          kend = min(k_hi, (kb / BOXC + 1) * BOXC);
          mbar_wait(&mb[kb / BOXC], staged & 1);
          FWD_MARK(FWD_STAGE);
          box_product(acc, tile, w_s, kb, kend);
          FWD_MARK(FWD_PRODUCT);
        }
        ++staged;
      }
      if (i > 0) __syncthreads();  // the last tile's gate math read red_s
      if (s > 0) store_red(red_s, acc);
      __syncthreads();  // red_s written; every thread has read the tile
      FWD_MARK(FWD_PRODUCT);
      if (s > 0 && i + 1 < ntiles)
        issue_tile(&map_h, tile, mb, nbox, tp, b0 + BT);

      const int b = b0 + cb;
      if (b < B) {
        float gh[GATES];
        gate_inputs(gh, red_s, bias, s == 0, cb, cj);
        // gxv[i] and h_keep[i], selected so that they stay in registers
        float g_in[GATES] = {0.0f, 0.0f, 0.0f};
        float h_old = 0.0f;  // h_{t-1}, written by this thread a step ago
#pragma unroll
        for (int ii = 0; ii < MAXG; ++ii)
          if (ii == i) {
#pragma unroll
            for (int q = 0; q < GATES; ++q) g_in[q] = gxv[ii][q];
            h_old = h_keep[ii];
          }
        if (i >= MAXG) {
          const float* gxr = gx + ((size_t)t * B + b) * G + u0 + cj;
#pragma unroll
          for (int q = 0; q < GATES; ++q) g_in[q] = gxr[(size_t)q * H];
          if (s > 0) h_old = hs[((size_t)tp * B + b) * H + u0 + cj];
        }
        if (s == 0) h_old = 0.0f;
        const float r = sigmoid_f(__fadd_rn(g_in[0], gh[0]));
        const float z = sigmoid_f(__fadd_rn(g_in[1], gh[1]));
        const float n = new_gate(g_in[2], r, gh[2]);
        const float h = new_state(z, n, h_old);
#pragma unroll
        for (int ii = 0; ii < MAXG; ++ii)
          if (ii == i) h_keep[ii] = h;
        hs[((size_t)t * B + b) * H + u0 + cj] = h;
      }
      FWD_MARK(FWD_CELL);
    }
    // the next step's copies in other blocks read this step's hs
    asm volatile("fence.proxy.async.global;" ::: "memory");
    grid_arrive(barrier);
    FWD_MARK(FWD_CELL);
    if (s + 1 < T) {
      load_gx(s + 1);  // needs no other block's writes
      FWD_MARK(FWD_OFFCHAIN);
      grid_wait(barrier, (unsigned int)(s + 1) * gridDim.x, 0, THREADS);
      FWD_MARK(FWD_BARRIER);
    }
    FWD_STORE(s, 0);
  }
}

}  // namespace

extern "C" {

const char* mlvae_gru_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The launch plan for H (B does not change it), as gru_common.cuh's
// launch_plan reports it. Returns a cudaError_t.
int mlvae_gru_fwd_plan(int H, int* out) {
  if (!takes(1, 1, H)) return cudaErrorInvalidValue;
  return launch_plan((const void*)gru_fwd_kernel, H, fwd_smem_bytes(H),
                     out);
}

// gx (T,B,3H), w_hh (3H,H) and b_hh (3H) f32; hs (T,B,H) f32 output,
// 16-byte aligned (the TMA reads it); barrier one zeroed counter. H a
// multiple of 16. Returns a cudaError_t. The timing build
// (MLVAE_FWD_TIMELINE) is mlvae_gru_fwd_timeline, which also takes the
// (T, H/4, 8) u64 timeline before the stream.
#ifdef MLVAE_FWD_TIMELINE
int mlvae_gru_fwd_timeline(
#else
int mlvae_gru_fwd(
#endif
    const float* gx, const float* w_hh, const float* b_hh, float* hs,
    unsigned int* barrier, int T, int B, int H,
    int reverse FWD_TIMELINE_ARG, cudaStream_t stream) {
  if (!takes(T, B, H) || reinterpret_cast<uintptr_t>(hs) % 16)
    return cudaErrorInvalidValue;
  CUtensorMap map_h;
  const cudaError_t err = hs_map(&map_h, hs, T, B, H);
  if (err != cudaSuccess) return err;
  void* args[] = {(void*)&gx,      (void*)&w_hh, (void*)&b_hh,
                  (void*)&hs,      (void*)&barrier,
                  (void*)&T,       (void*)&B,    (void*)&H,
                  (void*)&reverse, (void*)&map_h
#ifdef MLVAE_FWD_TIMELINE
                  ,
                  (void*)&timeline
#endif
  };
  return launch_cooperative(gru_fwd_kernel, H / UNITS, THREADS, args,
                            fwd_smem_bytes(H), stream);
}

}  // extern "C"
