// K5-fwd on bf16 streams: the GRU forward recurrence over precomputed input
// gates with its recurrent product on the tensor cores (the gate-3 GRU
// VAE's AMP step: three layers at H=512).
//
// Replaces the TPU kernel mlvae_tpu/ops/gru_pallas.py `_fwd_kernel`
// (launched by `_run_fwd`) under AMP: gh = h_{t-1} @ W_hh^T + b_hh as one
// bf16 MXU pass with f32 sums (`h.astype(whh_t_ref.dtype)`), in torch
// gate order (r, z, n), r = sigmoid(gx_r + gh_r), z = sigmoid(gx_z +
// gh_z), n = tanh(gx_n + r * gh_n) (b_hn inside the reset product, so b_hh
// is a kernel input), h_t = (1 - z) * n + z * h_{t-1} with an f32 carry;
// hs written in bf16 and the exact f32 carry beside it in hs32. Zero
// initial state; `reverse` by indexing (outputs stay in natural time
// order). gx, W_hh and hs are bf16; b_hh and hs32 f32.
//
// What bounds it on an H100: at B=64, H=512, T=160 the recurrent products
// are 2*B*H*3H*T = 16.1 GFLOP (16 us at 989 TFLOP/s of bf16 tensor cores)
// against about 65 MB of gx/hs/hs32/W_hh traffic (19 us at 3.35 TB/s):
// the floor is the bytes, by a little. What keeps the kernel far from it
// is the chain of T dependent steps: each needs all of h_{t-1}, 64 KB of
// bf16 for a 64-row tile, from every block, so every block reads its rows
// of it from L2 each step and the grid meets at a barrier each step.
//
// Design (gru_mma.cuh): W_hh's 24 rows of a group of 8 units stay in
// registers as mma B fragments, so shared memory holds only the block's
// h_{t-1} rows, copied by the TMA from hs[t_prev] in 64-column boxes, one
// mbarrier each; each warp starts its part of the K columns as its boxes
// land, and the parts' sums meet in shared memory. The cell thread reads
// its own f32 h_{t-1} from hs32, where it wrote it a step earlier, and
// writes hs (bf16) and hs32. There is no f32 h buffer: the next step reads
// hs itself. The writers fence hs for the async proxy before the split
// grid barrier's arrival; the next step's gx and h_{t-1} for the first
// tile are loaded between the arrival and the wait. B > 64 runs the 64-row
// tiles in series.
#include "fwd_timeline.cuh"
#include "gru_mma.cuh"

using namespace grubf;

namespace {

// The h_{t-1} tile (its boxes), the K parts' sums, an mbarrier a box.
size_t fwd_smem_bytes(int H) {
  return (size_t)n_boxes(H) * (BOX_BYTES + sizeof(uint64_t)) +
         PART_FLOAT2 * sizeof(float2);
}

// The cell thread's inputs of one step: gx of its unit's three gates, and
// its f32 h_{t-1}.
struct CellIn {
  float gx[GATES];
  float h_prev;
};

__global__ void __launch_bounds__(THREADS, 1)
gru_fwd_bf16_kernel(const bf16* __restrict__ gx,
                    const bf16* __restrict__ w_hh,
                    const float* __restrict__ b_hh, bf16* hs, float* hs32,
                    unsigned int* barrier, int Tn, int B, int H, int reverse,
                    const __grid_constant__ CUtensorMap map_h
                        FWD_TIMELINE_ARG) {
  extern __shared__ __align__(1024) float4 smem4[];
  const int nb = n_boxes(H);
  bf16* tile = reinterpret_cast<bf16*>(smem4);
  float2* part = reinterpret_cast<float2*>(tile + (size_t)nb * RB * BOX);
  uint64_t* bar = reinterpret_cast<uint64_t*>(part + PART_FLOAT2);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int u0 = (blockIdx.x / SPLIT) * UNITS;
  const int r0 = (blockIdx.x % SPLIT) * RB;  // the block's rows of a tile
  const int G = GATES * H;
  if (tid == 0) {
    if (smem_u32(tile) & 1023) __trap();  // the swizzle's 1024-byte atoms
    for (int i = 0; i < nb; ++i) mbar_init(&bar[i]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  int lo, hi;
  k_part(H, warp / MT, lo, hi);
  uint32_t wf[KMAX][GATES][2];
  load_w_frags(wf, w_hh, H, u0, lo, hi);
  const int cb = cell_row();
  const int cu = u0 + cell_unit();  // the cell thread's unit
  float bias[GATES];
#pragma unroll
  for (int q = 0; q < GATES; ++q) bias[q] = b_hh[q * H + cu];
  __syncthreads();
  const int ntiles = (B + BT - 1) / BT;

  auto load_in = [&](int s, int i, CellIn& in) {
    const int t = reverse ? Tn - 1 - s : s;
    const int tp = reverse ? t + 1 : t - 1;
    const int b = i * BT + r0 + cb;
    if (b >= B) return;
    const bf16* g = gx + ((size_t)t * B + b) * G + cu;
#pragma unroll
    for (int q = 0; q < GATES; ++q)
      in.gx[q] = __bfloat162float(g[(size_t)q * H]);
    // h_{t-1} was written by this same thread one step earlier
    in.h_prev = s > 0 ? hs32[((size_t)tp * B + b) * H + cu] : 0.0f;
  };

  FWD_CLOCK;
  auto mark = [&](int k) { FWD_MARK(k ? FWD_PRODUCT : FWD_STAGE); };
  auto nothing = [] {};
  CellIn in0;
  load_in(0, 0, in0);
  unsigned int staged = 0, arrivals = 0;
  for (int s = 0; s < Tn; ++s) {
    FWD_BEGIN();
    const int t = reverse ? Tn - 1 - s : s;
    const int tp = reverse ? t + 1 : t - 1;  // previous processed position
    for (int i = 0; i < ntiles; ++i) {
      const int b = i * BT + r0 + cb;
      float pre[GATES] = {};
      if (s > 0)
        recurrent_product(pre, tile, part, bar, &map_h, wf, lo, hi, nb, tp,
                          i * BT + r0, staged, mark, nothing);
      CellIn in = in0;
      if (i > 0) load_in(s, i, in);
      FWD_MARK(FWD_INPUT);
      if (b < B) {
        const float r = sigmoid_f(in.gx[0] + (pre[0] + bias[0]));
        const float z = sigmoid_f(in.gx[1] + (pre[1] + bias[1]));
        const float n = tanhf(in.gx[2] + r * (pre[2] + bias[2]));
        const float h = (1.0f - z) * n + z * in.h_prev;
        const size_t o = ((size_t)t * B + b) * H + cu;
        hs32[o] = h;
        hs[o] = __float2bfloat16_rn(h);
      }
      FWD_MARK(FWD_CELL);
      if (i + 1 < ntiles) __syncthreads();  // the tile is free for copies
    }
    // the next step's TMA copies in every block read hs[t]
    asm volatile("fence.proxy.async.global;" ::: "memory");
    grid_arrive(barrier);
    ++arrivals;
    if (s + 1 < Tn) {
      load_in(s + 1, 0, in0);  // needs no other block's writes
      grid_wait(barrier, arrivals * gridDim.x, 0, THREADS);
    }
    FWD_MARK(FWD_BARRIER);
    FWD_STORE(s, 0);
  }
}

}  // namespace

extern "C" {

const char* mlvae_gru_fwd_bf16_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The launch plan for H (B does not change it): out[0] blocks, [1]
// threads, [2] dynamic shared memory bytes, [3] resident blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), [4] TMA boxes of the
// h_{t-1} tile (one mbarrier each), [5] rows of a batch tile a block, [6]
// registers a thread, [7] local memory bytes a thread (spills). Returns a
// cudaError_t.
int mlvae_gru_fwd_bf16_plan(int H, int* out) {
  if (!takes(1, 1, H)) return cudaErrorInvalidValue;
  const size_t smem = fwd_smem_bytes(H);
  cudaError_t err = cudaFuncSetAttribute(
      gru_fwd_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int occ = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &occ, gru_fwd_bf16_kernel, THREADS, smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, gru_fwd_bf16_kernel);
  if (err != cudaSuccess) return err;
  out[0] = grid_blocks(H);
  out[1] = THREADS;
  out[2] = static_cast<int>(smem);
  out[3] = occ;
  out[4] = n_boxes(H);
  out[5] = RB;
  out[6] = attr.numRegs;
  out[7] = static_cast<int>(attr.localSizeBytes);
  return cudaSuccess;
}

// gx (T,B,3H) and w_hh (3H,H) bf16, b_hh (3H) f32 inputs; hs (T,B,H) bf16
// and hs32 (T,B,H) f32 outputs, hs 16-byte aligned (the TMA reads it);
// barrier one zeroed counter. H a multiple of 16 up to 528. Returns a
// cudaError_t. The timing build (MLVAE_FWD_TIMELINE) is
// mlvae_gru_fwd_bf16_timeline, which also takes the (T, blocks, 8) u64
// timeline before the stream.
#ifdef MLVAE_FWD_TIMELINE
int mlvae_gru_fwd_bf16_timeline(
#else
int mlvae_gru_fwd_bf16(
#endif
    const bf16* gx, const bf16* w_hh, const float* b_hh, bf16* hs,
    float* hs32, unsigned int* barrier, int T, int B, int H,
    int reverse FWD_TIMELINE_ARG, cudaStream_t stream) {
  if (!takes(T, B, H) || reinterpret_cast<uintptr_t>(hs) % 16)
    return cudaErrorInvalidValue;
  CUtensorMap map_h;
  const cudaError_t err = fused::tensor_map(&map_h, hs, H, H, B, T, RB);
  if (err != cudaSuccess) return err;
  void* args[] = {(void*)&gx, (void*)&w_hh,    (void*)&b_hh,
                  (void*)&hs, (void*)&hs32,    (void*)&barrier,
                  (void*)&T,  (void*)&B,       (void*)&H,
                  (void*)&reverse, (void*)&map_h
#ifdef MLVAE_FWD_TIMELINE
                  ,
                  (void*)&timeline
#endif
  };
  return launch_cooperative(gru_fwd_bf16_kernel, grid_blocks(H), THREADS,
                            args, fwd_smem_bytes(H), stream);
}

}  // extern "C"
