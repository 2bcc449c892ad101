// K1-fwd on bf16 streams at every H % 128 == 0 up to 1024: the LSTM forward
// recurrence over precomputed input gates with its recurrent product on the
// tensor cores (LSTM_FC's AMP step: four layers at H=1024; CRDNN_CTC's: its
// first bidirectional layer at H=512, In=7,680).
//
// Replaces the TPU kernel mlvae_tpu/ops/lstm_pallas.py `_fwd_kernel`
// (launched by `_run_fwd`) under AMP: hs[t] = o * tanh(c_t), c_t = f *
// c_{t-1} + i * g, with the gates (i, f, g, o) = gx[t] + h_{t-1} @ W_hh^T
// in torch gate order; `gx_ref[0].astype(f32)`, `h.astype(whh_t_ref.dtype)`
// (bf16) into one bf16 MXU dot with f32 accumulation, f32 carries,
// `h_new.astype(hs_ref.dtype)`. Zero initial state; `reverse` by indexing
// (outputs stay in natural time order). gx, W_hh and hs are bf16, cs f32.
//
// What bounds it on an H100: at B=64, H=1024, T=160 the recurrent products
// are 2*B*H*4H*T = 85.9 GFLOP (87 us at 989 TFLOP/s of bf16 tensor cores)
// against about 147 MB of gx/hs/cs/W_hh traffic (44 us at 3.35 TB/s): the
// floor is the operations. What keeps the kernel far from it is the chain
// of T dependent steps: each needs all of h_{t-1}, 128 KB of bf16 for a
// 64-row tile, from every block, so every block reads it from L2 each step
// (16 MB a step over 128 blocks) and the grid meets at a barrier each step.
//
// Design (lstm_wide_mma.cuh): the f32 wide build's grid, 8 units (32 gate
// rows) a block, H/8 blocks. W_hh's 32 rows stay in registers as mma B
// fragments (a warp holds its K slice's 128 columns), so shared memory
// holds only the h_{t-1} tile: the TMA copies hs[t_prev] in 128-column K
// slices, one mbarrier each, so each warp starts its slice as it lands;
// the warp's 128 mma a step form its slice's 64 x 32 sums, which it writes
// over its own slice; the cell threads add the slices in order and apply
// the cell update (contraction pinned as in the f32 builds) for two units
// a thread, writing hs (bf16) and cs (f32). There is no f32 h buffer: the
// next step reads hs itself. The writers fence hs for the async proxy
// before the split grid barrier's arrival; the next step's gx and c_{t-1}
// for the first tile are loaded between the arrival and the wait. B > 64
// runs the 64-row tiles in series. Shared memory: 128 KB at H=1024.
// Holding W_hh's rows in shared memory instead (64 KB more, read by
// ldmatrix) gave the same bits and saved 1.5 us of 0.77 ms (PERF.md), so
// the registers were kept.
#include "fwd_timeline.cuh"
#include "lstm_wide_mma.cuh"

using namespace widebf;

namespace {

// The h_{t-1} tile (n_slices(H) slices of 64 rows x 128 columns, each
// slice's first half taking its warp's sums), then an mbarrier a slice.
size_t fwd_smem_bytes(int H) {
  return (size_t)n_slices(H) * (SLICE * sizeof(bf16) + sizeof(uint64_t));
}

// The cell thread's inputs of one step: gx of its two units' four gates,
// and their c_{t-1}.
struct CellIn {
  float gx[GATES][2];
  float c_prev[2];
};

__global__ void __launch_bounds__(THREADS, 1)
lstm_fwd_wide_bf16_kernel(const bf16* __restrict__ gx,
                          const bf16* __restrict__ w_hh, bf16* hs,
                          float* cs, unsigned int* barrier, int Tn, int B,
                          int H, int reverse,
                          const __grid_constant__ CUtensorMap map_h
                              FWD_TIMELINE_ARG) {
  extern __shared__ __align__(1024) float4 smem4[];
  bf16* tile = reinterpret_cast<bf16*>(smem4);
  const int nk = n_slices(H);
  uint64_t* bar = reinterpret_cast<uint64_t*>(tile + (size_t)nk * SLICE);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int u0 = blockIdx.x * UNITS;
  const int G = GATES * H;
  if (tid == 0) {
    if (smem_u32(tile) & 1023) __trap();  // the swizzle's 1024-byte atoms
    for (int i = 0; i < nk; ++i) mbar_init(&bar[i]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  uint32_t wf[KSTEPS][GATES][2];
  if (warp < nk) load_w_frags(wf, w_hh, H, u0, warp);
  __syncthreads();

  // cell layout (the product's fragment layout): row cb of the tile,
  // units cu and cu + 1
  const int cb = 8 * warp + (lane >> 2);
  const int cu = 2 * (lane & 3);
  const int ntiles = (B + BT - 1) / BT;

  auto load_in = [&](int s, int b0, CellIn& in) {
    const int t = reverse ? Tn - 1 - s : s;
    const int tp = reverse ? t + 1 : t - 1;
    const int b = b0 + cb;
    if (b >= B) return;
    const bf16* g = gx + ((size_t)t * B + b) * G + u0 + cu;
#pragma unroll
    for (int q = 0; q < GATES; ++q) {
      const float2 v = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(g + (size_t)q * H));
      in.gx[q][0] = v.x;
      in.gx[q][1] = v.y;
    }
    // c_{t-1} was written by this same thread one step earlier
    const float2 c = s > 0 ? *reinterpret_cast<const float2*>(
                                 cs + ((size_t)tp * B + b) * H + u0 + cu)
                           : make_float2(0.0f, 0.0f);
    in.c_prev[0] = c.x;
    in.c_prev[1] = c.y;
  };

  FWD_CLOCK;
  auto mark = [&](int k) { FWD_MARK(k ? FWD_PRODUCT : FWD_STAGE); };
  CellIn in0;
  load_in(0, 0, in0);
  unsigned int staged = 0, arrivals = 0;
  for (int s = 0; s < Tn; ++s) {
    FWD_BEGIN();
    const int t = reverse ? Tn - 1 - s : s;
    const int tp = reverse ? t + 1 : t - 1;  // previous processed position
    for (int i = 0; i < ntiles; ++i) {
      const int b0 = i * BT;
      const int b = b0 + cb;
      float pre[GATES][2] = {};
      if (s > 0)
        recurrent_product(pre, tile, bar, &map_h, wf, nk, tp, b0, staged,
                          mark);
      CellIn in = in0;
      if (i > 0) load_in(s, b0, in);
      FWD_MARK(FWD_INPUT);
      if (b < B) {
        float c[2], h[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float ig = sigmoid_f(__fadd_rn(in.gx[0][e], pre[0][e]));
          const float fg = sigmoid_f(__fadd_rn(in.gx[1][e], pre[1][e]));
          const float gg = tanhf(__fadd_rn(in.gx[2][e], pre[2][e]));
          const float og = sigmoid_f(__fadd_rn(in.gx[3][e], pre[3][e]));
          // f * c_{t-1} rounded, then i * g + it, as the f32 builds
          c[e] = __fmaf_rn(ig, gg, __fmul_rn(fg, in.c_prev[e]));
          h[e] = __fmul_rn(og, tanhf(c[e]));
        }
        const size_t o = ((size_t)t * B + b) * H + u0 + cu;
        *reinterpret_cast<float2*>(cs + o) = make_float2(c[0], c[1]);
        *reinterpret_cast<__nv_bfloat162*>(hs + o) =
            __floats2bfloat162_rn(h[0], h[1]);
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

const char* mlvae_lstm_fwd_wide_bf16_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The launch plan for H (B does not change it): out[0] blocks, [1]
// threads, [2] dynamic shared memory bytes, [3] resident blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), [4] K slices of the
// h_{t-1} tile (one mbarrier each), [5] columns a slice, [6] registers a
// thread, [7] local memory bytes a thread (spills). Returns a cudaError_t.
int mlvae_lstm_fwd_wide_bf16_plan(int H, int B, int* out) {
  if (!takes(1, B, H)) return cudaErrorInvalidValue;
  const size_t smem = fwd_smem_bytes(H);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_fwd_wide_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int occ = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &occ, lstm_fwd_wide_bf16_kernel, THREADS, smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, lstm_fwd_wide_bf16_kernel);
  if (err != cudaSuccess) return err;
  out[0] = H / UNITS;
  out[1] = THREADS;
  out[2] = static_cast<int>(smem);
  out[3] = occ;
  out[4] = n_slices(H);
  out[5] = KSLICE;
  out[6] = attr.numRegs;
  out[7] = static_cast<int>(attr.localSizeBytes);
  return cudaSuccess;
}

// gx (T,B,4H) and w_hh (4H,H) bf16 inputs; hs (T,B,H) bf16 and cs (T,B,H)
// f32 outputs, hs 16-byte aligned (the TMA reads it); barrier one zeroed
// counter. H a multiple of 128 up to 1024. Returns a cudaError_t. The
// timing build (MLVAE_FWD_TIMELINE) is mlvae_lstm_fwd_wide_bf16_timeline,
// which also takes the (T, H/8, 8) u64 timeline before the stream.
#ifdef MLVAE_FWD_TIMELINE
int mlvae_lstm_fwd_wide_bf16_timeline(
#else
int mlvae_lstm_fwd_wide_bf16(
#endif
    const bf16* gx, const bf16* w_hh, bf16* hs, float* cs,
    unsigned int* barrier, int T, int B, int H,
    int reverse FWD_TIMELINE_ARG, cudaStream_t stream) {
  if (!takes(T, B, H) || reinterpret_cast<uintptr_t>(hs) % 16)
    return cudaErrorInvalidValue;
  CUtensorMap map_h;
  const cudaError_t err = fused::chunk_map(&map_h, hs, H, B, T);
  if (err != cudaSuccess) return err;
  void* args[] = {(void*)&gx, (void*)&w_hh,    (void*)&hs,
                  (void*)&cs, (void*)&barrier, (void*)&T,
                  (void*)&B,  (void*)&H,       (void*)&reverse,
                  (void*)&map_h
#ifdef MLVAE_FWD_TIMELINE
                  ,
                  (void*)&timeline
#endif
  };
  return launch_cooperative(lstm_fwd_wide_bf16_kernel, H / UNITS, THREADS,
                            args, fwd_smem_bytes(H), stream);
}

}  // extern "C"
