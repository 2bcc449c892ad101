// K7a on bf16 streams at every H % 128 == 0 up to 1024: the LSTM forward
// recurrence over precomputed gates with its recurrent product on the
// tensor cores and the gates of K consecutive steps staged in shared
// memory a group of K steps ahead.
//
// Replaces the TPU kernel mlvae_tpu/ops/lstm_unroll_exp.py `_fwd_kernel_k`
// (launched by `run_fwd_k`) on bf16 streams: K1-fwd (`lstm_pallas.
// _fwd_kernel`) with K time steps per grid iteration, `gx_ref[k]
// .astype(f32)`, `h.astype(whh_ref.dtype)` (bf16) into one bf16 MXU dot
// with f32 accumulation, f32 carries, `h_new.astype(hs_ref.dtype)`; zero
// initial state, T a multiple of K, `reverse` by indexing (outputs in
// natural time order). gx, W_hh and hs are bf16, cs f32. Its twin is the
// bf16 K1-fwd (lstm_fwd_wide_bf16.cu, which `ops.lstm.lstm_layer_fwd`
// runs on bf16 streams): this kernel repeats its step statement for
// statement (the same mma operations on the same operands in the same
// order, the slices' sums added in slice order, the same pinned cell
// update), so its outputs are bit-identical to that twin's at every K.
// The contract is the JAX dispatch's (mlvae_tpu/nn/rnn.py:100-102: H %
// 128 == 0); any other H is refused.
//
// What bounds it on an H100: at B=128, H=512, T=160 the recurrent products
// are 2*B*H*4H*T = 42.9 GFLOP (0.043 ms at 989 TFLOP/s of bf16 tensor
// cores) against about 149 MB of gx, hs, cs and W_hh (0.044 ms at
// 3.35 TB/s): the floor is the bytes. What keeps the kernel far from it,
// as its twin: the chain of T dependent steps, each of which needs all of
// h_{t-1} from every block before a grid barrier, and the 64-row batch
// tiles of a step run in series.
//
// Design (lstm_wide_mma.cuh): the twin's grid of H/8 blocks, 8 units (32
// gate rows) a block, W_hh's rows in registers as mma B fragments, h_{t-1}
// landing whole from hs by the TMA in 128-column K slices, one mbarrier
// each, a warp a slice, mma.sync m16n8k16 with f32 sums, the split grid
// barrier (the next step's first tile's gates and c_{t-1} read between
// arrival and wait). What K adds is where the gates come from: the
// block's 32 gate columns of a group's K steps, for `st` batch tiles, are
// copied by the TMA into shared memory a group ahead (K * st boxes of 64
// rows x 32 columns on one mbarrier per group buffer, from a 4-D tensor
// map over gx viewed as (T, B, gate, unit)); the window and the later
// tiles' cell updates read them there instead of from device memory. The
// copy of the next group is issued once every thread has read the last
// step of a group (after the arrival), into the other buffer where two
// fit, else into the one buffer just freed. The layout (``unroll_plan``)
// stages every batch tile where they fit, then two buffers where they
// fit; tiles past `st` read their gates from device memory as the twin
// does. Shared memory at H=512, B=128, K=8: 64 KB of h_{t-1} + 2 x 64 KB.
#include "fwd_timeline.cuh"
#include "lstm_wide_mma.cuh"

using namespace widebf;

namespace {

constexpr int GX_BOX = BT * ROWS;  // bf16 elements of a staged gates box
constexpr size_t SMEM_LIMIT = 232448;  // an H100 block's shared memory

// The h_{t-1} tile (n_slices(H) slices of 64 rows x 128 columns, each
// slice's first half taking its warp's sums), then the gates buffers
// [nbuf][K][st][64 rows][gate][unit] bf16, then an mbarrier a slice and a
// gates buffer.
size_t smem_bytes(int H, int K, int st, int nbuf) {
  return (size_t)n_slices(H) * SLICE * sizeof(bf16) +
         (size_t)nbuf * K * st * GX_BOX * sizeof(bf16) +
         sizeof(uint64_t) * (n_slices(H) + nbuf);
}

// The layout of a launch: the most batch tiles whose gates fit (every
// tile where they do), then two gates buffers where they fit, else one;
// false if not even one tile's fits.
bool unroll_plan(int H, int B, int K, int* st, int* nbuf) {
  for (int n = (B + BT - 1) / BT; n >= 1; --n)
    for (int nb = 2; nb >= 1; --nb)
      if (smem_bytes(H, K, n, nb) <= SMEM_LIMIT) {
        *st = n;
        *nbuf = nb;
        return true;
      }
  return false;
}

// The cell thread's inputs of one step: gx of its two units' four gates,
// and their c_{t-1}.
struct CellIn {
  float gx[GATES][2];
  float c_prev[2];
};

__global__ void __launch_bounds__(THREADS, 1)
lstm_unroll_fwd_bf16_kernel(const bf16* __restrict__ gx,
                            const bf16* __restrict__ w_hh, bf16* hs,
                            float* cs, unsigned int* barrier, int Tn, int B,
                            int H, int K, int reverse, int st, int nbuf,
                            const __grid_constant__ CUtensorMap map_h,
                            const __grid_constant__ CUtensorMap map_gx
                                FWD_TIMELINE_ARG) {
  extern __shared__ __align__(1024) float4 smem4[];
  bf16* tile = reinterpret_cast<bf16*>(smem4);
  const int nk = n_slices(H);
  bf16* gx_s = tile + (size_t)nk * SLICE;
  uint64_t* bar =
      reinterpret_cast<uint64_t*>(gx_s + (size_t)nbuf * K * st * GX_BOX);
  uint64_t* gbar = bar + nk;  // the gates buffers'
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int u0 = blockIdx.x * UNITS;
  const int G = GATES * H;
  const int groups = Tn / K;
  if (tid == 0) {
    if (smem_u32(tile) & 1023) __trap();  // the swizzle's 1024-byte atoms
    for (int i = 0; i < nk + nbuf; ++i) mbar_init(&bar[i]);
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

  // the gates of group g (processing steps gK .. gK+K-1), tiles below st,
  // into buffer g % nbuf: one box of 64 rows x the block's 32 gate
  // columns a step and tile, every box on the buffer's mbarrier; by
  // thread 0
  auto stage_gx = [&](int g) {
    const int buf = g % nbuf;
    mbar_expect(&gbar[buf], (unsigned int)(K * st * GX_BOX * sizeof(bf16)));
    for (int k = 0; k < K; ++k) {
      const int s = g * K + k;
      const int t = reverse ? Tn - 1 - s : s;
      for (int i = 0; i < st; ++i) {
        bf16* dst = gx_s + ((size_t)(buf * K + k) * st + i) * GX_BOX;
        asm volatile(
            "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
            "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(
                smem_u32(dst)),
            "l"(&map_gx), "r"(u0), "r"(0), "r"(i * BT), "r"(t),
            "r"(smem_u32(&gbar[buf]))
            : "memory");
      }
    }
  };

  // tile i of step s: the staged gates (waiting for the group at its first
  // step's first tile) or, past st, device memory's
  auto load_in = [&](int s, int i, CellIn& in) {
    const int t = reverse ? Tn - 1 - s : s;
    const int tp = reverse ? t + 1 : t - 1;
    const int g = s / K;
    const int buf = g % nbuf;
    if (i == 0 && s % K == 0) mbar_wait(&gbar[buf], (g / nbuf) & 1);
    const int b = i * BT + cb;
    if (b >= B) return;
    const bf16* src =
        i < st ? gx_s + ((size_t)((buf * K + s % K) * st + i) * BT + cb) *
                            ROWS + cu
               : gx + ((size_t)t * B + b) * G + u0 + cu;
    const int pitch = i < st ? UNITS : H;  // between gates
#pragma unroll
    for (int q = 0; q < GATES; ++q) {
      const float2 v = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(src + (size_t)q * pitch));
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

  if (tid == 0)
    for (int g = 0; g < nbuf && g < groups; ++g) stage_gx(g);
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
      if (i > 0) load_in(s, i, in);
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
    // every thread has read step s's gates: the last step of a group frees
    // its buffer for the group nbuf on
    if (tid == 0 && s % K == K - 1 && s / K + nbuf < groups)
      stage_gx(s / K + nbuf);
    if (s + 1 < Tn) {
      load_in(s + 1, 0, in0);  // needs no other block's writes
      FWD_MARK(FWD_OFFCHAIN);
      grid_wait(barrier, arrivals * gridDim.x, 0, THREADS);
    }
    FWD_MARK(FWD_BARRIER);
    FWD_STORE(s, 0);
  }
}

bool takes_k(int T, int B, int H, int K) {
  return takes(T, B, H) && K >= 1 && T % K == 0;
}

}  // namespace

extern "C" {

const char* mlvae_lstm_unroll_fwd_bf16_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The launch plan for (H, B, K): out[0] blocks, [1] threads, [2] dynamic
// shared memory bytes, [3] K slices of the h_{t-1} tile (one mbarrier
// each), [4] gates buffers (groups of K steps), [5] batch tiles whose
// gates are staged, [6] serial (0: this kernel has one schedule), [7]
// registers a thread, [8] local memory bytes a thread (spills). Returns a
// cudaError_t.
int mlvae_lstm_unroll_fwd_bf16_plan(int H, int B, int K, int* out) {
  int st, nbuf;
  if (!takes_k(K, B, H, K) || !unroll_plan(H, B, K, &st, &nbuf))
    return cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t err =
      cudaFuncGetAttributes(&attr, lstm_unroll_fwd_bf16_kernel);
  if (err != cudaSuccess) return err;
  out[0] = H / UNITS;
  out[1] = THREADS;
  out[2] = static_cast<int>(smem_bytes(H, K, st, nbuf));
  out[3] = n_slices(H);
  out[4] = nbuf;
  out[5] = st;
  out[6] = 0;
  out[7] = attr.numRegs;
  out[8] = static_cast<int>(attr.localSizeBytes);
  return cudaSuccess;
}

// gx (T,B,4H) and w_hh (4H,H) bf16 inputs, gx 16-byte aligned; hs (T,B,H)
// bf16 and cs (T,B,H) f32 outputs, hs 16-byte aligned (the TMA reads
// both); barrier one zeroed counter. H a multiple of 128 up to 1024, T of
// K. Returns a cudaError_t. The timing build (MLVAE_FWD_TIMELINE) is
// mlvae_lstm_unroll_fwd_bf16_timeline, which also takes the (T, H/8, 8)
// u64 timeline before the stream.
#ifdef MLVAE_FWD_TIMELINE
int mlvae_lstm_unroll_fwd_bf16_timeline(
#else
int mlvae_lstm_unroll_fwd_bf16(
#endif
    const bf16* gx, const bf16* w_hh, bf16* hs, float* cs,
    unsigned int* barrier, int T, int B, int H, int K,
    int reverse FWD_TIMELINE_ARG, cudaStream_t stream) {
  int st, nbuf;
  if (!takes_k(T, B, H, K) || reinterpret_cast<uintptr_t>(hs) % 16 ||
      reinterpret_cast<uintptr_t>(gx) % 16 ||
      !unroll_plan(H, B, K, &st, &nbuf))
    return cudaErrorInvalidValue;
  CUtensorMap map_h, map_gx;
  cudaError_t err = fused::chunk_map(&map_h, hs, H, B, T);
  if (err != cudaSuccess) return err;
  PFN_cuTensorMapEncodeTiled_v12000 encode;
  err = tensor_map_encoder(&encode);
  if (err != cudaSuccess) return err;
  // gx as (step, batch row, gate, unit), units innermost; boxes of the
  // block's 8 units x 4 gates x 64 rows of one step, zeros past B
  const cuuint64_t gdims[4] = {(cuuint64_t)H, GATES, (cuuint64_t)B,
                               (cuuint64_t)T};
  const cuuint64_t gstrides[3] = {
      (cuuint64_t)H * sizeof(bf16), (cuuint64_t)GATES * H * sizeof(bf16),
      (cuuint64_t)B * GATES * H * sizeof(bf16)};
  const cuuint32_t gbox[4] = {UNITS, GATES, BT, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  if (encode(&map_gx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<bf16*>(gx), gdims, gstrides, gbox, step,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_NONE,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  void* args[] = {(void*)&gx,      (void*)&w_hh,    (void*)&hs,
                  (void*)&cs,      (void*)&barrier, (void*)&T,
                  (void*)&B,       (void*)&H,       (void*)&K,
                  (void*)&reverse, (void*)&st,      (void*)&nbuf,
                  (void*)&map_h,   (void*)&map_gx
#ifdef MLVAE_FWD_TIMELINE
                  ,
                  (void*)&timeline
#endif
  };
  return launch_cooperative(lstm_unroll_fwd_bf16_kernel, H / UNITS, THREADS,
                            args, smem_bytes(H, K, st, nbuf), stream);
}

}  // extern "C"
