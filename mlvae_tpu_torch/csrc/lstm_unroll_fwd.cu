// K7a on f32 streams: the LSTM forward recurrence over precomputed gates
// with the gates of K consecutive steps staged in shared memory a group of
// K steps ahead.
//
// Replaces the TPU kernel mlvae_tpu/ops/lstm_unroll_exp.py `_fwd_kernel_k`
// (launched by `run_fwd_k`), K1-fwd (`lstm_pallas._fwd_kernel`) with K time
// steps per grid iteration: hs[t] = o * tanh(c_t), c_t = f * c_{t-1} +
// i * g, the gates (i, f, g, o) = gx[t] + h_{t-1} @ W_hh^T in torch gate
// order, zero initial state, f32 carries, T a multiple of K, and `reverse`
// processing t = T-1 .. 0 (outputs in natural time order). The result does
// not depend on K and is bit-identical to K1-fwd's (lstm_fwd.cu), whose
// step it repeats statement for statement: the same 4x4 product tiles, K
// split four ways and summed in the same order, the same pinned cell
// update. (Moving that step into a header that both kernels call changed
// K1-fwd's roundings, so each kernel keeps its own copy.) bf16 streams
// take lstm_unroll_fwd_bf16.cu, the tensor-core twin of the bf16 K1-fwd.
//
// What bounds it on an H100: at B=128, H=512, T=160 the recurrent products
// are 2*B*H*4H*T = 42.9 GFLOP: 0.641 ms at the f32 rate of 67 TFLOP/s,
// against 149 MB of gx, hs, cs and W_hh (0.044 ms at 3.35 TB/s): the floor
// is the operations. What keeps it far from that: the T dependent steps,
// each of which needs all of h_{t-1} from every block before a grid
// barrier.
//
// Design: K1-fwd's persistent cooperative grid of H/4 blocks, each
// holding its 16 rows of W_hh in shared memory; h_{t-1} staged by the TMA
// from a 3-D tensor map over the f32 ping-pong buffer (its row pitch
// padded to 16 bytes, zeros past B) in four copies a K slice and batch
// tile, through a ring of `nq` buffers a slice, one mbarrier each; the
// split grid barrier, between whose arrival and wait the block reads the
// next step's gates into registers. What K adds is where those gates come
// from: the block's 16 gate columns of a group's K steps, for every batch
// tile whose gates K1-fwd keeps in registers (the first MAXG), are copied
// by the TMA into shared memory a group ahead, K * tiles boxes of 64 rows
// x 16 columns on one mbarrier per group buffer, from a 4-D tensor map
// over gx viewed as (T, B, gate, unit). With two buffers the copy of
// group g + 1 runs during group g; with one it is issued once the last
// step of group g has read its gates, a step before they are needed. So
// the window between arrival and wait reads shared memory, not device
// memory. The layout (``unroll_plan``) keeps K1-fwd's deepest ring that
// fits beside the gates, then two buffers where they fit; a shape with
// no layout within 227 KB is refused. Batch tiles past MAXG read their
// gates from device memory in the cell update, as K1-fwd's do.
#include <cuda_runtime.h>

#include "fwd_timeline.cuh"
#include "grid_sync.cuh"
#include "mbarrier.cuh"

namespace {

constexpr int UNITS = 4;       // hidden units owned by one block
constexpr int GATES = 4;       // i, f, g, o
constexpr int BT = 64;         // batch rows per tile
constexpr int KSPLIT = 4;      // K is split four ways across the block
constexpr int THREADS = 256;   // KSPLIT * GATES * (BT / 4)
constexpr int QUARTERS = 4;    // TMA copies of one K slice of one tile
constexpr int SLICE = THREADS / KSPLIT;  // threads of a K slice: two warps
constexpr int MAXG = 4;        // tiles whose gx and c carry stay in registers
constexpr int GX_BOX = BT * GATES * UNITS;  // floats of a staged gates box
constexpr size_t SMEM_LIMIT = 232448;  // an H100 block's shared memory
static_assert(THREADS == KSPLIT * GATES * (BT / 4), "thread layout");
static_assert(THREADS == BT * UNITS, "cell-update layout");
static_assert(UNITS * KSPLIT == KSPLIT * QUARTERS, "H % 16: whole copies");

// f32 elements of one copy: H/16 rows of h_{t-1} x 64 batch columns
__host__ __device__ inline int quarter_elems(int H) {
  return H / (KSPLIT * QUARTERS) * BT;
}

// batch tiles whose gates are staged
__host__ __device__ inline int staged_tiles(int B) {
  const int n = (B + BT - 1) / BT;
  return n < MAXG ? n : MAXG;
}

size_t smem_bytes(int H, int B, int K, int nq, int nbuf) {
  // ring [KSPLIT][nq][H/16][BT] + w_s [GATES][H][UNITS] + red_s
  // [KSPLIT][BT][GATES*UNITS] + the gates [nbuf][K][tiles][BT][GATES*UNITS],
  // f32; the ring's mbarriers [KSPLIT][nq], then one a gates buffer
  return sizeof(float) * ((size_t)KSPLIT * nq * quarter_elems(H) +
                          (size_t)GATES * H * UNITS +
                          (size_t)KSPLIT * BT * GATES * UNITS +
                          (size_t)nbuf * K * staged_tiles(B) * GX_BOX) +
         sizeof(uint64_t) * (KSPLIT * nq + nbuf);
}

// The layout of a launch: the ring's depth (every copy of a step where
// they fit, else the most that fit beside the gates), then two gates
// buffers where they fit, else one; false if none fits.
bool unroll_plan(int H, int B, int K, int* nq, int* nbuf) {
  const int per = QUARTERS * ((B + BT - 1) / BT);
  for (int n = per; n >= 1; --n)
    for (int nb = 2; nb >= 1; --nb)
      if (smem_bytes(H, B, K, n, nb) <= SMEM_LIMIT) {
        *nq = n;
        *nbuf = nb;
        return true;
      }
  return false;
}

// The 16-byte row pitch of the h ping-pong buffer, in floats.
__host__ __device__ inline int hbuf_pitch(int B) { return (B + 3) & ~3; }

__global__ void __launch_bounds__(THREADS)
lstm_unroll_fwd_kernel(const float* __restrict__ gx,
                       const float* __restrict__ w_hh, float* __restrict__ hs,
                       float* __restrict__ cs, float* hbuf,
                       unsigned int* barrier, int T, int B, int H, int K,
                       int reverse, int nq, int nbuf,
                       const __grid_constant__ CUtensorMap map_h,
                       const __grid_constant__ CUtensorMap map_gx
                           FWD_TIMELINE_ARG) {
  extern __shared__ __align__(128) float4 smem4[];
  const int qe = quarter_elems(H);
  const int st = staged_tiles(B);
  float* ring = reinterpret_cast<float*>(smem4);
  float* w_s = ring + (size_t)KSPLIT * nq * qe;
  float* red_s = w_s + (size_t)GATES * H * UNITS;
  float* gx_s = red_s + (size_t)KSPLIT * BT * GATES * UNITS;
  uint64_t* mb =
      reinterpret_cast<uint64_t*>(gx_s + (size_t)nbuf * K * st * GX_BOX);
  uint64_t* gmb = mb + KSPLIT * nq;  // the gates buffers'

  const int tid = threadIdx.x;
  const int u0 = blockIdx.x * UNITS;
  const int G = GATES * H;
  const int Bp = hbuf_pitch(B);

  // this block's W_hh rows, laid out [gate][k][unit] so that one float4
  // holds the four units' weights for one k
  for (int idx = tid; idx < GATES * UNITS * H; idx += THREADS) {
    const int k = idx % H;
    const int j = (idx / H) % UNITS;
    const int gate = idx / (H * UNITS);
    w_s[((size_t)gate * H + k) * UNITS + j] =
        w_hh[(size_t)(gate * H + u0 + j) * H + k];
  }
  if (tid == 0) {
    for (int i = 0; i < KSPLIT * nq + nbuf; ++i) mbar_init(&mb[i]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // product layout: thread -> (K slice, gate, 4 batch rows)
  const int ks = tid / (GATES * (BT / 4));
  const int gate = (tid / (BT / 4)) % GATES;
  const int b4 = tid % (BT / 4);
  const int kper = H / KSPLIT;
  const int k_lo = ks * kper;
  const int kq = kper / QUARTERS;  // rows of h_{t-1} a copy
  // cell-update layout: thread -> (batch row, unit)
  const int cb = tid / UNITS;
  const int cj = tid % UNITS;

  const int ntiles = (B + BT - 1) / BT;
  const int per = QUARTERS * ntiles;  // a slice's copies a step
  const int groups = T / K;
  const bool producer = tid % SLICE == 0;
  float* my_ring = ring + (size_t)ks * nq * qe;
  uint64_t* my_mb = mb + ks * nq;
  unsigned int jq = 0;  // this slice's copies before this step
  // copies [from, to) of step s: tile j / 4, quarter j % 4, from slot
  // s & 1 of the buffer; by the slice's first thread
  auto issue = [&](int s, int from, int to) {
    for (int j = from; j < to; ++j) {
      const unsigned int J = jq + j;
      float* dst = my_ring + (size_t)(J % nq) * qe;
      uint64_t* bar = &my_mb[J % nq];
      mbar_expect(bar, qe * sizeof(float));
      asm volatile(
          "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
          "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(
              smem_u32(dst)),
          "l"(&map_h), "r"((j / QUARTERS) * BT),
          "r"(k_lo + (j % QUARTERS) * kq), "r"(s & 1), "r"(smem_u32(bar))
          : "memory");
    }
  };
  // the gates of group g (processing steps gK .. gK+K-1), tiles below st,
  // into buffer g % nbuf as [step][tile][row][gate][unit]: one box of 64
  // rows x the block's 16 gate columns a step and tile, every box on the
  // buffer's mbarrier; by thread 0
  auto stage_gx = [&](int g) {
    const int buf = g % nbuf;
    mbar_expect(&gmb[buf], (unsigned int)(K * st * GX_BOX * sizeof(float)));
    for (int k = 0; k < K; ++k) {
      const int s = g * K + k;
      const int t = reverse ? T - 1 - s : s;
      for (int i = 0; i < st; ++i) {
        float* dst = gx_s + ((size_t)(buf * K + k) * st + i) * GX_BOX;
        asm volatile(
            "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
            "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(
                smem_u32(dst)),
            "l"(&map_gx), "r"(u0), "r"(0), "r"(i * BT), "r"(t),
            "r"(smem_u32(&gmb[buf]))
            : "memory");
      }
    }
  };
  // the cell thread's gx of step s, tiles below MAXG, from the staged
  // buffer (waiting for its group at the group's first step); c_{t-1}
  // likewise in registers
  float gxv[MAXG][GATES];
  float c_keep[MAXG];
  auto load_gx = [&](int s) {
    const int g = s / K;
    const int buf = g % nbuf;
    if (s % K == 0) mbar_wait(&gmb[buf], (g / nbuf) & 1);
    const float* src = gx_s + (size_t)(buf * K + s % K) * st * GX_BOX;
#pragma unroll
    for (int i = 0; i < MAXG; ++i) {
      const int b = i * BT + cb;
      if (i < ntiles && b < B) {
        const float* r = src + ((size_t)i * BT + cb) * GATES * UNITS + cj;
#pragma unroll
        for (int q = 0; q < GATES; ++q) gxv[i][q] = r[q * UNITS];
      }
    }
  };
  if (tid == 0)
    for (int g = 0; g < nbuf && g < groups; ++g) stage_gx(g);
  load_gx(0);
  __syncthreads();  // step 0's gates are read: one buffer may take group 1
  FWD_CLOCK;

  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    const int tp = reverse ? t + 1 : t - 1;  // previous processed position
    float* h_next = hbuf + (size_t)((s + 1) & 1) * H * Bp;
    FWD_BEGIN();
    // every thread read step s's gates before the last barrier: the last
    // step of a group frees its buffer for the group nbuf on
    if (tid == 0 && s % K == K - 1 && s / K + nbuf < groups)
      stage_gx(s / K + nbuf);
    if (s > 0 && producer) {
      // h_prev was written by plain stores of every block: the TMA's
      // async proxy must see them
      asm volatile("fence.proxy.async.global;" ::: "memory");
      issue(s, 0, min(per, nq));
    }
    for (int i = 0; i < ntiles; ++i) {
      const int b0 = i * BT;
      const int nb = min(BT, B - b0);
      float acc[4][UNITS];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < UNITS; ++j) acc[r][j] = 0.0f;
      if (s > 0) {
        const float4* w4 = reinterpret_cast<const float4*>(w_s) +
                           (size_t)gate * H + k_lo;
        for (int qi = 0; qi < QUARTERS; ++qi) {
          const int j = i * QUARTERS + qi;
          const unsigned int J = jq + j;
          mbar_wait(&my_mb[J % nq], (J / nq) & 1);
          FWD_MARK(FWD_STAGE);
          const float4* h4 =
              reinterpret_cast<const float4*>(my_ring + (size_t)(J % nq) * qe);
          const float4* wq = w4 + qi * kq;
#pragma unroll 8
          for (int k = 0; k < kq; ++k) {
            const float4 hv = h4[k * (BT / 4) + b4];
            const float4 wv = wq[k];
            const float hb[4] = {hv.x, hv.y, hv.z, hv.w};
            const float wj[UNITS] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
              for (int jj = 0; jj < UNITS; ++jj)
                acc[r][jj] = fmaf(hb[r], wj[jj], acc[r][jj]);
          }
          FWD_MARK(FWD_PRODUCT);
          if (j + nq < per) {  // free the buffer for copy j + nq
            asm volatile("bar.sync %0, %1;" ::"r"(1 + ks), "r"(SLICE)
                         : "memory");
            if (producer) issue(s, j + nq, j + nq + 1);
          }
        }
      }
      if (i > 0) __syncthreads();  // the last tile's cell update read red_s
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < UNITS; ++j)
          red_s[((size_t)ks * BT + b4 * 4 + r) * (GATES * UNITS) +
                gate * UNITS + j] = acc[r][j];
      __syncthreads();

      if (cb < nb) {
        const int b = b0 + cb;
        float pre[GATES];
#pragma unroll
        for (int q = 0; q < GATES; ++q) {
          float sum = 0.0f;
          if (s > 0) {
#pragma unroll
            for (int kk = 0; kk < KSPLIT; ++kk)
              sum += red_s[((size_t)kk * BT + cb) * (GATES * UNITS) +
                           q * UNITS + cj];
          }
          // gxv[i][q], selected so that gxv stays in registers
          float g_in = 0.0f;
#pragma unroll
          for (int ii = 0; ii < MAXG; ++ii)
            if (ii == i) g_in = gxv[ii][q];
          if (i >= MAXG)
            g_in = gx[((size_t)t * B + b) * G + (size_t)q * H + u0 + cj];
          pre[q] = g_in + sum;
        }
        const float ig = sigmoid_f(pre[0]);
        const float fg = sigmoid_f(pre[1]);
        const float gg = tanhf(pre[2]);
        const float og = sigmoid_f(pre[3]);
        const size_t o = ((size_t)t * B + b) * H + u0 + cj;
        // c_{t-1} was written by this same thread one step earlier
        float c_prev = 0.0f;
        if (s > 0) {
#pragma unroll
          for (int ii = 0; ii < MAXG; ++ii)
            if (ii == i) c_prev = c_keep[ii];
          if (i >= MAXG) c_prev = cs[((size_t)tp * B + b) * H + u0 + cj];
        }
        // the single-copy design's contraction: f * c_{t-1} rounded, then
        // i * g + it
        const float c = __fmaf_rn(ig, gg, __fmul_rn(fg, c_prev));
#pragma unroll
        for (int ii = 0; ii < MAXG; ++ii)
          if (ii == i) c_keep[ii] = c;
        const float h = og * tanhf(c);
        cs[o] = c;
        hs[o] = h;
        h_next[(size_t)(u0 + cj) * Bp + b] = h;
      }
      FWD_MARK(FWD_CELL);
    }
    if (s > 0) jq += per;
    // the next step's TMA copies in other blocks read h_next
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

bool takes(int T, int B, int H, int K) {
  return H >= 16 && H % (UNITS * KSPLIT) == 0 && B >= 1 && T >= 1 &&
         K >= 1 && T % K == 0;
}

}  // namespace

extern "C" {

const char* mlvae_lstm_unroll_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The launch plan for (H, B, K): out[0] blocks, [1] threads, [2] dynamic
// shared memory bytes, [3] the ring's depth a K slice, [4] gates buffers
// (groups of K steps), [5] batch tiles whose gates are staged, [6] serial
// (0: this kernel has one schedule), [7] registers a thread, [8] local
// memory bytes a thread (spills). Returns a cudaError_t.
int mlvae_lstm_unroll_fwd_plan(int H, int B, int K, int* out) {
  int nq, nbuf;
  if (!takes(K, B, H, K) || !unroll_plan(H, B, K, &nq, &nbuf))
    return cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t err =
      cudaFuncGetAttributes(&attr, lstm_unroll_fwd_kernel);
  if (err != cudaSuccess) return err;
  out[0] = H / UNITS;
  out[1] = THREADS;
  out[2] = static_cast<int>(smem_bytes(H, B, K, nq, nbuf));
  out[3] = nq;
  out[4] = nbuf;
  out[5] = staged_tiles(B);
  out[6] = 0;
  out[7] = attr.numRegs;
  out[8] = static_cast<int>(attr.localSizeBytes);
  return cudaSuccess;
}

// gx (T,B,4H) f32, 16-byte aligned; w_hh (4H,H) f32; hs/cs (T,B,H) f32
// outputs; hbuf (2,H,Bp) f32 scratch, Bp = B rounded up to a multiple of
// 4; barrier one zeroed counter. H a multiple of 16, T of K. Returns a
// cudaError_t. The timing build (MLVAE_FWD_TIMELINE) is
// mlvae_lstm_unroll_fwd_timeline, which also takes the (T, H/4, 8) u64
// timeline before the stream.
#ifdef MLVAE_FWD_TIMELINE
int mlvae_lstm_unroll_fwd_timeline(
#else
int mlvae_lstm_unroll_fwd(
#endif
    const float* gx, const float* w_hh, float* hs, float* cs, float* hbuf,
    unsigned int* barrier, int T, int B, int H, int K,
    int reverse FWD_TIMELINE_ARG, cudaStream_t stream) {
  int nq, nbuf;
  if (!takes(T, B, H, K) || reinterpret_cast<uintptr_t>(gx) % 16 ||
      !unroll_plan(H, B, K, &nq, &nbuf))
    return cudaErrorInvalidValue;
  PFN_cuTensorMapEncodeTiled_v12000 encode;
  cudaError_t err = tensor_map_encoder(&encode);
  if (err != cudaSuccess) return err;
  // h_{t-1} as (slot, row k, batch column), batch innermost; boxes of 64
  // columns x H/16 rows of one slot, zeros past B
  const int Bp = hbuf_pitch(B);
  const cuuint64_t dims[3] = {(cuuint64_t)B, (cuuint64_t)H, 2};
  const cuuint64_t strides[2] = {(cuuint64_t)Bp * sizeof(float),
                                 (cuuint64_t)Bp * H * sizeof(float)};
  const cuuint32_t box[3] = {BT, (cuuint32_t)(H / (KSPLIT * QUARTERS)), 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  CUtensorMap map_h, map_gx;
  if (encode(&map_h, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, hbuf, dims, strides,
             box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  // gx as (step, batch row, gate, unit), units innermost; boxes of the
  // block's 4 units x 4 gates x 64 rows of one step, zeros past B
  const cuuint64_t gdims[4] = {(cuuint64_t)H, GATES, (cuuint64_t)B,
                               (cuuint64_t)T};
  const cuuint64_t gstrides[3] = {
      (cuuint64_t)H * sizeof(float), (cuuint64_t)GATES * H * sizeof(float),
      (cuuint64_t)B * GATES * H * sizeof(float)};
  const cuuint32_t gbox[4] = {UNITS, GATES, BT, 1};
  if (encode(&map_gx, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
             const_cast<float*>(gx), gdims, gstrides, gbox, step,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_NONE,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  void* args[] = {(void*)&gx,      (void*)&w_hh, (void*)&hs,
                  (void*)&cs,      (void*)&hbuf, (void*)&barrier,
                  (void*)&T,       (void*)&B,    (void*)&H,
                  (void*)&K,       (void*)&reverse, (void*)&nq,
                  (void*)&nbuf,    (void*)&map_h, (void*)&map_gx
#ifdef MLVAE_FWD_TIMELINE
                  ,
                  (void*)&timeline
#endif
  };
  return launch_cooperative(lstm_unroll_fwd_kernel, H / UNITS, THREADS, args,
                            smem_bytes(H, B, K, nq, nbuf), stream);
}

}  // extern "C"
