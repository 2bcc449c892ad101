// K1-fwd: the LSTM forward recurrence over precomputed input gates, f32.
//
// Replaces the TPU kernel mlvae_tpu/ops/lstm_pallas.py `_fwd_kernel`
// (launched by `_run_fwd`): hs[t] = o * tanh(c_t), c_t = f * c_{t-1} + i * g,
// with the gates (i, f, g, o) = gx[t] + h_{t-1} @ W_hh^T in torch gate order,
// zero initial state, f32 carries, and `reverse` handled by indexing
// (processing order t = T-1 .. 0, outputs stay in natural time order).
//
// What bounds it on an H100: at B=64, H=512, T=160 the recurrent products are
// 2*B*H*4H*T = 21.5 GFLOP of f32 FMA work (0.32 ms at 67 TFLOP/s) against
// ~130 MB of gx/hs/cs/W_hh traffic (39 us at 3.35 TB/s), so the floor is the
// operations. What keeps a simple kernel far from that floor is the serial
// dependence between steps: every step needs all of h_{t-1} before any of
// h_t can start, and W_hh (4 MB in f32) does not fit in one SM's 227 KB.
// Every block reads all of h_{t-1} (H x B f32, 128 KB at B=64) each step.
//
// Design: one persistent cooperative grid. Block k owns UNITS=4 hidden units
// and keeps their i/f/g/o rows of W_hh (16 x H floats, 32 KB at H=512) in
// shared memory for the whole sequence; H/4 = 128 blocks cover H=512, one
// per SM. H/4 blocks fit on an H100's 132 SMs up to H=528; wider layers, up
// to H=1024, take lstm_fwd_wide.cu (ops/k1_plan.py picks the build). Each
// step every block forms its B x 16 pre-activations with 4x4 register
// tiles split four ways over K (thread: K slice, gate, 4 batch rows; each
// sum over its slice in k order, then the slices summed in order), applies
// the cell update locally and writes its slice of h_t to an f32 ping-pong
// buffer in global memory that stays in L2. h_{t-1} comes in
// by the TMA: each K slice's quarter of it, per 64-row batch tile, in four
// copies of H/16 rows x 64 batch columns from a 3-D tensor map over the
// buffer (its row pitch padded to 16 bytes; zeros past B), each completing
// an mbarrier of its own, so that a slice's warps start on their first
// copy while the rest land. The copies run through a ring of `nq` buffers
// a slice (all of a tile's at B=64; five at B=128, so that the second
// tile's copies land behind the first tile's product); a slice's two warps
// free a buffer on a named barrier of their own and its first thread
// issues the next copy. The step's grid barrier is split: after the
// arrival the block loads the next step's gx (its c_{t-1} stays in
// registers), then waits. The barrier is a counter that the wrapper zeroes
// for every launch, raised with release and polled with acquire at GPU
// scope; the launch goes through cudaLaunchCooperativeKernel, which
// refuses a grid that cannot be co-resident instead of deadlocking. The
// products, the sums and the cell update are the single-copy design's,
// its contraction pinned, so the outputs are bit-identical to it.
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
constexpr size_t SMEM_LIMIT = 232448;  // an H100 block's shared memory
static_assert(THREADS == KSPLIT * GATES * (BT / 4), "thread layout");
static_assert(THREADS == BT * UNITS, "cell-update layout");
static_assert(UNITS * KSPLIT == KSPLIT * QUARTERS, "H % 16: whole copies");

// f32 elements of one copy: H/16 rows of h_{t-1} x 64 batch columns
__host__ __device__ inline int quarter_elems(int H) {
  return H / (KSPLIT * QUARTERS) * BT;
}

size_t smem_bytes(int H, int nq) {
  // ring [KSPLIT][nq][H/16][BT] + w_s [GATES][H][UNITS] + red_s
  // [KSPLIT][BT][GATES*UNITS], f32; the ring's mbarriers [KSPLIT][nq]
  return sizeof(float) * ((size_t)KSPLIT * nq * quarter_elems(H) +
                          (size_t)GATES * H * UNITS +
                          (size_t)KSPLIT * BT * GATES * UNITS) +
         sizeof(uint64_t) * KSPLIT * nq;
}

// The ring's depth: every copy of a step where they fit, else the most
// that fit; 0 if not even one does.
int ring_depth(int H, int B) {
  const int per = QUARTERS * ((B + BT - 1) / BT);
  for (int nq = per; nq >= 1; --nq)
    if (smem_bytes(H, nq) <= SMEM_LIMIT) return nq;
  return 0;
}

// The 16-byte row pitch of the h ping-pong buffer, in floats.
__host__ __device__ inline int hbuf_pitch(int B) { return (B + 3) & ~3; }

__global__ void __launch_bounds__(THREADS)
lstm_fwd_kernel(const float* __restrict__ gx, const float* __restrict__ w_hh,
                float* __restrict__ hs, float* __restrict__ cs,
                float* hbuf, unsigned int* barrier, int T, int B, int H,
                int reverse, int nq,
                const __grid_constant__ CUtensorMap map_h FWD_TIMELINE_ARG) {
  extern __shared__ __align__(128) float4 smem4[];
  const int qe = quarter_elems(H);
  float* ring = reinterpret_cast<float*>(smem4);
  float* w_s = ring + (size_t)KSPLIT * nq * qe;
  float* red_s = w_s + (size_t)GATES * H * UNITS;
  uint64_t* mb = reinterpret_cast<uint64_t*>(
      red_s + (size_t)KSPLIT * BT * GATES * UNITS);

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
    for (int i = 0; i < KSPLIT * nq; ++i) mbar_init(&mb[i]);
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
  // the cell thread's gx of step s, tiles below MAXG; c_{t-1} likewise
  float gxv[MAXG][GATES];
  float c_keep[MAXG];
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

  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    const int tp = reverse ? t + 1 : t - 1;  // previous processed position
    float* h_next = hbuf + (size_t)((s + 1) & 1) * H * Bp;
    FWD_BEGIN();
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

}  // namespace

extern "C" {

const char* mlvae_lstm_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// gx (T,B,4H) f32, w_hh (4H,H) f32, hs/cs (T,B,H) f32 outputs, hbuf
// (2,H,Bp) f32 scratch, Bp = B rounded up to a multiple of 4, barrier one
// zeroed counter. Returns a cudaError_t. The timing build
// (MLVAE_FWD_TIMELINE) is mlvae_lstm_fwd_timeline, which also takes the
// (T, H/4, 8) u64 timeline before the stream.
#ifdef MLVAE_FWD_TIMELINE
int mlvae_lstm_fwd_timeline(
#else
int mlvae_lstm_fwd(
#endif
    const float* gx, const float* w_hh, float* hs, float* cs, float* hbuf,
    unsigned int* barrier, int T, int B, int H, int reverse FWD_TIMELINE_ARG,
    cudaStream_t stream) {
  if (H % (UNITS * KSPLIT) != 0 || B < 1 || T < 1)
    return cudaErrorInvalidValue;
  const int nq = ring_depth(H, B);
  if (nq == 0) return cudaErrorInvalidValue;
  // h_{t-1} as (slot, row k, batch column), batch innermost; boxes of 64
  // columns x H/16 rows of one slot, zeros past B
  PFN_cuTensorMapEncodeTiled_v12000 encode;
  cudaError_t err = tensor_map_encoder(&encode);
  if (err != cudaSuccess) return err;
  const int Bp = hbuf_pitch(B);
  const cuuint64_t dims[3] = {(cuuint64_t)B, (cuuint64_t)H, 2};
  const cuuint64_t strides[2] = {(cuuint64_t)Bp * sizeof(float),
                                 (cuuint64_t)Bp * H * sizeof(float)};
  const cuuint32_t box[3] = {BT, (cuuint32_t)(H / (KSPLIT * QUARTERS)), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  CUtensorMap map_h;
  if (encode(&map_h, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, hbuf, dims, strides,
             box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  void* args[] = {(void*)&gx,   (void*)&w_hh,    (void*)&hs,
                  (void*)&cs,   (void*)&hbuf,    (void*)&barrier,
                  (void*)&T,    (void*)&B,       (void*)&H,
                  (void*)&reverse, (void*)&nq,   (void*)&map_h
#ifdef MLVAE_FWD_TIMELINE
                  ,
                  (void*)&timeline
#endif
  };
  return launch_cooperative(lstm_fwd_kernel, H / UNITS, THREADS, args,
                            smem_bytes(H, nq), stream);
}

}  // extern "C"
