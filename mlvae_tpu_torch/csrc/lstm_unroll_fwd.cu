// K7a: the LSTM forward recurrence over precomputed gates with the gates of
// K consecutive steps staged at once, f32 or bf16 streams.
//
// Replaces the TPU kernel mlvae_tpu/ops/lstm_unroll_exp.py `_fwd_kernel_k`
// (launched by `run_fwd_k`), K1-fwd (`lstm_pallas._fwd_kernel`) with K time
// steps per grid iteration: hs[t] = o * tanh(c_t), c_t = f * c_{t-1} +
// i * g, the gates (i, f, g, o) = gx[t] + bf16?(h_{t-1}) @ W_hh^T in torch
// gate order, zero initial state, an f32 cell, T a multiple of K, and
// `reverse` processing t = T-1 .. 0 (outputs in natural time order). Under
// bf16, h_{t-1} is rounded to bf16 before the product, which sums in f32
// (the Pallas kernel's rounding point); gx is read as bf16 and widened, hs
// leaves as bf16 and cs as f32. The result does not depend on K, and in
// f32 it is bit-identical to K1-fwd's (lstm_fwd.cu), whose step it repeats
// statement for statement: the same 4x4 product tiles, K split four ways
// and summed in the same order, the same cell update. (Moving that step
// into a header that both kernels call changed K1-fwd's roundings, so
// each kernel keeps its own copy.)
//
// What bounds it on an H100: at B=128, H=512, T=160 the recurrent products
// are 2*B*H*4H*T = 42.9 GFLOP: 0.641 ms at the f32 rate of 67 TFLOP/s. In
// bf16 the bound is the bytes, 149 MB of gx, hs, cs and W_hh (0.044 ms at
// 3.35 TB/s; the products would take 0.043 ms on the tensor cores). This
// design runs the products on the CUDA cores in f32 FMAs (bf16 operands
// widened, their products exact), so its floor is the f32 one in both
// dtypes. What keeps it far from even that: the T dependent steps, each of
// which needs all of h_{t-1} from every block before a grid barrier.
//
// Design: K1-fwd's persistent cooperative grid of H/4 blocks, each holding
// its 16 rows of W_hh in shared memory as f32, staging h_{t-1} (the rounded
// value under bf16) from an f32 [H][B] ping-pong buffer in L2 and ending
// each step at a grid barrier (grid_sync.cuh): the per-step barrier stays,
// since h_t spans all blocks. What K buys on this card is the gates: at the
// start of each group of K steps every block copies its 16 gate columns of
// gx for the group's K steps and all B rows into shared memory with
// cp.async (16 bytes a copy in f32, 8 in bf16), so no step waits on a gx
// load from device memory. Where two groups fit, the copy of the next
// group is in flight during the current group's steps and barriers (double
// buffer); otherwise one buffer is filled at each group's start. To make
// room, the split-K partials (16 KB) share the h_{t-1} tile's space, which
// is free once the product has read it. Shared memory at H=512, B=128:
// W_hh 32 KB + h_{t-1} tile 128 KB + the gx buffers K * 8 KB each in f32
// (K * 4 KB in bf16) against the 227 KB a block may use: f32 double-buffers
// K <= 4 and single-buffers K = 8; bf16 double-buffers K <= 8. A shape
// whose one buffer does not fit is refused (invalid argument).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "grid_sync.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int UNITS = 4;       // hidden units owned by one block
constexpr int GATES = 4;       // i, f, g, o
constexpr int BT = 64;         // batch rows per tile
constexpr int KSPLIT = 4;      // K is split four ways across the block
constexpr int THREADS = 256;   // KSPLIT * GATES * (BT / 4)
static_assert(THREADS == KSPLIT * GATES * (BT / 4), "thread layout");
static_assert(THREADS == BT * UNITS, "cell-update layout");
constexpr size_t SMEM_LIMIT = 232448;  // an H100 block's shared memory

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

// floats of the h_{t-1} tile h_s [H][BT], which the split-K partials
// red_s [KSPLIT][BT][GATES*UNITS] share
__host__ __device__ inline size_t tile_floats(int H) {
  const size_t red = (size_t)KSPLIT * BT * GATES * UNITS;
  return (size_t)H * BT > red ? (size_t)H * BT : red;
}

// elements of one group's gx buffer: [K][GATES][B][UNITS]
size_t group_elems(int K, int B) { return (size_t)K * GATES * B * UNITS; }

size_t smem_bytes(int H, int B, int K, size_t item, int nbuf) {
  return sizeof(float) * ((size_t)GATES * H * UNITS + tile_floats(H)) +
         item * nbuf * group_elems(K, B);
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
                 "l"(gmem)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(s),
                 "l"(gmem), "n"(BYTES)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most N of this thread's copy groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Start the copy of group g's gates (processing steps gK .. gK+K-1) into
// dst[k][gate][b][unit], one copy of the block's four units a (step, gate,
// row), as one commit group.
template <typename S>
__device__ __forceinline__ void stage_gates(S* dst, const S* gx, int g,
                                            int K, int T, int B, int H,
                                            int u0, int reverse) {
  const int n = K * GATES * B;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int b = i % B;
    const int q = (i / B) % GATES;
    const int s = g * K + i / (B * GATES);
    const int t = reverse ? T - 1 - s : s;
    cp_async<sizeof(S) * UNITS>(
        dst + (size_t)i * UNITS,
        gx + ((size_t)t * B + b) * GATES * H + (size_t)q * H + u0);
  }
  cp_async_commit();
}

template <typename S>
__global__ void __launch_bounds__(THREADS)
lstm_unroll_fwd_kernel(const S* __restrict__ gx, const S* __restrict__ w_hh,
                       S* __restrict__ hs, float* __restrict__ cs,
                       float* hbuf, unsigned int* barrier, int T, int B,
                       int H, int K, int nbuf, int reverse) {
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);
  float* h_s = w_s + (size_t)GATES * H * UNITS;
  float* red_s = h_s;  // the partials take the tile's space after the product
  S* gx_s = reinterpret_cast<S*>(h_s + tile_floats(H));

  const int tid = threadIdx.x;
  const int u0 = blockIdx.x * UNITS;

  // this block's W_hh rows as f32 (exact from bf16), laid out
  // [gate][k][unit] so that one float4 holds the four units' weights
  for (int idx = tid; idx < GATES * UNITS * H; idx += THREADS) {
    const int k = idx % H;
    const int j = (idx / H) % UNITS;
    const int gate = idx / (H * UNITS);
    w_s[((size_t)gate * H + k) * UNITS + j] =
        to_f32(w_hh[(size_t)(gate * H + u0 + j) * H + k]);
  }

  // product layout: thread -> (K slice, gate, 4 batch rows)
  const int ks = tid / (GATES * (BT / 4));
  const int gate = (tid / (BT / 4)) % GATES;
  const int b4 = tid % (BT / 4);
  const int kper = H / KSPLIT;
  const int k_lo = ks * kper;
  // cell-update layout: thread -> (batch row, unit)
  const int cb = tid / UNITS;
  const int cj = tid % UNITS;
  const int groups = T / K;
  const size_t slot = (size_t)GATES * B * UNITS;  // one step's gates

  if (nbuf == 2) stage_gates(gx_s, gx, 0, K, T, B, H, u0, reverse);
  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    const int tp = reverse ? t + 1 : t - 1;  // previous processed position
    const int g = s / K;
    const int k = s % K;
    if (k == 0) {
      // Every block has passed the barrier that ended the last group, so
      // its buffer is free: fill it (one buffer), or start the next group's
      // copy into it while waiting for this group's (two buffers).
      if (nbuf == 1) {
        stage_gates(gx_s, gx, g, K, T, B, H, u0, reverse);
        cp_async_wait<0>();
      } else if (g + 1 < groups) {
        stage_gates(gx_s + ((g + 1) & 1) * K * slot, gx, g + 1, K, T, B, H,
                    u0, reverse);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // every thread's copies have landed
    }
    const S* gx_k = gx_s + ((nbuf == 2 ? (g & 1) : 0) * K + k) * slot;
    const float* h_prev = hbuf + (size_t)(s & 1) * H * B;   // [H][B]
    float* h_next = hbuf + (size_t)((s + 1) & 1) * H * B;
    for (int b0 = 0; b0 < B; b0 += BT) {
      const int nb = min(BT, B - b0);
      __syncthreads();  // h_s (and the partials in it) are free again
      for (int idx = tid; idx < H * BT; idx += THREADS) {
        const int kk = idx / BT;
        const int bb = idx % BT;
        h_s[idx] = bb < nb ? __ldcg(h_prev + (size_t)kk * B + b0 + bb) : 0.0f;
      }
      __syncthreads();

      float acc[4][UNITS];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < UNITS; ++j) acc[r][j] = 0.0f;
      const float4* h4 = reinterpret_cast<const float4*>(h_s);
      const float4* w4 = reinterpret_cast<const float4*>(w_s) +
                         (size_t)gate * H;
      for (int kk = k_lo; kk < k_lo + kper; ++kk) {
        const float4 hv = h4[kk * (BT / 4) + b4];
        const float4 wv = w4[kk];
        const float hb[4] = {hv.x, hv.y, hv.z, hv.w};
        const float wj[UNITS] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int j = 0; j < UNITS; ++j)
            acc[r][j] = fmaf(hb[r], wj[j], acc[r][j]);
      }
      __syncthreads();  // every thread has read h_s, which red_s takes over
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
#pragma unroll
          for (int kk = 0; kk < KSPLIT; ++kk)
            sum += red_s[((size_t)kk * BT + cb) * (GATES * UNITS) +
                         q * UNITS + cj];
          pre[q] = to_f32(gx_k[((size_t)q * B + b) * UNITS + cj]) + sum;
        }
        const float ig = sigmoid_f(pre[0]);
        const float fg = sigmoid_f(pre[1]);
        const float gg = tanhf(pre[2]);
        const float og = sigmoid_f(pre[3]);
        const size_t o = ((size_t)t * B + b) * H + u0 + cj;
        // c_{t-1} was written by this same thread one step earlier
        const float c_prev =
            s == 0 ? 0.0f : cs[((size_t)tp * B + b) * H + u0 + cj];
        const float c = fg * c_prev + ig * gg;
        const float h = og * tanhf(c);
        cs[o] = c;
        store(hs + o, h);
        // the next product takes h_t as the stream holds it
        h_next[(size_t)(u0 + cj) * B + b] = rounded(h, hs);
      }
    }
    grid_barrier(barrier, (unsigned int)(s + 1) * gridDim.x);
  }
}

}  // namespace

extern "C" {

const char* mlvae_lstm_unroll_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// gx (T,B,4H) and w_hh (4H,H) in the stream dtype (f32, or bf16 when
// bf16_streams), 16-byte (f32) or 8-byte (bf16) aligned; hs (T,B,H) output
// in the stream dtype and cs (T,B,H) f32; hbuf (2,H,B) f32 scratch whose
// first half is zero; barrier one zeroed counter. T a multiple of K, H of
// 16. Returns a cudaError_t.
int mlvae_lstm_unroll_fwd(const void* gx, const void* w_hh, void* hs,
                          float* cs, float* hbuf, unsigned int* barrier,
                          int T, int B, int H, int K, int bf16_streams,
                          int reverse, cudaStream_t stream) {
  if (H % (UNITS * KSPLIT) || K < 1 || T < 1 || B < 1 || T % K)
    return cudaErrorInvalidValue;
  const size_t item = bf16_streams ? sizeof(bf16) : sizeof(float);
  int nbuf = 2;
  if (smem_bytes(H, B, K, item, nbuf) > SMEM_LIMIT) nbuf = 1;
  const size_t smem = smem_bytes(H, B, K, item, nbuf);
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  void* args[] = {(void*)&gx, (void*)&w_hh, (void*)&hs, (void*)&cs,
                  (void*)&hbuf, (void*)&barrier, (void*)&T, (void*)&B,
                  (void*)&H, (void*)&K, (void*)&nbuf, (void*)&reverse};
  if (bf16_streams)
    return launch_cooperative(lstm_unroll_fwd_kernel<bf16>, H / UNITS,
                              THREADS, args, smem, stream);
  return launch_cooperative(lstm_unroll_fwd_kernel<float>, H / UNITS,
                            THREADS, args, smem, stream);
}

}  // extern "C"
