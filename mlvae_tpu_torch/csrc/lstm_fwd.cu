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
//
// Design: one persistent cooperative grid. Block k owns UNITS=4 hidden units
// and keeps their i/f/g/o rows of W_hh (16 x H floats, 32 KB at H=512) in
// shared memory for the whole sequence; H/4 = 128 blocks cover H=512, one
// per SM. Each step every block stages h_{t-1} (read from an f32 ping-pong
// buffer in global memory that stays in L2, through __ldcg so that no stale
// L1 line from two steps back is read) into shared memory, computes its
// B x 16 pre-activations with 4x4 register tiles split four ways over K,
// applies the cell update locally and writes its slice of h_t. A grid-wide
// barrier ends each step: a counter that the wrapper zeroes for every launch,
// raised with release and polled with acquire at GPU scope, so the barrier's
// whole state belongs to this launch; it orders memory as cooperative_groups'
// grid.sync() does. The launch goes through
// cudaLaunchCooperativeKernel, which refuses a grid that cannot be
// co-resident instead of deadlocking; the wrapper raises on that error.
#include <cuda_runtime.h>

#include "grid_sync.cuh"

namespace {

constexpr int UNITS = 4;       // hidden units owned by one block
constexpr int GATES = 4;       // i, f, g, o
constexpr int BT = 64;         // batch rows per tile
constexpr int KSPLIT = 4;      // K is split four ways across the block
constexpr int THREADS = 256;   // KSPLIT * GATES * (BT / 4)
static_assert(THREADS == KSPLIT * GATES * (BT / 4), "thread layout");
static_assert(THREADS == BT * UNITS, "cell-update layout");

size_t smem_bytes(int H) {
  // w_s [GATES][H][UNITS] + h_s [H][BT] + red_s [KSPLIT][BT][GATES*UNITS]
  return sizeof(float) * ((size_t)GATES * H * UNITS + (size_t)H * BT +
                          (size_t)KSPLIT * BT * GATES * UNITS);
}

__global__ void __launch_bounds__(THREADS)
lstm_fwd_kernel(const float* __restrict__ gx, const float* __restrict__ w_hh,
                float* __restrict__ hs, float* __restrict__ cs,
                float* hbuf, unsigned int* barrier, int T, int B, int H,
                int reverse) {
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);
  float* h_s = w_s + (size_t)GATES * H * UNITS;
  float* red_s = h_s + (size_t)H * BT;

  const int tid = threadIdx.x;
  const int u0 = blockIdx.x * UNITS;
  const int G = GATES * H;

  // this block's W_hh rows, laid out [gate][k][unit] so that one float4
  // holds the four units' weights for one k
  for (int idx = tid; idx < GATES * UNITS * H; idx += THREADS) {
    const int k = idx % H;
    const int j = (idx / H) % UNITS;
    const int gate = idx / (H * UNITS);
    w_s[((size_t)gate * H + k) * UNITS + j] =
        w_hh[(size_t)(gate * H + u0 + j) * H + k];
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

  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    const int tp = reverse ? t + 1 : t - 1;  // previous processed position
    const float* h_prev = hbuf + (size_t)(s & 1) * H * B;   // [H][B]
    float* h_next = hbuf + (size_t)((s + 1) & 1) * H * B;
    for (int b0 = 0; b0 < B; b0 += BT) {
      const int nb = min(BT, B - b0);
      __syncthreads();  // h_s and red_s are free again
      for (int idx = tid; idx < H * BT; idx += THREADS) {
        const int k = idx / BT;
        const int bb = idx % BT;
        h_s[idx] = bb < nb ? __ldcg(h_prev + (size_t)k * B + b0 + bb) : 0.0f;
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
      for (int k = k_lo; k < k_lo + kper; ++k) {
        const float4 hv = h4[k * (BT / 4) + b4];
        const float4 wv = w4[k];
        const float hb[4] = {hv.x, hv.y, hv.z, hv.w};
        const float wj[UNITS] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int j = 0; j < UNITS; ++j)
            acc[r][j] = fmaf(hb[r], wj[j], acc[r][j]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < UNITS; ++j)
          red_s[((size_t)ks * BT + b4 * 4 + r) * (GATES * UNITS) +
                gate * UNITS + j] = acc[r][j];
      __syncthreads();

      if (cb < nb) {
        const int b = b0 + cb;
        const float* gxr = gx + ((size_t)t * B + b) * G + u0 + cj;
        float pre[GATES];
#pragma unroll
        for (int q = 0; q < GATES; ++q) {
          float sum = 0.0f;
#pragma unroll
          for (int kk = 0; kk < KSPLIT; ++kk)
            sum += red_s[((size_t)kk * BT + cb) * (GATES * UNITS) +
                         q * UNITS + cj];
          pre[q] = gxr[(size_t)q * H] + sum;
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
        hs[o] = h;
        h_next[(size_t)(u0 + cj) * B + b] = h;
      }
    }
    grid_barrier(barrier, (unsigned int)(s + 1) * gridDim.x);
  }
}

}  // namespace

extern "C" {

const char* mlvae_lstm_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// gx (T,B,4H) f32, w_hh (4H,H) f32, hs/cs (T,B,H) f32 outputs,
// hbuf (2,H,B) f32 scratch whose first half is zero, barrier one zeroed
// counter. Returns a cudaError_t.
int mlvae_lstm_fwd(const float* gx, const float* w_hh, float* hs, float* cs,
                   float* hbuf, unsigned int* barrier, int T, int B, int H,
                   int reverse, cudaStream_t stream) {
  if (H % (UNITS * KSPLIT) != 0) return cudaErrorInvalidValue;
  void* args[] = {(void*)&gx, (void*)&w_hh, (void*)&hs, (void*)&cs,
                  (void*)&hbuf, (void*)&barrier, (void*)&T, (void*)&B,
                  (void*)&H, (void*)&reverse};
  return launch_cooperative(lstm_fwd_kernel, H / UNITS, THREADS, args,
                            smem_bytes(H), stream);
}

}  // extern "C"
