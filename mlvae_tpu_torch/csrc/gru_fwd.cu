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
// operations. This design runs every product on the CUDA cores in f32
// FMAs, so its floor is the f32 one. What keeps it far even from that
// floor is the serial dependence between steps: every step needs all of
// h_{t-1} before any of h_t can start, and W_hh (3 MB in f32) does not fit
// in one SM.
//
// Design, K1-fwd's (lstm_fwd.cu) with three gates: one persistent
// cooperative grid of H/4 blocks. Block k owns UNITS=4 hidden units and
// keeps their r/z/n rows of W_hh (12 x H, 24 KB at H=512) and of b_hh in
// shared memory and registers for the whole sequence. Each step it stages
// h_{t-1} from an f32 ping-pong buffer in L2 through __ldcg, computes its
// B x 12 products with 4x4 register tiles split four ways over K (192 of
// the 256 threads), applies the gate update for its units, reading its own
// h_{t-1} from hs where the same thread wrote it a step earlier, and
// writes its slice of h_t. A grid barrier (grid_sync.cuh) ends each step.
// Shared memory is 164 KB at H=512; the H/4 blocks must all be resident,
// one per SM, which limits H to 528 on an H100 (132 SMs).
#include "gru_common.cuh"

using namespace gru;

namespace {

size_t smem_bytes(int H) {
  // w_s [GATES][H][UNITS] + h_s [H][BT] + red_s [KSPLIT][BT][ROWS]
  return sizeof(float) * ((size_t)GATES * H * UNITS + (size_t)H * BT +
                          (size_t)KSPLIT * BT * ROWS);
}

__global__ void __launch_bounds__(THREADS)
gru_fwd_kernel(const float* __restrict__ gx, const float* __restrict__ w_hh,
               const float* __restrict__ b_hh, float* __restrict__ hs,
               float* hbuf, unsigned int* barrier, int T, int B, int H,
               int reverse) {
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);
  float* h_s = w_s + (size_t)GATES * H * UNITS;
  float* red_s = h_s + (size_t)H * BT;

  const int tid = threadIdx.x;
  const int u0 = blockIdx.x * UNITS;
  const int G = GATES * H;

  // this block's W_hh rows, [gate][k][unit] (one float4 = four units' k)
  for (int idx = tid; idx < GATES * UNITS * H; idx += THREADS) {
    const int k = idx % H;
    const int j = (idx / H) % UNITS;
    const int gate = idx / (H * UNITS);
    w_s[((size_t)gate * H + k) * UNITS + j] =
        w_hh[(size_t)(gate * H + u0 + j) * H + k];
  }

  // product layout: thread -> (K slice, gate, 4 batch rows)
  const bool prod = tid < PRODUCT_THREADS;
  const int ks = tid / (GATES * (BT / 4));
  const int gate = (tid / (BT / 4)) % GATES;
  const int b4 = tid % (BT / 4);
  const int kper = H / KSPLIT;
  const int k_lo = ks * kper;
  // gate-update layout: thread -> (batch row, unit), with that unit's
  // hidden-side biases
  const int cb = tid / UNITS;
  const int cj = tid % UNITS;
  float bias[GATES];
#pragma unroll
  for (int q = 0; q < GATES; ++q) bias[q] = b_hh[q * H + u0 + cj];

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

      if (prod) {
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
            red_s[((size_t)ks * BT + b4 * 4 + r) * ROWS + gate * UNITS + j] =
                acc[r][j];
      }
      __syncthreads();

      if (cb < nb) {
        const int b = b0 + cb;
        const size_t row = (size_t)t * B + b;
        const float* gxr = gx + row * G + u0 + cj;
        float gh[GATES];
#pragma unroll
        for (int q = 0; q < GATES; ++q) {
          float sum = 0.0f;
#pragma unroll
          for (int kk = 0; kk < KSPLIT; ++kk)
            sum += red_s[((size_t)kk * BT + cb) * ROWS + q * UNITS + cj];
          gh[q] = sum + bias[q];
        }
        const float r = sigmoid_f(gxr[0] + gh[0]);
        const float z = sigmoid_f(gxr[H] + gh[1]);
        const float n = tanhf(gxr[2 * H] + r * gh[2]);
        const size_t o = row * H + u0 + cj;
        // h_{t-1}, written by this same thread one step earlier
        float h_old = 0.0f;
        if (s > 0) h_old = hs[((size_t)tp * B + b) * H + u0 + cj];
        const float h = (1.0f - z) * n + z * h_old;
        hs[o] = h;
        h_next[(size_t)(u0 + cj) * B + b] = h;
      }
    }
    grid_barrier(barrier, (unsigned int)(s + 1) * gridDim.x);
  }
}

}  // namespace

extern "C" {

const char* mlvae_gru_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// gx (T,B,3H), w_hh (3H,H) and b_hh (3H) f32; hs (T,B,H) f32 output; hbuf
// (2,H,B) f32 scratch whose first half is zero; barrier one zeroed
// counter. H a multiple of 16. Returns a cudaError_t.
int mlvae_gru_fwd(const float* gx, const float* w_hh, const float* b_hh,
                  float* hs, float* hbuf, unsigned int* barrier, int T,
                  int B, int H, int reverse, cudaStream_t stream) {
  if (H % (UNITS * KSPLIT) != 0 || T < 1 || B < 1)
    return cudaErrorInvalidValue;
  void* args[] = {(void*)&gx,      (void*)&w_hh, (void*)&b_hh,
                  (void*)&hs,      (void*)&hbuf, (void*)&barrier,
                  (void*)&T,       (void*)&B,    (void*)&H,
                  (void*)&reverse};
  return launch_cooperative(gru_fwd_kernel, H / UNITS, THREADS, args,
                            smem_bytes(H), stream);
}

}  // extern "C"
