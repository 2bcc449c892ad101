// K3/K4-fwd and K7b on f32 streams: the LSTM forward recurrence with the
// input projection inside, exact f32.
//
// Replaces the TPU kernels mlvae_tpu/ops/lstm_pallas.py `_fwd_fused_kernel`
// (launched by `_run_fwd_fused`) and mlvae_tpu/ops/lstm_unroll_exp.py
// `_fwd_fused_kernel_k` (launched by `run_fwd_fused_k`, K time steps per
// grid iteration) in f32 mode: gates = x_t @ W_ih^T + bias + h_{t-1} @
// W_hh^T in torch gate order, f32 operands, f32 sums, c_t and h_t in f32,
// zero initial state, `reverse` processing t = T-1 .. 0 (outputs in natural
// time order). The (T, B, 4H) gates never reach memory.
//
// What bounds it on an H100: at B=64, T=160, H=512 the products are
// 2*B*4H*(In+H)*T FLOP, 0.401 ms at In=128 and 0.641 ms at In=512 at 67
// TFLOP/s of f32 FMA, against 10-30 MB of x, hs, cs and the weights: the
// operations. What keeps it far from that: the T dependent steps, each of
// which needs all of h_{t-1} from every block behind a grid barrier, and
// one block per SM with 16 gate rows of work.
//
// Design (lstm_fused_f32.cuh): each block keeps its 16 rows of W_hh in
// shared memory; W_ih's rows are staged with x_t chunk by chunk (any In).
// The input products of a group of K steps (K=1: K3/K4-fwd; K > 1: K7b)
// are formed between the grid barrier's arrival and its wait at the end of
// the group before, off the chain of steps, into a (K, B, 4H) f32 scratch
// `xg` that each cell thread writes and reads for its own (row, unit): the
// scratch holds K steps, not T. A step stages h_{t-1} (hs of the step
// before, written by every block) 64 rows x 128 columns at a time, forms
// the hidden product, adds it to the step's input product and bias, and
// runs the cell update with K1-fwd's contraction. The input products of a
// step are the same sums in the same order for every K, so K7b's outputs
// are K3/K4-fwd's bit for bit.
#include "lstm_fused_f32.cuh"

using namespace f32f;

namespace {

size_t smem_bytes(int H) {
  // w_s [ROWS][H + 4], red_s [4][BT][ROWS], stages [2][STAGE]
  return sizeof(float) *
         ((size_t)ROWS * (H + 4) + RED + 2 * (size_t)STAGE);
}

__global__ void __launch_bounds__(THREADS, 1)
lstm_fused_fwd_f32_kernel(const float* __restrict__ x,
                          const float* __restrict__ w_ih,
                          const float* __restrict__ bias,
                          const float* __restrict__ w_hh, float* hs,
                          float* __restrict__ cs, float* __restrict__ xg,
                          unsigned int* barrier, int T, int B, int In, int H,
                          int K, int reverse) {
  extern __shared__ __align__(16) float smem[];
  const int LDH = H + 4;
  float* w_s = smem;
  float* red_s = w_s + ROWS * LDH;
  float* stages = red_s + RED;

  const int tid = threadIdx.x;
  const int u0 = blockIdx.x * UNITS;
  const int G = GATES * H;
  const int cb = tid / UNITS;  // cell layout: thread -> (batch row, unit)
  const int cj = tid % UNITS;
  const int ntiles = (B + BT - 1) / BT;
  load_whh(w_s, w_hh, H, u0);
  float bq[GATES];
#pragma unroll
  for (int q = 0; q < GATES; ++q) bq[q] = bias[(size_t)q * H + u0 + cj];
  __syncthreads();

  auto pos = [&](int s) { return reverse ? T - 1 - s : s; };
  // the input products of steps s0 .. s0 + K - 1 into their slots s % K
  auto form_inputs = [&](int s0) {
    for (int s = s0; s < s0 + K; ++s) {
      float* slot = xg + (size_t)(s % K) * B * G;
      for (int i = 0; i < ntiles; ++i) {
        const int b0 = i * BT;
        const int nb = min(BT, B - b0);
        float acc[4][UNITS];
        zero_acc(acc);
        input_product(acc, stages, x + ((size_t)pos(s) * B + b0) * In, In,
                      nb, In, w_ih, H, u0);
        store_red(red_s, acc);
        __syncthreads();
        if (cb < nb) {
#pragma unroll
          for (int q = 0; q < GATES; ++q)
            slot[(size_t)(b0 + cb) * G + (size_t)q * H + u0 + cj] =
                red_sum(red_s, cb, q, cj) + bq[q];
        }
        __syncthreads();
      }
    }
  };

  form_inputs(0);
  for (int s = 0; s < T; ++s) {
    const int t = pos(s);
    const int tp = reverse ? t + 1 : t - 1;  // previous processed position
    const float* slot = xg + (size_t)(s % K) * B * G;
    for (int i = 0; i < ntiles; ++i) {
      const int b0 = i * BT;
      const int nb = min(BT, B - b0);
      if (s > 0) {
        float acc[4][UNITS];
        zero_acc(acc);
        hidden_product(acc, stages, hs + ((size_t)tp * B + b0) * H, H, nb, H,
                       w_s, LDH);
        store_red(red_s, acc);
        __syncthreads();
      }
      if (cb < nb) {
        const int b = b0 + cb;
        float pre[GATES];
#pragma unroll
        for (int q = 0; q < GATES; ++q) {
          pre[q] = slot[(size_t)b * G + (size_t)q * H + u0 + cj];
          if (s > 0) pre[q] += red_sum(red_s, cb, q, cj);
        }
        const float ig = sigmoid_f(pre[0]);
        const float fg = sigmoid_f(pre[1]);
        const float gg = tanhf(pre[2]);
        const float og = sigmoid_f(pre[3]);
        // c_{t-1} was written by this same thread one step earlier
        const float c_prev =
            s > 0 ? cs[((size_t)tp * B + b) * H + u0 + cj] : 0.0f;
        // K1-fwd's contraction: f * c_{t-1} rounded, then i * g + it
        const float c = __fmaf_rn(ig, gg, __fmul_rn(fg, c_prev));
        const size_t o = ((size_t)t * B + b) * H + u0 + cj;
        cs[o] = c;
        hs[o] = og * tanhf(c);
      }
      __syncthreads();  // red_s and the stages are free for the next tile
    }
    if (s + 1 < T) {
      grid_arrive(barrier);
      if ((s + 1) % K == 0) form_inputs(s + 1);  // needs no other block
      grid_wait(barrier, (unsigned int)(s + 1) * gridDim.x, 0, THREADS);
    }
  }
}

cudaError_t launch(const float* x, const float* w_ih, const float* bias,
                   const float* w_hh, float* hs, float* cs, float* xg,
                   unsigned int* barrier, int T, int B, int In, int H, int K,
                   int reverse, cudaStream_t stream) {
  if (In < 4 || In % 4 || H % 16 || T < 1 || B < 1 || K < 1 || T % K)
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(H);
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  void* args[] = {(void*)&x,  (void*)&w_ih,    (void*)&bias, (void*)&w_hh,
                  (void*)&hs, (void*)&cs,      (void*)&xg,   (void*)&barrier,
                  (void*)&T,  (void*)&B,       (void*)&In,   (void*)&H,
                  (void*)&K,  (void*)&reverse};
  return launch_cooperative(lstm_fused_fwd_f32_kernel, H / UNITS, THREADS,
                            args, smem, stream);
}

}  // namespace

extern "C" {

const char* mlvae_lstm_fused_fwd_f32_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K3/K4-fwd: x (T,B,In), w_ih (4H,In), bias (4H,), w_hh (4H,H), f32; hs, cs
// (T,B,H) f32 outputs; xg a (B, 4H) f32 scratch; barrier one zeroed
// counter. In a multiple of 4, H of 16, every pointer 16-byte aligned.
// Returns a cudaError_t.
int mlvae_lstm_fused_fwd_f32(const float* x, const float* w_ih,
                             const float* bias, const float* w_hh, float* hs,
                             float* cs, float* xg, unsigned int* barrier,
                             int T, int B, int In, int H, int reverse,
                             cudaStream_t stream) {
  return launch(x, w_ih, bias, w_hh, hs, cs, xg, barrier, T, B, In, H, 1,
                reverse, stream);
}

// K7b: as mlvae_lstm_fused_fwd_f32 with the input products of K steps
// formed together; xg is (K, B, 4H), T a multiple of K.
int mlvae_lstm_unroll_fused_fwd_f32(const float* x, const float* w_ih,
                                    const float* bias, const float* w_hh,
                                    float* hs, float* cs, float* xg,
                                    unsigned int* barrier, int T, int B,
                                    int In, int H, int K, int reverse,
                                    cudaStream_t stream) {
  return launch(x, w_ih, bias, w_hh, hs, cs, xg, barrier, T, B, In, H, K,
                reverse, stream);
}

// The launch's shared memory bytes at H (not a launch).
int mlvae_lstm_fused_fwd_f32_smem(int H) {
  return static_cast<int>(smem_bytes(H));
}

}  // extern "C"
