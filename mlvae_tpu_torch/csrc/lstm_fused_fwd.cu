// K3/K4-fwd: the LSTM forward recurrence with the input projection inside,
// bf16 streams.
//
// Replaces the TPU kernel mlvae_tpu/ops/lstm_pallas.py `_fwd_fused_kernel`
// (launched by `_run_fwd_fused`), the forward of both fused tiers:
// gates = x_t @ W_ih^T + bias + bf16(h_{t-1}) @ W_hh^T in torch gate order
// (i, f, g, o), products of bf16 operands summed in f32, the bias f32;
// c_t = f * c_{t-1} + i * g and h_t = o * tanh(c_t) in f32; hs[t] leaves
// as bf16 and cs[t] as f32. Zero initial state; `reverse` processes
// t = T-1 .. 0 by indexing, outputs stay in natural time order.
//
// What bounds it on an H100: at B=64, H=512, T=160 and In=512 the products
// are 2*B*4H*(In+H)*T = 42.9 GFLOP (43 us at 989 TFLOP/s of bf16 tensor
// cores) against x, hs, cs and the weights, about 46 MB (14 us at
// 3.35 TB/s): the floor is the operations. What keeps this kernel far from
// it: the T dependent steps, each of which needs all of h_{t-1} from every
// block, and one block per SM with 16 gate rows of work, which keeps the
// tensor cores idle most of each step.
//
// Design (lstm_fused_common.cuh): K1-fwd's persistent cooperative grid,
// each block holding its 16 rows of [W_ih | W_hh] in shared memory, each
// step forming its B x 16 pre-activations on the tensor cores over the
// staged chunks of x_t and of h_{t-1}, which it reads from the bf16 hs of
// the step before (through L2, written by every block before the step's
// barrier), then the cell update of its 4 units. The step ends at a grid
// barrier. At In=1024 shared memory holds 86 KB: the weights (48 KB), one
// 256-column chunk (33 KB) and the pre-activations (4 KB).
#include "lstm_fused_common.cuh"

using namespace fused;

namespace {

size_t smem_bytes(int In, int H) {
  // red_s [BT][ROWS] f32 + w_s [ROWS][pitch] bf16 + tile [BT][LDT] bf16
  return sizeof(float) * BT * ROWS +
         sizeof(bf16) * ((size_t)ROWS * weight_pitch(In, H) +
                         (size_t)BT * LDT);
}

__global__ void __launch_bounds__(THREADS)
lstm_fused_fwd_kernel(const bf16* __restrict__ x,
                      const bf16* __restrict__ w_ih,
                      const float* __restrict__ bias,
                      const bf16* __restrict__ w_hh, bf16* hs,
                      float* __restrict__ cs, unsigned int* barrier, int T,
                      int B, int In, int H, int reverse) {
  extern __shared__ float4 smem4[];
  float* red_s = reinterpret_cast<float*>(smem4);
  bf16* w_s = reinterpret_cast<bf16*>(red_s + BT * ROWS);
  bf16* tile = w_s + (size_t)ROWS * weight_pitch(In, H);

  const int tid = threadIdx.x;
  const int u0 = blockIdx.x * UNITS;
  load_weights(w_s, w_ih, w_hh, In, H, u0);

  // cell layout: thread -> (batch row, unit)
  const int cb = tid / UNITS;
  const int cj = tid % UNITS;
  float bq[GATES];
#pragma unroll
  for (int q = 0; q < GATES; ++q) bq[q] = bias[(size_t)q * H + u0 + cj];

  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    const int tp = reverse ? t + 1 : t - 1;  // previous processed position
    for (int b0 = 0; b0 < B; b0 += BT) {
      const int nb = min(BT, B - b0);
      preactivations(red_s, tile, w_s, x, hs, t, tp, s == 0, b0, nb, B, In,
                     H);
      if (cb < nb) {
        const int b = b0 + cb;
        const float ig = sigmoid_f(preact(red_s, cb, 0, cj, bq[0]));
        const float fg = sigmoid_f(preact(red_s, cb, 1, cj, bq[1]));
        const float gg = tanhf(preact(red_s, cb, 2, cj, bq[2]));
        const float og = sigmoid_f(preact(red_s, cb, 3, cj, bq[3]));
        const size_t o = ((size_t)t * B + b) * H + u0 + cj;
        // c_{t-1} was written by this same thread one step earlier
        const float c_prev =
            s == 0 ? 0.0f : cs[((size_t)tp * B + b) * H + u0 + cj];
        const float c = fg * c_prev + ig * gg;
        cs[o] = c;
        hs[o] = __float2bfloat16_rn(og * tanhf(c));
      }
    }
    grid_barrier(barrier, (unsigned int)(s + 1) * gridDim.x);
  }
}

}  // namespace

extern "C" {

const char* mlvae_lstm_fused_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (T,B,In) bf16, w_ih (4H,In) bf16, bias (4H) f32, w_hh (4H,H) bf16; hs
// (T,B,H) bf16 and cs (T,B,H) f32 outputs; barrier one zeroed counter. In
// a multiple of 8, H of 16, rows 16-byte aligned. Returns a cudaError_t.
int mlvae_lstm_fused_fwd(const bf16* x, const bf16* w_ih, const float* bias,
                         const bf16* w_hh, bf16* hs, float* cs,
                         unsigned int* barrier, int T, int B, int In, int H,
                         int reverse, cudaStream_t stream) {
  if (In < 8 || In % 8 || H % 16 || T < 1 || B < 1)
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(In, H);
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  void* args[] = {(void*)&x,  (void*)&w_ih,    (void*)&bias, (void*)&w_hh,
                  (void*)&hs, (void*)&cs,      (void*)&barrier,
                  (void*)&T,  (void*)&B,       (void*)&In,   (void*)&H,
                  (void*)&reverse};
  return launch_cooperative(lstm_fused_fwd_kernel, H / UNITS, THREADS, args,
                            smem, stream);
}

}  // extern "C"
