// K7b: the LSTM forward recurrence with the input projection inside and the
// input products of K consecutive steps formed ahead of their barriers,
// bf16 streams.
//
// Replaces the TPU kernel mlvae_tpu/ops/lstm_unroll_exp.py
// `_fwd_fused_kernel_k` (launched by `run_fwd_fused_k`), K3/K4-fwd
// (`lstm_pallas._fwd_fused_kernel`) with K time steps per grid iteration
// and their input projections formed as one (K*B, In) @ (In, 4H) product:
// gates = x_t @ W_ih^T + bias + bf16(h_{t-1}) @ W_hh^T in torch gate order,
// products of bf16 operands summed in f32, the bias f32, c_t and h_t in
// f32, hs leaving as bf16 and cs as f32, zero initial state, T a multiple
// of K, `reverse` processing t = T-1 .. 0 (outputs in natural time order).
// It runs the same mma operations on the same operands, in the same order,
// as the port's K3/K4-fwd (lstm_fused_fwd.cu), so its result is
// bit-identical to K3/K4-fwd's for every K.
//
// What bounds it on an H100: at B=128, H=512, T=160 and In=512 the products
// are 2*B*4H*(In+H)*T = 85.9 GFLOP: 0.087 ms at 989 TFLOP/s of bf16 tensor
// cores, against about 92 MB of x, hs, cs and the weights (0.027 ms at
// 3.35 TB/s): the floor is the operations. What keeps it far from that, as
// K3/K4-fwd: the T dependent steps, each of which needs all of h_{t-1} from
// every block before a grid barrier, and one block per SM with 16 gate
// rows of work.
//
// Design (lstm_fused_common.cuh): K3/K4-fwd's persistent cooperative grid,
// each block holding its 16 rows of [W_ih | W_hh] in shared memory as bf16,
// mma.sync m16n8k16 with f32 accumulators, one warp a 16 x 8 tile of the
// block's 64 x 16 output. At the start of each group of K steps the block
// runs the input chunks of all K steps and all batch tiles (the group's
// K*B rows of x) and keeps each warp's f32 accumulators, four floats a
// thread for each step and tile, in shared memory (K * ceil(B/64) * 4 KB:
// 64 KB at K=8, B=128). Each step then loads its accumulators back as the
// mma C operand and runs only the hidden chunks, staging h_{t-1} from the
// bf16 hs of the step before (through L2), before the cell update and the
// grid barrier: the input product is off the steps' path between barriers.
// Shared memory at In=512, H=512, B=128, K=8: 133 KB.
#include "lstm_fused_common.cuh"

using namespace fused;

namespace {

size_t smem_bytes(int In, int H, int B, int K) {
  // red_s [BT][ROWS] f32 + acc_s [K][tiles][THREADS] float4 + w_s
  // [ROWS][pitch] bf16 + tile [BT][LDT] bf16
  const size_t tiles = (B + BT - 1) / BT;
  return sizeof(float) * BT * ROWS + sizeof(float4) * K * tiles * THREADS +
         sizeof(bf16) * ((size_t)ROWS * weight_pitch(In, H) +
                         (size_t)BT * LDT);
}

__global__ void __launch_bounds__(THREADS)
lstm_unroll_fused_fwd_kernel(const bf16* __restrict__ x,
                             const bf16* __restrict__ w_ih,
                             const float* __restrict__ bias,
                             const bf16* __restrict__ w_hh, bf16* hs,
                             float* __restrict__ cs, unsigned int* barrier,
                             int T, int B, int In, int H, int K,
                             int reverse) {
  extern __shared__ float4 smem4[];
  float* red_s = reinterpret_cast<float*>(smem4);
  float4* acc_s = reinterpret_cast<float4*>(red_s + BT * ROWS);
  const int tiles = (B + BT - 1) / BT;
  bf16* w_s = reinterpret_cast<bf16*>(acc_s + (size_t)K * tiles * THREADS);
  bf16* tile = w_s + (size_t)ROWS * weight_pitch(In, H);

  const int tid = threadIdx.x;
  const int u0 = blockIdx.x * UNITS;
  load_weights(w_s, w_ih, w_hh, In, H, u0);
  const int warp = tid >> 5;
  const int mi = warp >> 1;  // batch rows 16 mi ..
  const int ni = warp & 1;   // gate rows 8 ni ..
  const int LDW = weight_pitch(In, H);

  // cell layout: thread -> (batch row, unit)
  const int cb = tid / UNITS;
  const int cj = tid % UNITS;
  float bq[GATES];
#pragma unroll
  for (int q = 0; q < GATES; ++q) bq[q] = bias[(size_t)q * H + u0 + cj];

  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    const int tp = reverse ? t + 1 : t - 1;  // previous processed position
    const int k = s % K;
    if (k == 0) {
      // the group's input products: x of steps s .. s+K-1, every batch tile,
      // one accumulator set per (step, tile), kept by the thread that owns it
      for (int kk = 0; kk < K; ++kk) {
        const int tk = reverse ? t - kk : t + kk;
        for (int b0 = 0; b0 < B; b0 += BT) {
          float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          chunked_product(c, tile, w_s, LDW, x + ((size_t)tk * B + b0) * In,
                          In, 0, min(BT, B - b0), mi, ni);
          acc_s[((size_t)kk * tiles + b0 / BT) * THREADS + tid] =
              make_float4(c[0], c[1], c[2], c[3]);
        }
      }
    }
    for (int b0 = 0; b0 < B; b0 += BT) {
      const int nb = min(BT, B - b0);
      const float4 a = acc_s[((size_t)k * tiles + b0 / BT) * THREADS + tid];
      float c[4] = {a.x, a.y, a.z, a.w};
      if (s == 0)
        __syncthreads();  // the last tile's cell update has read red_s
      else
        chunked_product(c, tile, w_s, LDW, hs + ((size_t)tp * B + b0) * H,
                        H, In, nb, mi, ni);
      store_preacts(red_s, c, mi, ni);
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
        const float cn = fg * c_prev + ig * gg;
        cs[o] = cn;
        hs[o] = __float2bfloat16_rn(og * tanhf(cn));
      }
    }
    grid_barrier(barrier, (unsigned int)(s + 1) * gridDim.x);
  }
}

}  // namespace

extern "C" {

const char* mlvae_lstm_unroll_fused_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (T,B,In) bf16, w_ih (4H,In) bf16, bias (4H) f32, w_hh (4H,H) bf16; hs
// (T,B,H) bf16 and cs (T,B,H) f32 outputs; barrier one zeroed counter. In
// a multiple of 8, H of 16, T of K, rows 16-byte aligned. Returns a
// cudaError_t.
int mlvae_lstm_unroll_fused_fwd(const bf16* x, const bf16* w_ih,
                                const float* bias, const bf16* w_hh,
                                bf16* hs, float* cs, unsigned int* barrier,
                                int T, int B, int In, int H, int K,
                                int reverse, cudaStream_t stream) {
  if (In < 8 || In % 8 || H % 16 || T < 1 || B < 1 || K < 1 || T % K)
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(In, H, B, K);
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  void* args[] = {(void*)&x,  (void*)&w_ih,    (void*)&bias, (void*)&w_hh,
                  (void*)&hs, (void*)&cs,      (void*)&barrier,
                  (void*)&T,  (void*)&B,       (void*)&In,   (void*)&H,
                  (void*)&K,  (void*)&reverse};
  return launch_cooperative(lstm_unroll_fused_fwd_kernel, H / UNITS,
                            THREADS, args, smem, stream);
}

}  // extern "C"
