// K1-fwd for 528 < H <= 1024 on f32 streams: the LSTM forward recurrence
// over precomputed input gates, where the narrow build (lstm_fwd.cu, four
// units a block) would need more blocks than an H100 has SMs. bf16 streams
// take lstm_fwd_wide_bf16.cu, whose products run on the tensor cores.
//
// Replaces the TPU kernel mlvae_tpu/ops/lstm_pallas.py `_fwd_kernel`
// (launched by `_run_fwd`), which takes any H % 128 == 0: hs[t] = o *
// tanh(c_t), c_t = f * c_{t-1} + i * g, with the gates (i, f, g, o) = gx[t]
// + h_{t-1} @ W_hh^T in torch gate order, zero initial state, f32 carries,
// and `reverse` by indexing (outputs stay in natural time order). Its one
// recipe is LSTM_FC: four layers at H=1024.
//
// What bounds it on an H100: at B=64, H=1024, T=160 the recurrent products
// are 2*B*H*4H*T = 85.9 GFLOP of f32 FMA work (1.282 ms at 67 TFLOP/s)
// against about 210 MB of gx/hs/cs/W_hh traffic (63 us at 3.35 TB/s): the
// floor is the operations. As at H=512, every step needs all of h_{t-1}
// before any of h_t can start.
//
// Design (lstm_wide.cuh): one persistent cooperative grid of H/8 blocks
// (128 at H=1024, one an SM). A block owns 8 units, keeps their 32 gate
// rows of W_hh in shared memory (128 KB) and, each step and 64-row batch
// tile, stages h_{t-1} from an f32 ping-pong buffer in L2 in 128-row
// chunks through a ring of two cp.async buffers (the 256 KB of h_{t-1} do
// not fit beside W_hh: only one chunk lands while the previous one is
// multiplied), forms its B x 32 pre-activations with 8 x 8 register
// tiles split eight ways over K (a warp a slice), applies the cell update
// for two units a thread and writes its slice of h_t to the buffer. The
// step ends in the split grid barrier of grid_sync.cuh, the next step's
// gx for the first tile loaded between the arrival and the wait. The cell
// update's contraction is pinned as in the narrow build. Shared memory:
// 196 KB at H=1024. The chunk copies and the product share the block's
// warps.
#include <cuda_runtime.h>

#include "grid_sync.cuh"
#include "lstm_wide.cuh"

namespace {

using namespace wide;

constexpr int TB = 8, TR = 8;  // the product's register tile: 8 K slices

__global__ void __launch_bounds__(THREADS, 1)
lstm_fwd_wide_kernel(const float* __restrict__ gx,
                     const float* __restrict__ w_hh, float* __restrict__ hs,
                     float* __restrict__ cs, float* hbuf,
                     unsigned int* barrier, int T, int B, int H,
                     int reverse) {
  extern __shared__ __align__(16) float smem[];
  const Smem sm = carve(smem, H);
  const int tid = threadIdx.x;
  const int u0 = blockIdx.x * UNITS;
  const int G = GATES * H;
  const int Bp = pitch_of(B);
  load_w(sm.w, w_hh, H, u0);
  __syncthreads();

  // cell layout: thread -> (batch row cb of the tile, units cu, cu + 1)
  const int cb = tid / (UNITS / 2);
  const int cu = (tid % (UNITS / 2)) * 2;
  const int ntiles = (B + BT - 1) / BT;

  // the first tile's gx of step s, by the cell thread
  float gx0[2][GATES];
  auto load_gx0 = [&](int s) {
    const int t = reverse ? T - 1 - s : s;
    if (cb < B) {
      const float* gxr = gx + ((size_t)t * B + cb) * G + u0 + cu;
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int q = 0; q < GATES; ++q) gx0[e][q] = gxr[(size_t)q * H + e];
    }
  };
  load_gx0(0);

  unsigned int arrivals = 0;
  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    const int tp = reverse ? t + 1 : t - 1;  // previous processed position
    const float* h_prev = hbuf + (size_t)(s & 1) * H * Bp;
    float* h_next = hbuf + (size_t)((s + 1) & 1) * H * Bp;
    for (int i = 0; i < ntiles; ++i) {
      const int b0 = i * BT;
      const int b = b0 + cb;
      if (s > 0) product<TB, TR>(sm, h_prev, H, Bp, b0);
      if (b < B) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int u = u0 + cu + e;
          float pre[GATES];
#pragma unroll
          for (int q = 0; q < GATES; ++q) {
            const float sum =
                s > 0 ? red_at(sm.red, q, e) : 0.0f;
            const float g_in =
                i == 0 ? gx0[e][q]
                       : gx[((size_t)t * B + b) * G + (size_t)q * H + u];
            pre[q] = g_in + sum;
          }
          const float ig = sigmoid_f(pre[0]);
          const float fg = sigmoid_f(pre[1]);
          const float gg = tanhf(pre[2]);
          const float og = sigmoid_f(pre[3]);
          const size_t o = ((size_t)t * B + b) * H + u;
          // c_{t-1} was written by this same thread one step earlier
          const float c_prev =
              s > 0 ? cs[((size_t)tp * B + b) * H + u] : 0.0f;
          // f * c_{t-1} rounded, then i * g + it, as the narrow build
          const float c = __fmaf_rn(ig, gg, __fmul_rn(fg, c_prev));
          const float h = og * tanhf(c);
          cs[o] = c;
          hs[o] = h;
          h_next[(size_t)u * Bp + b] = h;
        }
      }
      __syncthreads();  // red_s (the ring) read before the next product
    }
    grid_arrive(barrier);
    ++arrivals;
    if (s + 1 < T) {
      load_gx0(s + 1);  // needs no other block's writes
      grid_wait(barrier, arrivals * gridDim.x, 0, THREADS);
    }
  }
}

}  // namespace

extern "C" {

const char* mlvae_lstm_fwd_wide_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The launch plan for H (B does not change it): out[0] blocks, [1]
// threads, [2] dynamic shared memory bytes, [3] resident blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), [4] ring buffers, [5]
// rows of k a chunk, [6] registers a thread, [7] local memory bytes a
// thread (spills). Returns a cudaError_t.
int mlvae_lstm_fwd_wide_plan(int H, int B, int* out) {
  if (!takes(1, B, H)) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(H, false);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_fwd_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int occ = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &occ, lstm_fwd_wide_kernel, THREADS, smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, lstm_fwd_wide_kernel);
  if (err != cudaSuccess) return err;
  out[0] = H / UNITS;
  out[1] = THREADS;
  out[2] = static_cast<int>(smem);
  out[3] = occ;
  out[4] = RING;
  out[5] = CHUNK;
  out[6] = attr.numRegs;
  out[7] = static_cast<int>(attr.localSizeBytes);
  return cudaSuccess;
}

// As mlvae_lstm_fwd: gx (T,B,4H) f32, w_hh (4H,H) f32, hs/cs (T,B,H) f32
// outputs, hbuf (2,H,Bp) f32 scratch zeroed (Bp = B rounded up to 4),
// barrier one zeroed counter. Returns a cudaError_t.
int mlvae_lstm_fwd_wide(const float* gx, const float* w_hh, float* hs,
                        float* cs, float* hbuf, unsigned int* barrier, int T,
                        int B, int H, int reverse, cudaStream_t stream) {
  if (!takes(T, B, H)) return cudaErrorInvalidValue;
  void* args[] = {(void*)&gx, (void*)&w_hh,    (void*)&hs, (void*)&cs,
                  (void*)&hbuf, (void*)&barrier, (void*)&T, (void*)&B,
                  (void*)&H,  (void*)&reverse};
  return launch_cooperative(lstm_fwd_wide_kernel, H / UNITS, THREADS, args,
                            smem_bytes(H, false), stream);
}

}  // extern "C"
