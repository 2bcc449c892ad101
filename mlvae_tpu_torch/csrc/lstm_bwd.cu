// K1-bwd: backpropagation through the LSTM recurrence over precomputed input
// gates, f32.
//
// Replaces the TPU kernel mlvae_tpu/ops/lstm_pallas.py `_bwd_kernel`
// (launched by `_run_bwd`). It walks the processing order backward from
// dh = 0 and dc = dc_last. At each step it recomputes the gates
// gx[t] + h_{t-1} @ W_hh^T from the saved hs (no gates residual), takes the
// pre-activation cotangents from `_bptt_dgates`' math, writes them to
// dgx[t], carries dc * f and dh_{t-1} = dgates @ W_hh backward, and
// accumulates dW_hh += dgates^T h_{t-1} in f32 over every batch row and
// step. h_{t-1} and c_{t-1} are zero at the first processed step (t=0, or
// t=T-1 when `reverse`), and `reverse` is indexing only, never a flip.
//
// What bounds it on an H100: at B=64, H=512, T=160 there are three products
// per step (the gate recompute, dh_{t-1} and dW_hh), 3*2*B*H*4H*T =
// 64.4 GFLOP of f32 FMA work (0.96 ms at 67 TFLOP/s), against ~260 MB of
// gx/dgx/hs/cs/dhs/W_hh/dW_hh traffic (78 us at 3.35 TB/s): the floor is the
// operations. What keeps a simple kernel far from it is the chain of T
// dependent steps, each of which needs every hidden unit's dgates before
// any unit's dh_{t-1} can be formed: a reduction across blocks every step.
//
// Design: one persistent cooperative grid, as K1-fwd. Block k owns UNITS=4
// hidden units, i.e. 16 gate rows, and keeps those rows of W_hh in shared
// memory (the recompute) and in registers (dh_{t-1}), and its 16 rows of
// dW_hh in registers for the whole sequence: the block owns those rows, so
// dW_hh needs no atomics and is deterministic. Each step, per batch tile of
// 64 rows, the block stages h_{t-1} straight from the saved hs (no exchange
// is needed for it), recomputes its B x 16 pre-activations with K1-fwd's
// 4x4 register tiles, forms its dgates from its own dh/dc carries (global
// scratch that only the owning thread touches) and writes them to its
// columns of dgx[t]. Then, in one pass over its dgates, it adds its share
// of dW_hh and writes its split-K share of dh_{t-1}, its 16 gate rows'
// product partial[k] = dgates[:, rows] @ W_hh[rows, :] (B x H), to a
// ping-pong buffer. After a grid barrier (a per-launch counter, as in
// K1-fwd) each block sums the partials of all blocks for its own four
// units, reading them through L2 with __ldcg in a fixed order, so dh_{t-1}
// is deterministic too. That moves 2 x B x H floats per block and step
// through L2, where reading all of dgx[t] would move 4 x B x H.
// Shared memory is 188 KB at H=512. The H/4 blocks must all be resident,
// one per SM, which limits H to 528 on an H100 (132 SMs).
#include <cuda_runtime.h>

#include "grid_sync.cuh"

namespace {

constexpr int UNITS = 4;                 // hidden units owned by one block
constexpr int GATES = 4;                 // i, f, g, o
constexpr int ROWS = GATES * UNITS;      // gate rows owned by one block
constexpr int BT = 64;                   // batch rows per tile
constexpr int KSPLIT = 4;                // recompute: K split four ways
constexpr int THREADS = 256;
constexpr int PAD = BT + 4;              // row stride of the staged [k][b] tile
constexpr int KPT = 3;                   // columns of H per thread
constexpr int RED = 4;                   // lanes that sum one row's partials
static_assert(THREADS == KSPLIT * GATES * (BT / 4), "recompute layout");
static_assert(THREADS == BT * UNITS, "cell layout");
static_assert(RED == UNITS, "a reducing lane ends with its own unit");

// Stage rows [0, nb) of a (rows x H) f32 slice with row stride `stride` as
// x_s[k][b] (row pitch PAD), zero past nb. Each warp moves tiles of 8 rows
// by 16 columns, one float4 a lane (full 32-byte sectors, 2-way bank
// conflicts at most on the transposing stores), with UNR loads in flight
// per lane before the stores.
__device__ __forceinline__ void stage_transposed(float* x_s, const float* src,
                                                 size_t stride, int H,
                                                 int nb) {
  constexpr int WARPS = THREADS / 32;
  constexpr int UNR = 8;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int bl = lane & 7;
  const int kl = lane >> 3;
  const int n_tiles = (BT / 8) * (H / 16);
  for (int t0 = warp; t0 < n_tiles; t0 += WARPS * UNR) {
    float4 v[UNR];
#pragma unroll
    for (int u = 0; u < UNR; ++u) {
      const int tile = t0 + u * WARPS;
      const int bb = (tile % (BT / 8)) * 8 + bl;
      const int k = ((tile / (BT / 8)) * 4 + kl) * 4;
      v[u] = (tile < n_tiles && bb < nb)
                 ? __ldg(reinterpret_cast<const float4*>(src + bb * stride +
                                                         k))
                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int u = 0; u < UNR; ++u) {
      const int tile = t0 + u * WARPS;
      if (tile < n_tiles) {
        const int bb = (tile % (BT / 8)) * 8 + bl;
        const int k = ((tile / (BT / 8)) * 4 + kl) * 4;
        float* d = x_s + (size_t)k * PAD + bb;
        d[0] = v[u].x;
        d[PAD] = v[u].y;
        d[2 * PAD] = v[u].z;
        d[3 * PAD] = v[u].w;
      }
    }
  }
}

size_t smem_bytes(int H) {
  // w_s [GATES][H][UNITS] + x_s [H][PAD] + red_s [KSPLIT][BT][ROWS]
  // + dg_s [BT][ROWS]
  return sizeof(float) * ((size_t)GATES * H * UNITS + (size_t)H * PAD +
                          (size_t)KSPLIT * BT * ROWS + (size_t)BT * ROWS);
}

__global__ void __launch_bounds__(THREADS)
lstm_bwd_kernel(const float* __restrict__ gx, const float* __restrict__ w_hh,
                const float* __restrict__ hs, const float* __restrict__ cs,
                const float* __restrict__ dhs, float* __restrict__ dgx,
                float* __restrict__ dw_hh, float* part, float* dh_buf,
                float* dc_buf, unsigned int* barrier, int T, int B, int H,
                int reverse) {
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);
  float* x_s = w_s + (size_t)GATES * H * UNITS;
  float* red_s = x_s + (size_t)H * PAD;
  float* dg_s = red_s + (size_t)KSPLIT * BT * ROWS;

  const int tid = threadIdx.x;
  const int nblk = gridDim.x;
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
  __syncthreads();

  // recompute layout: thread -> (K slice, gate, 4 batch rows)
  const int ks = tid / (GATES * (BT / 4));
  const int gate = (tid / (BT / 4)) % GATES;
  const int b4 = tid % (BT / 4);
  const int kper = H / KSPLIT;
  const int k_lo = ks * kper;
  // cell layout: thread -> (batch row, unit); the same thread owns the
  // (row, unit) dh/dc carries and sums dh_{t-1} for them
  const int cb = tid / UNITS;
  const int cj = tid % UNITS;
  // column layout (dW_hh and the partials): thread -> columns
  // k = tid + kk * THREADS, all 16 rows; W_hh[rows][k] held in registers
  float dw[KPT][ROWS];
  float wr[KPT][ROWS];
#pragma unroll
  for (int kk = 0; kk < KPT; ++kk) {
    const int k = tid + kk * THREADS;
#pragma unroll
    for (int q = 0; q < ROWS; ++q) {
      dw[kk][q] = 0.0f;
      wr[kk][q] = k < H ? w_s[((size_t)(q / UNITS) * H + k) * UNITS +
                              q % UNITS]
                        : 0.0f;
    }
  }

  unsigned int barriers = 0;
  for (int s = T - 1; s >= 0; --s) {  // processing steps, walked backward
    const int t = reverse ? T - 1 - s : s;
    const int tp = reverse ? t + 1 : t - 1;  // previous processed position
    const bool first = s == 0;               // h_{t-1} = c_{t-1} = 0
    float* part_s = part + (size_t)(s & 1) * nblk * B * H +
                    (size_t)blockIdx.x * B * H;  // this block's [B][H]
    for (int b0 = 0; b0 < B; b0 += BT) {
      const int nb = min(BT, B - b0);
      __syncthreads();  // x_s, red_s and dg_s are free again
      if (!first) {
        stage_transposed(x_s, hs + ((size_t)tp * B + b0) * H, H, H, nb);
        __syncthreads();
        float acc[4][UNITS];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int j = 0; j < UNITS; ++j) acc[r][j] = 0.0f;
        const float4* h4 = reinterpret_cast<const float4*>(x_s);
        const float4* w4 = reinterpret_cast<const float4*>(w_s) +
                           (size_t)gate * H;
        for (int k = k_lo; k < k_lo + kper; ++k) {
          const float4 hv = h4[k * (PAD / 4) + b4];
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
        __syncthreads();
      }

      float dg[GATES] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (cb < nb) {
        const int b = b0 + cb;
        const size_t row = (size_t)t * B + b;
        const float* gxr = gx + row * G + u0 + cj;
        float pre[GATES];
#pragma unroll
        for (int q = 0; q < GATES; ++q) {
          float sum = 0.0f;
          if (!first) {
#pragma unroll
            for (int kk = 0; kk < KSPLIT; ++kk)
              sum += red_s[((size_t)kk * BT + cb) * ROWS + q * UNITS + cj];
          }
          pre[q] = gxr[(size_t)q * H] + sum;
        }
        const float ig = sigmoid_f(pre[0]);
        const float fg = sigmoid_f(pre[1]);
        const float gg = tanhf(pre[2]);
        const float og = sigmoid_f(pre[3]);
        const size_t o = row * H + u0 + cj;
        const size_t bu = (size_t)b * H + u0 + cj;
        const float c_t = cs[o];
        const float c_prev =
            first ? 0.0f : cs[((size_t)tp * B + b) * H + u0 + cj];
        const float dh = dhs[o] + dh_buf[bu];
        const float tanh_c = tanhf(c_t);
        const float d_o = dh * tanh_c;
        const float dc = dc_buf[bu] + dh * og * (1.0f - tanh_c * tanh_c);
        dg[0] = dc * gg * ig * (1.0f - ig);
        dg[1] = dc * c_prev * fg * (1.0f - fg);
        dg[2] = dc * ig * (1.0f - gg * gg);
        dg[3] = d_o * og * (1.0f - og);
        dc_buf[bu] = dc * fg;
        float* dgr = dgx + row * G + u0 + cj;
#pragma unroll
        for (int q = 0; q < GATES; ++q) dgr[(size_t)q * H] = dg[q];
      }
      // rows past the tile's end stay zero: they meet zero h rows below
#pragma unroll
      for (int q = 0; q < GATES; ++q) dg_s[cb * ROWS + q * UNITS + cj] = dg[q];
      __syncthreads();

      if (!first) {
        // dW_hh[rows][k] += sum_b dgates[b][row] * h_{t-1}[b][k], and
        // partial[b][k] = sum_row dgates[b][row] * W_hh[row][k]
        const float4* g4 = reinterpret_cast<const float4*>(dg_s);
        for (int bb = 0; bb < nb; bb += 4) {
          float dgv[4][ROWS];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q4 = 0; q4 < ROWS / 4; ++q4) {
              const float4 v = g4[(bb + r) * (ROWS / 4) + q4];
              dgv[r][q4 * 4 + 0] = v.x;
              dgv[r][q4 * 4 + 1] = v.y;
              dgv[r][q4 * 4 + 2] = v.z;
              dgv[r][q4 * 4 + 3] = v.w;
            }
#pragma unroll
          for (int kk = 0; kk < KPT; ++kk) {
            const int k = tid + kk * THREADS;
            if (k < H) {
              const float4 hv =
                  *reinterpret_cast<const float4*>(x_s + (size_t)k * PAD + bb);
              const float hb[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
              for (int r = 0; r < 4; ++r) {
                float p = 0.0f;
#pragma unroll
                for (int q = 0; q < ROWS; ++q) {
                  dw[kk][q] = fmaf(dgv[r][q], hb[r], dw[kk][q]);
                  p = fmaf(dgv[r][q], wr[kk][q], p);
                }
                if (bb + r < nb) part_s[(size_t)(b0 + bb + r) * H + k] = p;
              }
            }
          }
        }
      }
    }
    if (first) break;

    // every block's partials of step s are written: sum this block's units
    grid_barrier(barrier, (++barriers) * gridDim.x);
    const float* part_all = part + (size_t)(s & 1) * nblk * B * H;
    const int lane_q = tid % RED;
    for (int b0 = 0; b0 < B; b0 += BT) {
      const int b = b0 + tid / RED;
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (b < B) {
#pragma unroll 8
        for (int k2 = lane_q; k2 < nblk; k2 += RED) {
          const float4 v = __ldcg(reinterpret_cast<const float4*>(
              part_all + ((size_t)k2 * B + b) * H + u0));
          acc.x += v.x;
          acc.y += v.y;
          acc.z += v.z;
          acc.w += v.w;
        }
      }
#pragma unroll
      for (int off = 1; off < RED; off <<= 1) {
        acc.x += __shfl_xor_sync(0xffffffffu, acc.x, off);
        acc.y += __shfl_xor_sync(0xffffffffu, acc.y, off);
        acc.z += __shfl_xor_sync(0xffffffffu, acc.z, off);
        acc.w += __shfl_xor_sync(0xffffffffu, acc.w, off);
      }
      // lane q keeps unit q: the thread that reads this carry next step
      const float mine = lane_q == 0 ? acc.x
                         : lane_q == 1 ? acc.y
                         : lane_q == 2 ? acc.z
                                       : acc.w;
      if (b < B) dh_buf[(size_t)b * H + u0 + lane_q] = mine;
    }
  }

#pragma unroll
  for (int kk = 0; kk < KPT; ++kk) {
    const int k = tid + kk * THREADS;
    if (k < H) {
#pragma unroll
      for (int q = 0; q < ROWS; ++q)
        dw_hh[(size_t)((q / UNITS) * H + u0 + q % UNITS) * H + k] = dw[kk][q];
    }
  }
}

}  // namespace

extern "C" {

const char* mlvae_lstm_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// gx (T,B,4H), w_hh (4H,H), hs/cs/dhs (T,B,H) f32 inputs, hs 16-byte
// aligned; dgx (T,B,4H) and dw_hh (4H,H) f32 outputs (every element
// written); part (2, H/4, B, H) f32 scratch; dh_buf (B,H) zeroed and dc_buf
// (B,H) holding dc_last, both scratch; barrier one zeroed counter. Returns
// a cudaError_t.
int mlvae_lstm_bwd(const float* gx, const float* w_hh, const float* hs,
                   const float* cs, const float* dhs, float* dgx,
                   float* dw_hh, float* part, float* dh_buf, float* dc_buf,
                   unsigned int* barrier, int T, int B, int H, int reverse,
                   cudaStream_t stream) {
  if (H % (UNITS * KSPLIT) != 0 || H > KPT * THREADS || T < 1 || B < 1)
    return cudaErrorInvalidValue;
  void* args[] = {(void*)&gx,     (void*)&w_hh,    (void*)&hs,
                  (void*)&cs,     (void*)&dhs,     (void*)&dgx,
                  (void*)&dw_hh,  (void*)&part,    (void*)&dh_buf,
                  (void*)&dc_buf, (void*)&barrier, (void*)&T,
                  (void*)&B,      (void*)&H,       (void*)&reverse};
  return launch_cooperative(lstm_bwd_kernel, H / UNITS, THREADS, args,
                            smem_bytes(H), stream);
}

}  // extern "C"
