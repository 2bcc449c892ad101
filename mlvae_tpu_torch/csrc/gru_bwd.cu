// K5-bwd: backpropagation through the GRU recurrence over precomputed input
// gates, f32 streams (bf16 streams: gru_bwd_bf16.cu).
//
// Replaces the TPU kernel mlvae_tpu/ops/gru_pallas.py `_bwd_kernel`
// (launched by `_run_bwd`). It walks the processing order backward from
// dh = 0. At each step it recomputes gh = h_{t-1} @ W_hh^T + b_hh and the
// gates r, z, n from the saved hs (no (T, B, 3H) residual, as the TPU
// kernel keeps none), takes
//   dn' = dh (1 - z)(1 - n^2), dr' = dn' gh_n r (1 - r),
//   dz' = dh (h_{t-1} - n) z (1 - z),
// writes dgx[t] = [dr', dz', dn'], and with dgh = [dr', dz', dn' r] carries
// dh_{t-1} = dh z + dgh @ W_hh backward, and accumulates dW_hh += dgh^T
// h_{t-1} and db_hh += sum_b dgh in f32 over every batch row and step.
// h_{t-1} is zero at the first processed step (t=0, or t=T-1 when
// `reverse`), and `reverse` is indexing only, never a flip.
//
// What bounds it on an H100: at B=64, H=512, T=160 there are three products
// per step (the recompute, dh_{t-1} and dW_hh), 3*2*B*H*3H*T = 48.3 GFLOP,
// 0.721 ms at the f32 rate of 67 TFLOP/s (0.049 ms at the bf16 tensor-core
// peak), against ~180 MB of gx/dgx/hs/dhs/W_hh/dW_hh traffic in f32 (54 us
// at 3.35 TB/s): the floor is the operations. As K5-fwd, every product runs
// on the CUDA cores in f32 FMAs, so the f32 floor is this design's. What keeps it far from it is the chain of T
// dependent steps, each of which needs every unit's dgh before any unit's
// dh_{t-1} can be formed: a reduction across blocks every step.
//
// Design, K1-bwd's (lstm_bwd.cu) with three gates: one persistent
// cooperative grid of H/4 blocks. Block k owns UNITS=4 hidden units, i.e.
// 12 gate rows, and keeps those rows of W_hh in shared memory (the
// recompute) and in registers (dh_{t-1}), its 12 rows of dW_hh in registers
// and of db_hh in 12 threads' registers for the whole sequence: the block
// owns those rows, so neither needs atomics and both are deterministic.
// Because h_{t-1} is saved, the recompute needs no exchange: per batch tile
// of 64 rows the block stages h_{t-1} straight from hs, recomputes its B x
// 12 gate inputs with K5-fwd's register tiles, forms its dgh from its own
// dh carry (global scratch that only the owning thread touches, which also
// keeps the local term dh z) and writes its columns of dgx[t]. Then, in one
// pass over its dgh, it adds its share of dW_hh and writes its split-K
// share of dgh @ W_hh, its 12 rows' product (B x H), to a ping-pong buffer
// in L2. After a grid barrier each block sums the shares of all blocks for
// its own four units, through __ldcg in a fixed order, onto the dh z term.
// Shared memory is 178 KB at H=512; the H/4 blocks must all be resident,
// which limits H to 528 on an H100 (132 SMs).
#include "gru_common.cuh"

using namespace gru;

namespace {

constexpr int PAD = BT + 4;              // row stride of the staged [k][b] tile
constexpr int KPT = 3;                   // columns of H per thread
constexpr int RED = 4;                   // lanes that sum one row's shares
static_assert(RED == UNITS, "a reducing lane ends with its own unit");
static_assert(ROWS % 4 == 0, "dgh rows are read as float4");

// four consecutive entries, widened to f32
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// Stage rows [0, nb) of a (rows x H) slice of hs (row stride H) as
// x_s[k][b] in f32 (row pitch PAD), zero past nb. Each warp moves tiles of 8
// rows by 16 columns, four columns a lane, with UNR loads in flight per
// lane before the transposing stores (lstm_bwd.cu's staging, for both
// stream dtypes).
__device__ __forceinline__ void stage_transposed(float* x_s, const float* src,
                                                 int H, int nb) {
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
                 ? load4(src + (size_t)bb * H + k)
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
  // + dg_s [BT][ROWS] (dgh as the products take it) + df_s [BT][ROWS] (f32)
  return sizeof(float) * ((size_t)GATES * H * UNITS + (size_t)H * PAD +
                          (size_t)KSPLIT * BT * ROWS + 2 * (size_t)BT * ROWS);
}

__global__ void __launch_bounds__(THREADS)
gru_bwd_kernel(const float* __restrict__ gx, const float* __restrict__ w_hh,
               const float* __restrict__ b_hh, const float* __restrict__ hs,
               const float* __restrict__ dhs,
               float* __restrict__ dgx, float* __restrict__ dw_hh,
               float* __restrict__ db_hh, float* part, float* dh_buf,
               unsigned int* barrier, int T, int B, int H, int reverse) {
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);
  float* x_s = w_s + (size_t)GATES * H * UNITS;
  float* red_s = x_s + (size_t)H * PAD;
  float* dg_s = red_s + (size_t)KSPLIT * BT * ROWS;
  float* df_s = dg_s + (size_t)BT * ROWS;

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
  const bool prod = tid < PRODUCT_THREADS;
  const int ks = tid / (GATES * (BT / 4));
  const int gate = (tid / (BT / 4)) % GATES;
  const int b4 = tid % (BT / 4);
  const int kper = H / KSPLIT;
  const int k_lo = ks * kper;
  // gate layout: thread -> (batch row, unit); the same thread owns the
  // (row, unit) dh carry and sums dh_{t-1} for it
  const int cb = tid / UNITS;
  const int cj = tid % UNITS;
  float bias[GATES];
#pragma unroll
  for (int q = 0; q < GATES; ++q) bias[q] = b_hh[q * H + u0 + cj];
  // db_hh: thread q < ROWS owns row q
  float db = 0.0f;
  // column layout (dW_hh and the shares): thread -> columns
  // k = tid + kk * THREADS, all 12 rows; W_hh[rows][k] held in registers
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
    const bool first = s == 0;               // h_{t-1} = 0
    float* part_s = part + (size_t)(s & 1) * nblk * B * H +
                    (size_t)blockIdx.x * B * H;  // this block's [B][H]
    for (int b0 = 0; b0 < B; b0 += BT) {
      const int nb = min(BT, B - b0);
      __syncthreads();  // x_s, red_s, dg_s and df_s are free again
      if (!first) {
        stage_transposed(x_s, hs + ((size_t)tp * B + b0) * H, H, nb);
        __syncthreads();
        if (prod) {
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
              red_s[((size_t)ks * BT + b4 * 4 + r) * ROWS + gate * UNITS +
                    j] = acc[r][j];
        }
        __syncthreads();
      }

      float dg[GATES] = {0.0f, 0.0f, 0.0f};  // dgh in f32
      if (cb < nb) {
        const int b = b0 + cb;
        const size_t row = (size_t)t * B + b;
        const float* gxr = gx + row * G + u0 + cj;
        float gh[GATES];
#pragma unroll
        for (int q = 0; q < GATES; ++q) {
          float sum = 0.0f;
          if (!first) {
#pragma unroll
            for (int kk = 0; kk < KSPLIT; ++kk)
              sum += red_s[((size_t)kk * BT + cb) * ROWS + q * UNITS + cj];
          }
          gh[q] = sum + bias[q];
        }
        const float r = sigmoid_f(gxr[0] + gh[0]);
        const float z = sigmoid_f(gxr[H] + gh[1]);
        const float hn = gh[2];
        const float n = tanhf(gxr[2 * H] + r * hn);
        float h_prev = 0.0f;  // h_{t-1} of the elementwise chain
        if (!first) h_prev = hs[((size_t)tp * B + b) * H + u0 + cj];
        const size_t o = row * H + u0 + cj;
        const size_t bu = (size_t)b * H + u0 + cj;
        const float dh = dhs[o] + dh_buf[bu];
        const float dn = dh * (1.0f - z) * (1.0f - n * n);
        const float dr = dn * hn * r * (1.0f - r);
        const float dz = dh * (h_prev - n) * z * (1.0f - z);
        float* dgr = dgx + row * G + u0 + cj;
        dgr[0] = dr;
        dgr[H] = dz;
        dgr[2 * H] = dn;
        dg[0] = dr;
        dg[1] = dz;
        dg[2] = dn * r;
        // the local term of dh_{t-1}; the exchange below adds dgh @ W_hh
        dh_buf[bu] = dh * z;
      }
      // rows past the tile's end stay zero: they meet zero h rows below
#pragma unroll
      for (int q = 0; q < GATES; ++q) {
        dg_s[cb * ROWS + q * UNITS + cj] = dg[q];
        df_s[cb * ROWS + q * UNITS + cj] = dg[q];
      }
      __syncthreads();

      if (tid < ROWS) {
        float sum = 0.0f;
        for (int bb = 0; bb < nb; ++bb) sum += df_s[bb * ROWS + tid];
        db += sum;
      }
      if (!first) {
        // dW_hh[rows][k] += sum_b dgh[b][row] * h_{t-1}[b][k], and
        // share[b][k] = sum_row dgh[b][row] * W_hh[row][k]
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

    // every block's shares of step s are written: sum this block's units
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
      // lane q keeps unit q: the thread that wrote dh z for it, and that
      // reads this carry next step
      const float mine = lane_q == 0 ? acc.x
                         : lane_q == 1 ? acc.y
                         : lane_q == 2 ? acc.z
                                       : acc.w;
      if (b < B) dh_buf[(size_t)b * H + u0 + lane_q] += mine;
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
  if (tid < ROWS) db_hh[(tid / UNITS) * H + u0 + tid % UNITS] = db;
}

}  // namespace

extern "C" {

const char* mlvae_gru_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// gx (T,B,3H), w_hh (3H,H), hs and dhs (T,B,H) and b_hh (3H) f32; every
// row 16-byte aligned. Outputs, every element written: dgx (T,B,3H),
// dw_hh (3H,H) and db_hh (3H) f32. Scratch: part (2, H/4, B, H) f32,
// dh_buf (B,H) zeroed, barrier one zeroed counter. H a multiple of 16.
// Returns a cudaError_t.
int mlvae_gru_bwd(const float* gx, const float* w_hh, const float* b_hh,
                  const float* hs, const float* dhs, float* dgx,
                  float* dw_hh, float* db_hh, float* part, float* dh_buf,
                  unsigned int* barrier, int T, int B, int H, int reverse,
                  cudaStream_t stream) {
  if (H % (UNITS * KSPLIT) != 0 || H > KPT * THREADS || T < 1 || B < 1)
    return cudaErrorInvalidValue;
  void* args[] = {(void*)&gx,     (void*)&w_hh,   (void*)&b_hh,
                  (void*)&hs,     (void*)&dhs,    (void*)&dgx,
                  (void*)&dw_hh,  (void*)&db_hh,  (void*)&part,
                  (void*)&dh_buf, (void*)&barrier, (void*)&T,
                  (void*)&B,      (void*)&H,      (void*)&reverse};
  return launch_cooperative(gru_bwd_kernel, H / UNITS, THREADS, args,
                            smem_bytes(H), stream);
}

}  // extern "C"
