// The backward walk shared by K3-bwd (lstm_fused_bwd.cu, SEMI = false) and
// K4-bwd (lstm_semi_bwd.cu, SEMI = true): backpropagation through the fused
// LSTM recurrence, bf16 streams, f32 carries and sums.
//
// It walks the processing order backward from dh = 0 and dc = dc_last. At
// each step it recomputes the pre-activations x_t @ W_ih^T + bias +
// h_{t-1} @ W_hh^T from x and the saved bf16 hs (no gates residual), takes
// the f32 dgates from `_bptt_dgates`' math and carries dc * f. dgates
// rounded to bf16 is the operand of every product, as the Pallas kernels
// cast it:
//   dX[t]    = dgates @ W_ih                   (K3; (T,B,In) bf16)
//   dh_{t-1} = dgates @ W_hh                   (carried, f32)
//   dW_ih   += dgates^T x_t,  dW_hh += dgates^T h_{t-1}   (f32)
//   db      += the f32 dgates summed over the batch       (K3)
// K4 writes dgates to dgx (T,B,4H) bf16 instead of forming dX, dW_ih and
// db, which its caller forms from dgx.
//
// Design: block k owns 16 gate rows and keeps their [W_ih | W_hh] in
// shared memory, and their dW (K3: In + H columns, K4: H) in shared memory
// as f32, each entry summed by one thread only, so there are no atomics
// and every run gives the same bits. Per step and tile of 64 batch rows it
// forms its pre-activations on the tensor cores (the staged chunks of x_t
// and h_{t-1}), its dgates from its own dh/dc carries, which it writes in
// bf16 to a (B, 4H) exchange buffer (K3: a ping-pong scratch; K4: dgx[t]
// itself), then, over the chunks again, its dW on the tensor cores. dX[t]
// and dh_{t-1} need all 4H dgates of the step: after a grid barrier each
// block reads the whole (B, 4H) exchange buffer through L2 and multiplies
// it by the columns it owns, W_hh's for its 4 units' dh and W_ih's for dX
// columns 4g .. 4g+3, g = k, k + H/4, ... (held in shared memory), on the
// tensor cores in a fixed order. The exchange moves B * 4H bf16 through
// L2 per step, and the (T, B, 4H) dgates of K3 never reach memory.
#pragma once

#include "lstm_fused_common.cuh"

namespace fused {

constexpr int LDD = BT + 8;  // bf16 pitch of dg_t [ROWS][LDD]
constexpr int MAXP = 4;      // dX column groups a block may own

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// dW of one staged chunk on the tensor cores, columns [0, width) of the
// chunk (width a multiple of 8): warp w takes the 8-wide column tiles
// 4w .. 4w+3, dW[q][col] += dgates[b][q]^T in[b][col] over the tile's 64
// rows (dg_t: the bf16 dgates as [q][b]; rows past the tile's end have
// zero dgates and zero inputs). pcol is the dW column of the chunk's first
// column. No __syncthreads inside.
__device__ __forceinline__ void dw_chunk(const bf16* tile, float* dw_s,
                                         const bf16* dg_t, int Kp, int pcol,
                                         int width) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n0 = (4 * warp + j) * 8;
    if (n0 >= width) break;
    const int col = pcol + n0 + 2 * t;
    float d[4] = {dw_s[g * Kp + col], dw_s[g * Kp + col + 1],
                  dw_s[(g + 8) * Kp + col], dw_s[(g + 8) * Kp + col + 1]};
    const bf16* ic = tile + n0 + g;  // in[b][col] as the k16 x n8 B
#pragma unroll
    for (int k0 = 0; k0 < BT; k0 += 16) {
      const bf16* r = dg_t + g * LDD + k0 + 2 * t;
      mma16816(d, ld32(r), ld32(r + 8 * LDD), ld32(r + 8),
               ld32(r + 8 * LDD + 8),
               pack2(ic[(k0 + 2 * t) * LDT], ic[(k0 + 2 * t + 1) * LDT]),
               pack2(ic[(k0 + 2 * t + 8) * LDT], ic[(k0 + 2 * t + 9) * LDT]));
    }
    dw_s[g * Kp + col] = d[0];
    dw_s[g * Kp + col + 1] = d[1];
    dw_s[(g + 8) * Kp + col] = d[2];
    dw_s[(g + 8) * Kp + col + 1] = d[3];
  }
}

// The groups of 4 dX columns a block owns (K3; 0 for K4).
template <bool SEMI>
__host__ __device__ inline int x_passes(int In, int nblk) {
  return SEMI ? 0 : (In / 4 + nblk - 1) / nblk;
}

// Rows of the owned-column slab in shared memory (pitch 4H + 8): 4 per dX
// group, then the 4 units' W_hh columns.
template <bool SEMI>
__host__ __device__ inline int slab_rows(int In, int nblk) {
  return 4 * x_passes<SEMI>(In, nblk) + UNITS;
}

template <bool SEMI>
size_t bwd_smem_bytes(int In, int H, int nblk) {
  // dw_s [ROWS][Kp] + red_s and dgf_s [BT][ROWS], f32; w_s [ROWS][pitch],
  // tile [BT][LDT], dg_t [ROWS][LDD] and the slab, bf16
  const size_t Kp = SEMI ? H : In + H;
  return sizeof(float) * (ROWS * Kp + 2 * (size_t)BT * ROWS) +
         sizeof(bf16) * ((size_t)ROWS * weight_pitch(In, H) +
                         (size_t)BT * LDT + (size_t)ROWS * LDD +
                         (size_t)slab_rows<SEMI>(In, nblk) * (4 * H + 8));
}

// out: K3 dX (T,B,In), K4 dgx (T,B,4H), bf16. dw_ih, db and dgbuf (the
// (2, B, 4H) bf16 exchange scratch): K3 only.
template <bool SEMI>
__global__ void __launch_bounds__(THREADS)
lstm_fused_bwd_kernel(const bf16* __restrict__ x,
                      const bf16* __restrict__ w_ih,
                      const float* __restrict__ bias,
                      const bf16* __restrict__ w_hh,
                      const bf16* __restrict__ hs,
                      const float* __restrict__ cs,
                      const bf16* __restrict__ dhs, bf16* out,
                      float* __restrict__ dw_ih, float* __restrict__ db,
                      float* __restrict__ dw_hh, bf16* dgbuf, float* dh_buf,
                      float* dc_buf, unsigned int* barrier, int T, int B,
                      int In, int H, int reverse) {
  const int G = GATES * H;
  const int Kp = SEMI ? H : In + H;  // columns of dW
  const int hcol = SEMI ? 0 : In;    // its column of h_{t-1}'s first
  const int LDW = weight_pitch(In, H);
  const int nblk = gridDim.x;
  const int npass = x_passes<SEMI>(In, nblk);
  const int LDS = G + 8;
  extern __shared__ float4 smem4[];
  float* dw_s = reinterpret_cast<float*>(smem4);
  float* red_s = dw_s + (size_t)ROWS * Kp;
  float* dgf_s = red_s + (size_t)BT * ROWS;  // f32 dgates, for db
  bf16* w_s = reinterpret_cast<bf16*>(dgf_s + (size_t)BT * ROWS);
  bf16* tile = w_s + (size_t)ROWS * LDW;
  bf16* dg_t = tile + (size_t)BT * LDT;      // bf16 dgates [q][b]
  bf16* slab = dg_t + (size_t)ROWS * LDD;    // owned columns [n][4H]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int u0 = blockIdx.x * UNITS;
  load_weights(w_s, w_ih, w_hh, In, H, u0);
  for (int i = tid; i < ROWS * Kp; i += THREADS) dw_s[i] = 0.0f;
  // the slab: W_ih[:, 4g + n] of the owned groups (zero past In), then
  // W_hh[:, u0 + n]; zero padding
  const int nslab = slab_rows<SEMI>(In, nblk);
  for (int i = tid; i < nslab * LDS; i += THREADS) {
    const int n = i / LDS;
    const int k = i % LDS;
    bf16 v = __float2bfloat16_rn(0.0f);
    if (k < G) {
      if (n >= 4 * npass) {
        v = w_hh[(size_t)k * H + u0 + n - 4 * npass];
      } else {
        const int col = 4 * (blockIdx.x + (n / 4) * nblk) + n % 4;
        if (col < In) v = w_ih[(size_t)k * In + col];
      }
    }
    slab[i] = v;
  }
  float db_acc = 0.0f;  // thread q < ROWS: db of gate row q

  // cell layout: thread -> (batch row, unit); the same thread owns the
  // (row, unit) dc carry
  const int cb = tid / UNITS;
  const int cj = tid % UNITS;
  float bq[GATES];
#pragma unroll
  for (int q = 0; q < GATES; ++q) bq[q] = bias[(size_t)q * H + u0 + cj];
  // the exchange's fragments: lane -> (g, tq); B row of column n = g is
  // the slab's row g of pass 0 (n < 4) or of the units (n >= 4)
  const int g = lane >> 2;
  const int tq = lane & 3;
  const bf16* brow = slab + (size_t)(g < 4 ? g : 4 * npass + g - 4) * LDS;

  unsigned int barriers = 0;
  for (int s = T - 1; s >= 0; --s) {  // processing steps, walked backward
    const int t = reverse ? T - 1 - s : s;
    const int tp = reverse ? t + 1 : t - 1;  // previous processed position
    const bool first = s == 0;               // h_{t-1} = c_{t-1} = 0
    // this step's bf16 dgates, (B, 4H): the exchange
    bf16* dgx = SEMI ? out + (size_t)t * B * G
                     : dgbuf + (size_t)(s & 1) * B * G;
    for (int b0 = 0; b0 < B; b0 += BT) {
      const int nb = min(BT, B - b0);
      preactivations(red_s, tile, w_s, x, hs, t, tp, first, b0, nb, B, In,
                     H);
      float dg[GATES] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (cb < nb) {
        const int b = b0 + cb;
        const float ig = sigmoid_f(preact(red_s, cb, 0, cj, bq[0]));
        const float fg = sigmoid_f(preact(red_s, cb, 1, cj, bq[1]));
        const float gg = tanhf(preact(red_s, cb, 2, cj, bq[2]));
        const float og = sigmoid_f(preact(red_s, cb, 3, cj, bq[3]));
        const size_t o = ((size_t)t * B + b) * H + u0 + cj;
        const size_t bu = (size_t)b * H + u0 + cj;
        const float c_t = cs[o];
        const float c_prev =
            first ? 0.0f : cs[((size_t)tp * B + b) * H + u0 + cj];
        const float dh = __bfloat162float(dhs[o]) + dh_buf[bu];
        const float tanh_c = tanhf(c_t);
        const float d_o = dh * tanh_c;
        const float dc = dc_buf[bu] + dh * og * (1.0f - tanh_c * tanh_c);
        dg[0] = dc * gg * ig * (1.0f - ig);
        dg[1] = dc * c_prev * fg * (1.0f - fg);
        dg[2] = dc * ig * (1.0f - gg * gg);
        dg[3] = d_o * og * (1.0f - og);
        dc_buf[bu] = dc * fg;
#pragma unroll
        for (int q = 0; q < GATES; ++q)
          dgx[(size_t)b * G + (size_t)q * H + u0 + cj] =
              __float2bfloat16_rn(dg[q]);
      }
      // rows past the tile's end stay zero: they meet zero rows below
#pragma unroll
      for (int q = 0; q < GATES; ++q) {
        dg_t[(q * UNITS + cj) * LDD + cb] = __float2bfloat16_rn(dg[q]);
        dgf_s[cb * ROWS + q * UNITS + cj] = dg[q];
      }
      __syncthreads();
      if (!SEMI && tid < ROWS) {
        float sum = 0.0f;
        for (int b = 0; b < nb; ++b) sum += dgf_s[b * ROWS + tid];
        db_acc += sum;
      }
      if (!SEMI) {
        for (int c0 = 0; c0 < In; c0 += KC) {
          const int width = min(KC, In - c0);
          __syncthreads();
          stage_bf16(tile, x + ((size_t)t * B + b0) * In, In, c0, width, nb);
          __syncthreads();
          dw_chunk(tile, dw_s, dg_t, Kp, c0, width);
        }
      }
      if (!first) {
        for (int c0 = 0; c0 < H; c0 += KC) {
          const int width = min(KC, H - c0);
          __syncthreads();
          stage_bf16(tile, hs + ((size_t)tp * B + b0) * H, H, c0, width, nb);
          __syncthreads();
          dw_chunk(tile, dw_s, dg_t, Kp, hcol + c0, width);
        }
      }
    }
    if (SEMI && first) break;  // nothing left to exchange

    // every block's dgates of step s are written: multiply them by the
    // owned columns, pass p taking the n8 tile [dX group p | the 4 units]
    grid_barrier(barrier, (++barriers) * gridDim.x);
    for (int b0 = 0; b0 < B; b0 += BT) {
      const int nb = min(BT, B - b0);
      float acc[MAXP][4];
#pragma unroll
      for (int p = 0; p < MAXP; ++p)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[p][i] = 0.0f;
      for (int c0 = 0; c0 < G; c0 += KC) {
        const int width = min(KC, G - c0);
        __syncthreads();
        stage_bf16(tile, dgx + (size_t)b0 * G, G, c0, width, nb);
        __syncthreads();
        if (warp < BT / 16) {
          const bf16* a = tile + (size_t)(warp * 16 + g) * LDT + 2 * tq;
          for (int k0 = 0; k0 < width; k0 += 16) {
            const uint32_t a0 = ld32(a + k0);
            const uint32_t a1 = ld32(a + 8 * LDT + k0);
            const uint32_t a2 = ld32(a + k0 + 8);
            const uint32_t a3 = ld32(a + 8 * LDT + k0 + 8);
            const bf16* bk = brow + c0 + k0 + 2 * tq;
#pragma unroll
            for (int p = 0; p < MAXP; ++p) {
              if (p > 0 && p >= npass) break;
              // columns n < 4: dX group p's slab rows; n >= 4: the units'
              const bf16* bp = g < 4 ? bk + (size_t)p * 4 * LDS : bk;
              mma16816(acc[p], a0, a1, a2, a3, ld32(bp), ld32(bp + 8));
            }
          }
        }
      }
      if (warp < BT / 16) {
#pragma unroll
        for (int p = 0; p < MAXP; ++p) {
          if (p > 0 && p >= npass) break;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = warp * 16 + g + 8 * half;
            if (r >= nb) continue;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int n = 2 * tq + e;
              const float v = acc[p][2 * half + e];
              if (n >= 4) {
                if (p == 0 && !first)
                  dh_buf[(size_t)(b0 + r) * H + u0 + n - 4] = v;
              } else if (!SEMI) {
                const int col = 4 * (blockIdx.x + p * nblk) + n;
                if (col < In)
                  out[((size_t)t * B + b0 + r) * In + col] =
                      __float2bfloat16_rn(v);
              }
            }
          }
        }
      }
    }
  }

  __syncthreads();
  for (int i = tid; i < ROWS * Kp; i += THREADS) {
    const int q = i / Kp;
    const int k = i % Kp;
    const size_t row = (size_t)(q / UNITS) * H + u0 + q % UNITS;
    if (k >= hcol)
      dw_hh[row * H + (k - hcol)] = dw_s[i];
    else
      dw_ih[row * In + k] = dw_s[i];
  }
  if (!SEMI && tid < ROWS)
    db[(size_t)(tid / UNITS) * H + u0 + tid % UNITS] = db_acc;
}

// The C entry's checks and launch; args as the kernel's. A block owns at
// most MAXP groups of 4 dX columns: In <= 4 * MAXP * H / 4.
template <bool SEMI>
cudaError_t launch_bwd(const bf16* x, const bf16* w_ih, const float* bias,
                       const bf16* w_hh, const bf16* hs, const float* cs,
                       const bf16* dhs, bf16* out, float* dw_ih, float* db,
                       float* dw_hh, bf16* dgbuf, float* dh_buf,
                       float* dc_buf, unsigned int* barrier, int T, int B,
                       int In, int H, int reverse, cudaStream_t stream) {
  const int nblk = H / UNITS;
  if (In < 8 || In % 8 || H % 16 || T < 1 || B < 1 ||
      x_passes<SEMI>(In, nblk) > MAXP)
    return cudaErrorInvalidValue;
  const size_t smem = bwd_smem_bytes<SEMI>(In, H, nblk);
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  void* args[] = {(void*)&x,      (void*)&w_ih,    (void*)&bias,
                  (void*)&w_hh,   (void*)&hs,      (void*)&cs,
                  (void*)&dhs,    (void*)&out,     (void*)&dw_ih,
                  (void*)&db,     (void*)&dw_hh,   (void*)&dgbuf,
                  (void*)&dh_buf, (void*)&dc_buf,  (void*)&barrier,
                  (void*)&T,      (void*)&B,       (void*)&In,
                  (void*)&H,      (void*)&reverse};
  return launch_cooperative(lstm_fused_bwd_kernel<SEMI>, nblk, THREADS, args,
                            smem, stream);
}

}  // namespace fused
