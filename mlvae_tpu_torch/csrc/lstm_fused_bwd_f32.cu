// K3-bwd and K4-bwd on f32 streams: backpropagation through the fused LSTM
// recurrence, exact f32.
//
// Replaces the TPU kernels mlvae_tpu/ops/lstm_pallas.py `_bwd_fused_kernel`
// (launched by `_run_bwd_fused`; SEMI = false) and `_bwd_semi_kernel`
// (launched by `_run_bwd_semi`; SEMI = true) in f32 mode. It walks the
// processing order backward from dh = 0 and dc = dc_last. At each step it
// recomputes the pre-activations x_t @ W_ih^T + bias + h_{t-1} @ W_hh^T from
// x and the saved hs, takes the f32 dgates from `_bptt_dgates`' math and
// carries dc * f:
//   dX[t]    = dgates @ W_ih                   (K3; (T,B,In))
//   dh_{t-1} = dgates @ W_hh                   (carried)
//   dW_ih   += dgates^T x_t,  dW_hh += dgates^T h_{t-1}   (dW_ih: K3)
//   db      += dgates summed over the batch    (K3)
// K4 writes the dgates to dgx (T,B,4H) instead of forming dX, dW_ih and db,
// which its caller forms from dgx.
//
// What bounds it on an H100, at B=64, T=160, H=512 and 67 TFLOP/s of f32
// FMA: K3 at In=128 three products of 2*B*4H*(In+H)*T FLOP, 1.202 ms; K4 at
// In=512 the recompute, dh and dW_hh, 1.282 ms. The chain of steps is
// dgates -> exchange -> dh: every block needs all 4H dgates of a step.
//
// Design (lstm_fused_f32.cuh): block k owns 16 gate rows, keeps their W_hh
// rows in shared memory, and their dW (K3: In + H columns, K4: H) in
// shared memory, each entry summed by one thread only, so there are no
// atomics and every launch gives the same bits. A step:
//   dgates(s): the cell threads, from the pre-activations of step s (an
//     f32 (B, 4H) scratch `pre`, each thread its own entries), dhs, cs and
//     the dh and dc carries, write the step's dgates to the exchange
//     buffer (K3: a (2, B, 4H) ping-pong scratch; K4: dgx[t] itself);
//   the grid barrier's arrival; then, needing no other block:
//   dW(s): the block's own dgates (16 x 64 a tile, from the exchange
//     buffer) times the staged chunks of x_t (K3) and h_{t-1};
//   the pre-activations of step s - 1 (staged x and hs chunks, W_ih's rows
//     staged with them);
//   the wait; then the exchange(s): the staged chunks of the whole (B, 4H)
//     buffer times the block's columns of W_hh (its 4 units: dh_{t-1}) and
//     of W_ih (K3: dX column groups 4g .. 4g+3, g = k, k + H/4, ...),
//     staged with them, each sum in its column order over 16 K slices.
// The exchange moves B * 4H f32 through L2 a step and block.
#include "lstm_fused_f32.cuh"

using namespace f32f;

namespace {

// The groups of 4 dX columns a block owns (K3; 0 for K4).
template <bool SEMI>
__host__ __device__ inline int x_passes(int In, int nblk) {
  return SEMI ? 0 : (In / 4 + nblk - 1) / nblk;
}

template <bool SEMI>
size_t smem_bytes(int In, int H) {
  // w_s [ROWS][H + 4], dw_s [ROWS][Kp], red_s, dgt_s [BT][ROWS], stages
  const size_t Kp = SEMI ? H : In + H;
  return sizeof(float) * ((size_t)ROWS * (H + 4) + ROWS * Kp + RED +
                          ROWS * BT + 2 * (size_t)STAGE);
}

template <bool SEMI>
__global__ void __launch_bounds__(THREADS, 1)
lstm_fused_bwd_f32_kernel(const float* __restrict__ x,
                          const float* __restrict__ w_ih,
                          const float* __restrict__ bias,
                          const float* __restrict__ w_hh, const float* hs,
                          const float* __restrict__ cs,
                          const float* __restrict__ dhs, float* out,
                          float* __restrict__ dw_ih, float* __restrict__ db,
                          float* __restrict__ dw_hh, float* dgbuf,
                          float* __restrict__ pre, float* __restrict__ dh_buf,
                          float* __restrict__ dc_buf, unsigned int* barrier,
                          int T, int B, int In, int H, int reverse) {
  extern __shared__ __align__(16) float smem[];
  const int LDH = H + 4;
  const int Kp = SEMI ? H : In + H;  // columns of dW
  const int hcol = SEMI ? 0 : In;    // its column of h_{t-1}'s first
  float* w_s = smem;
  float* dw_s = w_s + ROWS * LDH;
  float* red_s = dw_s + (size_t)ROWS * Kp;
  float* dgt_s = red_s + RED;  // the tile's own dgates [b][q]
  float* stages = dgt_s + ROWS * BT;

  const int tid = threadIdx.x;
  const int nblk = gridDim.x;
  const int u0 = blockIdx.x * UNITS;
  const int G = GATES * H;
  const int npass = x_passes<SEMI>(In, nblk);
  const int ng = 1 + npass;  // the exchange's column groups
  const int ntiles = (B + BT - 1) / BT;
  const int cb = tid / UNITS;  // cell layout: thread -> (batch row, unit)
  const int cj = tid % UNITS;
  load_whh(w_s, w_hh, H, u0);
  for (int i = tid; i < ROWS * Kp; i += THREADS) dw_s[i] = 0.0f;
  float bq[GATES];
#pragma unroll
  for (int q = 0; q < GATES; ++q) bq[q] = bias[(size_t)q * H + u0 + cj];
  float db_acc = 0.0f;  // thread q < ROWS: db of gate row q
  __syncthreads();

  auto pos = [&](int s) { return reverse ? T - 1 - s : s; };
  auto prev = [&](int s) { return reverse ? T - s : s - 1; };

  // The pre-activations of step s, every tile, to `pre`.
  auto recompute = [&](int s) {
    for (int i = 0; i < ntiles; ++i) {
      const int b0 = i * BT;
      const int nb = min(BT, B - b0);
      float acc[4][UNITS];
      zero_acc(acc);
      input_product(acc, stages, x + ((size_t)pos(s) * B + b0) * In, In, nb,
                    In, w_ih, H, u0);
      if (s > 0)
        hidden_product(acc, stages, hs + ((size_t)prev(s) * B + b0) * H, H,
                       nb, H, w_s, LDH);
      store_red(red_s, acc);
      __syncthreads();
      if (cb < nb) {
#pragma unroll
        for (int q = 0; q < GATES; ++q)
          pre[(size_t)(b0 + cb) * G + (size_t)q * H + u0 + cj] =
              red_sum(red_s, cb, q, cj) + bq[q];
      }
      __syncthreads();
    }
  };

  // The dgates of step s, every tile, to the exchange buffer ex; the dc
  // carry; K3's db.
  auto dgates = [&](int s, float* ex) {
    const int t = pos(s);
    for (int i = 0; i < ntiles; ++i) {
      const int b0 = i * BT;
      const int nb = min(BT, B - b0);
      float dg[GATES] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (cb < nb) {
        const int b = b0 + cb;
        const size_t pr = (size_t)b * G + u0 + cj;
        const float ig = sigmoid_f(pre[pr]);
        const float fg = sigmoid_f(pre[pr + H]);
        const float gg = tanhf(pre[pr + 2 * (size_t)H]);
        const float og = sigmoid_f(pre[pr + 3 * (size_t)H]);
        const size_t bu = (size_t)b * H + u0 + cj;
        const size_t o = ((size_t)t * B + b) * H + u0 + cj;
        const float dh = dhs[o] + dh_buf[bu];
        const float c_t = cs[o];
        const float c_prev =
            s == 0 ? 0.0f : cs[((size_t)prev(s) * B + b) * H + u0 + cj];
        const float tanh_c = tanhf(c_t);
        const float d_o = dh * tanh_c;
        const float dc = dc_buf[bu] + dh * og * (1.0f - tanh_c * tanh_c);
        dg[0] = dc * gg * ig * (1.0f - ig);
        dg[1] = dc * c_prev * fg * (1.0f - fg);
        dg[2] = dc * ig * (1.0f - gg * gg);
        dg[3] = d_o * og * (1.0f - og);
        dc_buf[bu] = dc * fg;
#pragma unroll
        for (int q = 0; q < GATES; ++q) ex[pr + (size_t)q * H] = dg[q];
      }
      if (!SEMI) {
#pragma unroll
        for (int q = 0; q < GATES; ++q) red_s[cb * ROWS + q * UNITS + cj] =
            dg[q];
        __syncthreads();
        if (tid < ROWS) {
          float sum = 0.0f;
          for (int b = 0; b < nb; ++b) sum += red_s[b * ROWS + tid];
          db_acc += sum;
        }
        __syncthreads();
      }
    }
  };

  // dW of step s: the block's dgates (from ex) times x_t (K3) and h_{t-1}.
  // Thread (half, column c) sums rows q = 8 half .. 8 half + 7 of column c,
  // over the tile's rows b in order, reading a chunk entry and two float4
  // of dgates a row.
  auto dw = [&](int s, const float* ex) {
    const int qh = tid >> 7;
    const int c = tid & (KC - 1);
    const int nx = SEMI ? 0 : (In + KC - 1) / KC;  // chunks of x_t
    const int nh = s == 0 ? 0 : (H + KC - 1) / KC;  // chunks of h_{t-1}
    for (int i = 0; i < ntiles; ++i) {
      const int b0 = i * BT;
      const int nb = min(BT, B - b0);
      for (int e = tid; e < ROWS * BT; e += THREADS) {
        const int b = e / ROWS;
        const int q = e % ROWS;
        dgt_s[e] = b < nb ? __ldcg(ex + (size_t)(b0 + b) * G +
                                   (size_t)(q / UNITS) * H + u0 + q % UNITS)
                          : 0.0f;
      }
      // the first stage's __syncthreads publishes dgt_s
      pipeline(
          stages, nx + nh,
          [&](int j, float* st) {
            if (j < nx)
              stage_rows(st, BT, x + ((size_t)pos(s) * B + b0) * In, In, nb,
                         j * KC, min(KC, In - j * KC));
            else
              stage_rows(st, BT, hs + ((size_t)prev(s) * B + b0) * H, H, nb,
                         (j - nx) * KC, min(KC, H - (j - nx) * KC));
          },
          [&](int j, const float* st) {
            const int wd = j < nx ? min(KC, In - j * KC)
                                  : min(KC, H - (j - nx) * KC);
            const int col = j < nx ? j * KC + c : hcol + (j - nx) * KC + c;
            if (c >= wd) return;
            float acc[8];
#pragma unroll
            for (int r = 0; r < 8; ++r) acc[r] = 0.0f;
#pragma unroll 4
            for (int b = 0; b < BT; ++b) {
              const float a = st[b * KCP + c];
              const float4* d = reinterpret_cast<const float4*>(
                  dgt_s + b * ROWS + 8 * qh);
              const float4 d0 = d[0], d1 = d[1];
              const float dq[8] = {d0.x, d0.y, d0.z, d0.w,
                                   d1.x, d1.y, d1.z, d1.w};
#pragma unroll
              for (int r = 0; r < 8; ++r) acc[r] = fmaf(dq[r], a, acc[r]);
            }
#pragma unroll
            for (int r = 0; r < 8; ++r)
              dw_s[(8 * qh + r) * Kp + col] += acc[r];
          });
      __syncthreads();  // dgt_s is free for the next tile
    }
  };

  // The exchange of step s: thread (K slice ks, b4) sums rows b4 + 16 r of
  // each column group over g = 8 ks .. 8 ks + 7 of each chunk of 4H.
  auto exchange = [&](int s, const float* ex) {
    const int t = pos(s);
    const int ks = tid >> 4;
    const int b4 = tid & 15;
    const int nchunks = (G + KC - 1) / KC;
    for (int i = 0; i < ntiles; ++i) {
      const int b0 = i * BT;
      const int nb = min(BT, B - b0);
      float acc[NGMAX][4][4];
#pragma unroll
      for (int n = 0; n < NGMAX; ++n)
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][r][e] = 0.0f;
      pipeline(
          stages, nchunks,
          [&](int j, float* st) {
            const int g0 = j * KC;
            const int wd = min(KC, G - g0);
            stage_rows(st, BT, ex + (size_t)b0 * G, G, nb, g0, wd);
            // the column groups' rows g0 .. g0 + wd: [g][n][4]; thread
            // (n parity, g)
            float* slab = st + BT * KCP;
            const int g = tid & (KC - 1);
            for (int n = tid / KC; n < ng && g < wd; n += THREADS / KC) {
              float* dst = slab + (g * ng + n) * 4;
              if (n == 0) {
                cp16(dst, w_hh + (size_t)(g0 + g) * H + u0, true);
              } else {
                const int col = 4 * (blockIdx.x + (n - 1) * nblk);
                const bool ok = col < In;
                cp16(dst, ok ? w_ih + (size_t)(g0 + g) * In + col : w_ih, ok);
              }
            }
          },
          [&](int j, const float* st) {
            const int wd = min(KC, G - j * KC);
            const float* slab = st + BT * KCP;
            const int g_lo = 8 * ks;
            if (g_lo >= wd) return;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int g = g_lo + 4 * h;
              float4 dv[4];
#pragma unroll
              for (int r = 0; r < 4; ++r)
                dv[r] = *reinterpret_cast<const float4*>(
                    st + (b4 + 16 * r) * KCP + g);
#pragma unroll
              for (int n = 0; n < NGMAX; ++n) {
                if (n >= ng) break;
                float4 wv[4];
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  wv[e] = *reinterpret_cast<const float4*>(
                      slab + ((g + e) * ng + n) * 4);
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                  const float d[4] = {dv[r].x, dv[r].y, dv[r].z, dv[r].w};
#pragma unroll
                  for (int e = 0; e < 4; ++e) {
                    acc[n][r][0] = fmaf(d[e], wv[e].x, acc[n][r][0]);
                    acc[n][r][1] = fmaf(d[e], wv[e].y, acc[n][r][1]);
                    acc[n][r][2] = fmaf(d[e], wv[e].z, acc[n][r][2]);
                    acc[n][r][3] = fmaf(d[e], wv[e].w, acc[n][r][3]);
                  }
                }
              }
            }
          });
      // each group's 16 slices summed in order by thread (row, column)
#pragma unroll
      for (int n = 0; n < NGMAX; ++n) {
        if (n >= ng) break;
#pragma unroll
        for (int r = 0; r < 4; ++r)
          *reinterpret_cast<float4*>(red_s + (ks * BT + b4 + 16 * r) * 4) =
              make_float4(acc[n][r][0], acc[n][r][1], acc[n][r][2],
                          acc[n][r][3]);
        __syncthreads();
        const int row = tid >> 2;
        const int col = tid & 3;
        float v = red_s[row * 4 + col];
        for (int k = 1; k < 16; ++k) v += red_s[(k * BT + row) * 4 + col];
        if (row < nb) {
          if (n == 0) {
            if (s > 0) dh_buf[(size_t)(b0 + row) * H + u0 + col] = v;
          } else {
            const int xc = 4 * (blockIdx.x + (n - 1) * nblk) + col;
            if (xc < In) out[((size_t)t * B + b0 + row) * In + xc] = v;
          }
        }
        __syncthreads();
      }
    }
  };

  recompute(T - 1);
  unsigned int barriers = 0;
  for (int s = T - 1; s >= 0; --s) {  // processing steps, walked backward
    const int t = pos(s);
    // K3's slot s & 1 is safe to overwrite here: this block passed its
    // wait of step s + 1, which every block reached only after its
    // exchange of step s + 2, the slot's last read.
    float* ex = SEMI ? out + (size_t)t * B * G
                     : dgbuf + (size_t)(s & 1) * B * G;
    const bool exchanges = !(SEMI && s == 0);  // K4's step 0 has none
    dgates(s, ex);
    if (exchanges)
      grid_arrive(barrier);
    else
      __syncthreads();
    dw(s, ex);
    if (s > 0) recompute(s - 1);
    if (exchanges) {
      grid_wait(barrier, (barriers + 1) * nblk, 0, THREADS);
      exchange(s, ex);
      ++barriers;
    }
    __syncthreads();
  }

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

template <bool SEMI>
cudaError_t launch_bwd(const float* x, const float* w_ih, const float* bias,
                       const float* w_hh, const float* hs, const float* cs,
                       const float* dhs, float* out, float* dw_ih, float* db,
                       float* dw_hh, float* dgbuf, float* pre, float* dh_buf,
                       float* dc_buf, unsigned int* barrier, int T, int B,
                       int In, int H, int reverse, cudaStream_t stream) {
  const int nblk = H / UNITS;
  if (In < 4 || In % 4 || H % 16 || T < 1 || B < 1 ||
      x_passes<SEMI>(In, nblk) > MAXP)
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes<SEMI>(In, H);
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  void* args[] = {(void*)&x,      (void*)&w_ih,   (void*)&bias,
                  (void*)&w_hh,   (void*)&hs,     (void*)&cs,
                  (void*)&dhs,    (void*)&out,    (void*)&dw_ih,
                  (void*)&db,     (void*)&dw_hh,  (void*)&dgbuf,
                  (void*)&pre,    (void*)&dh_buf, (void*)&dc_buf,
                  (void*)&barrier, (void*)&T,     (void*)&B,
                  (void*)&In,     (void*)&H,      (void*)&reverse};
  return launch_cooperative(lstm_fused_bwd_f32_kernel<SEMI>, nblk, THREADS,
                            args, smem, stream);
}

}  // namespace

extern "C" {

const char* mlvae_lstm_fused_bwd_f32_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K3-bwd: x (T,B,In), w_ih (4H,In), bias (4H,), w_hh (4H,H), hs, cs, dhs
// (T,B,H), f32; dx (T,B,In), dw_ih (4H,In), db (4H,), dw_hh (4H,H) f32
// outputs; scratch: dgbuf (2,B,4H), pre (B,4H), dh_buf (B,H) zeroed, dc_buf
// (B,H) holding dc_last, barrier one zeroed counter. In a multiple of 4 up
// to 4H, H of 16, every pointer 16-byte aligned. Returns a cudaError_t.
int mlvae_lstm_fused_bwd_f32(const float* x, const float* w_ih,
                             const float* bias, const float* w_hh,
                             const float* hs, const float* cs,
                             const float* dhs, float* dx, float* dw_ih,
                             float* db, float* dw_hh, float* dgbuf,
                             float* pre, float* dh_buf, float* dc_buf,
                             unsigned int* barrier, int T, int B, int In,
                             int H, int reverse, cudaStream_t stream) {
  return launch_bwd<false>(x, w_ih, bias, w_hh, hs, cs, dhs, dx, dw_ih, db,
                           dw_hh, dgbuf, pre, dh_buf, dc_buf, barrier, T, B,
                           In, H, reverse, stream);
}

// K4-bwd: as K3-bwd with dgx (T,B,4H) f32 and dw_hh the outputs; no dgbuf.
int mlvae_lstm_semi_bwd_f32(const float* x, const float* w_ih,
                            const float* bias, const float* w_hh,
                            const float* hs, const float* cs,
                            const float* dhs, float* dgx, float* dw_hh,
                            float* pre, float* dh_buf, float* dc_buf,
                            unsigned int* barrier, int T, int B, int In,
                            int H, int reverse, cudaStream_t stream) {
  return launch_bwd<true>(x, w_ih, bias, w_hh, hs, cs, dhs, dgx, nullptr,
                          nullptr, dw_hh, nullptr, pre, dh_buf, dc_buf,
                          barrier, T, B, In, H, reverse, stream);
}

// The launch's shared memory bytes (not a launch).
int mlvae_lstm_fused_bwd_f32_smem(int In, int H, int semi) {
  return static_cast<int>(semi ? smem_bytes<true>(In, H)
                               : smem_bytes<false>(In, H));
}

}  // extern "C"
