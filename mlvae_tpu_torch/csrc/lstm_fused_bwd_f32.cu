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
// which its caller forms from dgx. Every product is an exact f32 FMA (no
// tensor cores, no TF32).
//
// What bounds it on an H100, at B=64, T=160, H=512 and 67 TFLOP/s of f32
// FMA: K3 at In=128 three products of 2*B*4H*(In+H)*T FLOP, 1.202 ms; K4 at
// In=512 the recompute, dh and dW_hh, 1.282 ms. The chain of steps runs
// through a reduction across blocks: every block's dgates feed every
// unit's dh_{t-1}.
//
// Design, the split-K schedule (K1-bwd's, lstm_bwd.cu, carried over): one
// persistent cooperative grid of H/4 blocks of 256 threads; block k owns 4
// hidden units, i.e. 16 gate rows, keeps their W_hh rows in shared memory
// (the recompute) and, for the columns of [x | h] (K4: h) a thread owns,
// their W rows and dW in registers, so that dW needs no atomics. A unit of
// work is a step s and a tile of 64 batch rows:
//   the cell: the dgates of the block's rows from the pre-activations, the
//     bias and the dh and dc carries (K4: to dgx[t]; K3: db summed by the
//     cell thread over steps and tiles, then over rows at the end);
//   one pass over the dgates: the block's split-K share of [dX[t] |
//     dh_{t-1}], partial[b][k] = dgates[b, rows] @ W[rows, k] over In + H
//     columns (K4: H), to a ping-pong scratch, and dW[rows, k] +=
//     dgates^T a with a = [x_t | h_{t-1}] from shared memory;
//   the grid barrier's arrival; then, needing no other block, the next
//     unit's copies, pre-activations and cell inputs; the wait;
//   the reduce: each block sums its own units' dh_{t-1} over the blocks'
//     partials in block order (the carry), and (K3) its share of dX[t]'s
//     (column group, row) items, 16 lanes an item.
// This moves the partials through L2, 64 (In + H) floats a block and unit
// (K4: 64 H), where the exchange schedule below read the whole (B, 4H)
// dgates in every block. A thread owns columns tid + 256 kk; K3 at In <=
// 128 and H <= 512 (640 columns at MD_VAE's In=128) gives each thread two
// h columns and one x column over half the tile's rows instead, so that
// no warp owns three columns while another owns two. At B <= 64 the
// carries stay in registers (K1-bwd's split schedule); above, each tile is
// a unit with its own barrier, the carries in dh_buf / dc_buf, and the
// partials (2, H/4, 64, In + H) stay in L2 whatever B.
// The TMA stages h_{t-1} from hs (one 64 x 32 box an mbarrier, 128-byte
// swizzled, as K1-bwd) and x_t from x with W_ih's 16 rows of the same
// columns ([gate][unit][column]) in x slots of 10 KB, one mbarrier a slot:
// K3 keeps every x box of the step in a slot from the recompute to dW_ih;
// K4 runs its boxes through up to four slots in rounds, each round's
// copies landing behind a segment of the h product. The x product sums
// before the h product, each over k in order; the partials over their 16
// rows in order, dW over steps, then tiles, then rows, the reduces over
// blocks in order: no atomics, and every launch gives the same bits.
// Shared memory at H=512: 225,440 bytes for K3 at In=128 and K4 (four x
// slots each).
//
// The exchange schedule (the first design; lstm_fused_f32.cuh), for the
// layouts the split-K schedule cannot hold: K3 where x's boxes do not all
// fit beside the h tile (In=256 at H=512) or In + H passes 768 columns
// (three a thread).
// Block k keeps its dW (16 x (In + H), K4 16 x H) in shared memory. A step:
// dgates(s) from the pre-activations of step s (an f32 (B, 4H) scratch
// `pre`) to the exchange buffer (K3: a (2, B, 4H) ping-pong scratch; K4:
// dgx[t] itself); the arrival; dW(s) (the block's own dgates times the
// staged chunks of x_t and h_{t-1}); the pre-activations of step s - 1; the
// wait; the exchange(s): the staged chunks of the whole (B, 4H) buffer
// times the block's columns of W_hh (its 4 units: dh_{t-1}) and of W_ih
// (K3: dX column groups 4g .. 4g+3, g = k, k + H/4, ...), each sum in its
// column order over 16 K slices.
#include "lstm_fused_f32.cuh"
#include "mbarrier.cuh"

// The step timeline (only with -DMLVAE_BWD_TIMELINE, the timing build of
// tools/bench_bwd_timeline.py): K1-bwd's clock and slots
// (bwd_timeline.cuh), slot 5 partial_dw (the pass forming the partials and
// dW; the exchange schedule's dW) and 7 reduce (dh_{t-1} and dX from the
// partials; the exchange schedule's exchange). Stage is thread 0's time
// in the mbarrier waits (split-K; the exchange schedule's copies lie in
// its recompute and dW).
#ifdef MLVAE_BWD_TIMELINE
#define MLVAE_K1_BWD_TIMELINE
#endif
#include "bwd_timeline.cuh"
#ifdef MLVAE_BWD_TIMELINE
enum { TL_PARTIAL_DW = 5, TL_REDUCE = 7 };
#endif

using namespace f32f;

namespace {

// ---------------------------------------------------------------------------
// The exchange schedule
// ---------------------------------------------------------------------------


// The groups of 4 dX columns a block owns (K3; 0 for K4).
template <bool SEMI>
__host__ __device__ inline int x_passes(int In, int nblk) {
  return SEMI ? 0 : (In / 4 + nblk - 1) / nblk;
}

template <bool SEMI>
size_t exchange_smem(int In, int H) {
  // w_s [ROWS][H + 4], dw_s [ROWS][Kp], red_s, dgt_s [BT][ROWS], stages
  const size_t Kp = SEMI ? H : In + H;
  return sizeof(float) * ((size_t)ROWS * (H + 4) + ROWS * Kp + RED +
                          ROWS * BT + 2 * (size_t)STAGE);
}

template <bool SEMI>
__global__ void __launch_bounds__(THREADS, 1)
exchange_kernel(const float* __restrict__ x,
                          const float* __restrict__ w_ih,
                          const float* __restrict__ bias,
                          const float* __restrict__ w_hh, const float* hs,
                          const float* __restrict__ cs,
                          const float* __restrict__ dhs, float* out,
                          float* __restrict__ dw_ih, float* __restrict__ db,
                          float* __restrict__ dw_hh, float* dgbuf,
                          float* __restrict__ pre, float* __restrict__ dh_buf,
                          float* __restrict__ dc_buf, unsigned int* barrier,
                          int T, int B, int In, int H, int reverse TL_ARG) {
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

  TL_CLOCK;
  recompute(T - 1);
  unsigned int barriers = 0;
  for (int s = T - 1; s >= 0; --s) {  // processing steps, walked backward
    TL_BEGIN();
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
    TL_MARK(TL_CELL);
    TL_ARRIVED();
    dw(s, ex);
    TL_MARK(TL_PARTIAL_DW);
    if (s > 0) recompute(s - 1);
    TL_MARK(TL_RECOMPUTE);
    if (exchanges) {
      grid_wait(barrier, (barriers + 1) * nblk, 0, THREADS);
      TL_MARK(TL_WAIT);
      TL_WAITED();
      exchange(s, ex);
      ++barriers;
    }
    __syncthreads();
    TL_MARK(TL_REDUCE);
    TL_STORE(s);
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
cudaError_t launch_exchange(const float* x, const float* w_ih, const float* bias,
                       const float* w_hh, const float* hs, const float* cs,
                       const float* dhs, float* out, float* dw_ih, float* db,
                       float* dw_hh, float* dgbuf, float* pre, float* dh_buf,
                       float* dc_buf, unsigned int* barrier, int T, int B,
                       int In, int H, int reverse TL_ARG,
                       cudaStream_t stream) {
  const int nblk = H / UNITS;
  if (In < 4 || In % 4 || H % 16 || T < 1 || B < 1 ||
      x_passes<SEMI>(In, nblk) > MAXP)
    return cudaErrorInvalidValue;
  const size_t smem = exchange_smem<SEMI>(In, H);
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  void* args[] = {(void*)&x,      (void*)&w_ih,   (void*)&bias,
                  (void*)&w_hh,   (void*)&hs,     (void*)&cs,
                  (void*)&dhs,    (void*)&out,    (void*)&dw_ih,
                  (void*)&db,     (void*)&dw_hh,  (void*)&dgbuf,
                  (void*)&pre,    (void*)&dh_buf, (void*)&dc_buf,
                  (void*)&barrier, (void*)&T,     (void*)&B,
                  (void*)&In,     (void*)&H,      (void*)&reverse
#ifdef MLVAE_BWD_TIMELINE
                  ,
                  (void*)&timeline
#endif
  };
  return launch_cooperative(exchange_kernel<SEMI>, nblk, THREADS,
                            args, smem, stream);
}

// ---------------------------------------------------------------------------
// The split-K schedule
// ---------------------------------------------------------------------------

constexpr int KSPLIT = 4;             // recompute: K split four ways
constexpr int BOXC = 32;              // columns of a TMA box: 128 bytes
constexpr int BOX = BT * BOXC;        // floats of a box of 64 rows (8 KB)
constexpr int WBOX = ROWS * BOXC;     // W_ih's 16 rows of a box's columns
constexpr int XSLOT = BOX + WBOX;     // floats of an x slot (10 KB)
constexpr int KPMAX = 3;              // columns of the partials a thread
constexpr int RING = 4;               // K4's x slots, at most
constexpr int XRED = 16;              // dX items a pass, lanes an item
static_assert(THREADS == KSPLIT * GATES * (BT / 4), "recompute layout");
static_assert((XSLOT * 4) % 1024 == 0 && (BOX * 4) % 1024 == 0,
              "the swizzle's 1024-byte atoms");

// The split-K layout of a launch: x slots (0: the layout does not fit, or
// the columns of the partials pass KPMAX a thread), shared memory bytes.
struct SplitPlan {
  int slots;
  size_t smem;
};

template <bool SEMI>
SplitPlan split_plan(int In, int H) {
  const size_t nbh = (H + BOXC - 1) / BOXC;
  // h tile, w_s [GATES][H][UNITS], red_s, dg_s, f32; an mbarrier a box
  const size_t fixed = sizeof(float) * (nbh * BOX + (size_t)ROWS * H +
                                        (size_t)KSPLIT * BT * ROWS +
                                        (size_t)BT * ROWS) +
                       sizeof(uint64_t) * nbh;
  const size_t slot = sizeof(float) * XSLOT + sizeof(uint64_t);
  const int nxb = (In + BOXC - 1) / BOXC;
  const int fit = fixed >= SMEM_LIMIT ? 0 : (int)((SMEM_LIMIT - fixed) / slot);
  const int cols = SEMI ? H : In + H;
  int slots = SEMI ? (nxb < RING ? nxb : RING) : nxb;
  if (SEMI ? slots > fit : nxb > fit) slots = SEMI ? fit : 0;
  if (cols > KPMAX * THREADS) slots = 0;
  return {slots, fixed + (size_t)slots * slot};
}

// Offset of element (b, c) of a 64 x 32 box, as the TMA's 128-byte swizzle
// writes it: row b of 128 bytes, 16-byte unit c / 4 at that unit ^ (b % 8).
__device__ __forceinline__ int box_off(int b, int c) {
  return b * BOXC + ((((c >> 2) & 7) ^ (b & 7)) << 2) + (c & 3);
}

// A 4 x 4 transpose across the quad of lanes holding v: lane u (its place
// in the quad) ends with v[j] = the v[u] of lane j (K1-bwd's).
__device__ __forceinline__ void quad_transpose(float (&v)[4], int u) {
  const bool hi = u & 2;
  const float a0 = __shfl_xor_sync(0xffffffffu, hi ? v[0] : v[2], 2);
  const float a1 = __shfl_xor_sync(0xffffffffu, hi ? v[1] : v[3], 2);
  if (hi) {
    v[0] = a0;
    v[1] = a1;
  } else {
    v[2] = a0;
    v[3] = a1;
  }
  const bool lo = u & 1;
  const float b0 = __shfl_xor_sync(0xffffffffu, lo ? v[0] : v[1], 1);
  const float b1 = __shfl_xor_sync(0xffffffffu, lo ? v[2] : v[3], 1);
  if (lo) {
    v[0] = b0;
    v[2] = b1;
  } else {
    v[1] = b0;
    v[3] = b1;
  }
}

__device__ __forceinline__ void tma3(void* dst, const CUtensorMap* map,
                                     int c0, int c1, int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(
          smem_u32(dst)),
      "l"(map), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}

// The cell thread's inputs of one step: c_t, c_{t-1}, the cotangent of h_t
// from above and the dh and dc carries.
struct CellIn {
  float c_t, c_prev, dhs, dh, dc;
};

// The columns of [x | h] (K4: h) a thread owns in the pass, KP of them, all
// 16 rows: column tid + kk * THREADS; with XHALF (K3, In <= 128, H <= 512)
// columns kk < 2 are h columns hcol + tid + kk * THREADS and column 2 the x
// column tid % 128 over half the tile's rows (rows 32 (tid / 128) .. + 31),
// so that the 128 x columns take two threads each and every warp owns two
// and a half columns, not three or two.
template <bool XHALF>
__device__ __forceinline__ int col_of(int t, int kk, int hcol) {
  if (XHALF) return kk < 2 ? hcol + t + kk * THREADS : t & 127;
  return t + kk * THREADS;
}

template <bool SEMI, int KP, bool XHALF>
__global__ void __launch_bounds__(THREADS, 1)
split_kernel(const float* __restrict__ w_ih, const float* __restrict__ bias,
             const float* __restrict__ w_hh, const float* __restrict__ cs,
             const float* __restrict__ dhs, float* __restrict__ out,
             float* __restrict__ dw_ih, float* __restrict__ db,
             float* __restrict__ dw_hh, float* part, float* dh_buf,
             float* dc_buf, unsigned int* barrier, int T, int B, int In,
             int H, int reverse, int ns,
             const __grid_constant__ CUtensorMap map_h,
             const __grid_constant__ CUtensorMap map_x,
             const __grid_constant__ CUtensorMap map_w TL_ARG) {
  extern __shared__ __align__(1024) float4 smem4[];
  const int nbh = (H + BOXC - 1) / BOXC;
  float* tile = reinterpret_cast<float*>(smem4);
  float* xs = tile + (size_t)nbh * BOX;
  float* w_s = xs + (size_t)ns * XSLOT;
  float* red_s = w_s + (size_t)GATES * H * UNITS;
  float* dg_s = red_s + (size_t)KSPLIT * BT * ROWS;
  uint64_t* mb = reinterpret_cast<uint64_t*>(dg_s + (size_t)BT * ROWS);
  uint64_t* xb = mb + nbh;
  if (smem_u32(tile) & 1023) __trap();  // the swizzle's 1024-byte atoms

  const int tid = threadIdx.x;
  const int nblk = gridDim.x;
  const int u0 = blockIdx.x * UNITS;
  const int G = GATES * H;
  const int hcol = SEMI ? 0 : In;     // the partials' first h column
  const int Kc = hcol + H;            // columns of the partials and dW
  const int nxb = (In + BOXC - 1) / BOXC;
  const int ntiles = (B + BT - 1) / BT;
  const int pb = min(B, BT);          // the partials' rows a block

  // this block's W_hh rows, [gate][k][unit]
  for (int idx = tid; idx < GATES * UNITS * H; idx += THREADS) {
    const int k = idx % H;
    const int j = (idx / H) % UNITS;
    const int gate = idx / (H * UNITS);
    w_s[((size_t)gate * H + k) * UNITS + j] =
        w_hh[(size_t)(gate * H + u0 + j) * H + k];
  }
  if (tid == 0) {
    for (int i = 0; i < nbh + ns; ++i) mbar_init(&mb[i]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }

  // recompute layout: thread -> (K slice, gate, batch rows b4 + 16 r)
  const int ks = tid / (GATES * (BT / 4));
  const int gate = (tid / (BT / 4)) % GATES;
  const int b4 = tid % (BT / 4);
  const int kper = H / KSPLIT;
  const int k_lo = ks * kper;
  // cell layout: thread -> (batch row, unit)
  const int cb = tid / UNITS;
  const int cj = tid % UNITS;
  // column layout (col_of): the weights in wr, dW in dw
  float dw[KP][ROWS];
  float wr[KP][ROWS];
#pragma unroll
  for (int kk = 0; kk < KP; ++kk) {
    const int k = col_of<XHALF>(tid, kk, hcol);
#pragma unroll
    for (int q = 0; q < ROWS; ++q) {
      const size_t row = (size_t)(q / UNITS) * H + u0 + q % UNITS;
      dw[kk][q] = 0.0f;
      wr[kk][q] = k < hcol ? w_ih[row * In + k]
                  : k < Kc ? w_hh[row * H + (k - hcol)]
                           : 0.0f;
    }
  }
  float bq[GATES];
#pragma unroll
  for (int q = 0; q < GATES; ++q) bq[q] = bias[(size_t)q * H + u0 + cj];
  float db_acc[GATES] = {0.0f, 0.0f, 0.0f, 0.0f};  // K3: over steps, tiles
  __syncthreads();

  TL_CLOCK;
  TL_BEGIN();
  unsigned int staged = 0;  // h tiles consumed: the h mbarriers' phase
  unsigned int xph = 0;     // each x slot's next parity

  auto pos = [&](int s) { return reverse ? T - 1 - s : s; };
  auto prev = [&](int s) { return reverse ? T - s : s - 1; };

  // thread 0: x box j of rows [b0, b0 + 64) at position t, with W_ih's 16
  // rows of its columns, into x slot `slot`
  auto issue_x = [&](int j, int slot, int t, int b0) {
    float* dst = xs + (size_t)slot * XSLOT;
    mbar_expect(&xb[slot], XSLOT * sizeof(float));
    tma3(dst, &map_x, j * BOXC, b0, t, &xb[slot]);
    tma3(dst + BOX, &map_w, j * BOXC, u0, 0, &xb[slot]);
  };

  // the pre-activations of step s, tile b0, into red_s [K slice][row][gate
  // row]: the x part (each K slice 8 columns of every x box, the boxes in
  // rounds of ns slots) and, for s > 0, the h part (K1-bwd's: each slice
  // H/4 columns in k order), the slice's h columns cut into one segment a
  // round so that a round's copies land behind them
  auto recompute = [&](int s, int b0) {
    const int t = pos(s);
    const bool hpart = s > 0;
    if (tid == 0) {
      for (int j = 0; j < min(ns, nxb); ++j) issue_x(j, j, t, b0);
      if (hpart) {
        for (int j = 0; j < nbh; ++j) {
          mbar_expect(&mb[j], BOX * sizeof(float));
          tma3(tile + (size_t)j * BOX, &map_h, j * BOXC, b0, prev(s), &mb[j]);
        }
      }
    }
    float acc[4][UNITS];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < UNITS; ++j) acc[r][j] = 0.0f;
    const float4* w4 = reinterpret_cast<const float4*>(w_s) +
                       (size_t)gate * H;
    const int sw = b4 & 7;  // the swizzle of rows b4 + 16 r
    const int rounds = (nxb + ns - 1) / ns;
    for (int rd = 0; rd < rounds; ++rd) {
      const int j0 = rd * ns;
      const int j1 = min(nxb, j0 + ns);
      for (int j = j0; j < j1; ++j) {
        const int slot = j - j0;
        TL_MARK(TL_RECOMPUTE);
        mbar_wait(&xb[slot], (xph >> slot) & 1);
        TL_MARK(TL_STAGE);
        xph ^= 1u << slot;
        const float* xsl = xs + (size_t)slot * XSLOT;
        const float* wg = xsl + BOX + gate * UNITS * BOXC;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = ks * 8 + h * 4;
          float4 wv[UNITS];
#pragma unroll
          for (int jj = 0; jj < UNITS; ++jj)
            wv[jj] = *reinterpret_cast<const float4*>(wg + jj * BOXC + c);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float4 v = *reinterpret_cast<const float4*>(
                xsl + box_off(b4 + 16 * r, c));
#pragma unroll
            for (int jj = 0; jj < UNITS; ++jj) {
              float a = acc[r][jj];
              a = fmaf(v.x, wv[jj].x, a);
              a = fmaf(v.y, wv[jj].y, a);
              a = fmaf(v.z, wv[jj].z, a);
              a = fmaf(v.w, wv[jj].w, a);
              acc[r][jj] = a;
            }
          }
        }
      }
      if (j1 < nxb) {
        __syncthreads();  // every slot of the round read
        if (tid == 0)
          for (int j = j1; j < min(nxb, j1 + ns); ++j)
            issue_x(j, j - j1, t, b0);
      }
      if (!hpart) continue;
      // this round's segment of the slice's h columns
      const int kb0 = k_lo + (kper / 4) * rd / rounds * 4;
      const int kb1 = k_lo + (kper / 4) * (rd + 1) / rounds * 4;
      for (int kb = kb0; kb < kb1;) {
        const int box = kb / BOXC;
        const int kend = min(kb1, (box + 1) * BOXC);
        TL_MARK(TL_RECOMPUTE);
        mbar_wait(&mb[box], staged & 1);
        TL_MARK(TL_STAGE);
        const float* tb = tile + (size_t)box * BOX + b4 * BOXC;
#pragma unroll 4
        for (int k = kb; k < kend; k += 4) {
          const int u = (((k >> 2) & 7) ^ sw) << 2;
          float hb[4][4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float4 v =
                *reinterpret_cast<const float4*>(tb + r * 16 * BOXC + u);
            hb[r][0] = v.x;
            hb[r][1] = v.y;
            hb[r][2] = v.z;
            hb[r][3] = v.w;
          }
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float4 wv = w4[k + c];
            const float wj[UNITS] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
              for (int jj = 0; jj < UNITS; ++jj)
                acc[r][jj] = fmaf(hb[r][c], wj[jj], acc[r][jj]);
          }
        }
        kb = kend;
      }
    }
    if (hpart) ++staged;
#pragma unroll
    for (int r = 0; r < 4; ++r)
      *reinterpret_cast<float4*>(
          red_s + ((size_t)ks * BT + b4 + 16 * r) * ROWS + gate * UNITS) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  };

  // the carries of one tile: in registers, or (more than one tile) in
  // dh_buf / dc_buf, read with the cell inputs
  float dh_r = 0.0f;
  float dc_r = ntiles == 1 && cb < B ? dc_buf[(size_t)cb * H + u0 + cj]
                                     : 0.0f;

  // the cell thread's inputs of step s, batch tile b0: c_t, c_{t-1}, the
  // cotangent of h_t from above and the carries
  auto load_in = [&](int s, int b0, CellIn& in) {
    const int b = b0 + cb;
    if (b < B) {
      const size_t o = ((size_t)pos(s) * B + b) * H + u0 + cj;
      in.c_t = cs[o];
      in.c_prev = s == 0 ? 0.0f : cs[((size_t)prev(s) * B + b) * H + u0 + cj];
      in.dhs = dhs[o];
      if (ntiles > 1) {
        in.dh = dh_buf[(size_t)b * H + u0 + cj];
        in.dc = dc_buf[(size_t)b * H + u0 + cj];
      } else {
        in.dh = dh_r;
        in.dc = dc_r;
      }
    }
  };

  // the dgates of step s, tile b0, from red_s, the bias and the carries
  // (dh from the step above; dc, updated to dc * f): to dg_s (rows past B
  // zero), K4's dgx[t], K3's db sums
  auto cell = [&](int s, int b0, const CellIn& in) {
    const int b = b0 + cb;
    float dg[GATES] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (b < B) {
      float pre[GATES];
#pragma unroll
      for (int q = 0; q < GATES; ++q) {
        float sum = red_s[(size_t)cb * ROWS + q * UNITS + cj];
#pragma unroll
        for (int kk = 1; kk < KSPLIT; ++kk)
          sum = __fadd_rn(
              sum, red_s[((size_t)kk * BT + cb) * ROWS + q * UNITS + cj]);
        pre[q] = __fadd_rn(sum, bq[q]);
      }
      const float ig = sigmoid_f(pre[0]);
      const float fg = sigmoid_f(pre[1]);
      const float gg = tanhf(pre[2]);
      const float og = sigmoid_f(pre[3]);
      // K1-bwd's contraction: every product rounded, 1 - x^2 and dc's
      // update one FMA each
      const float dh = __fadd_rn(in.dhs, in.dh);
      const float tanh_c = tanhf(in.c_t);
      const float d_o = __fmul_rn(dh, tanh_c);
      const float dc = __fmaf_rn(__fmul_rn(dh, og),
                                 __fmaf_rn(-tanh_c, tanh_c, 1.0f), in.dc);
      dg[0] = __fmul_rn(__fmul_rn(__fmul_rn(dc, gg), ig),
                        __fsub_rn(1.0f, ig));
      dg[1] = __fmul_rn(__fmul_rn(__fmul_rn(dc, in.c_prev), fg),
                        __fsub_rn(1.0f, fg));
      dg[2] = __fmul_rn(__fmul_rn(dc, ig), __fmaf_rn(-gg, gg, 1.0f));
      dg[3] = __fmul_rn(__fmul_rn(d_o, og), __fsub_rn(1.0f, og));
      const float dc_next = __fmul_rn(dc, fg);
      if (ntiles > 1)
        dc_buf[(size_t)b * H + u0 + cj] = dc_next;
      else
        dc_r = dc_next;
      if (SEMI) {
        float* dgr = out + ((size_t)pos(s) * B + b) * G + u0 + cj;
#pragma unroll
        for (int q = 0; q < GATES; ++q) dgr[(size_t)q * H] = dg[q];
      } else {
#pragma unroll
        for (int q = 0; q < GATES; ++q)
          db_acc[q] = __fadd_rn(db_acc[q], dg[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < GATES; ++q) dg_s[cb * ROWS + q * UNITS + cj] = dg[q];
  };

  // One pass over the tile's nb rows and this thread's columns k < lim of
  // [x | h] (col_of): partial[b][k] = sum_row dgates[b][row] * W[row][k],
  // rows in order, into part_s [Kc/4][pb][4] (the quad of lanes that holds
  // four rows of columns k - k % 4 .. + 3 turns them around, so that lane
  // u stores row bb + u's four columns as one float4), and dW[rows][k] +=
  // sum_b dgates[b][row] * a[b][k], a = x_t (K3's columns k < In, from the
  // x slots) or h_{t-1} (the h tile), rows in order. K1-bwd's pass.
  auto pass = [&](float* part_s, int nb, int lim) {
    const int u = tid & 3;
    // each column's source in shared memory, (offset from the h tile << 3)
    // | its 16-byte unit in a 128-byte row; bit kk of `on`: the warp's
    // quads are whole (its first column is in range), bit kk + 4: this
    // thread's column is
    int asrc[KP];
    unsigned int on = 0;
    const int xlo = 32 * (tid >> 7);  // XHALF: the x column's rows
#pragma unroll
    for (int kk = 0; kk < KP; ++kk) {
      const int k = col_of<XHALF>(tid, kk, hcol);
      const int kh = k - hcol;
      const int c = (k < hcol ? k : kh) & 31;
      const int off = (k < hcol ? nbh * BOX + (k >> 5) * XSLOT
                                : (max(kh, 0) >> 5) * BOX) + (c & 3);
      asrc[kk] = (off << 3) | (c >> 2);
      const bool half = XHALF && kk == 2;
      if (col_of<XHALF>(tid & ~31, kk, hcol) < (half ? In : lim))
        on |= 1u << kk;
      if (k < lim && (!half || k < In)) on |= 16u << kk;
    }
#pragma unroll 2  // two groups of rows in flight
    for (int bb = 0; bb < nb; bb += 4) {
      float dgv[4][ROWS];
      const float4* g4 = reinterpret_cast<const float4*>(dg_s);
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
      for (int kk = 0; kk < KP; ++kk) {
        if (XHALF && kk == 2 && (bb < xlo || bb >= xlo + 32))
          continue;  // warp-uniform
        const int k = col_of<XHALF>(tid, kk, hcol);
        if (on & (1u << kk)) {
          float v[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            float p = 0.0f;
#pragma unroll
            for (int q = 0; q < ROWS; ++q) p = fmaf(dgv[r][q], wr[kk][q], p);
            v[r] = p;
          }
          quad_transpose(v, u);
          if ((on & (16u << kk)) && bb + u < nb)
            *reinterpret_cast<float4*>(
                part_s + ((size_t)(k >> 2) * pb + bb + u) * UNITS) =
                make_float4(v[0], v[1], v[2], v[3]);
        }
        if (on & (16u << kk)) {
          const float* src = tile + (asrc[kk] >> 3);
          const int unit = asrc[kk] & 7;
          float a[4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            a[r] = src[(bb + r) * BOXC + ((unit ^ ((bb + r) & 7)) << 2)];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < ROWS; ++q)
              dw[kk][q] = fmaf(dgv[r][q], a[r], dw[kk][q]);
        }
      }
    }
  };

  // dh_{t-1} for the tile's row tid / 4, unit tid % 4: the partials of
  // every block, through L2, in block order (four lanes, then shuffles)
  // (sixteen loads in flight a lane; eight where K4's three columns a
  // thread leave no registers for them)
  constexpr int DH_UNROLL = SEMI && KP == 3 ? 8 : 16;
  auto reduce_dh = [&](const float* part_all, int nb) {
    const int lane_q = tid % UNITS;
    const int r = tid / UNITS;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r < nb) {
#pragma unroll DH_UNROLL
      for (int k2 = lane_q; k2 < nblk; k2 += UNITS) {
        const float4 v = __ldcg(reinterpret_cast<const float4*>(
            part_all + (size_t)k2 * pb * Kc +
            ((size_t)(hcol / 4 + blockIdx.x) * pb + r) * UNITS));
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      }
    }
#pragma unroll
    for (int off = 1; off < UNITS; off <<= 1) {
      acc.x += __shfl_xor_sync(0xffffffffu, acc.x, off);
      acc.y += __shfl_xor_sync(0xffffffffu, acc.y, off);
      acc.z += __shfl_xor_sync(0xffffffffu, acc.z, off);
      acc.w += __shfl_xor_sync(0xffffffffu, acc.w, off);
    }
    return lane_q == 0 ? acc.x
           : lane_q == 1 ? acc.y
           : lane_q == 2 ? acc.z
                         : acc.w;
  };

  // K3's dX[t] for the tile's rows: the items (column group g, row r), i =
  // g * nb + r, of the (In/4) x nb, a run of consecutive items a block;
  // thread (lane l, item j) sums the partials of blocks l, l + 16, ... in
  // order (a warp reads 16 consecutive items of two blocks: whole
  // sectors), then item j's 16 lane sums in order through dg_s (free
  // between the pass and the next cell)
  auto reduce_dx = [&](const float* part_all, int s, int b0, int nb) {
    const int n = (In / 4) * nb;
    const int per = (n + nblk - 1) / nblk;
    const int first = blockIdx.x * per;
    const int last = min(n, first + per);
    const int j = tid % XRED;
    const int lane = tid / XRED;
    float4* sums = reinterpret_cast<float4*>(dg_s);  // [lane][item]
    for (int i0 = first; i0 < last; i0 += XRED) {
      const int i = i0 + j;
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (i < last) {
        const int g = i / nb;
        const int r = i - g * nb;
#pragma unroll 8
        for (int k2 = lane; k2 < nblk; k2 += THREADS / XRED) {
          const float4 v = __ldcg(reinterpret_cast<const float4*>(
              part_all + (size_t)k2 * pb * Kc +
              ((size_t)g * pb + r) * UNITS));
          acc.x += v.x;
          acc.y += v.y;
          acc.z += v.z;
          acc.w += v.w;
        }
      }
      sums[lane * XRED + j] = acc;
      __syncthreads();
      if (tid < XRED && i < last) {
        float4 v = sums[j];
#pragma unroll
        for (int l = 1; l < THREADS / XRED; ++l) {
          const float4 w = sums[l * XRED + j];
          v.x += w.x;
          v.y += w.y;
          v.z += w.z;
          v.w += w.w;
        }
        const int g = i / nb;
        *reinterpret_cast<float4*>(
            out + ((size_t)pos(s) * B + b0 + i - g * nb) * In + 4 * g) = v;
      }
      __syncthreads();  // sums read; dg_s free for the next cell
    }
  };

  // The walk: step s from T - 1 down, tile b0 within it, each (step, tile)
  // a unit: its cell, its pass, the barrier's arrival; then the next unit's
  // copies, pre-activations and cell inputs (no other block's writes); the
  // wait; the unit's reduce. One tile (B <= 64) is K1-bwd's split schedule.
  // The partials ping-pong between two slots by the barrier's count.
  unsigned int arrivals = 0;
  CellIn in;
  recompute(T - 1, 0);
  load_in(T - 1, 0, in);
  __syncthreads();  // red_s
  for (int s = T - 1; s >= 0; --s) {
    TL_BEGIN();
    for (int b0 = 0; b0 < B; b0 += BT) {
      const int nb = min(BT, B - b0);
      // the next unit: the next tile of this step, or step s - 1's first
      const bool next = b0 + BT < B || s > 0;
      const int s_n = b0 + BT < B ? s : s - 1;
      const int b0_n = b0 + BT < B ? b0 + BT : 0;
      cell(s, b0, in);
      __syncthreads();  // dg_s written, red_s read
      TL_MARK(TL_CELL);
      if (SEMI && s == 0) {  // K4's step 0: dgx only
        if (next) {
          recompute(s_n, b0_n);
          load_in(s_n, b0_n, in);
          __syncthreads();
          TL_MARK(TL_RECOMPUTE);
        }
        continue;
      }
      float* slot = part + (size_t)(arrivals & 1) * nblk * pb * Kc;
      // K3's step 0: dX and dW_ih, no h_{t-1}
      pass(slot + (size_t)blockIdx.x * pb * Kc, nb, s == 0 ? hcol : Kc);
      grid_arrive(barrier);  // the tiles and dg_s free, partials published
      ++arrivals;
      TL_MARK(TL_PARTIAL_DW);
      TL_ARRIVED();
      if (next) {
        recompute(s_n, b0_n);
        TL_MARK(TL_RECOMPUTE);
        load_in(s_n, b0_n, in);
        TL_MARK(TL_LOADS);
      }
      grid_wait(barrier, arrivals * nblk, 0, THREADS);
      TL_MARK(TL_WAIT);
      TL_WAITED();
      if (s > 0) {  // thread (cb, cj) reads this carry next
        const float dh = reduce_dh(slot, nb);
        if (ntiles == 1)
          dh_r = dh;
        else if (tid / UNITS < nb)
          dh_buf[(size_t)(b0 + tid / UNITS) * H + u0 + tid % UNITS] = dh;
        if (ntiles == 1 && next) in.dh = dh_r;
      }
      if (!SEMI) reduce_dx(slot, s, b0, nb);
      TL_MARK(TL_REDUCE);
    }
    TL_STORE(s);
  }

  // dW; XHALF's x column summed over its two halves of rows, in order
  if constexpr (XHALF) {
    __syncthreads();
    if (tid >= 128)
#pragma unroll
      for (int q = 0; q < ROWS; ++q) red_s[(tid - 128) * ROWS + q] = dw[2][q];
    __syncthreads();
  }
#pragma unroll
  for (int kk = 0; kk < KP; ++kk) {
    const int k = col_of<XHALF>(tid, kk, hcol);
    const bool half = XHALF && kk == 2;
    if (k < Kc && (!half || (tid < 128 && k < In))) {
#pragma unroll
      for (int q = 0; q < ROWS; ++q) {
        const size_t row = (size_t)(q / UNITS) * H + u0 + q % UNITS;
        if (k < hcol)
          dw_ih[row * In + k] =
              half ? __fadd_rn(dw[kk][q], red_s[tid * ROWS + q]) : dw[kk][q];
        else
          dw_hh[row * H + (k - hcol)] = dw[kk][q];
      }
    }
  }
  if (!SEMI) {  // db: each gate row's sum over the cell threads, in order
    __syncthreads();
#pragma unroll
    for (int q = 0; q < GATES; ++q)
      red_s[cb * ROWS + q * UNITS + cj] = db_acc[q];
    __syncthreads();
    if (tid < ROWS) {
      float sum = 0.0f;
      for (int b = 0; b < BT; ++b) sum = __fadd_rn(sum, red_s[b * ROWS + tid]);
      db[(size_t)(tid / UNITS) * H + u0 + tid % UNITS] = sum;
    }
  }
}

// A tensor map over the 3-D f32 tensor `base` (dims innermost first,
// dense), boxes of box0 x box1 x box2, zeros past the ends.
inline cudaError_t f32_map(CUtensorMap* map, const float* base,
                           const cuuint64_t (&dims)[3], const cuuint32_t
                           (&box)[3], bool swizzle) {
  PFN_cuTensorMapEncodeTiled_v12000 encode;
  const cudaError_t err = tensor_map_encoder(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t strides[2] = {dims[0] * sizeof(float),
                                 dims[0] * dims[1] * sizeof(float)};
  const cuuint32_t step[3] = {1, 1, 1};
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
             const_cast<float*>(base), dims, strides, box, step,
             CU_TENSOR_MAP_INTERLEAVE_NONE,
             swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

enum Schedule { EXCHANGE = 0, SPLIT = 1 };

// The schedule a launch takes: split-K where its layout fits, else
// exchange.
template <bool SEMI>
int schedule_of(int In, int H) {
  return split_plan<SEMI>(In, H).slots ? SPLIT : EXCHANGE;
}

// The floats of a launch's `work` scratch: the split-K partials (2, H/4,
// min(B, 64), In + H) (K4: H columns), or the exchange schedule's (2, B,
// 4H) exchange buffer (K3) and (B, 4H) pre-activations.
template <bool SEMI>
size_t work_floats(int In, int H, int B) {
  if (schedule_of<SEMI>(In, H) == EXCHANGE)
    return (size_t)B * GATES * H * (SEMI ? 1 : 3);
  return (size_t)2 * (H / UNITS) * (B < BT ? B : BT) * (SEMI ? H : In + H);
}

// The kernel a launch takes: 0 the exchange schedule's; in the split-K
// schedule 1 two columns of the partials a thread, 2 three, 3 (K3) two h
// columns and half an x one.
template <bool SEMI>
int variant_of(int In, int H) {
  if (schedule_of<SEMI>(In, H) == EXCHANGE) return 0;
  if ((SEMI ? H : In + H) <= 2 * THREADS) return 1;
  return !SEMI && In <= 128 && H <= 2 * THREADS ? 3 : 2;
}

template <bool SEMI>
const void* kernel_of(int variant) {
  switch (variant) {
    case 0: return (const void*)exchange_kernel<SEMI>;
    case 1: return (const void*)split_kernel<SEMI, 2, false>;
    case 2: return (const void*)split_kernel<SEMI, 3, false>;
    default: return (const void*)split_kernel<SEMI, 3, !SEMI>;
  }
}

template <bool SEMI>
cudaError_t launch_bwd(const float* x, const float* w_ih, const float* bias,
                       const float* w_hh, const float* hs, const float* cs,
                       const float* dhs, float* out, float* dw_ih, float* db,
                       float* dw_hh, float* work, float* dh_buf,
                       float* dc_buf, unsigned int* barrier, int T, int B,
                       int In, int H, int reverse, long long work_size TL_ARG,
                       cudaStream_t stream) {
  if (In < 4 || In % 4 || H % 16 || T < 1 || B < 1)
    return cudaErrorInvalidValue;
  // the kernels write the whole scratch of their schedule
  if (work_size < 0 || (size_t)work_size < work_floats<SEMI>(In, H, B))
    return cudaErrorInvalidValue;
  const int variant = variant_of<SEMI>(In, H);
  if (variant == 0) {
    // work: K3's (2, B, 4H) exchange buffer, then pre (B, 4H)
    float* dgbuf = SEMI ? nullptr : work;
    float* pre = SEMI ? work : work + (size_t)2 * B * GATES * H;
    return launch_exchange<SEMI>(x, w_ih, bias, w_hh, hs, cs, dhs, out,
                                 dw_ih, db, dw_hh, dgbuf, pre, dh_buf, dc_buf,
                                 barrier, T, B, In, H, reverse,
#ifdef MLVAE_BWD_TIMELINE
                                 timeline,
#endif
                                 stream);
  }
  const SplitPlan plan = split_plan<SEMI>(In, H);
  // hs (H, B, T) and x (In, B, T): boxes of 32 columns x 64 rows, 128-byte
  // swizzled; W_ih as (In, H, 4 gates): boxes of 32 columns x the block's 4
  // units x 4 gates, [gate][unit][column]
  CUtensorMap map_h, map_x, map_w;
  cudaError_t err = f32_map(&map_h, hs, {(cuuint64_t)H, (cuuint64_t)B,
                                         (cuuint64_t)T}, {BOXC, BT, 1}, true);
  if (err == cudaSuccess)
    err = f32_map(&map_x, x, {(cuuint64_t)In, (cuuint64_t)B, (cuuint64_t)T},
                  {BOXC, BT, 1}, true);
  if (err == cudaSuccess)
    err = f32_map(&map_w, w_ih, {(cuuint64_t)In, (cuuint64_t)H, GATES},
                  {BOXC, UNITS, GATES}, false);
  if (err != cudaSuccess) return err;
  int ns = plan.slots;
  void* args[] = {(void*)&w_ih,   (void*)&bias,  (void*)&w_hh,
                  (void*)&cs,     (void*)&dhs,   (void*)&out,
                  (void*)&dw_ih,  (void*)&db,    (void*)&dw_hh,
                  (void*)&work,   (void*)&dh_buf, (void*)&dc_buf,
                  (void*)&barrier, (void*)&T,    (void*)&B,
                  (void*)&In,     (void*)&H,     (void*)&reverse,
                  (void*)&ns,     (void*)&map_h, (void*)&map_x,
                  (void*)&map_w
#ifdef MLVAE_BWD_TIMELINE
                  ,
                  (void*)&timeline
#endif
  };
  return launch_cooperative(variant == 1   ? split_kernel<SEMI, 2, false>
                            : variant == 3 ? split_kernel<SEMI, 3, !SEMI>
                                           : split_kernel<SEMI, 3, false>,
                            H / UNITS, THREADS, args, plan.smem, stream);
}

template <bool SEMI>
size_t smem_of(int In, int H) {
  return schedule_of<SEMI>(In, H) == EXCHANGE ? exchange_smem<SEMI>(In, H)
                                             : split_plan<SEMI>(In, H).smem;
}

template <bool SEMI>
int plan_of(int In, int H, int B, long long* out) {
  const int variant = variant_of<SEMI>(In, H);
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel_of<SEMI>(variant));
  out[0] = schedule_of<SEMI>(In, H);
  out[1] = split_plan<SEMI>(In, H).slots;
  out[2] = (long long)smem_of<SEMI>(In, H);
  out[3] = (long long)work_floats<SEMI>(In, H, B);
  out[4] = variant;
  out[5] = err == cudaSuccess ? attr.numRegs : 0;
  out[6] = err == cudaSuccess ? (long long)attr.localSizeBytes : 0;
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

const char* mlvae_lstm_fused_bwd_f32_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K3-bwd: x (T,B,In), w_ih (4H,In), bias (4H,), w_hh (4H,H), hs, cs, dhs
// (T,B,H), f32; dx (T,B,In), dw_ih (4H,In), db (4H,), dw_hh (4H,H) f32
// outputs; scratch: work (work_size floats, at least the plan's: see
// mlvae_lstm_fused_bwd_f32_plan), dh_buf (B,H) zeroed, dc_buf (B,H) holding
// dc_last, barrier one zeroed counter. In a multiple of 4 up to 4H, H of
// 16, x, w_ih, w_hh and hs 16-byte aligned. Returns a cudaError_t. The
// timing build (MLVAE_BWD_TIMELINE) is mlvae_lstm_fused_bwd_f32_timeline,
// which also takes the (T, H/4, 10) u64 timeline before the stream.
#ifdef MLVAE_BWD_TIMELINE
int mlvae_lstm_fused_bwd_f32_timeline(
#else
int mlvae_lstm_fused_bwd_f32(
#endif
    const float* x, const float* w_ih, const float* bias, const float* w_hh,
    const float* hs, const float* cs, const float* dhs, float* dx,
    float* dw_ih, float* db, float* dw_hh, float* work, float* dh_buf,
    float* dc_buf, unsigned int* barrier, int T, int B, int In, int H,
    int reverse, long long work_size TL_ARG, cudaStream_t stream) {
  return launch_bwd<false>(x, w_ih, bias, w_hh, hs, cs, dhs, dx, dw_ih, db,
                           dw_hh, work, dh_buf, dc_buf, barrier, T, B, In, H,
                           reverse, work_size,
#ifdef MLVAE_BWD_TIMELINE
                           timeline,
#endif
                           stream);
}

// K4-bwd: as K3-bwd with dgx (T,B,4H) f32 and dw_hh the outputs.
#ifdef MLVAE_BWD_TIMELINE
int mlvae_lstm_semi_bwd_f32_timeline(
#else
int mlvae_lstm_semi_bwd_f32(
#endif
    const float* x, const float* w_ih, const float* bias, const float* w_hh,
    const float* hs, const float* cs, const float* dhs, float* dgx,
    float* dw_hh, float* work, float* dh_buf, float* dc_buf,
    unsigned int* barrier, int T, int B, int In, int H, int reverse,
    long long work_size TL_ARG, cudaStream_t stream) {
  return launch_bwd<true>(x, w_ih, bias, w_hh, hs, cs, dhs, dgx, nullptr,
                          nullptr, dw_hh, work, dh_buf, dc_buf, barrier, T, B,
                          In, H, reverse, work_size,
#ifdef MLVAE_BWD_TIMELINE
                          timeline,
#endif
                          stream);
}

// The launch's shared memory bytes, whatever B (not a launch).
int mlvae_lstm_fused_bwd_f32_smem(int In, int H, int semi) {
  return static_cast<int>(semi ? smem_of<true>(In, H)
                               : smem_of<false>(In, H));
}

// The plan of a launch at In, H, B (not a launch): out[0] its schedule (0
// exchange, 1 split-K), out[1] the split-K schedule's x slots (0 where it
// does not fit), out[2] shared memory bytes, out[3] the floats of its work
// scratch, out[4] its kernel (variant_of), out[5] and out[6] that kernel's
// registers and local memory bytes a thread. Returns a cudaError_t.
int mlvae_lstm_fused_bwd_f32_plan(int In, int H, int B, int semi,
                                  long long* out) {
  return semi ? plan_of<true>(In, H, B, out) : plan_of<false>(In, H, B, out);
}

}  // extern "C"
