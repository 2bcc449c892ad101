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
// itself), and, over the chunks again, its dW on the tensor cores. dX[t]
// and dh_{t-1} need all 4H dgates of the step: after a grid barrier each
// block reads the whole (B, 4H) exchange buffer through L2 and multiplies
// it by the columns it owns, W_hh's for its 4 units' dh and W_ih's for dX
// columns 4g .. 4g+3, g = k, k + H/4, ... (held in shared memory), on the
// tensor cores in a fixed order. The exchange moves B * 4H bf16 through
// L2 per step, and the (T, B, 4H) dgates of K3 never reach memory.
//
// The schedule. Only the dgates and the exchange lie on the chain of
// steps: the dW of step s and the recompute of step s-1's pre-activations
// read x, hs and the step's own dgates, which the block holds. So the
// step's grid barrier is split (grid_arrive / grid_wait), and after the
// arrival the block splits in two warp groups that run at once:
//   all:       dgates(s) -> exchange slot -> arrive -> loads of cs/dhs
//              for dgates(s-1)
//   warps 0-3: wait -> exchange(s)
//   warps 4-7: dW(s), then the pre-activations of step s-1
//   all:       __syncthreads -> dgates(s-1)
// with the recompute of step T-1 as a prologue. Each of the three is a
// chain of dependent tensor-core products (the exchange's 4H / 16 a step),
// so running the groups' chains side by side hides one's latency behind
// the other's. Every chunk of x_t, h_{t-1} and the exchange (64 rows x
// 128 columns) is copied by the TMA, two requests a chunk from a 3-D
// descriptor that zero-fills past the batch's and the columns' ends, into
// one of its group's two tiles (128-byte swizzled, read by ldmatrix); the
// next chunk is in flight while the products run on this one, and a
// group syncs on its own named barrier. Per-thread copies (cp.async, 16
// bytes a thread) cost more a chunk than the products they fed. Every sum keeps its order (dW step after step from T-1 down to
// 0, tile after tile, x columns then h columns; each pre-activation and
// exchange chain in its column order), so the outputs have the bits of the
// schedule that ran the four phases in series. A launch whose tiles'
// pre-activations and dgates do not all fit in shared memory (more than
// MAXT tiles, or past 227 KB) runs the phases in series (each tile:
// recompute, dgates, dW; then the exchange), with the same copies.
#pragma once

#include "lstm_fused_tma.cuh"

namespace fused {

constexpr int LDD = BT + 8;   // bf16 pitch of dg_t [ROWS][LDD]
constexpr int MAXP = 4;       // dX column groups a block may own
constexpr int MAXT = 4;       // batch tiles kept across the barrier: B <= 256
constexpr int BAR_X = 1, BAR_W = 2;  // the groups' named barriers
static_assert(GROUP == (BT / 16) * 32, "a warp of the exchange: 16 rows");
static_assert(KCB == (GROUP / 32) * 32, "dW: 32 columns a warp of group W");

#ifdef MLVAE_BWD_TIMELINE
// The timing build: timeline[s][block][k] holds %globaltimer at step s's
// k = 0 start, 1 dgates done and arrived, 2 dW done, 3 pre-activations of
// step s-1 done (warp 4, lane 0), 4 the wait done, 5 the exchange done
// (thread 0), 6 the groups joined.
constexpr int STAMPS = 7;
#define BWD_STAMP_BY(s, k, lead)                                         \
  do {                                                                   \
    if (threadIdx.x == (lead)) {                                         \
      unsigned long long ns_;                                            \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns_));            \
      timeline[((size_t)(s) * gridDim.x + blockIdx.x) * STAMPS + (k)] =  \
          ns_;                                                           \
    }                                                                    \
  } while (0)
#define BWD_TIMELINE_ARG , unsigned long long* timeline
#else
#define BWD_STAMP_BY(s, k, lead) \
  do {                           \
  } while (0)
#define BWD_TIMELINE_ARG
#endif
#define BWD_STAMP(s, k) BWD_STAMP_BY(s, k, 0)

// f32 row pitch of dw_s: Kp and enough padding that the pitch is 8 words
// past a multiple of 32, so that the float2 accesses of dw_chunk (rows g
// and g + 8, columns 2t) meet no bank twice in a half-warp.
__host__ __device__ inline int dw_pitch(int Kp) {
  return Kp + (40 - Kp % 32) % 32;
}

// dW of one staged chunk on the tensor cores, columns [0, width) of the
// chunk (width a multiple of 8): warp wg (0-3) of group W takes the 8-wide
// column tiles 4 wg .. 4 wg + 3, dW[q][col] += dgates[b][q]^T in[b][col]
// over the tile's 64 rows (dg_t: the bf16 dgates as [q][b]; rows past the
// tile's end have zero dgates and zero inputs), each tile's sum over the
// rows in the same order, 16 at a time. The fragments come by ldmatrix (A
// from dg_t, B transposed from the tile: k 0-7 / 8-15 of columns n0, then
// of n0 + 8), dW by float2 at pitch KpP. pcol is the dW column of the
// chunk's first column. No barrier inside.
__device__ __forceinline__ void dw_chunk(const bf16* tile, float* dw_s,
                                         const bf16* dg_t, int KpP, int pcol,
                                         int width, int wg) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int ntw = min(4, (width - 32 * wg + 7) / 8);  // column tiles
  if (ntw <= 0) return;
  float d[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j >= ntw) break;
    const int col = pcol + 32 * wg + 8 * j + 2 * t;
    const float2 lo = *reinterpret_cast<const float2*>(dw_s + g * KpP + col);
    const float2 hi =
        *reinterpret_cast<const float2*>(dw_s + (g + 8) * KpP + col);
    d[j][0] = lo.x;
    d[j][1] = lo.y;
    d[j][2] = hi.x;
    d[j][3] = hi.y;
  }
  const bf16* pa = a_frag_addr(dg_t, LDD, 0);
  const int brow = (lane & 7) + 8 * ((lane >> 3) & 1);
  const int bcol = 32 * wg + 8 * (lane >> 4);
#pragma unroll
  for (int k0 = 0; k0 < BT; k0 += 16) {
    uint32_t a[4], b01[4], b23[4];
    ldsm_x4(a, pa + k0);
    ldsm_x4_trans(b01, tile_at(tile, k0 + brow, bcol));
    if (ntw > 2) ldsm_x4_trans(b23, tile_at(tile, k0 + brow, bcol + 16));
    mma16816(d[0], a[0], a[1], a[2], a[3], b01[0], b01[1]);
    if (ntw > 1) mma16816(d[1], a[0], a[1], a[2], a[3], b01[2], b01[3]);
    if (ntw > 2) mma16816(d[2], a[0], a[1], a[2], a[3], b23[0], b23[1]);
    if (ntw > 3) mma16816(d[3], a[0], a[1], a[2], a[3], b23[2], b23[3]);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j >= ntw) break;
    const int col = pcol + 32 * wg + 8 * j + 2 * t;
    *reinterpret_cast<float2*>(dw_s + g * KpP + col) =
        make_float2(d[j][0], d[j][1]);
    *reinterpret_cast<float2*>(dw_s + (g + 8) * KpP + col) =
        make_float2(d[j][2], d[j][3]);
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

// Shared memory of a launch over `ntiles` batch tiles. `ahead` keeps every
// tile's pre-activations and dgates across the barrier and gives each warp
// group two chunk tiles: at H=512, B=64, 199.2 KB at In=512 (K3), 167.1 KB
// at In=1024 (K4); each further tile adds 6.25 KB (B=256 at In=512: 217.9
// KB). The serial schedule keeps one tile and its groups take turns on two
// chunk tiles, the smallest layout: at H=512 it takes K3-bwd up to
// In + H = 1480 and K4-bwd up to In + H = 4472.
template <bool SEMI>
size_t bwd_smem_bytes(int In, int H, int nblk, int ntiles, bool ahead) {
  // the chunk tiles [4 or 2][TILE], first (the swizzle wants 1024-byte
  // alignment), bf16; dw_s [ROWS][dw_pitch(Kp)] and red_s [nres][BT][ROWS]
  // (the tile's f32 pre-activations, then its f32 dgates), f32; w_s
  // [ROWS][pitch], dg_t [nres][ROWS][LDD] and the slab, bf16; the tiles'
  // four mbarriers. Every part a multiple of 16 bytes (ldmatrix).
  const size_t KpP = dw_pitch(SEMI ? H : In + H);
  const size_t nres = ahead ? ntiles : 1;
  return sizeof(bf16) * (ahead ? 4 : 2) * (size_t)TILE +
         sizeof(float) * (ROWS * KpP + nres * BT * ROWS) +
         sizeof(bf16) * ((size_t)ROWS * weight_pitch(In, H) +
                         nres * ROWS * LDD +
                         (size_t)slab_rows<SEMI>(In, nblk) * (4 * H + 8)) +
         4 * sizeof(uint64_t);
}

// The schedule a launch takes: 1 keeps every tile across the barrier.
template <bool SEMI>
inline int keeps_tiles(int In, int H, int B, int nblk) {
  const int ntiles = (B + BT - 1) / BT;
  return ntiles <= MAXT &&
         bwd_smem_bytes<SEMI>(In, H, nblk, ntiles, true) <= SMEM_LIMIT;
}

// The cell thread's dgates of batch row b0 + cb at step t (cb < nb), from
// the tile's pre-activations `red` and the step's c_t, c_prev and dhs[t]
// (f32): the bf16 dgates to the exchange dgx and to dg_t ([q][b], zero
// past nb), the dc carry, and (K3) the tile's f32 dgates summed into db.
// The f32 dgates take the place of the pre-activations in `red`: each
// thread reads only its own entries there before it writes them. Starts
// with __syncthreads; ends with one before the db sums.
template <bool SEMI>
__device__ __forceinline__ void tile_dgates(
    float* red, bf16* dg_t, bf16* dgx, float* dh_buf,
    float* dc_buf, const float (&bq)[GATES], float c_t, float c_prev,
    float dh_in, int b0, int nb, int H, int u0, float& db_acc) {
  const int tid = threadIdx.x;
  const int cb = tid / UNITS;
  const int cj = tid % UNITS;
  const int G = GATES * H;
  __syncthreads();
  float dg[GATES] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (cb < nb) {
    const int b = b0 + cb;
    const float ig = sigmoid_f(preact(red, cb, 0, cj, bq[0]));
    const float fg = sigmoid_f(preact(red, cb, 1, cj, bq[1]));
    const float gg = tanhf(preact(red, cb, 2, cj, bq[2]));
    const float og = sigmoid_f(preact(red, cb, 3, cj, bq[3]));
    const size_t bu = (size_t)b * H + u0 + cj;
    const float dh = dh_in + dh_buf[bu];
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
  // rows past the tile's end stay zero: they meet zero rows in dW
#pragma unroll
  for (int q = 0; q < GATES; ++q) {
    dg_t[(q * UNITS + cj) * LDD + cb] = __float2bfloat16_rn(dg[q]);
    red[cb * ROWS + q * UNITS + cj] = dg[q];
  }
  __syncthreads();
  if (!SEMI && tid < ROWS) {
    float sum = 0.0f;
    for (int b = 0; b < nb; ++b) sum += red[b * ROWS + tid];
    db_acc += sum;
  }
}

// out: K3 dX (T,B,In), K4 dgx (T,B,4H), bf16. dw_ih, db and dgbuf (the
// (2, B, 4H) bf16 exchange scratch): K3 only. ahead: keeps_tiles().
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
                      int In, int H, int reverse, int ahead,
                      const __grid_constant__ CUtensorMap map_x,
                      const __grid_constant__ CUtensorMap map_h,
                      const __grid_constant__ CUtensorMap map_dg
                          BWD_TIMELINE_ARG) {
  const int G = GATES * H;
  const int Kp = SEMI ? H : In + H;  // columns of dW
  const int KpP = dw_pitch(Kp);      // and its pitch in dw_s
  const int hcol = SEMI ? 0 : In;    // its column of h_{t-1}'s first
  const int LDW = weight_pitch(In, H);
  const int nblk = gridDim.x;
  const int npass = x_passes<SEMI>(In, nblk);
  const int LDS = G + 8;
  const int ntiles = (B + BT - 1) / BT;
  const int nres = ahead ? ntiles : 1;
  extern __shared__ __align__(1024) float4 smem4[];
  bf16* bufs_x = reinterpret_cast<bf16*>(smem4);  // group X's chunk tiles
  // group W's: their own when the groups run at once, else the same
  bf16* bufs_w = bufs_x + (ahead ? 2 * (size_t)TILE : 0);
  float* dw_s = reinterpret_cast<float*>(bufs_w + 2 * (size_t)TILE);
  float* red_s = dw_s + (size_t)ROWS * KpP;      // [nres] pre-activations
  bf16* w_s = reinterpret_cast<bf16*>(red_s + (size_t)nres * BT * ROWS);
  bf16* dg_all = w_s + (size_t)ROWS * LDW;       // [nres] bf16 dgates [q][b]
  bf16* slab = dg_all + (size_t)nres * ROWS * LDD;  // owned columns [n][4H]
  // full[group][tile]: the chunk tiles' mbarriers (group 0 X, 1 W)
  uint64_t* full = reinterpret_cast<uint64_t*>(
      slab + (size_t)slab_rows<SEMI>(In, nblk) * LDS);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int u0 = blockIdx.x * UNITS;
  load_weights(w_s, w_ih, w_hh, In, H, u0);
  for (int i = tid; i < ROWS * KpP; i += THREADS) dw_s[i] = 0.0f;
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
  unsigned int phase[2] = {0, 0};  // each group's tiles' next parities
  if (tid == 0) {
    if (smem_u32(smem4) & 1023) __trap();  // the swizzled tiles' alignment
    for (int i = 0; i < 4; ++i) mbar_init(&full[i]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

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
  const bool in_w = tid >= GROUP;  // group W (warps 4-7), else group X
  const int wg = warp & 3;         // the warp within its group

  auto pos = [&](int s) { return reverse ? T - 1 - s : s; };
  auto prev = [&](int s) { return reverse ? T - s : s - 1; };
  const int nx = (In + KCB - 1) / KCB;  // chunks of x_t
  const int nh = (H + KCB - 1) / KCB;   // chunks of h_{t-1}
  auto tile_rows = [&](int i) { return min(BT, B - i * BT); };

  // Group W's jobs. The pre-activations of step s for tile i: x chunks,
  // then h_{t-1}'s unless s == 0, one accumulator chain for each of warp
  // wg's two 16 x 8 tiles, stored to `red` after the last chunk.
  float acc_pre[2][4];
  auto pre_jobs = [&](int s) { return nx + (s == 0 ? 0 : nh); };
  auto pre_chunk = [&](int s, int i, int r) {
    return r < nx ? Chunk{&map_x, r * KCB, i * BT, pos(s)}
                  : Chunk{&map_h, (r - nx) * KCB, i * BT, prev(s)};
  };
  auto pre_work = [&](int s, int r, const bf16* tile, float* red) {
    if (r == 0) {
#pragma unroll
      for (int e = 0; e < 8; ++e) acc_pre[e / 4][e % 4] = 0.0f;
    }
    const int wcol = r < nx ? r * KCB : In + (r - nx) * KCB;
    const int width = r < nx ? min(KCB, In - r * KCB)
                             : min(KCB, H - (r - nx) * KCB);
    pre_chunk_mma(acc_pre, tile, w_s, LDW, wcol, width, wg);
    if (r == pre_jobs(s) - 1) {
      const int row = wg * 16 + g;
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
        const int q = ni * 8 + 2 * tq;
        red[row * ROWS + q] = acc_pre[ni][0];
        red[row * ROWS + q + 1] = acc_pre[ni][1];
        red[(row + 8) * ROWS + q] = acc_pre[ni][2];
        red[(row + 8) * ROWS + q + 1] = acc_pre[ni][3];
      }
    }
  };
  // dW of step s for one tile: (K3) x chunks, then h_{t-1}'s unless s == 0
  auto dw_jobs = [&](int s) { return (SEMI ? 0 : nx) + (s == 0 ? 0 : nh); };
  auto dw_chunk_of = [&](int s, int i, int r) {
    return pre_chunk(s, i, SEMI ? r + nx : r);
  };
  auto dw_work = [&](int r, const bf16* tile, const bf16* dg_t) {
    const int rr = SEMI ? r + nx : r;
    if (rr < nx)
      dw_chunk(tile, dw_s, dg_t, KpP, rr * KCB, min(KCB, In - rr * KCB), wg);
    else
      dw_chunk(tile, dw_s, dg_t, KpP, hcol + (rr - nx) * KCB,
               min(KCB, H - (rr - nx) * KCB), wg);
  };

  // Group X's job: the exchange of step s, tile after tile, chunk after
  // chunk of the 4H dgates; warp wg takes rows 16 wg .. of each tile, pass
  // p the n8 tile [dX group p | the 4 units]
  float acc[MAXP][4];
  const int ng = (G + KCB - 1) / KCB;
  auto exchange = [&](int s) {
    const int t = pos(s);
    const bool first = s == 0;
    pipeline(
        bufs_x, full, phase[0], ntiles * ng, 0, BAR_X, true,
        [&](int j) {
          return Chunk{&map_dg, (j % ng) * KCB, (j / ng) * BT,
                       SEMI ? pos(s) : (s & 1)};
        },
        [&](int j, const bf16* tile) {
          const int i = j / ng;
          const int r = j % ng;
          const int c0 = r * KCB;
          const int width = min(KCB, G - c0);  // a multiple of 64
          if (r == 0) {
#pragma unroll
            for (int p = 0; p < MAXP; ++p)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[p][e] = 0.0f;
          }
          const int arow = 16 * wg + (lane & 7) + 8 * ((lane >> 3) & 1);
          const int acol = 8 * (lane >> 4);
#pragma unroll 4
          for (int k0 = 0; k0 < width; k0 += 16) {
            uint32_t af[4];
            ldsm_x4(af, tile_at(tile, arow, acol + k0));
            const bf16* bk = brow + c0 + k0 + 2 * tq;
#pragma unroll
            for (int p = 0; p < MAXP; ++p) {
              if (p > 0 && p >= npass) break;
              // columns n < 4: dX group p's slab rows; n >= 4: the units'
              const bf16* bp = g < 4 ? bk + (size_t)p * 4 * LDS : bk;
              mma16816(acc[p], af[0], af[1], af[2], af[3], ld32(bp),
                       ld32(bp + 8));
            }
          }
          if (r != ng - 1) return;
          const int b0 = i * BT;
          const int nb = tile_rows(i);
#pragma unroll
          for (int p = 0; p < MAXP; ++p) {
            if (p > 0 && p >= npass) break;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int rw = wg * 16 + g + 8 * half;
              if (rw >= nb) continue;
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int n = 2 * tq + e;
                const float v = acc[p][2 * half + e];
                if (n >= 4) {
                  if (p == 0 && !first)
                    dh_buf[(size_t)(b0 + rw) * H + u0 + n - 4] = v;
                } else if (!SEMI) {
                  const int col = 4 * (blockIdx.x + p * nblk) + n;
                  if (col < In)
                    out[((size_t)t * B + b0 + rw) * In + col] =
                        __float2bfloat16_rn(v);
                }
              }
            }
          }
        });
  };

  // the cs / dhs values of the cell thread's rows, tile i, for dgates(s)
  float pc[MAXT], pp[MAXT], pd[MAXT];
  auto load_cell = [&](int s, int i, float& c_t, float& c_prev,
                       float& dh_in) {
    const int b = i * BT + cb;
    c_t = c_prev = dh_in = 0.0f;
    if (b < B) {
      const size_t o = ((size_t)pos(s) * B + b) * H + u0 + cj;
      c_t = cs[o];
      c_prev = s == 0 ? 0.0f : cs[((size_t)prev(s) * B + b) * H + u0 + cj];
      dh_in = __bfloat162float(dhs[o]);
    }
  };
  auto prefetch = [&](int s) {
#pragma unroll
    for (int i = 0; i < MAXT; ++i)
      if (i < ntiles) load_cell(s, i, pc[i], pp[i], pd[i]);
  };

  if (ahead) {  // the prologue: step T-1's pre-activations and loads
    prefetch(T - 1);
    if (in_w) {
      const int per = pre_jobs(T - 1);
      pipeline(
          bufs_w, full + 2, phase[1], ntiles * per, GROUP, BAR_W, false,
          [&](int j) { return pre_chunk(T - 1, j / per, j % per); },
          [&](int j, const bf16* tile) {
            pre_work(T - 1, j % per, tile,
                     red_s + (size_t)(j / per) * BT * ROWS);
          });
    }
  }

  unsigned int barriers = 0;
  for (int s = T - 1; s >= 0; --s) {  // processing steps, walked backward
    const int t = pos(s);
    const bool first = s == 0;  // h_{t-1} = c_{t-1} = 0
    const bool exchanges = !(SEMI && first);  // K4's step 0 has none
    // this step's bf16 dgates, (B, 4H): the exchange. K3's slot s & 1 is
    // safe to overwrite here: this block passed its join of iteration s+1,
    // after its wait there, which every block reached only after its
    // exchange of step s + 2, the slot's last read.
    bf16* dgx = SEMI ? out + (size_t)t * B * G
                     : dgbuf + (size_t)(s & 1) * B * G;
    BWD_STAMP(s, 0);
    if (ahead) {
#pragma unroll
      for (int i = 0; i < MAXT; ++i)
        if (i < ntiles)
          tile_dgates<SEMI>(red_s + (size_t)i * BT * ROWS,
                            dg_all + (size_t)i * ROWS * LDD, dgx,
                            dh_buf, dc_buf, bq, pc[i], pp[i], pd[i], i * BT,
                            tile_rows(i), H, u0, db_acc);
      // the exchange's TMA copies read dgx through the async proxy
      asm volatile("fence.proxy.async.global;" ::: "memory");
      if (exchanges) grid_arrive(barrier);
      BWD_STAMP(s, 1);
      if (!first) prefetch(s - 1);
      if (in_w) {
        // dW(s) of every tile, then the pre-activations of step s - 1 of
        // every tile, one stream of chunks
        const int pw = dw_jobs(s);
        const int ndw = ntiles * pw;
        const int pr = first ? 0 : pre_jobs(s - 1);
        pipeline(
            bufs_w, full + 2, phase[1], ndw + ntiles * pr, GROUP, BAR_W, false,
            [&](int j) {
              return j < ndw ? dw_chunk_of(s, j / pw, j % pw)
                             : pre_chunk(s - 1, (j - ndw) / pr,
                                         (j - ndw) % pr);
            },
            [&](int j, const bf16* tile) {
              if (j < ndw) {
                dw_work(j % pw, tile,
                        dg_all + (size_t)(j / pw) * ROWS * LDD);
              } else {
                if (j == ndw) BWD_STAMP_BY(s, 2, GROUP);
                pre_work(s - 1, (j - ndw) % pr, tile,
                         red_s + (size_t)((j - ndw) / pr) * BT * ROWS);
              }
            });
        if (first) BWD_STAMP_BY(s, 2, GROUP);
        BWD_STAMP_BY(s, 3, GROUP);
      } else if (exchanges) {
        grid_wait(barrier, (barriers + 1) * nblk, BAR_X, GROUP);
        BWD_STAMP(s, 4);
        exchange(s);
        BWD_STAMP(s, 5);
      }
    } else {  // the serial schedule: every phase of the step on the chain
      for (int i = 0; i < ntiles; ++i) {
        if (in_w) {
          pipeline(
              bufs_w, full + 2, phase[1], pre_jobs(s), GROUP, BAR_W, false,
              [&](int r) { return pre_chunk(s, i, r); },
              [&](int r, const bf16* tile) { pre_work(s, r, tile, red_s); });
        }
        float c_t, c_prev, dh_in;
        load_cell(s, i, c_t, c_prev, dh_in);
        tile_dgates<SEMI>(red_s, dg_all, dgx, dh_buf, dc_buf, bq, c_t, c_prev,
                          dh_in, i * BT, tile_rows(i), H, u0, db_acc);
        if (in_w) {
          pipeline(
              bufs_w, full + 2, phase[1], dw_jobs(s), GROUP, BAR_W, false,
              [&](int r) { return dw_chunk_of(s, i, r); },
              [&](int r, const bf16* tile) { dw_work(r, tile, dg_all); });
        }
        __syncthreads();
      }
      asm volatile("fence.proxy.async.global;" ::: "memory");
      if (exchanges) grid_arrive(barrier);
      BWD_STAMP(s, 1);
      BWD_STAMP(s, 2);
      BWD_STAMP(s, 3);
      if (!in_w && exchanges) {
        grid_wait(barrier, (barriers + 1) * nblk, BAR_X, GROUP);
        BWD_STAMP(s, 4);
        exchange(s);
        BWD_STAMP(s, 5);
      }
    }
    if (exchanges) ++barriers;
    __syncthreads();  // the groups join: dh_buf and red_s are complete
    BWD_STAMP(s, 6);
  }

  for (int i = tid; i < ROWS * Kp; i += THREADS) {
    const int q = i / Kp;
    const int k = i % Kp;
    const size_t row = (size_t)(q / UNITS) * H + u0 + q % UNITS;
    if (k >= hcol)
      dw_hh[row * H + (k - hcol)] = dw_s[q * KpP + k];
    else
      dw_ih[row * In + k] = dw_s[q * KpP + k];
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
                       int In, int H, int reverse BWD_TIMELINE_ARG,
                       cudaStream_t stream) {
  const int nblk = H / UNITS;
  if (In < 8 || In % 8 || H % 16 || T < 1 || B < 1 ||
      x_passes<SEMI>(In, nblk) > MAXP)
    return cudaErrorInvalidValue;
  int ahead = keeps_tiles<SEMI>(In, H, B, nblk);
  const size_t smem =
      bwd_smem_bytes<SEMI>(In, H, nblk, (B + BT - 1) / BT, ahead);
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  // the exchange: K3's (2, B, 4H) ping-pong scratch, K4's (T, B, 4H) dgx
  CUtensorMap map_x, map_h, map_dg;
  cudaError_t err = chunk_map(&map_x, x, In, B, T);
  if (err == cudaSuccess) err = chunk_map(&map_h, hs, H, B, T);
  if (err == cudaSuccess)
    err = chunk_map(&map_dg, SEMI ? out : dgbuf, GATES * H, B, SEMI ? T : 2);
  if (err != cudaSuccess) return err;
  void* args[] = {(void*)&x,      (void*)&w_ih,    (void*)&bias,
                  (void*)&w_hh,   (void*)&hs,      (void*)&cs,
                  (void*)&dhs,    (void*)&out,     (void*)&dw_ih,
                  (void*)&db,     (void*)&dw_hh,   (void*)&dgbuf,
                  (void*)&dh_buf, (void*)&dc_buf,  (void*)&barrier,
                  (void*)&T,      (void*)&B,       (void*)&In,
                  (void*)&H,      (void*)&reverse, (void*)&ahead,
                  (void*)&map_x,  (void*)&map_h,   (void*)&map_dg
#ifdef MLVAE_BWD_TIMELINE
                  ,
                  (void*)&timeline
#endif
  };
  return launch_cooperative(lstm_fused_bwd_kernel<SEMI>, nblk, THREADS, args,
                            smem, stream);
}

}  // namespace fused
