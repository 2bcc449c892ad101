// Pieces of the fused-projection LSTM backwards on f32 streams, K3-bwd and
// K4-bwd (lstm_fused_bwd_f32.cu), in their exchange schedule; the f32
// K3/K4-fwd and K7b (lstm_fused_fwd_f32.cu) have a layout of their own.
//
// They run the bf16 fused kernels' contract (lstm_fused_common.cuh) with
// every operand f32 and every product an exact f32 FMA (no tensor cores, no
// TF32), as the Pallas kernels compute in f32 mode. Layout, as K1's: one
// persistent cooperative grid of H/4 blocks of 256 threads; block k owns
// UNITS=4 hidden units, i.e. ROWS=16 gate rows (row q = gate * 4 + unit,
// the global row gate * H + 4k + unit).
//
// Every operand that is not resident is staged in chunks of KC=128 columns
// and 64 batch rows by cp.async (16 bytes a thread, through L2 only: hs and
// the backward's exchange are written by other blocks during the launch),
// two stages, the next chunk in flight while one works (`pipeline`; a ring
// of four in flight measured no faster on the H100). Rows past the batch's
// end arrive as zeros. A pre-activation product (`pre_chunk`) gives thread
// (K slice ks, gate, b4) the 4 x 4 sums of batch rows b4 + 16 r and its
// gate's four units over the chunk's float4 columns ks, ks + 4, ...; the
// four slices are summed in order by the cell thread (batch row, unit),
// which owns that row's carries for the whole launch. Every sum keeps its
// order, so every launch gives the same bits.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_sync.cuh"

namespace f32f {

constexpr int UNITS = 4;             // hidden units owned by one block
constexpr int GATES = 4;             // i, f, g, o
constexpr int ROWS = GATES * UNITS;  // gate rows owned by one block
constexpr int BT = 64;               // batch rows per tile
constexpr int THREADS = 256;
constexpr int KC = 128;              // columns per staged chunk
constexpr int KCP = KC + 4;          // f32 row pitch of a staged chunk
constexpr int MAXP = 4;              // dX column groups a block may own (K3)
constexpr int NGMAX = 1 + MAXP;      // the exchange's column groups
// one stage: the chunk's 64 rows, then its weights: 16 gate rows of a
// chunk, or (the exchange) the chunk's KC rows of the block's column groups
constexpr int WAREA = KC * 4 * NGMAX > ROWS * KCP ? KC * 4 * NGMAX
                                                  : ROWS * KCP;
constexpr int STAGE = BT * KCP + WAREA;  // floats
constexpr int RED = 4 * BT * ROWS;       // floats of the partial sums
constexpr size_t SMEM_LIMIT = 232448;    // an H100 block's shared memory
static_assert(THREADS == BT * UNITS, "cell layout: a thread a row and unit");
static_assert(THREADS == 4 * GATES * 16 && BT == 4 * 16,
              "product layout: (K slice, gate, b4), rows b4 + 16 r");
static_assert(RED == 16 * BT * 4, "the exchange's partials fit the same");
static_assert(KC == 32 * 4, "staging: a lane 16 bytes of a chunk's row");

__device__ __forceinline__ uint32_t s_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory through L2; zeros unless `valid`.
__device__ __forceinline__ void cp16(float* dst, const float* src,
                                     bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   s_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Stage columns [k0, k0 + w) (w <= KC, a multiple of 4) of `rows` rows of a
// row-major f32 matrix, row r at a0 + r * lda, rows [nb, rows) zero, as
// dst[r][c] (pitch KCP): a warp a row, a lane 16 bytes of it. a0 and lda
// keep 16-byte alignment.
__device__ __forceinline__ void stage_rows(float* dst, int rows,
                                           const float* a0, size_t lda,
                                           int nb, int k0, int w) {
  const int c = (threadIdx.x & 31) * 4;
  if (c >= w) return;
  for (int r = threadIdx.x >> 5; r < rows; r += THREADS / 32) {
    const bool ok = r < nb;
    cp16(dst + r * KCP + c, ok ? a0 + r * lda + k0 + c : a0, ok);
  }
}

// Stage columns [k0, k0 + w) of the block's 16 rows of a (4H, ld) weight
// matrix (row q is gate row (q / 4) * H + u0 + q % 4) as dst[q][c].
__device__ __forceinline__ void stage_wrows(float* dst, const float* w,
                                            int ld, int H, int u0, int k0,
                                            int wd) {
  const int c = (threadIdx.x & 31) * 4;
  if (c >= wd) return;
  for (int q = threadIdx.x >> 5; q < ROWS; q += THREADS / 32)
    cp16(dst + q * KCP + c,
         w + (size_t)((q / UNITS) * H + u0 + q % UNITS) * ld + k0 + c, true);
}

// Run jobs 0 .. n-1, each on one of two stages: issue(j, stage) starts the
// copies of job j, work(j, stage) runs once they have landed. Job j + 1's
// copies are in flight while job j works. Every thread of the block calls
// it; it ends with __syncthreads, after which both stages are free.
template <class Issue, class Work>
__device__ __forceinline__ void pipeline(float* stages, int n, Issue issue,
                                         Work work) {
  if (n <= 0) return;
  issue(0, stages);
  cp_commit();
  for (int j = 0; j < n; ++j) {
    if (j + 1 < n) {
      issue(j + 1, stages + ((j + 1) & 1) * STAGE);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    work(j, stages + (j & 1) * STAGE);
    __syncthreads();
  }
}

__device__ __forceinline__ void zero_acc(float (&acc)[4][UNITS]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < UNITS; ++j) acc[r][j] = 0.0f;
}

// acc[r][j] += sum over the chunk's columns c < w of thread (ks, gate, b4)
// of a_s[b4 + 16 r][c] * w[(gate * 4 + j) * ldw + c]: a_s a staged chunk,
// w the block's 16 rows of the chunk's weights (shared memory).
__device__ __forceinline__ void pre_chunk(float (&acc)[4][UNITS],
                                          const float* a_s, const float* w,
                                          int ldw, int wd) {
  const int tid = threadIdx.x;
  const int ks = tid >> 6;
  const int gate = (tid >> 4) & 3;
  const int b4 = tid & 15;
  const float* wg = w + gate * UNITS * ldw;
#pragma unroll 2
  for (int c = ks * 4; c < wd; c += 16) {
    float4 wv[UNITS], av[4];
#pragma unroll
    for (int j = 0; j < UNITS; ++j)
      wv[j] = *reinterpret_cast<const float4*>(wg + j * ldw + c);
#pragma unroll
    for (int r = 0; r < 4; ++r)
      av[r] = *reinterpret_cast<const float4*>(a_s + (b4 + 16 * r) * KCP + c);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < UNITS; ++j) {
        float s = acc[r][j];
        s = fmaf(av[r].x, wv[j].x, s);
        s = fmaf(av[r].y, wv[j].y, s);
        s = fmaf(av[r].z, wv[j].z, s);
        s = fmaf(av[r].w, wv[j].w, s);
        acc[r][j] = s;
      }
  }
}

// The product of a 64-row tile of A (rows [0, nb) at a0, row stride lda, K
// columns) with the block's 16 rows of a global (4H, K) weight matrix,
// both staged chunk by chunk, added to acc.
__device__ __forceinline__ void input_product(float (&acc)[4][UNITS],
                                              float* stages, const float* a0,
                                              size_t lda, int nb, int K,
                                              const float* w, int H, int u0) {
  pipeline(
      stages, (K + KC - 1) / KC,
      [&](int j, float* st) {
        const int k0 = j * KC;
        const int wd = min(KC, K - k0);
        stage_rows(st, BT, a0, lda, nb, k0, wd);
        stage_wrows(st + BT * KCP, w, K, H, u0, k0, wd);
      },
      [&](int j, float* st) {
        pre_chunk(acc, st, st + BT * KCP, KCP, min(KC, K - j * KC));
      });
}

// As input_product with the weights resident: w_s the block's 16 rows of
// K columns at pitch ldw.
__device__ __forceinline__ void hidden_product(float (&acc)[4][UNITS],
                                               float* stages, const float* a0,
                                               size_t lda, int nb, int K,
                                               const float* w_s, int ldw) {
  pipeline(
      stages, (K + KC - 1) / KC,
      [&](int j, float* st) {
        stage_rows(st, BT, a0, lda, nb, j * KC, min(KC, K - j * KC));
      },
      [&](int j, float* st) {
        pre_chunk(acc, st, w_s + j * KC, ldw, min(KC, K - j * KC));
      });
}

// The product threads' sums to red_s [ks][row][q]; the block syncs before
// the cell threads read them.
__device__ __forceinline__ void store_red(float* red_s,
                                          const float (&acc)[4][UNITS]) {
  const int tid = threadIdx.x;
  const int ks = tid >> 6;
  const int gate = (tid >> 4) & 3;
  const int b4 = tid & 15;
#pragma unroll
  for (int r = 0; r < 4; ++r)
    *reinterpret_cast<float4*>(red_s + (ks * BT + b4 + 16 * r) * ROWS +
                               gate * UNITS) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
}

// The cell thread's (row cb, unit cj) sum of gate q's four slices.
__device__ __forceinline__ float red_sum(const float* red_s, int cb, int q,
                                         int cj) {
  float v = red_s[cb * ROWS + q * UNITS + cj];
#pragma unroll
  for (int ks = 1; ks < 4; ++ks)
    v += red_s[(ks * BT + cb) * ROWS + q * UNITS + cj];
  return v;
}

// Load the block's 16 rows of W_hh (4H, H) into w_s [q][k], pitch H + 4.
__device__ __forceinline__ void load_whh(float* w_s, const float* w_hh,
                                         int H, int u0) {
  for (int i = threadIdx.x; i < ROWS * H; i += THREADS) {
    const int q = i / H;
    const int k = i - q * H;
    w_s[q * (H + 4) + k] =
        w_hh[(size_t)((q / UNITS) * H + u0 + q % UNITS) * H + k];
  }
}

}  // namespace f32f
