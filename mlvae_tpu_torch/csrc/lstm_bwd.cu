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
// dW_hh needs no atomics and is deterministic. Per step and batch tile of
// 64 rows the block recomputes its B x 16 pre-activations from h_{t-1}
// with K1-fwd's 4x4 register tiles (thread: K slice, gate, rows b4 + 16 r),
// forms its dgates from its dh/dc carries and writes them to its columns
// of dgx[t]; then it writes its split-K share of dh_{t-1}, its 16 gate
// rows' product partial[k] = dgates[:, rows] @ W_hh[rows, :] (B x H), to a
// ping-pong buffer, and adds its share of dW_hh. After a grid barrier (a
// per-launch counter, as in K1-fwd) each block sums the partials of all
// blocks for its own four units, reading them through L2 with __ldcg in a
// fixed order, so dh_{t-1} is deterministic too. A block's partials lie
// [unit group][row][unit], so that a reducing block reads its four units
// of a row as one float4 and a warp's reads fill whole 32-byte sectors;
// the writer turns each 4 x 4 of rows and units across a lane quad with
// shuffles and stores float4s, whole sectors too.
//
// h_{t-1} comes straight from the saved hs by the TMA: a 3-D tensor map
// over hs (H, B, T) copies 64 batch rows x 32 columns a box (rows past B
// arrive as zeros) into one 128 KB tile (at H=512), 128-byte swizzled
// (the 16-byte unit u of row b at u ^ (b % 8)), one mbarrier a box; the
// recompute's K slices wait only for their own boxes. The tile stays [b][k]
// as hs has it: the recompute reads a float4 along k for each of its rows
// b4 + 16 r, whose swizzles differ across a quarter warp, and dW reads 32
// consecutive columns of one row a warp, so neither meets a bank twice.
//
// The schedule (B <= 64, one tile). Only the dgates, the partials and the
// reduce lie on the chain of steps: the recompute of step s-1 reads hs and
// W_hh only. So the step's grid barrier is split: cell(s) -> one pass over
// the dgates forming partial(s) and dW(s) -> arrive -> copy of h for step
// s-1 -> recompute(s-1) -> loads of step s-1's gx, c and dh inputs ->
// wait -> reduce(s), the dh and dc carries in registers. The partials'
// stores drain behind dW's products in the pass, and the arrival after it
// finds them done (an arrival between the two would hold thread 0's warp
// until they drained).
// Two warp groups, the partials and the reduce on warps 0-3 beside dW and
// the recompute on warps 4-7 (as K3-bwd runs), were slower: the partials
// on four warps outlasted the rest. B > 64 runs the tiles in series with
// the same copies (each tile: copy, recompute, cell, the pass; then the
// barrier and the reduce). A thread holds W_hh's and dW_hh's 16 rows for
// KP = 2 columns of H (H <= 512) or 3. Every sum keeps its order (dW over
// s, then tiles, then rows; each partial over its 16 rows; each
// pre-activation over k; the reduce over blocks) and the dgates block its
// contraction, so the outputs are bit-identical to the single-copy design.
// Shared memory is 184 KB at H=512. The H/4 blocks must all be resident,
// one per SM, which limits this build to H <= 528 on an H100 (132 SMs);
// wider layers, up to H=1024, take lstm_bwd_wide.cu (ops/k1_plan.py).
#include <cuda_runtime.h>
#include <stdint.h>

#include "bwd_timeline.cuh"
#include "grid_sync.cuh"
#include "mbarrier.cuh"

// The step timeline (bwd_timeline.cuh, only with -DMLVAE_K1_BWD_TIMELINE):
// slot 5 partial_dw (the pass forming the split-K share of dh_{t-1} and
// dW, to the arrival; the block's other warps catch up in 6 wait), 7
// reduce (dh_{t-1} from the partials). Stage is thread 0's time in the
// mbarrier waits of its K slice, recompute the rest of its recompute.
#ifdef MLVAE_K1_BWD_TIMELINE
enum { TL_PARTIAL_DW = 5, TL_REDUCE = 7 };
#endif

namespace {

constexpr int UNITS = 4;                 // hidden units owned by one block
constexpr int GATES = 4;                 // i, f, g, o
constexpr int ROWS = GATES * UNITS;      // gate rows owned by one block
constexpr int BT = 64;                   // batch rows per tile
constexpr int KSPLIT = 4;                // recompute: K split four ways
constexpr int THREADS = 256;
constexpr int KPT = 3;                   // columns of H a thread, at most
constexpr int RED = 4;                   // lanes that sum one row's partials
constexpr int BOXC = 32;                 // columns of a TMA box: 128 bytes
constexpr int BOX = BT * BOXC;           // floats of a box (8 KB)
static_assert(THREADS == KSPLIT * GATES * (BT / 4), "recompute layout");
static_assert(THREADS == BT * UNITS, "cell layout");
static_assert(RED == UNITS, "a reducing lane ends with its own unit");

__host__ __device__ inline int n_boxes(int H) {
  return (H + BOXC - 1) / BOXC;
}

size_t smem_bytes(int H) {
  // tile [box][BT][BOXC] + w_s [GATES][H][UNITS] + red_s [KSPLIT][BT][ROWS]
  // + dg_s [BT][ROWS], f32; an mbarrier a box
  return sizeof(float) * ((size_t)n_boxes(H) * BOX +
                          (size_t)GATES * H * UNITS +
                          (size_t)KSPLIT * BT * ROWS + (size_t)BT * ROWS) +
         sizeof(uint64_t) * n_boxes(H);
}

// Offset of element (b, k) in the tile: box k / 32, row b of 128 bytes,
// 16-byte unit (k / 4) % 8 at that unit ^ (b % 8), as the TMA's 128-byte
// swizzle writes it.
__device__ __forceinline__ int tile_off(int b, int k) {
  return (k >> 5) * BOX + b * BOXC + ((((k >> 2) & 7) ^ (b & 7)) << 2) +
         (k & 3);
}

// A 4 x 4 transpose across the quad of lanes holding v: lane u (its place
// in the quad) ends with v[j] = the v[u] of lane j. Two butterflies: the
// 2 x 2 blocks across lanes u ^ 2, then the entries within them across
// lanes u ^ 1.
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

// The cell thread's inputs of one step: gx's four gates, c_t, c_{t-1}
// and the cotangent of h_t from above.
struct CellIn {
  float gx[GATES];
  float c_t, c_prev, dhs;
};

template <bool SPLIT, int KP>
__global__ void __launch_bounds__(THREADS)
lstm_bwd_kernel(const float* __restrict__ gx, const float* __restrict__ w_hh,
                const float* __restrict__ cs, const float* __restrict__ dhs,
                float* __restrict__ dgx, float* __restrict__ dw_hh,
                float* part, float* dh_buf, float* dc_buf,
                unsigned int* barrier, int T, int B, int H, int reverse,
                const __grid_constant__ CUtensorMap map_h TL_ARG) {
  extern __shared__ __align__(1024) float4 smem4[];
  const int nbox = n_boxes(H);
  float* tile = reinterpret_cast<float*>(smem4);
  float* w_s = tile + (size_t)nbox * BOX;
  float* red_s = w_s + (size_t)GATES * H * UNITS;
  float* dg_s = red_s + (size_t)KSPLIT * BT * ROWS;
  uint64_t* mb = reinterpret_cast<uint64_t*>(dg_s + (size_t)BT * ROWS);
  if (smem_u32(tile) & 1023) __trap();  // the swizzle's 1024-byte atoms

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
  if (tid == 0) {
    for (int i = 0; i < nbox; ++i) mbar_init(&mb[i]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // recompute layout: thread -> (K slice, gate, batch rows b4 + 16 r)
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
  float dw[KP][ROWS];
  float wr[KP][ROWS];
#pragma unroll
  for (int kk = 0; kk < KP; ++kk) {
    const int k = tid + kk * THREADS;
#pragma unroll
    for (int q = 0; q < ROWS; ++q) {
      dw[kk][q] = 0.0f;
      wr[kk][q] = k < H ? w_s[((size_t)(q / UNITS) * H + k) * UNITS +
                              q % UNITS]
                        : 0.0f;
    }
  }

  TL_CLOCK;
  TL_BEGIN();
  unsigned int staged = 0;  // copies of h_{t-1} consumed: the mbarriers' phase

  // thread 0: rows [b0, b0 + 64) of h at position tp into the tile, a box
  // of 32 columns an mbarrier
  auto issue = [&](int tp, int b0) {
    if (tid == 0) {
      for (int j = 0; j < nbox; ++j) {
        mbar_expect(&mb[j], BOX * sizeof(float));
        asm volatile(
            "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
            "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(
                smem_u32(tile + (size_t)j * BOX)),
            "l"(&map_h), "r"(j * BOXC), "r"(b0), "r"(tp),
            "r"(smem_u32(&mb[j]))
            : "memory");
      }
    }
  };

  // h_{t-1} @ W_hh^T of the staged tile into red_s [K slice][row][gate
  // row]: each sum over its K slice in k order, box by box as they land
  auto recompute = [&]() {
    float acc[4][UNITS];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < UNITS; ++j) acc[r][j] = 0.0f;
    const float4* w4 = reinterpret_cast<const float4*>(w_s) +
                       (size_t)gate * H;
    const int sw = b4 & 7;  // the swizzle of rows b4 + 16 r
    for (int kb = k_lo; kb < k_lo + kper;) {
      const int box = kb / BOXC;
      const int kend = min(k_lo + kper, (box + 1) * BOXC);
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
            for (int j = 0; j < UNITS; ++j)
              acc[r][j] = fmaf(hb[r][c], wj[j], acc[r][j]);
        }
      }
      kb = kend;
    }
    ++staged;
#pragma unroll
    for (int r = 0; r < 4; ++r)
      *reinterpret_cast<float4*>(
          red_s + ((size_t)ks * BT + b4 + 16 * r) * ROWS + gate * UNITS) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  };

  // the cell thread's inputs of step s, batch tile b0
  auto load_in = [&](int s, int b0, CellIn& in) {
    const int t = reverse ? T - 1 - s : s;
    const int tp = reverse ? t + 1 : t - 1;
    const int b = b0 + cb;
    if (b < B) {
      const size_t row = (size_t)t * B + b;
#pragma unroll
      for (int q = 0; q < GATES; ++q)
        in.gx[q] = gx[row * G + (size_t)q * H + u0 + cj];
      const size_t o = row * H + u0 + cj;
      in.c_t = cs[o];
      in.c_prev = s == 0 ? 0.0f : cs[((size_t)tp * B + b) * H + u0 + cj];
      in.dhs = dhs[o];
    }
  };

  // the dgates of step s, tile b0, from red_s and the carries dh_c (dh
  // from the step above) and dc_c (updated to dc * f): to dgx[t] and dg_s
  // (rows past the tile's end stay zero: they meet zero h rows in dW)
  auto cell = [&](int s, int b0, const CellIn& in, float dh_c, float& dc_c) {
    const int t = reverse ? T - 1 - s : s;
    const int b = b0 + cb;
    float dg[GATES] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (b < B) {
      float pre[GATES];
#pragma unroll
      for (int q = 0; q < GATES; ++q) {
        float sum = 0.0f;
        if (s != 0) {
#pragma unroll
          for (int kk = 0; kk < KSPLIT; ++kk)
            sum = __fadd_rn(
                sum, red_s[((size_t)kk * BT + cb) * ROWS + q * UNITS + cj]);
        }
        pre[q] = __fadd_rn(in.gx[q], sum);
      }
      const float ig = sigmoid_f(pre[0]);
      const float fg = sigmoid_f(pre[1]);
      const float gg = tanhf(pre[2]);
      const float og = sigmoid_f(pre[3]);
      // the single-copy design's contraction, read off its SASS: every
      // product rounded, 1 - x^2 and dc's update one FMA each
      const float dh = __fadd_rn(in.dhs, dh_c);
      const float tanh_c = tanhf(in.c_t);
      const float d_o = __fmul_rn(dh, tanh_c);
      const float dc = __fmaf_rn(__fmul_rn(dh, og),
                                 __fmaf_rn(-tanh_c, tanh_c, 1.0f), dc_c);
      dg[0] = __fmul_rn(__fmul_rn(__fmul_rn(dc, gg), ig),
                        __fsub_rn(1.0f, ig));
      dg[1] = __fmul_rn(__fmul_rn(__fmul_rn(dc, in.c_prev), fg),
                        __fsub_rn(1.0f, fg));
      dg[2] = __fmul_rn(__fmul_rn(dc, ig), __fmaf_rn(-gg, gg, 1.0f));
      dg[3] = __fmul_rn(__fmul_rn(d_o, og), __fsub_rn(1.0f, og));
      dc_c = __fmul_rn(dc, fg);
      float* dgr = dgx + ((size_t)t * B + b) * G + u0 + cj;
#pragma unroll
      for (int q = 0; q < GATES; ++q) dgr[(size_t)q * H] = dg[q];
    }
#pragma unroll
    for (int q = 0; q < GATES; ++q) dg_s[cb * ROWS + q * UNITS + cj] = dg[q];
  };

  // dgates rows [bb, bb + 4) of dg_s in registers
  auto load_dg = [&](int bb, float (&dgv)[4][ROWS]) {
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
  };

  // One pass over the tile's nb rows from b0 and this thread's columns k:
  // partial[b][k] = sum_row dgates[b][row] * W_hh[row][k], rows in order,
  // into part_s [H/4][B][4] (the quad of lanes that holds four rows of
  // units k - k % 4 .. + 3 turns them around, so that lane u stores row
  // bb + u's four units as one float4), and dW_hh[rows][k] += sum_b
  // dgates[b][row] * h_{t-1}[b][k], rows in order. The partials' stores
  // drain behind dW's products.
  auto partial_dw = [&](float* part_s, int b0, int nb) {
    const int u = tid & 3;
#pragma unroll 2  // two groups of rows in flight
    for (int bb = 0; bb < nb; bb += 4) {
      float dgv[4][ROWS];
      load_dg(bb, dgv);
#pragma unroll
      for (int kk = 0; kk < KP; ++kk) {
        const int k = tid + kk * THREADS;
        if ((tid & ~31) + kk * THREADS < H) {  // the warp's quads are whole
          float v[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            float p = 0.0f;
#pragma unroll
            for (int q = 0; q < ROWS; ++q)
              p = fmaf(dgv[r][q], wr[kk][q], p);
            v[r] = p;
          }
          quad_transpose(v, u);
          if (k < H && bb + u < nb)
            *reinterpret_cast<float4*>(
                part_s + ((size_t)(k >> 2) * B + b0 + bb + u) * UNITS) =
                make_float4(v[0], v[1], v[2], v[3]);
        }
        if (k < H) {
          float hb[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) hb[r] = tile[tile_off(bb + r, k)];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < ROWS; ++q)
              dw[kk][q] = fmaf(dgv[r][q], hb[r], dw[kk][q]);
        }
      }
    }
  };

  // dh_{t-1} for row b0 + tid / RED, unit tid % RED: the partials of
  // every block, through L2, in block order (four lanes, then shuffles)
  auto reduce = [&](const float* part_all, int b0) {
    const int lane_q = tid % RED;
    const int b = b0 + tid / RED;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (b < B) {
#pragma unroll 8
      for (int k2 = lane_q; k2 < nblk; k2 += RED) {
        const float4 v = __ldcg(reinterpret_cast<const float4*>(
            part_all + (size_t)k2 * B * H +
            ((size_t)blockIdx.x * B + b) * UNITS));
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
    return lane_q == 0 ? acc.x
           : lane_q == 1 ? acc.y
           : lane_q == 2 ? acc.z
                         : acc.w;
  };

  auto prev_pos = [&](int s) {  // h_{t-1}'s position for step s
    const int t = reverse ? T - 1 - s : s;
    return reverse ? t + 1 : t - 1;
  };
  auto part_of = [&](int s) {  // the ping-pong slot of step s
    return part + (size_t)(s & 1) * nblk * B * H;
  };
  unsigned int arrivals = 0;

  if (SPLIT) {
    // one tile; the carries in registers
    float dh_c = 0.0f;
    float dc_c = cb < B ? dc_buf[(size_t)cb * H + u0 + cj] : 0.0f;
    CellIn in;
    if (T > 1) {
      issue(prev_pos(T - 1), 0);
      recompute();
    }
    load_in(T - 1, 0, in);
    __syncthreads();  // red_s
    for (int s = T - 1;; --s) {
      TL_BEGIN();
      cell(s, 0, in, dh_c, dc_c);
      __syncthreads();  // dg_s written, red_s read
      TL_MARK(TL_CELL);
      if (s == 0) {
        TL_STORE(s);
        break;
      }
      partial_dw(part_of(s) + (size_t)blockIdx.x * B * H, 0, B);
      grid_arrive(barrier);  // the tile and dg_s are free, partials published
      ++arrivals;
      TL_MARK(TL_PARTIAL_DW);
      TL_ARRIVED();
      // needs no other block's writes: step s-1's pre-activations and
      // inputs
      if (s > 1) {
        issue(prev_pos(s - 1), 0);
        recompute();
        TL_MARK(TL_RECOMPUTE);
      }
      load_in(s - 1, 0, in);
      TL_MARK(TL_LOADS);
      grid_wait(barrier, arrivals * gridDim.x, 0, THREADS);
      TL_MARK(TL_WAIT);
      TL_WAITED();
      dh_c = reduce(part_of(s), 0);  // thread (b, unit) == (cb, cj)
      TL_MARK(TL_REDUCE);
      TL_STORE(s);
    }
  } else {
    // the tiles in series, the carries in dh_buf / dc_buf
    for (int s = T - 1; s >= 0; --s) {
      TL_BEGIN();
      const bool first = s == 0;  // h_{t-1} = c_{t-1} = 0
      for (int b0 = 0; b0 < B; b0 += BT) {
        const int nb = min(BT, B - b0);
        __syncthreads();  // the tile, red_s and dg_s are free again
        if (!first) {
          issue(prev_pos(s), b0);
          recompute();
          __syncthreads();
          TL_MARK(TL_RECOMPUTE);
        }
        CellIn in;
        load_in(s, b0, in);
        const size_t bu = (size_t)(b0 + cb) * H + u0 + cj;
        float dh_c = 0.0f, dc_c = 0.0f;
        if (cb < nb) {
          dh_c = dh_buf[bu];
          dc_c = dc_buf[bu];
        }
        cell(s, b0, in, dh_c, dc_c);
        if (cb < nb) dc_buf[bu] = dc_c;
        __syncthreads();
        TL_MARK(TL_CELL);
        if (!first) {
          partial_dw(part_of(s) + (size_t)blockIdx.x * B * H, b0, nb);
          TL_MARK(TL_PARTIAL_DW);
        }
      }
      if (first) {
        TL_STORE(s);
        break;
      }
      grid_arrive(barrier);
      ++arrivals;
      TL_ARRIVED();
      grid_wait(barrier, arrivals * gridDim.x, 0, THREADS);
      TL_MARK(TL_WAIT);
      TL_WAITED();
      for (int b0 = 0; b0 < B; b0 += BT) {
        const int b = b0 + tid / RED;
        const float mine = reduce(part_of(s), b0);
        if (b < B) dh_buf[(size_t)b * H + u0 + tid % RED] = mine;
      }
      TL_MARK(TL_REDUCE);
      TL_STORE(s);
    }
  }

#pragma unroll
  for (int kk = 0; kk < KP; ++kk) {
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
// written); part (2, H/4, H/4, B, 4) f32 scratch (slot, writing block,
// unit group, row, unit); dh_buf (B,H) zeroed and dc_buf
// (B,H) holding dc_last, both scratch; barrier one zeroed counter. Returns
// a cudaError_t. The timing build (MLVAE_K1_BWD_TIMELINE) is
// mlvae_lstm_bwd_timeline, which also takes the (T, H/4, 10) u64 timeline
// before the stream.
#ifdef MLVAE_K1_BWD_TIMELINE
int mlvae_lstm_bwd_timeline(
#else
int mlvae_lstm_bwd(
#endif
    const float* gx, const float* w_hh, const float* hs, const float* cs,
    const float* dhs, float* dgx, float* dw_hh, float* part, float* dh_buf,
    float* dc_buf, unsigned int* barrier, int T, int B, int H,
    int reverse TL_ARG, cudaStream_t stream) {
  if (H % (UNITS * KSPLIT) != 0 || H > KPT * THREADS || T < 1 || B < 1 ||
      reinterpret_cast<uintptr_t>(hs) % 16)
    return cudaErrorInvalidValue;
  // hs as (column k, batch row, position), k innermost; boxes of 32
  // columns x 64 rows of one position, zeros past B, 128-byte swizzled
  PFN_cuTensorMapEncodeTiled_v12000 encode;
  cudaError_t err = tensor_map_encoder(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[3] = {(cuuint64_t)H, (cuuint64_t)B, (cuuint64_t)T};
  const cuuint64_t strides[2] = {(cuuint64_t)H * sizeof(float),
                                 (cuuint64_t)B * H * sizeof(float)};
  const cuuint32_t box[3] = {BOXC, BT, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  CUtensorMap map_h;
  if (encode(&map_h, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
             const_cast<float*>(hs), dims, strides, box, step,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  void* args[] = {(void*)&gx,     (void*)&w_hh,   (void*)&cs,
                  (void*)&dhs,    (void*)&dgx,    (void*)&dw_hh,
                  (void*)&part,   (void*)&dh_buf, (void*)&dc_buf,
                  (void*)&barrier, (void*)&T,     (void*)&B,
                  (void*)&H,      (void*)&reverse, (void*)&map_h
#ifdef MLVAE_K1_BWD_TIMELINE
                  ,
                  (void*)&timeline
#endif
  };
  const bool split = B <= BT;
  const bool two = H <= 2 * THREADS;  // two columns a thread, or three
  return launch_cooperative(
      split ? (two ? lstm_bwd_kernel<true, 2> : lstm_bwd_kernel<true, KPT>)
            : (two ? lstm_bwd_kernel<false, 2> : lstm_bwd_kernel<false, KPT>),
      H / UNITS, THREADS, args, smem_bytes(H), stream);
}

}  // extern "C"
