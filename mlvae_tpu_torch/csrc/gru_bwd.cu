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
// at 3.35 TB/s): the floor is the operations. As K5-fwd, every product
// runs on the CUDA cores in f32 FMAs, so the f32 floor is this design's.
// What keeps it far from it is the chain of T dependent steps, each of
// which needs every unit's dgh before any unit's dh_{t-1} can be formed: a
// reduction across blocks every step.
//
// Design, K1-bwd's (lstm_bwd.cu) with three gates: one persistent cooperative
// grid of H/4 blocks. Block k owns UNITS=4 hidden units, i.e. 12 gate rows,
// and keeps those rows of W_hh in shared memory (the recompute) and in
// registers (the partials), and its 12 rows of dW_hh in registers for the
// whole sequence: the block owns those rows, so dW_hh and db_hh need no
// atomics and are deterministic. h_{t-1} comes straight from hs by the TMA
// into a 128-byte swizzled tile, a box of 32 columns x 64 rows an mbarrier
// (gru_common.cuh, shared with K5-fwd, as are the recompute's register tiles
// over all 256 threads and the gate math). The gate thread (row, unit) forms
// its dgh from its dh carry, writes its columns of dgx[t], and leaves dh z for
// the carry. One pass over the dgh then writes the block's split-K share of
// dh_{t-1}, its 12 rows' product partial = dgh[:, rows] @ W_hh[rows, :] (B x
// H), and adds its share of dW_hh. The partials lie [unit group][row][unit] in
// a ping-pong buffer, so that a reducing block reads its four units of a row
// as one float4 and a warp's reads fill whole 32-byte sectors; the writer
// turns each lane quad's 4 x 4 of rows and units around through shared memory
// (red_s, free during the pass: a step 1.0 us shorter than with K1-bwd's
// shuffles at B=64, H=512). After the grid barrier each block sums the
// partials of all blocks for its own four units, through L2 in block order,
// onto dh z.
//
// The schedule (B <= 64, one tile). Only the dgh, the partials and the reduce
// lie on the chain of steps: the recompute of step s-1 reads hs and W_hh only.
// So the step's grid barrier is split: gate math(s) -> the pass forming
// partial(s) and dW(s) -> arrive -> copy of h for step s-1 (thread 0) beside
// db_hh's sums of step s (12 threads of warp 1) -> recompute(s-1) -> loads of
// step s-1's gx, dhs and h_{t-1} -> wait -> reduce(s), the dh carry in
// registers. B > 64 runs the tiles in series with the same copies (each tile:
// copy, recompute, gate math, db_hh, the pass; then the barrier and the
// reduce), the carries in dh_buf. A thread holds W_hh's and dW_hh's 12 rows
// for KP = 2 columns of H (H <= 512) or 3. Every sum keeps the single-copy
// design's order (dW over s, then tiles, then rows; each partial over its 12
// rows; db_hh over the rows of a tile, then tiles and steps; each
// pre-activation over k; the reduce over blocks) and the gate math its
// contraction, so the outputs are bit-identical to that design.
// Shared memory is 177 KB at H=512 (186 KB at 528). The H/4 blocks must
// all be resident, one per SM, which limits H to 528 on an H100 (132 SMs).
#include "bwd_timeline.cuh"
#include "gru_common.cuh"

// The step timeline (bwd_timeline.cuh, only with -DMLVAE_K1_BWD_TIMELINE):
// slot 5 partial_dw (the pass forming the split-K share of dh_{t-1} and dW,
// to the arrival; the block's other warps catch up in 6 wait), 7 reduce
// (dh_{t-1} from the partials). Stage is thread 0's time in the mbarrier
// waits of its K slice, recompute the rest of its recompute; loads also
// take thread 0's issue of the next step's copies.
#ifdef MLVAE_K1_BWD_TIMELINE
enum { TL_PARTIAL_DW = 5, TL_REDUCE = 7 };
#endif

using namespace gru;

namespace {

constexpr int KPT = 3;                   // columns of H a thread, at most
constexpr int RED = 4;                   // lanes that sum one row's partials
constexpr int DBT = 32;                  // the first of db_hh's 12 threads
constexpr int XQ = 20;   // a quad's transpose scratch: 16 floats, padded
static_assert(THREADS / 32 * 8 * XQ <= KSPLIT * ROWS * RP, "fits red_s");
static_assert(RED == UNITS, "a reducing lane ends with its own unit");
static_assert(ROWS % 4 == 0, "dgh rows are read as float4");

size_t bwd_smem_bytes(int H) {
  // gru_common.cuh's tile, w_s and red_s + dg_s [BT][ROWS], f32; an
  // mbarrier a box
  return sizeof(float) * (common_floats(H) + (size_t)BT * ROWS) +
         sizeof(uint64_t) * n_boxes(H);
}

bool takes(int T, int B, int H) {
  return H % (UNITS * KSPLIT) == 0 && H <= KPT * THREADS && T >= 1 &&
         B >= 1 && bwd_smem_bytes(H) <= SMEM_LIMIT;
}

// 1 - n^2, its contraction pinned as the single-copy design compiled it.
__device__ __forceinline__ float one_minus_sq(float n) {
  return __fmaf_rn(-n, n, 1.0f);
}

// The gate thread's inputs of one step: gx's three gates, h_{t-1} and the
// cotangent of h_t from above.
struct CellIn {
  float gx[GATES];
  float h_prev, dhs;
};

template <bool SPLIT, int KP>
__global__ void __launch_bounds__(THREADS, 1)
gru_bwd_kernel(const float* __restrict__ gx, const float* __restrict__ w_hh,
               const float* __restrict__ b_hh, const float* hs,
               const float* __restrict__ dhs, float* __restrict__ dgx,
               float* __restrict__ dw_hh, float* __restrict__ db_hh,
               float* part, float* dh_buf, unsigned int* barrier, int T,
               int B, int H, int reverse,
               const __grid_constant__ CUtensorMap map_h TL_ARG) {
  extern __shared__ __align__(1024) float4 smem4[];
  const int nbox = n_boxes(H);
  float* tile = reinterpret_cast<float*>(smem4);
  float* w_s = tile + (size_t)nbox * BOX;
  float* red_s = w_s + (size_t)H * UNITS * WP;
  float* dg_s = red_s + (size_t)KSPLIT * ROWS * RP;
  uint64_t* mb = reinterpret_cast<uint64_t*>(dg_s + (size_t)BT * ROWS);
  if (smem_u32(tile) & 1023) __trap();  // the swizzle's 1024-byte atoms

  const int tid = threadIdx.x;
  const int nblk = gridDim.x;
  const int u0 = blockIdx.x * UNITS;
  const int G = GATES * H;
  load_w(w_s, w_hh, u0, H);
  if (tid == 0) {
    for (int i = 0; i < nbox; ++i) mbar_init(&mb[i]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // gate layout: thread -> (batch row, unit); the same thread owns the
  // (row, unit) dh carry and sums dh_{t-1} for it
  const int cb = tid / UNITS;
  const int cj = tid % UNITS;
  float bias[GATES];
#pragma unroll
  for (int q = 0; q < GATES; ++q) bias[q] = b_hh[q * H + u0 + cj];
  // db_hh: thread DBT + q of warp 1 owns gate row q (warp 0's thread 0
  // issues the copies beside it)
  const int dq = tid - DBT;
  float db = 0.0f;
  // column layout (dW_hh and the partials): thread -> columns
  // k = tid + kk * THREADS, all 12 rows; W_hh[rows][k] held in registers
  float dw[KP][ROWS];
  float wr[KP][ROWS];
#pragma unroll
  for (int kk = 0; kk < KP; ++kk) {
    const int k = tid + kk * THREADS;
#pragma unroll
    for (int q = 0; q < ROWS; ++q) {
      dw[kk][q] = 0.0f;
      wr[kk][q] = k < H ? w_s[((size_t)k * UNITS + q % UNITS) * WP +
                              q / UNITS]
                        : 0.0f;
    }
  }

  TL_CLOCK;
  TL_BEGIN();
  unsigned int staged = 0;  // copies of h_{t-1} consumed: the mbarriers' phase
  const int k_lo = slice_lo(H);
  const int k_hi = k_lo + H / KSPLIT;

  // h_{t-1} @ W_hh^T of the tile in flight into red_s: the slice box by
  // box as they land
  auto recompute = [&]() {
    float acc[4][GATES];
    zero_acc(acc);
    for (int kb = k_lo, kend; kb < k_hi; kb = kend) {
      kend = min(k_hi, (kb / BOXC + 1) * BOXC);
      TL_MARK(TL_RECOMPUTE);
      mbar_wait(&mb[kb / BOXC], staged & 1);
      TL_MARK(TL_STAGE);
      box_product(acc, tile, w_s, kb, kend);
    }
    ++staged;
    store_red(red_s, acc);
  };

  // the gate thread's inputs of step s, batch tile b0
  auto load_in = [&](int s, int b0, CellIn& in) {
    const int t = reverse ? T - 1 - s : s;
    const int tp = reverse ? t + 1 : t - 1;
    const int b = b0 + cb;
    if (b < B) {
      const size_t row = (size_t)t * B + b;
#pragma unroll
      for (int q = 0; q < GATES; ++q)
        in.gx[q] = gx[row * G + (size_t)q * H + u0 + cj];
      in.h_prev = s == 0 ? 0.0f : hs[((size_t)tp * B + b) * H + u0 + cj];
      in.dhs = dhs[row * H + u0 + cj];
    }
  };

  // the dgh of step s, tile b0, from red_s and the carry dh_c (dh from the
  // step above): dgx[t] and dg_s written (rows past the tile's end stay
  // zero: they meet zero h rows in dW); returns dh z, the local term of
  // dh_{t-1}
  auto cell = [&](int s, int b0, const CellIn& in, float dh_c) {
    const int t = reverse ? T - 1 - s : s;
    const int b = b0 + cb;
    float dg[GATES] = {0.0f, 0.0f, 0.0f};
    float dhz = 0.0f;
    if (b < B) {
      float gh[GATES];
      gate_inputs(gh, red_s, bias, s == 0, cb, cj);
      const float r = sigmoid_f(__fadd_rn(in.gx[0], gh[0]));
      const float z = sigmoid_f(__fadd_rn(in.gx[1], gh[1]));
      const float hn = gh[2];
      const float n = new_gate(in.gx[2], r, hn);
      const float dh = __fadd_rn(in.dhs, dh_c);
      const float dn = __fmul_rn(__fmul_rn(dh, __fsub_rn(1.0f, z)),
                                 one_minus_sq(n));
      const float dr = __fmul_rn(__fmul_rn(__fmul_rn(dn, hn), r),
                                 __fsub_rn(1.0f, r));
      const float dz =
          __fmul_rn(__fmul_rn(__fmul_rn(dh, __fsub_rn(in.h_prev, n)), z),
                    __fsub_rn(1.0f, z));
      float* dgr = dgx + ((size_t)t * B + b) * G + u0 + cj;
      dgr[0] = dr;
      dgr[H] = dz;
      dgr[2 * H] = dn;
      dg[0] = dr;
      dg[1] = dz;
      dg[2] = __fmul_rn(dn, r);
      dhz = __fmul_rn(dh, z);
    }
#pragma unroll
    for (int q = 0; q < GATES; ++q) dg_s[cb * ROWS + q * UNITS + cj] = dg[q];
    return dhz;
  };

  // db_hh += the tile's nb rows of dgh, summed in row order (the owner of
  // gate row dq), each sixteen rows' loads ahead of their adds
  auto sum_db = [&](int nb) {
    if (dq >= 0 && dq < ROWS) {
      float sum = 0.0f;
#pragma unroll
      for (int b16 = 0; b16 < BT; b16 += 16) {
        float v[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) v[i] = dg_s[(b16 + i) * ROWS + dq];
#pragma unroll
        for (int i = 0; i < 16; ++i)
          if (b16 + i < nb) sum = __fadd_rn(sum, v[i]);
      }
      db = __fadd_rn(db, sum);
    }
  };

  // dgh rows [bb, bb + 4) of dg_s in registers
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
  // partial[b][k] = sum_row dgh[b][row] * W_hh[row][k], rows in order,
  // into part_s [H/4][B][4] (the quad of lanes that holds four rows of
  // units k - k % 4 .. + 3 turns them around through shared memory, so
  // that lane u stores row bb + u's four units as one float4), and
  // dW_hh[rows][k] += sum_b dgh[b][row] * h_{t-1}[b][k], rows in order. The
  // partials' stores drain behind dW's products.
  auto partial_dw = [&](float* part_s, int b0, int nb) {
    const int u = tid & 3;
    // the quad's 4 x 4 of rows and units turned around in red_s, free
    // between the gate math and the next recompute: [quad][row][unit] a
    // warp, quads XQ floats apart
    float* xq = red_s + (tid >> 5) * (8 * XQ) + ((tid & 31) >> 2) * XQ;
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
            for (int q = 0; q < ROWS; ++q) p = fmaf(dgv[r][q], wr[kk][q], p);
            v[r] = p;
          }
#pragma unroll
          for (int r = 0; r < 4; ++r) xq[r * UNITS + u] = v[r];
          __syncwarp();
          const float4 t = *reinterpret_cast<const float4*>(xq + u * UNITS);
          __syncwarp();
          if (k < H && bb + u < nb)
            *reinterpret_cast<float4*>(
                part_s + ((size_t)(k >> 2) * B + b0 + bb + u) * UNITS) = t;
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
#pragma unroll 16
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
    // one tile; the carry in registers
    float dh_c = 0.0f;
    CellIn in;
    if (T > 1) {
      issue_tile(&map_h, tile, mb, nbox, prev_pos(T - 1), 0);
      recompute();
    }
    load_in(T - 1, 0, in);
    __syncthreads();  // red_s
    for (int s = T - 1;; --s) {
      TL_BEGIN();
      const float dhz = cell(s, 0, in, dh_c);
      __syncthreads();  // dg_s written, red_s read
      TL_MARK(TL_CELL);
      if (s == 0) {
        sum_db(B);
        TL_STORE(s);
        break;
      }
      partial_dw(part_of(s) + (size_t)blockIdx.x * B * H, 0, B);
      grid_arrive(barrier);  // the tile and red_s are free, partials published
      ++arrivals;
      TL_MARK(TL_PARTIAL_DW);
      TL_ARRIVED();
      // needs no other block's writes: db_hh's sums of step s (dg_s is
      // rewritten only after the wait), step s-1's pre-activations and
      // inputs
      if (s > 1) issue_tile(&map_h, tile, mb, nbox, prev_pos(s - 1), 0);
      sum_db(B);
      TL_MARK(TL_LOADS);
      if (s > 1) {
        recompute();
        TL_MARK(TL_RECOMPUTE);
      }
      load_in(s - 1, 0, in);
      TL_MARK(TL_LOADS);
      grid_wait(barrier, arrivals * gridDim.x, 0, THREADS);
      TL_MARK(TL_WAIT);
      TL_WAITED();
      // thread (b, unit) == (cb, cj)
      dh_c = __fadd_rn(dhz, reduce(part_of(s), 0));
      TL_MARK(TL_REDUCE);
      TL_STORE(s);
    }
  } else {
    // the tiles in series, the carries in dh_buf
    for (int s = T - 1; s >= 0; --s) {
      TL_BEGIN();
      const bool first = s == 0;  // h_{t-1} = 0
      for (int b0 = 0; b0 < B; b0 += BT) {
        const int nb = min(BT, B - b0);
        __syncthreads();  // the tile, red_s and dg_s are free again
        if (!first) {
          issue_tile(&map_h, tile, mb, nbox, prev_pos(s), b0);
          recompute();
          __syncthreads();
          TL_MARK(TL_RECOMPUTE);
        }
        CellIn in;
        load_in(s, b0, in);
        const size_t bu = (size_t)(b0 + cb) * H + u0 + cj;
        const float dhz = cell(s, b0, in, cb < nb ? dh_buf[bu] : 0.0f);
        if (cb < nb) dh_buf[bu] = dhz;
        __syncthreads();
        TL_MARK(TL_CELL);
        sum_db(nb);
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
        if (b < B) {
          float* d = dh_buf + (size_t)b * H + u0 + tid % RED;
          *d = __fadd_rn(*d, mine);
        }
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
  if (dq >= 0 && dq < ROWS) db_hh[(dq / UNITS) * H + u0 + dq % UNITS] = db;
}

// The instantiation a launch at H, B takes.
using BwdKernel = decltype(&gru_bwd_kernel<true, 2>);
BwdKernel pick(int H, int B) {
  const bool split = B <= BT;
  const bool two = H <= 2 * THREADS;  // two columns a thread, or three
  return split ? (two ? gru_bwd_kernel<true, 2> : gru_bwd_kernel<true, KPT>)
               : (two ? gru_bwd_kernel<false, 2>
                      : gru_bwd_kernel<false, KPT>);
}

}  // namespace

extern "C" {

const char* mlvae_gru_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The launch plan at H, B (B picks the schedule), as gru_common.cuh's
// launch_plan reports it. Returns a cudaError_t.
int mlvae_gru_bwd_plan(int H, int B, int* out) {
  if (!takes(1, B, H)) return cudaErrorInvalidValue;
  return launch_plan((const void*)pick(H, B), H, bwd_smem_bytes(H), out);
}

// gx (T,B,3H), w_hh (3H,H), hs and dhs (T,B,H) and b_hh (3H) f32, hs
// 16-byte aligned (the TMA reads it). Outputs, every element written: dgx
// (T,B,3H), dw_hh (3H,H) and db_hh (3H) f32. Scratch: part (2, H/4, H/4,
// B, 4) f32 (slot, writing block, unit group, row, unit), dh_buf (B,H)
// zeroed, barrier one zeroed counter. H a multiple of 16. Returns a
// cudaError_t. The timing build (MLVAE_K1_BWD_TIMELINE) is
// mlvae_gru_bwd_timeline, which also takes the (T, H/4, 10) u64 timeline
// before the stream.
#ifdef MLVAE_K1_BWD_TIMELINE
int mlvae_gru_bwd_timeline(
#else
int mlvae_gru_bwd(
#endif
    const float* gx, const float* w_hh, const float* b_hh, const float* hs,
    const float* dhs, float* dgx, float* dw_hh, float* db_hh, float* part,
    float* dh_buf, unsigned int* barrier, int T, int B, int H,
    int reverse TL_ARG, cudaStream_t stream) {
  if (!takes(T, B, H) || reinterpret_cast<uintptr_t>(hs) % 16)
    return cudaErrorInvalidValue;
  CUtensorMap map_h;
  const cudaError_t err = hs_map(&map_h, hs, T, B, H);
  if (err != cudaSuccess) return err;
  void* args[] = {(void*)&gx,      (void*)&w_hh,   (void*)&b_hh,
                  (void*)&hs,      (void*)&dhs,    (void*)&dgx,
                  (void*)&dw_hh,   (void*)&db_hh,  (void*)&part,
                  (void*)&dh_buf,  (void*)&barrier, (void*)&T,
                  (void*)&B,       (void*)&H,      (void*)&reverse,
                  (void*)&map_h
#ifdef MLVAE_K1_BWD_TIMELINE
                  ,
                  (void*)&timeline
#endif
  };
  return launch_cooperative(pick(H, B), H / UNITS, THREADS, args,
                            bwd_smem_bytes(H), stream);
}

}  // extern "C"
