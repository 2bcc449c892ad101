// K1-bwd for 528 < H <= 1024 on f32 streams: backpropagation through the
// LSTM recurrence over precomputed input gates, where the narrow build
// (lstm_bwd.cu) would need more blocks than an H100 has SMs and more
// registers than a thread has for W_hh's and dW_hh's rows. bf16 streams
// take lstm_bwd_wide_bf16.cu, whose products run on the tensor cores.
//
// Replaces the TPU kernel mlvae_tpu/ops/lstm_pallas.py `_bwd_kernel`
// (launched by `_run_bwd`), which takes any H % 128 == 0. As the narrow
// build: walk the processing order backward from dh = 0 and dc = dc_last;
// at each step recompute the gates gx[t] + h_{t-1} @ W_hh^T from the saved
// hs, take the pre-activation cotangents (`_bptt_dgates`' math), write them
// to dgx[t], carry dc * f and dh_{t-1} = dgates @ W_hh backward, and
// accumulate dW_hh += dgates^T h_{t-1} in f32 over every batch row and
// step; h_{t-1} = c_{t-1} = 0 at the first processed step; `reverse` is
// indexing only.
//
// What bounds it on an H100: at B=64, H=1024, T=160 three products a step
// (the recompute, dh_{t-1}, dW_hh), 3*2*B*H*4H*T = 257.7 GFLOP of f32 FMA
// work (3.846 ms at 67 TFLOP/s) against about 400 MB of traffic (0.12 ms
// at 3.35 TB/s): the floor is the operations.
//
// Two kernels. The recurrence (mlvae_lstm_bwd_wide) forms dgx; dW_hh needs
// no carry, so a second kernel (mlvae_lstm_dw_wide) forms it after the
// recurrence from dgx and hs, as the bf16 build's does.
//
// The recurrence (lstm_wide.cuh): one persistent cooperative grid of H/8
// blocks; a block owns 8 units, i.e. 32 gate rows, and keeps those rows of
// W_hh in shared memory (128 KB at H=1024) for the recompute; for the
// partials a thread owns four consecutive columns of H and takes their 32
// rows into registers at the start of each pass (128 registers, which
// dW_hh's accumulators held for the whole launch in the first wide design
// (cp.async chunks), and
// which the recompute needs the rest of the step). A step, for
// a 64-row batch tile: h_{t-1} comes straight from hs by the TMA (a 3-D
// tensor map over hs (H, B, T), boxes of 32 columns x 64 rows, 128-byte
// swizzled, zeros past B), each of the recompute's four K slices (64
// threads: 8 batch rows x 4 gate rows a thread, rows b + 8 j, reading a
// float4 along k for each) through a ring of two boxes of its own, one
// mbarrier a box, issued by the slice's first thread and refilled once
// the slice's two warps have read the box (a named barrier of 64
// threads); the slices' sums go to their own rings laid out for the
// cell, which adds them in slice order, forms the dgates and writes them
// to dgx[t] and shared memory; then one pass forms each thread's four
// columns of its split-K share of dh_{t-1}, partial[b][k] = sum over the
// block's rows in row order of dgates[b][row] * W_hh[row][k], eight
// float4 reads of the row's dgates (one shared-memory pass each: every
// lane reads the same row) for 128 FMAs, stored as float4s. After the grid
// barrier each block sums the partials of every block for its own 8 units
// in block order, as four interleaved lanes, then shuffles.
//
// The schedule (B <= 64, one tile). The recompute of step s-1 reads hs and
// W_hh only, and is bound by its FMAs; the reduce of step s waits for every
// block's partials and is bound by L2. So they run at once, in each
// thread: cell(s) -> the first copies of h for step s-1 issued -> the
// partials of step s -> arrive -> loads of step s-1's gx, c and dh inputs
// -> wait -> recompute(s-1), each of its chunks carrying a batch of the
// reduce's loads (issued when the chunk's box has landed, added after its
// products) -> the reduce's shuffles -> cell(s-1), the dh and dc carries
// in registers. B > 64 runs the tiles in series (each tile: copy and
// recompute, cell, partials; then the barrier and the reduce), the carries
// in dh_buf and dc_buf.
//
// The exchange keeps the first wide design's split-K partials, laid out
// (slot, writing block, unit group of 8, row, unit), so that a reducing
// block reads its 8 units of a row as one 32-byte sector, two lanes a
// float4 each, and its 64 rows from one writer as 2 KB in a run: (2, H/8,
// B, H) f32, 64 MB at H=1024, B=64, of which one step writes and reads one
// 32 MB slot. Every sum keeps that design's order (each pre-activation
// over its K slice in k order, chunk after chunk, then the four slices in
// order; each partial over the 32 rows; the reduce over blocks), and the
// cell its contraction, so the outputs are bit-identical to that
// design's. Shared memory: 202 KB at H=1024.
//
// dW_hh (mlvae_lstm_dw_wide): dW_hh[r][k] = sum over the processing
// order's steps s from T-1 down to 1, and within a step over the batch
// rows b in order, of dgx[t_s][b][r] * hs[t_{s-1}][b][k], one fmaf a term
// in that order from zero: the first wide design's order, so its bits too.
// A tiled f32 SIMT product (not split over K): a block of 256 threads owns
// a 128 x 128 tile of dW_hh, a warp 64 x 32 of it, a thread 8 x 8 (two
// float4s of rows and two of columns for 64 FMAs), and streams the K =
// (T-1)B rows of both operands through two stages of 32 rows (cp.async,
// zeros past the end;
// each thread copies one row a stage, so that the step and batch row of
// a row of K are worked out once: the kernel is bound by the issue of its
// instructions); (H/128) x (4H/128) blocks, two an SM. Bound: 2 *
// 4H * H * (T-1) * B = 85.4 GFLOP at B=64, H=1024, T=160 (1.27 ms at 67
// TFLOP/s).
#include <cuda_runtime.h>
#include <stdint.h>

#include "bwd_timeline.cuh"
#include "grid_sync.cuh"
#include "lstm_wide.cuh"
#include "mbarrier.cuh"

// The step timeline (bwd_timeline.cuh, only with -DMLVAE_K1_BWD_TIMELINE):
// stage is thread 0's wait for its slice's boxes, recompute the rest of
// the recompute (B <= 64: with the reduce's loads and adds in its chunks),
// cell the dgates and their stores, slot 5 partial_dw the pass forming the
// partials (to the arrival; B <= 64 also thread 0's issue of the next
// step's first copies), wait the grid barrier, barrier the arrival to the
// end of the wait, slot 7 reduce (B <= 64: its shuffles and the block
// barrier after them, where the block waits for its slowest slice), loads
// the next step's cell inputs.
#ifdef MLVAE_K1_BWD_TIMELINE
enum { TL_PARTIAL_DW = 5, TL_REDUCE = 7 };
#endif

namespace {

using namespace wide;

constexpr int KS = 4;                 // the recompute's K slices
constexpr int SLICE_T = THREADS / KS; // threads of a slice: two warps
constexpr int BOXC = CHUNK / KS;      // columns of a box: 128 bytes
constexpr int BOX = BT * BOXC;        // floats of a box (8 KB)
constexpr int RING = 2;               // boxes a slice
constexpr int REGION = RING * BOX;    // a slice's ring, floats
constexpr int RED = 4;                // lanes that sum one row's partials
static_assert(RED_SLICE <= REGION, "a slice's sums fit in its ring");
static_assert(SLICE_T == (ROWS / 4) * (BT / 8), "recompute layout");

size_t smem_bytes(int H) {
  // rings [KS][RING][BT][BOXC] + w_s [H][ROWS] + dg_s [BT][ROWS] + dh_s
  // [BT][UNITS], f32; an mbarrier a box
  return sizeof(float) * ((size_t)KS * REGION + (size_t)ROWS * H +
                          (size_t)BT * (ROWS + UNITS)) +
         sizeof(uint64_t) * KS * RING;
}

// The cell thread's inputs of one step: gx's four gates, c_t, c_{t-1}
// and the cotangent of h_t from above, for its two units.
struct CellIn {
  float gx[2][GATES];
  float c_t[2], c_prev[2], dhs[2];
};

template <bool SPLIT>
__global__ void __launch_bounds__(THREADS, 1)
lstm_bwd_wide_kernel(const float* __restrict__ gx,
                     const float* __restrict__ w_hh,
                     const float* __restrict__ cs,
                     const float* __restrict__ dhs, float* __restrict__ dgx,
                     float* part, float* dh_buf, float* dc_buf,
                     unsigned int* barrier, int T, int B, int H, int reverse,
                     const __grid_constant__ CUtensorMap map_h TL_ARG) {
  extern __shared__ __align__(1024) float smem[];
  float* ring = smem;
  float* w_s = ring + (size_t)KS * REGION;
  float* dg_s = w_s + (size_t)ROWS * H;
  float* dh_s = dg_s + (size_t)BT * ROWS;  // the reduce's sums, one tile
  uint64_t* mb = reinterpret_cast<uint64_t*>(dh_s + (size_t)BT * UNITS);
  if (smem_u32(ring) & 1023) __trap();  // the swizzle's 1024-byte atoms
  const int tid = threadIdx.x;
  const int nblk = gridDim.x;
  const int u0 = blockIdx.x * UNITS;
  const int G = GATES * H;
  const int nc = n_chunks(H);
  load_w(w_s, w_hh, H, u0);
  if (tid == 0) {
    for (int i = 0; i < KS * RING; ++i) mbar_init(&mb[i]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // recompute layout: thread -> (K slice ks, row quad rq: gate rq / 2,
  // units 4 (rq % 2) .. + 3, batch rows bq + 8 j)
  const int ks = tid / SLICE_T, sl = tid % SLICE_T;
  const int rq = sl / 8, bq = sl % 8;
  const bool producer = sl == 0;
  float* my_ring = ring + (size_t)ks * REGION;
  uint64_t* my_mb = mb + ks * RING;
  // cell layout: thread -> (batch row cb of the tile, units cu, cu + 1);
  // the same thread owns those (row, unit) carries and reduces them
  const int cb = tid / (UNITS / 2);
  const int cu = (tid % (UNITS / 2)) * 2;
  // column layout (the partials): thread -> columns kq .. kq+3
  const int kq = tid * 4;

  TL_CLOCK;
  TL_BEGIN();
  unsigned int taken = 0;  // this slice's boxes read so far

  // this slice's box of chunk c: rows [b0, b0 + 64) of hs at position tp,
  // into its ring buffer n % RING (by the slice's first thread)
  auto issue = [&](unsigned int n, int c, int tp, int b0) {
    const int kb = c * CHUNK + ks * slice_part(H, c, KS);
    uint64_t* bar = &my_mb[n % RING];
    mbar_expect(bar, BOX * sizeof(float));
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(
            smem_u32(my_ring + (size_t)(n % RING) * BOX)),
        "l"(&map_h), "r"(kb), "r"(b0), "r"(tp), "r"(smem_u32(bar))
        : "memory");
  };
  // the first boxes of a recompute, once the slice's sums (in the ring)
  // have been read
  auto issue_first = [&](int tp, int b0) {
    if (producer) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      for (int c = 0; c < RING && c < nc; ++c) issue(taken + c, c, tp, b0);
    }
  };

  // h_{t-1} @ W_hh^T for the tile from b0, this slice's part of it: each
  // sum over the slice's k of every chunk in order, box by box as they
  // land; the sums into the slice's ring (red). at_chunk(c) runs once chunk
  // c's box has landed, after_chunk(c) once the chunk's products are done.
  auto recompute = [&](int tp, int b0, auto at_chunk, auto after_chunk) {
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[j][r] = 0.0f;
    const float4* w4 = reinterpret_cast<const float4*>(w_s);
    for (int c = 0; c < nc; ++c) {
      const unsigned int n = taken + c;
      TL_MARK(TL_RECOMPUTE);
      mbar_wait(&my_mb[n % RING], (n / RING) & 1);
      TL_MARK(TL_STAGE);
      at_chunk(c);
      const int part = slice_part(H, c, KS);
      const int kb = c * CHUNK + ks * part;
      // row b of a box is 128 bytes, its 16-byte unit k / 4 at that unit ^
      // (b % 8), as the TMA's 128-byte swizzle writes it; this thread's
      // rows bq + 8 j all have b % 8 == bq
      const float* box = my_ring + (size_t)(n % RING) * BOX + bq * BOXC;
#pragma unroll 2
      for (int k4 = 0; k4 < part / 4; ++k4) {
        // W_hh's rows 4 rq .. 4 rq + 3 at k = kb + 4 k4 + i: slots of one
        // swizzle (kb is a multiple of 4), eight float4s apart
        const float4* wk = w4 + w_slot(kb + 4 * k4, rq);
        float hb[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float4 v = *reinterpret_cast<const float4*>(
              box + j * 8 * BOXC + ((k4 ^ bq) << 2));
          hb[j][0] = v.x;
          hb[j][1] = v.y;
          hb[j][2] = v.z;
          hb[j][3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 wv = wk[i * (ROWS / 4)];
          const float wj[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int r = 0; r < 4; ++r)
              acc[j][r] = fmaf(hb[j][i], wj[r], acc[j][r]);
        }
      }
      after_chunk(c);
      // the slice's two warps have read the box
      asm volatile("bar.sync %0, %1;" ::"r"(1 + ks), "r"(SLICE_T)
                   : "memory");
      if (producer && c + RING < nc) issue(n + RING, c + RING, tp, b0);
    }
    taken += nc;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        my_ring[red_at(rq / 2, (rq % 2) * 4 + r, bq + 8 * j)] = acc[j][r];
  };

  // the cell thread's inputs of step s, batch tile b0
  auto load_in = [&](int s, int b0, CellIn& in) {
    const int t = reverse ? T - 1 - s : s;
    const int tp = reverse ? t + 1 : t - 1;
    const int b = b0 + cb;
    if (b < B) {
      const size_t row = (size_t)t * B + b;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int q = 0; q < GATES; ++q)
          in.gx[e][q] = gx[row * G + (size_t)q * H + u0 + cu + e];
        const size_t o = row * H + u0 + cu + e;
        in.c_t[e] = cs[o];
        in.c_prev[e] =
            s == 0 ? 0.0f : cs[((size_t)tp * B + b) * H + u0 + cu + e];
        in.dhs[e] = dhs[o];
      }
    }
  };

  // the dgates of step s, tile b0, from the slices' sums and the carries
  // dh_c (dh from the step above) and dc_c (updated to dc * f): to dgx[t]
  // and dg_s
  auto cell = [&](int s, int b0, const CellIn& in, const float (&dh_c)[2],
                  float (&dc_c)[2]) {
    const int t = reverse ? T - 1 - s : s;
    const int b = b0 + cb;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int uu = cu + e;
      float dg[GATES] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (b < B) {
        float pre[GATES];
#pragma unroll
        for (int q = 0; q < GATES; ++q) {
          const float sum =
              s == 0 ? 0.0f : slice_sum<KS>(ring, REGION, q, uu, cb);
          pre[q] = __fadd_rn(in.gx[e][q], sum);
        }
        const float ig = sigmoid_f(pre[0]);
        const float fg = sigmoid_f(pre[1]);
        const float gg = tanhf(pre[2]);
        const float og = sigmoid_f(pre[3]);
        // the narrow build's contraction: every product rounded, 1 - x^2
        // and dc's update one FMA each
        const float dh = __fadd_rn(in.dhs[e], dh_c[e]);
        const float tanh_c = tanhf(in.c_t[e]);
        const float d_o = __fmul_rn(dh, tanh_c);
        const float dc = __fmaf_rn(__fmul_rn(dh, og),
                                   __fmaf_rn(-tanh_c, tanh_c, 1.0f), dc_c[e]);
        dg[0] = __fmul_rn(__fmul_rn(__fmul_rn(dc, gg), ig),
                          __fsub_rn(1.0f, ig));
        dg[1] = __fmul_rn(__fmul_rn(__fmul_rn(dc, in.c_prev[e]), fg),
                          __fsub_rn(1.0f, fg));
        dg[2] = __fmul_rn(__fmul_rn(dc, ig), __fmaf_rn(-gg, gg, 1.0f));
        dg[3] = __fmul_rn(__fmul_rn(d_o, og), __fsub_rn(1.0f, og));
        dc_c[e] = __fmul_rn(dc, fg);
        float* dgr = dgx + ((size_t)t * B + b) * G + u0 + uu;
#pragma unroll
        for (int q = 0; q < GATES; ++q) dgr[(size_t)q * H] = dg[q];
      }
#pragma unroll
      for (int q = 0; q < GATES; ++q)
        dg_s[cb * ROWS + q * UNITS + uu] = dg[q];
    }
  };

  // The tile's nb rows from b0: this thread's columns of the block's
  // split-K share of dh_{t-1}, partial[b][kq + c] = sum over the 32 rows
  // in order of dgates[b][row] * W_hh[row][kq + c], into part_s as
  // (unit group, row, unit), a float4 of four units. Four rows at once:
  // their sixteen sums are sixteen chains of FMAs, issued interleaved.
  auto partials = [&](float* part_s, int b0, int nb) {
    if (kq >= H) return;
    // W_hh's 32 rows of the thread's columns, in registers for the pass
    // (not across the step: the recompute needs the registers)
    float wr[4][ROWS];
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int q = 0; q < ROWS / 4; ++q) {
        const float4 v =
            reinterpret_cast<const float4*>(w_s)[w_slot(kq + c, q)];
        wr[c][4 * q + 0] = v.x;
        wr[c][4 * q + 1] = v.y;
        wr[c][4 * q + 2] = v.z;
        wr[c][4 * q + 3] = v.w;
      }
    const float4* g4 = reinterpret_cast<const float4*>(dg_s);
#pragma unroll 1
    for (int bb = 0; bb < nb; bb += 4) {
      // 4 rows at once, their 16 sums interleaved row by row of W_hh
      // (each its own chain, rows in order); dg_s holds zeros past nb
      float d[4][ROWS];
#pragma unroll
      for (int h = 0; h < 4; ++h)
#pragma unroll
        for (int q = 0; q < ROWS / 4; ++q) {
          const float4 v = g4[(bb + h) * (ROWS / 4) + q];
          d[h][4 * q + 0] = v.x;
          d[h][4 * q + 1] = v.y;
          d[h][4 * q + 2] = v.z;
          d[h][4 * q + 3] = v.w;
        }
      float p[4][4];
#pragma unroll
      for (int h = 0; h < 4; ++h)
#pragma unroll
        for (int c = 0; c < 4; ++c) p[h][c] = 0.0f;
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int h = 0; h < 4; ++h)
            p[h][c] = fmaf(d[h][r], wr[c][r], p[h][c]);
#pragma unroll
      for (int h = 0; h < 4; ++h)
        if (bb + h < nb)
          *reinterpret_cast<float4*>(
              part_s + ((size_t)(kq >> 3) * B + b0 + bb + h) * UNITS +
              (kq & 7)) = make_float4(p[h][0], p[h][1], p[h][2], p[h][3]);
    }
  };

  // dh_{t-1} for the tile's rows from b0: the partials of every block
  // through L2 in block order, four lanes a row and half of its units (the
  // lane of q4 sums blocks q4, q4 + 4, ...), then shuffles across the four;
  // a lane pair reads the row's 32-byte sector (units 0-3, 4-7) at once.
  // Two passes of 32 rows (row 32 p + 4 warp + lane / 8). The loads go in
  // batches of eight, batch c (blocks 16 c .. 16 c + 15 of both passes) in
  // flight while the recompute's chunk c runs (red_load before the chunk,
  // red_add after it); each pass's sum keeps its block order.
  const int lane = tid % 32;
  const int q4 = (lane >> 1) % RED, half = lane & 1;
  float4 red_v[8];    // a batch in flight
  float4 red_acc[2];  // the two passes' sums
  auto red_row = [&](int pass) {
    return pass * 32 + (tid / 32) * 4 + lane / 8;
  };
  // a lane's blocks are RED * B * H floats apart in a slot
  const size_t red_stride = (size_t)RED * B * H;
  auto red_ok = [&](int b0, int c, int u) {
    return q4 + RED * (4 * c + (u >> 1)) < nblk && b0 + red_row(u & 1) < B;
  };
  auto red_load = [&](const float* slot, int b0, int c) {
    // this lane's float4 of block q4's row in each pass, then block by block
    const float* base[2];
#pragma unroll
    for (int pass = 0; pass < 2; ++pass)
      base[pass] = slot + (size_t)q4 * B * H +
                   ((size_t)blockIdx.x * B + b0 + red_row(pass)) * UNITS +
                   half * 4 + (size_t)(4 * c) * red_stride;
#pragma unroll
    for (int u = 0; u < 8; ++u)
      red_v[u] = red_ok(b0, c, u)
                     ? __ldcg(reinterpret_cast<const float4*>(
                           base[u & 1] + (u >> 1) * red_stride))
                     : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  };
  auto red_add = [&](int b0, int c) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (red_ok(b0, c, u)) {
        float4& a = red_acc[u & 1];
        a.x += red_v[u].x;
        a.y += red_v[u].y;
        a.z += red_v[u].z;
        a.w += red_v[u].w;
      }
    }
  };
  // the passes' sums across the four lanes; lanes q4 = 0 store them to dst
  // + row * ld (rows below B)
  auto red_finish = [&](int b0, float* dst, int ld) {
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
      float4 a = red_acc[pass];
#pragma unroll
      for (int off = 2; off < 2 * RED; off <<= 1) {
        a.x += __shfl_xor_sync(0xffffffffu, a.x, off);
        a.y += __shfl_xor_sync(0xffffffffu, a.y, off);
        a.z += __shfl_xor_sync(0xffffffffu, a.z, off);
        a.w += __shfl_xor_sync(0xffffffffu, a.w, off);
      }
      const int row = red_row(pass);
      if (q4 == 0 && b0 + row < B)
        *reinterpret_cast<float4*>(dst + (size_t)row * ld + half * 4) = a;
      red_acc[pass] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  };
  red_acc[0] = red_acc[1] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  // the whole reduce of the tile from b0, with no recompute beside it
  auto reduce = [&](const float* slot, int b0, float* dst, int ld) {
    for (int c = 0; c < nc; ++c) {
      red_load(slot, b0, c);
      red_add(b0, c);
    }
    red_finish(b0, dst, ld);
  };
  auto none = [](int) {};

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
    float dh_c[2] = {0.0f, 0.0f}, dc_c[2] = {0.0f, 0.0f};
    if (cb < B) {
      dc_c[0] = dc_buf[(size_t)cb * H + u0 + cu];
      dc_c[1] = dc_buf[(size_t)cb * H + u0 + cu + 1];
    }
    CellIn in;
    if (T > 1) {
      issue_first(prev_pos(T - 1), 0);
      recompute(prev_pos(T - 1), 0, none, none);
    }
    load_in(T - 1, 0, in);
    __syncthreads();  // the slices' sums
    for (int s = T - 1;; --s) {
      TL_BEGIN();
      cell(s, 0, in, dh_c, dc_c);
      __syncthreads();  // dg_s written, the sums read
      TL_MARK(TL_CELL);
      if (s == 0) {
        TL_STORE(s);
        break;
      }
      // needs no other block's writes: step s-1's copies land behind the
      // partials
      if (s > 1) issue_first(prev_pos(s - 1), 0);
      partials(part_of(s) + (size_t)blockIdx.x * B * H, 0, B);
      grid_arrive(barrier);  // dg_s is free, the partials published
      ++arrivals;
      TL_MARK(TL_PARTIAL_DW);
      TL_ARRIVED();
      load_in(s - 1, 0, in);
      TL_MARK(TL_LOADS);
      grid_wait(barrier, arrivals * gridDim.x, 0, THREADS);
      TL_MARK(TL_WAIT);
      TL_WAITED();
      // the recompute of step s-1 carries the reduce of step s: batch c of
      // the partials' loads in flight while its chunk c runs
      const float* slot = part_of(s);
      if (s > 1) {
        recompute(prev_pos(s - 1), 0,
                  [&](int c) { red_load(slot, 0, c); },
                  [&](int c) { red_add(0, c); });
        red_finish(0, dh_s, UNITS);
      } else {
        reduce(slot, 0, dh_s, UNITS);
      }
      __syncthreads();  // dh_s and the slices' sums written
      dh_c[0] = dh_s[cb * UNITS + cu];
      dh_c[1] = dh_s[cb * UNITS + cu + 1];
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
        if (!first) {
          issue_first(prev_pos(s), b0);
          recompute(prev_pos(s), b0, none, none);
        }
        __syncthreads();  // the sums written; the last tile's dg_s read
        TL_MARK(TL_RECOMPUTE);
        CellIn in;
        load_in(s, b0, in);
        const size_t bu = (size_t)(b0 + cb) * H + u0 + cu;
        float dh_c[2] = {0.0f, 0.0f}, dc_c[2] = {0.0f, 0.0f};
        if (cb < nb) {
          dh_c[0] = dh_buf[bu];
          dh_c[1] = dh_buf[bu + 1];
          dc_c[0] = dc_buf[bu];
          dc_c[1] = dc_buf[bu + 1];
        }
        cell(s, b0, in, dh_c, dc_c);
        if (cb < nb) {
          dc_buf[bu] = dc_c[0];
          dc_buf[bu + 1] = dc_c[1];
        }
        __syncthreads();  // dg_s written, the sums read
        TL_MARK(TL_CELL);
        if (!first) {
          partials(part_of(s) + (size_t)blockIdx.x * B * H, b0, nb);
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
      for (int b0 = 0; b0 < B; b0 += BT)
        reduce(part_of(s), b0, dh_buf + (size_t)b0 * H + u0, H);
      TL_MARK(TL_REDUCE);
      TL_STORE(s);
    }
  }
}

// ---------------------------------------------------------------------------
// dW_hh after the recurrence
// ---------------------------------------------------------------------------

constexpr int DW_TILE = 128;   // rows and columns of dW_hh a block
constexpr int DW_BK = 32;      // rows of K a stage
constexpr int DW_STAGES = 2;
constexpr int DW_STAGE = DW_BK * 2 * DW_TILE;  // floats: both operands
static_assert(DW_BK * 8 == THREADS, "a stage: eight threads a row of K");

size_t dw_smem_bytes() { return sizeof(float) * DW_STAGES * DW_STAGE; }

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__global__ void __launch_bounds__(THREADS, 2)
lstm_dw_wide_kernel(const float* __restrict__ dgx,
                    const float* __restrict__ hs, float* __restrict__ dw_hh,
                    int T, int B, int H, int reverse) {
  extern __shared__ __align__(16) float dsm[];
  const int G = GATES * H;
  const int m0 = blockIdx.y * DW_TILE, n0 = blockIdx.x * DW_TILE;
  const int K = (T - 1) * B;
  const int nk = (K + DW_BK - 1) / DW_BK;
  const int tid = threadIdx.x;
  // warp w owns rows 64 (w / 4) .. + 63 and columns 32 (w % 4) .. + 31 of
  // the tile; its lane (lm, ln) rows wm + 4 lm + i and + 32, columns wn +
  // 4 ln + j and + 16: each float4 read of a stage row meets one pass of
  // the shared-memory pipe (eight or four distinct float4s a warp)
  const int wm = (tid / 128) * 64 + (tid % 32) / 4 * 4;
  const int wn = ((tid / 32) % 4) * 32 + (tid % 4) * 4;
  // the copies: thread -> row lr of each stage, float4s lq + 8 j of both
  // operands' 32 in that row
  const int lr = tid / 8, lq = tid % 8;

  // rows [kk0, kk0 + DW_BK) of K (step T-1-kk/B's dgates and its h_{t-1},
  // batch row kk % B) into stage st, one copy group; zeros past K, G, H
  auto load = [&](int st, int kk0) {
    float* as = dsm + (size_t)st * DW_STAGE + lr * DW_TILE;
    float* bs = as + DW_BK * DW_TILE;
    const int kk = kk0 + lr;
    const bool in_k = kk < K;
    const int s = T - 1 - (in_k ? kk / B : 0);
    const int b = in_k ? kk % B : 0;
    const int t = reverse ? T - 1 - s : s;
    const int tp = reverse ? t + 1 : t - 1;
    const float* a_row = dgx + ((size_t)t * B + b) * G + m0;
    const float* b_row = hs + ((size_t)tp * B + b) * H + n0;
#pragma unroll
    for (int j = 0; j < DW_TILE / 32; ++j) {
      const int c4 = (lq + 8 * j) * 4;
      const bool a_ok = in_k && m0 + c4 < G;
      const bool b_ok = in_k && n0 + c4 < H;
      cp_async16(as + c4, a_ok ? a_row + c4 : dgx, a_ok);
      cp_async16(bs + c4, b_ok ? b_row + c4 : hs, b_ok);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  for (int st = 0; st < DW_STAGES - 1; ++st) {
    if (st < nk)
      load(st, st * DW_BK);
    else
      asm volatile("cp.async.commit_group;" ::: "memory");
  }
  for (int it = 0; it < nk; ++it) {
    asm volatile("cp.async.wait_group %0;" ::"n"(DW_STAGES - 2) : "memory");
    __syncthreads();  // stage it landed; stage it - 1 read by every thread
    const int nx = it + DW_STAGES - 1;
    if (nx < nk)
      load(nx % DW_STAGES, nx * DW_BK);
    else
      asm volatile("cp.async.commit_group;" ::: "memory");
    const float* as = dsm + (size_t)(it % DW_STAGES) * DW_STAGE;
    const float* bs = as + DW_BK * DW_TILE;
#pragma unroll
    for (int kk = 0; kk < DW_BK; ++kk) {
      float a[8], b[8];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 va = *reinterpret_cast<const float4*>(
            as + kk * DW_TILE + wm + h * 32);
        const float4 vb = *reinterpret_cast<const float4*>(
            bs + kk * DW_TILE + wn + h * 16);
        a[4 * h + 0] = va.x;
        a[4 * h + 1] = va.y;
        a[4 * h + 2] = va.z;
        a[4 * h + 3] = va.w;
        b[4 * h + 0] = vb.x;
        b[4 * h + 1] = vb.y;
        b[4 * h + 2] = vb.z;
        b[4 * h + 3] = vb.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + wm + (i >> 2) * 32 + (i & 3);
    if (m >= G) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + wn + h * 16;
      if (n < H)
        *reinterpret_cast<float4*>(dw_hh + (size_t)m * H + n) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]);
    }
  }
}

// hs as (column k, batch row, position), k innermost; boxes of 32 columns
// x 64 rows of one position, zeros past B, 128-byte swizzled.
cudaError_t hs_map(CUtensorMap* map, const float* hs, int T, int B, int H) {
  PFN_cuTensorMapEncodeTiled_v12000 encode;
  const cudaError_t err = tensor_map_encoder(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[3] = {(cuuint64_t)H, (cuuint64_t)B, (cuuint64_t)T};
  const cuuint64_t strides[2] = {(cuuint64_t)H * sizeof(float),
                                 (cuuint64_t)B * H * sizeof(float)};
  const cuuint32_t box[3] = {BOXC, BT, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(hs),
             dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// A kernel's launch plan, as mlvae_lstm_fwd_wide_plan's out[0..7].
int plan_of(const void* kernel, int blocks, size_t smem, int ring, int chunk,
            int* out) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int occ = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, THREADS,
                                                      smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  out[0] = blocks;
  out[1] = THREADS;
  out[2] = static_cast<int>(smem);
  out[3] = occ;
  out[4] = ring;
  out[5] = chunk;
  out[6] = attr.numRegs;
  out[7] = static_cast<int>(attr.localSizeBytes);
  return cudaSuccess;
}

int dw_blocks(int H) {
  return ((H + DW_TILE - 1) / DW_TILE) * ((GATES * H + DW_TILE - 1) / DW_TILE);
}

}  // namespace

extern "C" {

const char* mlvae_lstm_bwd_wide_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The recurrence's launch plan for H and B, as mlvae_lstm_fwd_wide_plan's
// out[0..7] (out[4]: boxes a K slice; the build B takes: one tile and the
// split barrier for B <= 64, the tiles in series above).
int mlvae_lstm_bwd_wide_plan(int H, int B, int* out) {
  if (!takes(1, B, H)) return cudaErrorInvalidValue;
  return plan_of(B <= BT ? (const void*)lstm_bwd_wide_kernel<true>
                         : (const void*)lstm_bwd_wide_kernel<false>,
                 H / UNITS, smem_bytes(H), RING, CHUNK, out);
}

// The dW_hh kernel's launch plan for H: out[0] blocks, [4] stages, [5]
// rows and columns of dW_hh a block, the rest as above.
int mlvae_lstm_dw_wide_plan(int H, int B, int* out) {
  if (!takes(1, B, H)) return cudaErrorInvalidValue;
  return plan_of((const void*)lstm_dw_wide_kernel, dw_blocks(H),
                 dw_smem_bytes(), DW_STAGES, DW_TILE, out);
}

// The recurrence: gx (T,B,4H), w_hh (4H,H), hs/cs/dhs (T,B,H) f32 inputs,
// hs 16-byte aligned; dgx (T,B,4H) f32 output (every element written);
// part (2, H/8, H/8, B, 8) f32 scratch (slot, writing block, unit group,
// row, unit); dh_buf (B,H) zeroed and dc_buf (B,H) holding dc_last, both
// scratch; barrier one zeroed counter. Returns a cudaError_t. The timing
// build (MLVAE_K1_BWD_TIMELINE) is mlvae_lstm_bwd_wide_timeline, which also
// takes the (T, H/8, 10) u64 timeline before the stream.
#ifdef MLVAE_K1_BWD_TIMELINE
int mlvae_lstm_bwd_wide_timeline(
#else
int mlvae_lstm_bwd_wide(
#endif
    const float* gx, const float* w_hh, const float* hs, const float* cs,
    const float* dhs, float* dgx, float* part, float* dh_buf, float* dc_buf,
    unsigned int* barrier, int T, int B, int H, int reverse TL_ARG,
    cudaStream_t stream) {
  if (!takes(T, B, H) || reinterpret_cast<uintptr_t>(hs) % 16)
    return cudaErrorInvalidValue;
  CUtensorMap map_h;
  const cudaError_t err = hs_map(&map_h, hs, T, B, H);
  if (err != cudaSuccess) return err;
  void* args[] = {(void*)&gx,     (void*)&w_hh,   (void*)&cs,
                  (void*)&dhs,    (void*)&dgx,    (void*)&part,
                  (void*)&dh_buf, (void*)&dc_buf, (void*)&barrier,
                  (void*)&T,      (void*)&B,      (void*)&H,
                  (void*)&reverse, (void*)&map_h
#ifdef MLVAE_K1_BWD_TIMELINE
                  ,
                  (void*)&timeline
#endif
  };
  return launch_cooperative(
      B <= BT ? lstm_bwd_wide_kernel<true> : lstm_bwd_wide_kernel<false>,
      H / UNITS, THREADS, args, smem_bytes(H), stream);
}

// dW_hh (4H,H) f32, every element written, from the recurrence's dgx
// (T,B,4H) and hs (T,B,H), f32, both 16-byte aligned; T >= 2. Returns a
// cudaError_t.
int mlvae_lstm_dw_wide(const float* dgx, const float* hs, float* dw_hh,
                       int T, int B, int H, int reverse,
                       cudaStream_t stream) {
  if (!takes(T, B, H) || T < 2 || reinterpret_cast<uintptr_t>(dgx) % 16 ||
      reinterpret_cast<uintptr_t>(hs) % 16)
    return cudaErrorInvalidValue;
  const size_t smem = dw_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      lstm_dw_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((H + DW_TILE - 1) / DW_TILE,
                  (GATES * H + DW_TILE - 1) / DW_TILE);
  lstm_dw_wide_kernel<<<grid, THREADS, smem, stream>>>(dgx, hs, dw_hh, T, B,
                                                       H, reverse);
  return cudaGetLastError();
}

}  // extern "C"
