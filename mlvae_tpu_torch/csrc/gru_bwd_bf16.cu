// K5-bwd on bf16 streams: backpropagation through the GRU recurrence over
// precomputed input gates with its three products on the tensor cores (the
// gate-3 GRU VAE's AMP step: three layers at H=512), in two kernels: the
// recurrence, then dW_hh.
//
// Replaces the TPU kernel mlvae_tpu/ops/gru_pallas.py `_bwd_kernel`
// (launched by `_run_bwd`) under AMP. The recurrence walks the processing
// order backward from dh = 0: at each step it recomputes gh = h_{t-1} @
// W_hh^T + b_hh from the saved hs (h_{t-1} = hs[t_prev] in bf16; zero at
// the first processed step) and the gates, takes
//   dn' = dh (1 - z)(1 - n^2), dr' = dn' gh_n r (1 - r),
//   dz' = dh (h_{t-1} - n) z (1 - z)
// in f32 with dh = dhs + the f32 dh carry and the f32 h_{t-1} of hs32,
// writes dgx[t] = [dr', dz', dn'] in bf16 and carries dh_{t-1} = dh z +
// bf16(dgh) @ W_hh (f32 sums) backward, dgh = [dr', dz', dn' r]. db_hh
// sums the f32 dgh. As the TPU kernel rounds dgh to W_hh's bf16 before
// both of its products, and the r and z columns of bf16(dgh) are dgx's,
// only the n column, bf16(dn' r), differs from dgx: the recurrence writes
// it to a (T, B, H) scratch dgn. dW_hh = the sum over the steps of
// bf16(dgh)^T h_{t-1} (f32 sums; the first processed step adds nothing) is
// then one product over [dgx's r and z columns | dgn] and hs shifted by a
// step: the second kernel forms it after the recurrence. `reverse` is
// indexing only. gx, W_hh, hs, dhs, dgx and dgn are bf16; hs32, b_hh,
// dW_hh and db_hh f32.
//
// What bounds it on an H100: at B=64, H=512, T=160 three products,
// 3*2*B*H*3H*T = 48.3 GFLOP (49 us at 989 TFLOP/s of bf16 tensor cores),
// against about 100 MB of traffic (30 us at 3.35 TB/s): the floor is the
// operations. What keeps the recurrence far from it is the chain of T
// dependent steps, each of which needs every unit's dgh before any unit's
// dh_{t-1}: an exchange across the grid every step.
//
// Design of the recurrence (gru_mma.cuh): K5-fwd's grid and product. The
// recompute needs only hs and gx, so for B <= 64 (one tile) the step's
// barrier is split: cell (dgx[t], dgn[t]) -> fence and arrival ->
// recompute and loads of the next step -> wait -> dh_{t-1}, the carries in
// registers; the recompute's tile is the block's own, so the copies of the
// recompute after next are issued as soon as a recompute is gathered and
// land while the exchange runs. The exchange: every block reads, for its
// rows, all of bf16(dgh) of step t from L2 by the TMA (dgx[t]'s r and z
// columns through a tensor map that ends at 2H, then dgn[t]), in 64-column
// chunks through a ring of two buffers a warp (warp w takes chunks w, w +
// 8, ...), and multiplies them by W_hh's columns of its 8 units, held in
// registers as B fragments (the warp's chunks only): 3H x 32 bf16 a block
// a step, 96 KB at H=512. The warps' sums are added in warp
// order, so the order is fixed. B > 64 runs the tiles in series with the
// dh carry in dh_buf. db_hh: each cell thread sums its f32 dgh over the
// steps, the block adds its rows in order at the end, and the two blocks
// of a group of units add theirs to the zeroed db_hh by atomicAdd: two
// addends onto zero give the same sum in either order.
//
// The dW_hh kernel: dW_hh (3H x H) = X^T Y, X = [dgx[..., :2H] | dgn] and
// Y = hs, each viewed as ((T-1)*B) rows and shifted by a step (forward:
// steps 1.. of X against 0.. of Y; reverse: the other way), K = (T-1)*B =
// 10,176 at B=64. Tiles of 64 rows (one 64-column box of X: rows [0, 2H)
// from dgx, [2H, 3H) from dgn) x 128 columns of dW_hh (96 blocks at
// H=512), 64-row K chunks of both operands copied by the TMA (128-byte
// swizzle, four stages), eight warps of 32 x 32 with mma.sync m16n8k16 on
// fragments read by ldmatrix.trans, every sum in K order: no atomics,
// repeated launches bit-equal. Keeping dW_hh in registers inside the
// recurrence instead would put a product as large as the recompute's
// between the arrival and the wait, where the recompute already fills
// most of the barrier (1.10 of 1.76 us a step at gate 3's shape on an
// H100), and about 48 registers on a kernel at 200; the kernel after the
// recurrence takes 0.083 of K5-bwd's 0.788 ms (PERF.md section 6).
#include "bwd_timeline.cuh"
#include "gru_mma.cuh"

// The step timeline (bwd_timeline.cuh, only with -DMLVAE_K1_BWD_TIMELINE):
// slot 5 dh_stage (waiting for its chunks of bf16(dgh)), 7 dh_product (its
// chunks' products and the gather of the warps' dh sums). Recompute is
// its part of the product and the parts' gather; cell includes the
// arrival.
#ifdef MLVAE_K1_BWD_TIMELINE
enum { TL_DH_STAGE = 5, TL_DH_PRODUCT = 7 };
#endif

using namespace grubf;

namespace {

// The exchange's ring: chunks of BOX gate columns (one TMA box of RB
// rows, 4 KB), XBUFS buffers a warp, so that a warp's next chunk is in flight
// while it multiplies the last one; a warp takes at most XC chunks.
constexpr int XBUFS = 2;
constexpr int RING = WARPS * XBUFS;
constexpr int XC = (2 * MAX_H / BOX + 1 + MAX_H / BOX + 1 + WARPS - 1) / WARPS;

// The chunks of bf16(dgh): ncz over dgx's r and z columns, then the n
// columns of dgn.
__host__ __device__ inline int rz_chunks(int H) { return n_boxes(2 * H); }
__host__ __device__ inline int dgh_chunks(int H) {
  return n_boxes(2 * H) + n_boxes(H);
}

// The h_{t-1} tile, the ring, the K parts' sums (the exchange's dh sums
// and the final db_hh sums reuse them), an mbarrier a box and a ring
// buffer.
size_t bwd_smem_bytes(int H) {
  return (size_t)(n_boxes(H) + RING) * (BOX_BYTES + sizeof(uint64_t)) +
         PART_FLOAT2 * sizeof(float2);
}

// The cell thread's inputs of one step: gx of its unit's three gates, the
// f32 h_{t-1} and the cotangent of h_t from above.
struct CellIn {
  float gx[GATES];
  float h_prev, dhs;
};

template <bool ONE>
__global__ void __launch_bounds__(THREADS, 1)
gru_bwd_bf16_kernel(const bf16* __restrict__ gx,
                    const bf16* __restrict__ w_hh,
                    const float* __restrict__ b_hh,
                    const float* __restrict__ hs32,
                    const bf16* __restrict__ dhs, bf16* dgx, bf16* dgn,
                    float* db_hh, float* dh_buf, unsigned int* barrier,
                    int Tn, int B, int H, int reverse,
                    const __grid_constant__ CUtensorMap map_h,
                    const __grid_constant__ CUtensorMap map_g,
                    const __grid_constant__ CUtensorMap map_n TL_ARG) {
  extern __shared__ __align__(1024) float4 smem4[];
  const int nb = n_boxes(H);
  const int ncz = rz_chunks(H), nc = dgh_chunks(H);
  const int G = GATES * H;
  bf16* tile = reinterpret_cast<bf16*>(smem4);
  bf16* ring = tile + (size_t)nb * RB * BOX;
  float2* part = reinterpret_cast<float2*>(ring + (size_t)RING * RB * BOX);
  uint64_t* hbar = reinterpret_cast<uint64_t*>(part + PART_FLOAT2);
  uint64_t* gbar = hbar + nb;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int nblk = gridDim.x;
  const int u0 = (blockIdx.x / SPLIT) * UNITS;
  const int r0 = (blockIdx.x % SPLIT) * RB;  // the block's rows of a tile
  if (tid == 0) {
    if (smem_u32(tile) & 1023) __trap();  // the swizzle's 1024-byte atoms
    for (int i = 0; i < nb + RING; ++i) mbar_init(&hbar[i]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  int lo, hi;
  k_part(H, warp / MT, lo, hi);
  uint32_t wf[KMAX][GATES][2];
  load_w_frags(wf, w_hh, H, u0, lo, hi);
  // the exchange's B fragments: chunk c = warp + 8 ci of bf16(dgh), k-step
  // kk: xw = {b0, b1}, b0 = W_hh[col, col + 1][u0 + g] (two rows of the
  // unit's column), b1 8 rows on, col = the chunk's first gate column + 16
  // kk + 2 t; zero past the chunk's part (2H for r and z, 3H for n)
  uint32_t xw[XC][KB][2];
#pragma unroll
  for (int ci = 0; ci < XC; ++ci) {
    const int c = warp + ci * WARPS;
    const int base = c < ncz ? c * BOX : 2 * H + (c - ncz) * BOX;
    const int lim = c < ncz ? 2 * H : G;
#pragma unroll
    for (int kk = 0; kk < KB; ++kk)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = base + 16 * kk + 8 * j + 2 * tq;
        uint32_t v = 0u;
        if (c < nc && col < lim) {
          const unsigned short lo16 = __bfloat16_as_ushort(
              w_hh[(size_t)col * H + u0 + g]);
          const unsigned short hi16 = __bfloat16_as_ushort(
              w_hh[(size_t)(col + 1) * H + u0 + g]);
          v = (uint32_t)lo16 | ((uint32_t)hi16 << 16);
        }
        xw[ci][kk][j] = v;
      }
  }
  const int cb = cell_row();
  const int cu = u0 + cell_unit();  // the cell thread's unit
  float bias[GATES];
#pragma unroll
  for (int q = 0; q < GATES; ++q) bias[q] = b_hh[q * H + cu];
  __syncthreads();

  const int arow = (lane & 7) + 8 * ((lane >> 3) & 1);
  const int acol = 8 * (lane >> 4);
  unsigned int hstaged = 0;  // copies of h_{t-1}: the boxes' parity
  unsigned int gphase = 0;   // this warp's ring buffers' next parities
  float db[GATES] = {};      // the f32 dgh summed over the steps
  TL_CLOCK;
  auto mark = [&](int k) { TL_MARK(k ? TL_RECOMPUTE : TL_STAGE); };
  auto pos = [&](int s) { return reverse ? Tn - 1 - s : s; };
  auto prev_pos = [&](int s) { return reverse ? pos(s) + 1 : pos(s) - 1; };

  // the recurrent part of step s's gh for tile i (zero at the first
  // processed step); `issued`: its copies are in flight already. In the
  // one-tile schedule it issues the copies of step s - 1 once the tile is
  // free, and says so.
  auto recompute = [&](int s, int i, float (&pre)[GATES],
                       bool issued) -> bool {
    if (s == 0) {
#pragma unroll
      for (int q = 0; q < GATES; ++q) pre[q] = 0.0f;
      return false;
    }
    const bool ahead = ONE && s >= 2;
    auto after = [&] {
      if (ahead && tid == 0)
        stage_h(tile, &map_h, hbar, nb, prev_pos(s - 1), r0);
    };
    recurrent_product(pre, tile, part, hbar, &map_h, wf, lo, hi, nb,
                      prev_pos(s), i * BT + r0, hstaged, mark, after, issued);
    return ahead;
  };

  auto load_in = [&](int s, int i, CellIn& in) {
    const int b = i * BT + r0 + cb;
    if (b >= B) return;
    const size_t row = (size_t)pos(s) * B + b;
#pragma unroll
    for (int q = 0; q < GATES; ++q)
      in.gx[q] = __bfloat162float(gx[row * G + q * H + cu]);
    in.dhs = __bfloat162float(dhs[row * H + cu]);
    in.h_prev =
        s > 0 ? hs32[((size_t)prev_pos(s) * B + b) * H + cu] : 0.0f;
  };

  // the cell of step s, tile i: dgx[t] and dgn[t] from gh's recurrent part
  // and the dh carry from the step above; returns the local term dh z of
  // dh_{t-1}; db summed
  auto cell = [&](int s, int i, const float (&pre)[GATES], const CellIn& in,
                  float dh_c) -> float {
    const int b = i * BT + r0 + cb;
    if (b >= B) return 0.0f;
    const float hn = pre[2] + bias[2];
    const float r = sigmoid_f(in.gx[0] + (pre[0] + bias[0]));
    const float z = sigmoid_f(in.gx[1] + (pre[1] + bias[1]));
    const float n = tanhf(in.gx[2] + r * hn);
    const float dh = in.dhs + dh_c;
    const float dn = dh * (1.0f - z) * (1.0f - n * n);
    const float dr = dn * hn * r * (1.0f - r);
    const float dz = dh * (in.h_prev - n) * z * (1.0f - z);
    const float dnr = dn * r;
    db[0] += dr;
    db[1] += dz;
    db[2] += dnr;
    const size_t row = (size_t)pos(s) * B + b;
    bf16* dst = dgx + row * G + cu;
    dst[0] = __float2bfloat16_rn(dr);
    dst[H] = __float2bfloat16_rn(dz);
    dst[2 * H] = __float2bfloat16_rn(dn);
    dgn[row * H + cu] = __float2bfloat16_rn(dnr);
    return dh * z;
  };

  // dh_{t-1}'s exchange part for the cell thread's row of tile i and its
  // unit: rows [b0, b0 + RB) of bf16(dgh) of step s (every block's, in
  // L2) times W_hh's columns of this block's units, chunk c by warp c % 8
  // through its two ring buffers, then the warps' sums in warp order.
  // Ends after a block barrier; `part` stays taken until the caller's
  // next one.
  auto dh_product = [&](int s, int i) -> float {
    const int b0 = i * BT + r0;
    const int t = pos(s);
    bf16* bufs = ring + (size_t)warp * XBUFS * RB * BOX;
    uint64_t* bars = gbar + warp * XBUFS;
    auto issue = [&](int c, int slot) {
      asm volatile("fence.proxy.async.global;" ::: "memory");
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      const fused::Chunk ch =
          c < ncz ? fused::Chunk{&map_g, c * BOX, b0, t}
                  : fused::Chunk{&map_n, (c - ncz) * BOX, b0, t};
      mbar_expect(&bars[slot], BOX_BYTES);
      fused::tma_half(bufs + (size_t)slot * RB * BOX, ch, 0, &bars[slot]);
    };
    if (lane == 0)
      for (int j = 0; j < XBUFS && warp + j * WARPS < nc; ++j)
        issue(warp + j * WARPS, j);
    float acc[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][e] = 0.0f;
#pragma unroll
    for (int ci = 0; ci < XC; ++ci) {
      const int c = warp + ci * WARPS;
      if (c < nc) {
        const int slot = ci % XBUFS;
        const bf16* buf = bufs + (size_t)slot * RB * BOX;
        mbar_wait(&bars[slot], (gphase >> slot) & 1);
        gphase ^= 1u << slot;
        TL_MARK(TL_DH_STAGE);
#pragma unroll
        for (int kk = 0; kk < KB; ++kk)
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            uint32_t a[4];
            fused::ldsm_x4(a, fused::swz_at<RB>(buf, 16 * m + arow,
                                                16 * kk + acol));
            fused::mma16816(acc[m], a[0], a[1], a[2], a[3], xw[ci][kk][0],
                            xw[ci][kk][1]);
          }
        __syncwarp();  // the buffer is read
        if (lane == 0 && c + XBUFS * WARPS < nc)
          issue(c + XBUFS * WARPS, slot);
        TL_MARK(TL_DH_PRODUCT);
      }
    }
    // lane (g, t) of m-tile m holds rows 16 m + g (+ 8) at units 2t, 2t+1
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        part[((warp * MT + m) * 2 + h) * 32 + lane] =
            make_float2(acc[m][2 * h], acc[m][2 * h + 1]);
    __syncthreads();
    const int mt = warp % MT, h = cell_half();
    float xs = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w)
      xs += cell_pick(part[((w * MT + mt) * 2 + h) * 32 + lane]);
    TL_MARK(TL_DH_PRODUCT);
    return xs;
  };

  unsigned int arrivals = 0;
  if constexpr (ONE) {
    // one tile; the dh carry in registers
    float dh_c = 0.0f;
    float pre[GATES];
    CellIn in;
    bool issued = recompute(Tn - 1, 0, pre, false);
    load_in(Tn - 1, 0, in);
    for (int s = Tn - 1;; --s) {
      TL_BEGIN();
      const float dhz = cell(s, 0, pre, in, dh_c);
      if (s == 0) {
        TL_MARK(TL_CELL);
        TL_STORE(s);
        break;
      }
      // the other blocks' copies of this step's bf16(dgh) read dgx[t] and
      // dgn[t]
      asm volatile("fence.proxy.async.global;" ::: "memory");
      grid_arrive(barrier);
      ++arrivals;
      TL_MARK(TL_CELL);
      TL_ARRIVED();
      // needs no other block's writes: step s-1's gh, its inputs
      issued = recompute(s - 1, 0, pre, issued);
      load_in(s - 1, 0, in);
      TL_MARK(TL_LOADS);
      grid_wait(barrier, arrivals * nblk, 0, THREADS);
      TL_MARK(TL_WAIT);
      TL_WAITED();
      dh_c = dhz + dh_product(s, 0);
      TL_STORE(s);
    }
  } else {
    // the tiles in series, the dh carry in dh_buf (each entry read and
    // written by one thread only)
    const int ntiles = (B + BT - 1) / BT;
    for (int s = Tn - 1; s >= 0; --s) {
      TL_BEGIN();
      for (int i = 0; i < ntiles; ++i) {
        __syncthreads();  // the tile and the sums are free again
        float pre[GATES];
        CellIn in;
        recompute(s, i, pre, false);
        load_in(s, i, in);
        TL_MARK(TL_LOADS);
        const int b = i * BT + r0 + cb;
        float* dh = dh_buf + (size_t)b * H + cu;
        const float dhz = cell(s, i, pre, in, b < B ? *dh : 0.0f);
        if (b < B) *dh = dhz;
        TL_MARK(TL_CELL);
      }
      if (s == 0) {
        TL_STORE(s);
        break;
      }
      asm volatile("fence.proxy.async.global;" ::: "memory");
      grid_arrive(barrier);
      ++arrivals;
      TL_ARRIVED();
      grid_wait(barrier, arrivals * nblk, 0, THREADS);
      TL_MARK(TL_WAIT);
      TL_WAITED();
      for (int i = 0; i < ntiles; ++i) {
        const float xs = dh_product(s, i);
        const int b = i * BT + r0 + cb;
        if (b < B) dh_buf[(size_t)b * H + cu] += xs;
        __syncthreads();  // the dh sums and the ring are free again
      }
      TL_STORE(s);
    }
  }

  // db_hh: the block's rows in order, then the group's blocks by atomicAdd
  __syncthreads();
  float* dbs = reinterpret_cast<float*>(part);  // [RB][GATES * UNITS]
#pragma unroll
  for (int q = 0; q < GATES; ++q)
    dbs[cb * GATES * UNITS + q * UNITS + cu - u0] = db[q];
  __syncthreads();
  if (tid < GATES * UNITS) {
    float sum = 0.0f;
    for (int r = 0; r < RB; ++r) sum += dbs[r * GATES * UNITS + tid];
    atomicAdd(db_hh + (tid / UNITS) * H + u0 + tid % UNITS, sum);
  }
}

// ---------------------------------------------------------------------------
// dW_hh = X^T Y: X (K, 3H) = [dgx[..., :2H] | dgn] shifted, Y (K, H) = hs
// shifted, bf16; dW_hh (3H, H) f32
// ---------------------------------------------------------------------------

constexpr int DW_M = BOX;      // rows of dW_hh a block: one box of X
constexpr int DW_N = 128;      // columns of dW_hh a block: two boxes of Y
constexpr int DW_BK = 64;      // K rows a chunk
constexpr int DW_STAGES = 4;   // chunks in flight
constexpr int DW_STAGE = DW_BK * (DW_M + DW_N);  // bf16: X's chunk, Y's

size_t dw_smem_bytes() {
  return (size_t)DW_STAGES * (DW_STAGE * sizeof(bf16) + sizeof(uint64_t));
}

__global__ void __launch_bounds__(THREADS, 2)
gru_dw_bf16_kernel(float* __restrict__ dw, int K, int H,
                   const __grid_constant__ CUtensorMap map_xg,
                   const __grid_constant__ CUtensorMap map_xn,
                   const __grid_constant__ CUtensorMap map_y) {
  extern __shared__ __align__(1024) float4 smem4[];
  bf16* stages = reinterpret_cast<bf16*>(smem4);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(stages + (size_t)DW_STAGES * DW_STAGE);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int ncz = rz_chunks(H);
  // dW_hh's rows: X's columns [x0, x0 + 64) of dgx (r, z) or dgn (n)
  const bool rz = (int)blockIdx.y < ncz;
  const CUtensorMap* map_x = rz ? &map_xg : &map_xn;
  const int x0 = (rz ? blockIdx.y : blockIdx.y - ncz) * DW_M;
  const int row0 = rz ? x0 : 2 * H + x0;   // dW_hh's first row
  const int rows = rz ? 2 * H - x0 : H - x0;  // of the part, from row0
  const int n0 = blockIdx.x * DW_N;        // dW_hh's columns: Y's
  const int wm = warp >> 2, wn = warp & 3;  // 32 x 32 of the tile a warp
  const int nkc = (K + DW_BK - 1) / DW_BK;
  if (tid == 0) {
    if (smem_u32(stages) & 1023) __trap();
    for (int i = 0; i < DW_STAGES; ++i) mbar_init(&full[i]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](int kc) {  // by thread 0
    const int st = kc % DW_STAGES;
    bf16* a = stages + (size_t)st * DW_STAGE;
    bf16* b = a + DW_BK * DW_M;
    const fused::Chunk cx{map_x, x0, kc * DW_BK, 0};
    const fused::Chunk cy{&map_y, n0, kc * DW_BK, 0};
    mbar_expect(&full[st], DW_STAGE * sizeof(bf16));
    fused::tma_half(a, cx, 0, &full[st]);
    fused::tma_half(b, cy, 0, &full[st]);
    fused::tma_half(b + DW_BK * BOX, cy, 1, &full[st]);
  };
  if (tid == 0)
    for (int kc = 0; kc < DW_STAGES && kc < nkc; ++kc) issue(kc);

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
  // ldmatrix.trans rows: A (m16 x k16 from X's [k][m]): k 0-7 / 8-15 by
  // lane >> 4, m 0-7 / 8-15 by lane bit 3; B (k16 x n8 pairs from Y's
  // [k][n]): k by lane bit 3, n 0-7 / 8-15 by lane >> 4
  const int ak = (lane & 7) + 8 * (lane >> 4);
  const int am = 32 * wm + 8 * ((lane >> 3) & 1);
  const int bk = (lane & 7) + 8 * ((lane >> 3) & 1);
  const int bn = 32 * wn + 8 * (lane >> 4);
  for (int kc = 0; kc < nkc; ++kc) {
    const int st = kc % DW_STAGES;
    mbar_wait(&full[st], (kc / DW_STAGES) & 1);
    const bf16* a = stages + (size_t)st * DW_STAGE;
    const bf16* b = a + DW_BK * DW_M;
#pragma unroll
    for (int k0 = 0; k0 < DW_BK; k0 += 16) {
      uint32_t af[2][4], bfr[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        fused::ldsm_x4_trans(af[i],
                             fused::swz_at<DW_BK>(a, k0 + ak, am + 16 * i));
#pragma unroll
      for (int p = 0; p < 2; ++p)
        fused::ldsm_x4_trans(bfr[p],
                             fused::swz_at<DW_BK>(b, k0 + bk, bn + 16 * p));
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          fused::mma16816(acc[i][j], af[i][0], af[i][1], af[i][2], af[i][3],
                          bfr[j >> 1][2 * (j & 1)],
                          bfr[j >> 1][2 * (j & 1) + 1]);
    }
    __syncthreads();  // every warp is done with the stage
    if (tid == 0 && kc + DW_STAGES < nkc) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      issue(kc + DW_STAGES);
    }
  }
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = 32 * wm + 16 * i + g;   // of the part's rows, from row0
      const int c = n0 + 32 * wn + 8 * j + 2 * t;
      if (c >= H) continue;
      if (r < rows)
        *reinterpret_cast<float2*>(dw + (size_t)(row0 + r) * H + c) =
            make_float2(acc[i][j][0], acc[i][j][1]);
      if (r + 8 < rows)
        *reinterpret_cast<float2*>(dw + (size_t)(row0 + r + 8) * H + c) =
            make_float2(acc[i][j][2], acc[i][j][3]);
    }
}

template <typename Kernel>
int plan_of(Kernel* kernel, size_t smem, int* out) {
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
  out[1] = THREADS;
  out[2] = static_cast<int>(smem);
  out[3] = occ;
  out[6] = attr.numRegs;
  out[7] = static_cast<int>(attr.localSizeBytes);
  return cudaSuccess;
}

cudaError_t launch_bwd(void** args, int H, int B, cudaStream_t stream) {
  return launch_cooperative(B <= BT ? gru_bwd_bf16_kernel<true>
                                    : gru_bwd_bf16_kernel<false>,
                            grid_blocks(H), THREADS, args, bwd_smem_bytes(H),
                            stream);
}

}  // namespace

extern "C" {

const char* mlvae_gru_bwd_bf16_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The recurrence's launch plan for H, B: out[0] blocks, [1] threads, [2]
// dynamic shared memory bytes, [3] resident blocks an SM, [4] ring
// buffers of bf16(dgh) chunks, [5] rows of a batch tile a block, [6]
// registers a thread, [7] local memory bytes a thread (spills), of the
// build B takes (one tile: the split barrier; more: the tiles in series).
// Returns a cudaError_t.
int mlvae_gru_bwd_bf16_plan(int H, int B, int* out) {
  if (!takes(1, B, H)) return cudaErrorInvalidValue;
  const int err = plan_of(B <= BT ? gru_bwd_bf16_kernel<true>
                                  : gru_bwd_bf16_kernel<false>,
                          bwd_smem_bytes(H), out);
  out[0] = grid_blocks(H);
  out[4] = RING;
  out[5] = RB;
  return err;
}

// The dW_hh kernel's plan for H: out[0] blocks, [4] stages, [5] K rows a
// stage, the rest as above.
int mlvae_gru_dw_bf16_plan(int H, int* out) {
  if (!takes(2, 1, H)) return cudaErrorInvalidValue;
  const int err = plan_of(gru_dw_bf16_kernel, dw_smem_bytes(), out);
  out[0] = ((H + DW_N - 1) / DW_N) * dgh_chunks(H);
  out[4] = DW_STAGES;
  out[5] = DW_BK;
  return err;
}

// gx (T,B,3H), w_hh (3H,H), hs and dhs (T,B,H) bf16, b_hh (3H) and hs32
// (T,B,H) f32 inputs; dgx (T,B,3H) and dgn (T,B,H) bf16 outputs (every
// element written), 16-byte aligned (the TMA reads them back), hs
// likewise; db_hh (3H) f32 output, zeroed; dh_buf (B,H) zeroed f32
// scratch (read by the tiles in series of B > 64 only); barrier one zeroed
// counter. H a multiple of 16 up to 528. dW_hh is
// mlvae_gru_dw_bf16's, after this. Returns a cudaError_t. The timing build
// (MLVAE_K1_BWD_TIMELINE) is mlvae_gru_bwd_bf16_timeline, which also takes
// the (T, blocks, 10) u64 timeline before the stream.
#ifdef MLVAE_K1_BWD_TIMELINE
int mlvae_gru_bwd_bf16_timeline(
#else
int mlvae_gru_bwd_bf16(
#endif
    const bf16* gx, const bf16* w_hh, const float* b_hh, const bf16* hs,
    const float* hs32, const bf16* dhs, bf16* dgx, bf16* dgn, float* db_hh,
    float* dh_buf, unsigned int* barrier, int T, int B, int H,
    int reverse TL_ARG, cudaStream_t stream) {
  if (!takes(T, B, H) || reinterpret_cast<uintptr_t>(hs) % 16 ||
      reinterpret_cast<uintptr_t>(dgx) % 16 ||
      reinterpret_cast<uintptr_t>(dgn) % 16)
    return cudaErrorInvalidValue;
  CUtensorMap map_h, map_g, map_n;
  cudaError_t err = fused::tensor_map(&map_h, hs, H, H, B, T, RB);
  // dgx's r and z columns only: the map ends at 2H of each 3H row
  if (err == cudaSuccess)
    err = fused::tensor_map(&map_g, dgx, 2 * H, GATES * H, B, T, RB);
  if (err == cudaSuccess)
    err = fused::tensor_map(&map_n, dgn, H, H, B, T, RB);
  if (err != cudaSuccess) return err;
  void* args[] = {(void*)&gx,     (void*)&w_hh,    (void*)&b_hh,
                  (void*)&hs32,   (void*)&dhs,     (void*)&dgx,
                  (void*)&dgn,    (void*)&db_hh,   (void*)&dh_buf,
                  (void*)&barrier, (void*)&T,      (void*)&B,
                  (void*)&H,      (void*)&reverse, (void*)&map_h,
                  (void*)&map_g,  (void*)&map_n
#ifdef MLVAE_K1_BWD_TIMELINE
                  ,
                  (void*)&timeline
#endif
  };
  return launch_bwd(args, H, B, stream);
}

// dW_hh (3H,H) f32 output (every element written) = sum over the steps s
// >= 1 of the processing order of bf16(dgh)[t_s]^T hs[t_{s-1}], from
// K5-bwd's dgx (its r and z columns) and dgn and the forward's hs, all
// bf16 and 16-byte aligned; T >= 2. Returns a cudaError_t.
int mlvae_gru_dw_bf16(const bf16* dgx, const bf16* dgn, const bf16* hs,
                      float* dw, int T, int B, int H, int reverse,
                      cudaStream_t stream) {
  if (!takes(T, B, H) || T < 2 || reinterpret_cast<uintptr_t>(hs) % 16 ||
      reinterpret_cast<uintptr_t>(dgx) % 16 ||
      reinterpret_cast<uintptr_t>(dgn) % 16)
    return cudaErrorInvalidValue;
  const int G = GATES * H;
  const int K = (T - 1) * B;
  // forward: X's steps 1.. against hs's 0..; reverse: X's 0.. against 1..
  const size_t xs = reverse ? 0 : (size_t)B, ys = reverse ? (size_t)B : 0;
  CUtensorMap map_xg, map_xn, map_y;
  cudaError_t err =
      fused::tensor_map(&map_xg, dgx + xs * G, 2 * H, G, K, 1, DW_BK);
  if (err == cudaSuccess)
    err = fused::tensor_map(&map_xn, dgn + xs * H, H, H, K, 1, DW_BK);
  if (err == cudaSuccess)
    err = fused::tensor_map(&map_y, hs + ys * H, H, H, K, 1, DW_BK);
  if (err != cudaSuccess) return err;
  const size_t smem = dw_smem_bytes();
  err = cudaFuncSetAttribute(gru_dw_bf16_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  gru_dw_bf16_kernel<<<dim3((H + DW_N - 1) / DW_N, dgh_chunks(H)), THREADS,
                       smem, stream>>>(dw, K, H, map_xg, map_xn, map_y);
  return cudaGetLastError();
}

}  // extern "C"
