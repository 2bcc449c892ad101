// K1-bwd on bf16 streams at every H % 128 == 0 up to 1024: backpropagation
// through the LSTM recurrence over precomputed input gates with its three
// products on the tensor cores (LSTM_FC's AMP step: four layers at H=1024;
// CRDNN_CTC's: its first bidirectional layer at H=512), in two kernels: the
// recurrence, then dW_hh.
//
// Replaces the TPU kernel mlvae_tpu/ops/lstm_pallas.py `_bwd_kernel`
// (launched by `_run_bwd`) under AMP. The recurrence walks the processing
// order backward from dh = 0 and dc = dc_last: at each step it recomputes
// the gates gx[t] + h_{t-1} @ W_hh^T from the saved hs (h_{t-1} = hs[t_prev]
// in bf16, `h_prev.astype(whh_t_ref.dtype)`; zero at the first processed
// step), takes the pre-activation cotangents from `_bptt_dgates`' math in
// f32 (dh = dhs + the f32 dh carry), writes them to dgx[t] rounded to bf16
// and carries dc * f and dh_{t-1} = dgates @ W_hh (f32 sums) backward. As
// `dgates.astype(whh_t_ref.dtype)` feeds `_bwd_recurrent_grads`, both
// products take the dgates rounded to bf16: exactly what dgx holds. So
// dgx[t] is the operand of dh_{t-1}, and dW_hh = sum over the steps of
// dgx[t]^T hs[t_prev] (f32 sums; the first processed step adds nothing) is
// one product over dgx and hs shifted by a step: the second kernel forms
// it after the recurrence. `reverse` is indexing only. gx, W_hh, hs, dhs
// and dgx are bf16; cs, dc_last and dW_hh f32 (the wrapper rounds dW_hh to
// W_hh's dtype once).
//
// What bounds it on an H100: at B=64, H=1024, T=160 three products,
// 3*2*B*H*4H*T = 257.7 GFLOP (0.26 ms at 989 TFLOP/s of bf16 tensor
// cores), against about 280 MB of traffic (84 us at 3.35 TB/s): the floor
// is the operations. What keeps the recurrence far from it is the chain
// of T dependent steps, each of which needs every unit's dgates before any
// unit's dh_{t-1}: an exchange across the grid every step.
//
// Design of the recurrence (lstm_wide_mma.cuh): the grid of the wide
// builds, 8 units (32 gate rows) a block, H/8 blocks; the recompute is
// K1-fwd's product (W_hh's 32 rows as register B fragments, h_{t-1} staged
// whole from hs by the TMA in 128-column slices, a warp a slice). The
// exchange publishes the dgates themselves: each block reads all of dgx[t]
// for its tile (64 x 4H bf16, 512 KB at H=1024) from L2 by the TMA, in
// 8 KB chunks of 64 gate columns through a ring of two buffers a warp (the
// h tile's memory, free once the recompute is gathered; a warp's next
// chunk lands while it multiplies the last), and forms dh_{t-1} for its
// own 8 units against W_hh's 8 columns of them (4H x 8 bf16 in shared
// memory, read by ldmatrix): warp w takes chunks w, w + 8, ..., its sums
// added in warp order, so the order is fixed. The recompute needs only hs
// and gx, so for B <= 64 (one tile) the step's barrier is split: cell
// (dgx[t]) -> fence and arrival -> recompute and loads of the next step ->
// wait -> dh_{t-1}, the carries in registers; the copies of the recompute
// after next are issued once dh_{t-1} frees the tile, so they land during
// the next cell. B > 64 runs the tiles in series with the carries in
// dh_buf / dc_buf. Shared memory: 208 KB at H=1024 (the 128 KB tile /
// ring, W_hh's columns, the dh sums).
// Publishing the split-K partials of dh_{t-1} instead (the f32 build's
// exchange) would have each block write 256 KB and read 256 KB a step;
// here each block writes 4 KB (dgx, which it writes anyway) and reads
// 512 KB. Thread-block clusters with TMA multicast, which would share
// those reads between the blocks of a cluster, are not used.
//
// The dW_hh kernel: dW_hh (4H x H) = X^T Y with X = dgx and Y = hs, each
// viewed as ((T-1)*B) rows and shifted by a step (forward: dgx[1:], hs[:-1];
// reverse: dgx[:-1], hs[1:]), K = (T-1)*B = 10,176 at B=64. 128 x 128
// output tiles (256 blocks at H=1024, two an SM), 64-row K chunks of both
// operands copied by the TMA (128-byte swizzle, three stages), eight warps
// of 64 x 32 with mma.sync m16n8k16 on fragments read by ldmatrix.trans,
// every sum in K order: no atomics, repeated launches bit-equal.
#include "bwd_timeline.cuh"
#include "lstm_wide_mma.cuh"

// The step timeline (bwd_timeline.cuh, only with -DMLVAE_K1_BWD_TIMELINE):
// slot 5 dh_stage (waiting for its chunks of the dgates), 7 dh_product
// (its chunks' products and the sums' gather). Recompute is its slice's
// product and the sums' gather; cell includes the arrival.
#ifdef MLVAE_K1_BWD_TIMELINE
enum { TL_DH_STAGE = 5, TL_DH_PRODUCT = 7 };
#endif

using namespace widebf;

namespace {

// The exchange's ring: chunks of XCHUNK gate columns (one 64 x 64 TMA box,
// 8 KB), XBUFS buffers a warp, so that a warp's next chunk is in flight
// while it multiplies the last one.
constexpr int XCHUNK = 64;
constexpr int XBUFS = 2;
constexpr int RING = WARPS * XBUFS;
constexpr int XCHUNK_ELEMS = BT * XCHUNK;
static_assert(XCHUNK == fused::HALF, "an exchange chunk is one TMA box");
static_assert(RING * XCHUNK_ELEMS == MAX_SLICES * SLICE,
              "the ring is the h_{t-1} tile's memory");

__host__ __device__ inline int wct_pitch(int H) {
  return GATES * H + 8;  // bf16; 8 rows of W_hh^T meet 8 bank quads
}

// The tile / ring (128 KB), the dh sums (WARPS x 64 x 8
// f32), W_hh's columns of the block's units transposed (8 x (4H + 8)
// bf16), then an mbarrier a slice of h_{t-1} and a ring buffer.
size_t bwd_smem_bytes(int H) {
  return (size_t)MAX_SLICES * SLICE * sizeof(bf16) +
         (size_t)WARPS * BT * UNITS * sizeof(float) +
         (size_t)UNITS * wct_pitch(H) * sizeof(bf16) +
         (size_t)(n_slices(H) + RING) * sizeof(uint64_t);
}

// The cell thread's inputs of one step: gx of its two units' four gates,
// c_t, c_{t-1} and the cotangent of h_t from above.
struct CellIn {
  float gx[GATES][2];
  float c_t[2], c_prev[2], dhs[2];
};

template <bool SPLIT>
__global__ void __launch_bounds__(THREADS, 1)
lstm_bwd_wide_bf16_kernel(const bf16* __restrict__ gx,
                          const bf16* __restrict__ w_hh,
                          const float* __restrict__ cs,
                          const bf16* __restrict__ dhs, bf16* dgx,
                          float* dh_buf, float* dc_buf,
                          unsigned int* barrier, int Tn, int B, int H,
                          int reverse,
                          const __grid_constant__ CUtensorMap map_h,
                          const __grid_constant__ CUtensorMap map_g TL_ARG) {
  extern __shared__ __align__(1024) float4 smem4[];
  const int nk = n_slices(H);
  const int G = GATES * H;
  const int WP = wct_pitch(H);
  bf16* tile = reinterpret_cast<bf16*>(smem4);
  float2* red =
      reinterpret_cast<float2*>(tile + (size_t)MAX_SLICES * SLICE);
  bf16* wct = reinterpret_cast<bf16*>(red + WARPS * BT * UNITS / 2);
  uint64_t* hbar = reinterpret_cast<uint64_t*>(wct + (size_t)UNITS * WP);
  uint64_t* gbar = hbar + nk;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int nblk = gridDim.x;
  const int u0 = blockIdx.x * UNITS;

  // W_hh's columns of this block's units, wct[j][r] = W_hh[r][u0 + j]
  for (int r = tid; r < G; r += THREADS) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(
        w_hh + (size_t)r * H + u0));
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int j = 0; j < UNITS; ++j) wct[(size_t)j * WP + r] = e[j];
  }
  if (tid == 0) {
    if (smem_u32(tile) & 1023) __trap();  // the swizzle's 1024-byte atoms
    for (int i = 0; i < nk + RING; ++i) mbar_init(&hbar[i]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  uint32_t wf[KSTEPS][GATES][2];
  if (warp < nk) load_w_frags(wf, w_hh, H, u0, warp);
  __syncthreads();

  // cell layout (the products' fragment layout): row cb of the tile,
  // units cu and cu + 1
  const int cb = 8 * warp + (lane >> 2);
  const int cu = 2 * (lane & 3);
  const int arow = (lane & 7) + 8 * ((lane >> 3) & 1);
  const int acol = 8 * (lane >> 4);
  unsigned int hstaged = 0;  // copies of h_{t-1}: the slices' parity
  unsigned int gphase = 0;   // this warp's ring buffers' next parities
  TL_CLOCK;
  auto mark = [&](int k) { TL_MARK(k ? TL_RECOMPUTE : TL_STAGE); };
  auto pos = [&](int s) { return reverse ? Tn - 1 - s : s; };
  auto prev_pos = [&](int s) { return reverse ? pos(s) + 1 : pos(s) - 1; };

  // the recurrent part of step s's pre-activations for tile b0 (zero at
  // the first processed step); `issued`: its copies are in flight already
  auto recompute = [&](int s, int b0, float (&pre)[GATES][2],
                       bool issued = false) {
    if (s == 0) {
#pragma unroll
      for (int q = 0; q < GATES; ++q) pre[q][0] = pre[q][1] = 0.0f;
      return;
    }
    recurrent_product(pre, tile, hbar, &map_h, wf, nk, prev_pos(s), b0,
                      hstaged, mark, issued);
  };

  auto load_in = [&](int s, int b0, CellIn& in) {
    const int t = pos(s), tp = prev_pos(s);
    const int b = b0 + cb;
    if (b >= B) return;
    const size_t row = (size_t)t * B + b;
    const bf16* g = gx + row * G + u0 + cu;
#pragma unroll
    for (int q = 0; q < GATES; ++q) {
      const float2 v = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(g + (size_t)q * H));
      in.gx[q][0] = v.x;
      in.gx[q][1] = v.y;
    }
    const size_t o = row * H + u0 + cu;
    const float2 c = *reinterpret_cast<const float2*>(cs + o);
    const float2 cp = s > 0 ? *reinterpret_cast<const float2*>(
                                  cs + ((size_t)tp * B + b) * H + u0 + cu)
                            : make_float2(0.0f, 0.0f);
    const float2 d = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(dhs + o));
    in.c_t[0] = c.x;
    in.c_t[1] = c.y;
    in.c_prev[0] = cp.x;
    in.c_prev[1] = cp.y;
    in.dhs[0] = d.x;
    in.dhs[1] = d.y;
  };

  // the dgates of step s, tile b0, from the pre-activations' recurrent
  // parts and the carries dh_c (from the step above) and dc_c (updated to
  // dc * f), to dgx[t] in bf16
  auto cell = [&](int s, int b0, const float (&pre)[GATES][2],
                  const CellIn& in, const float (&dh_c)[2],
                  float (&dc_c)[2]) {
    const int b = b0 + cb;
    if (b >= B) return;
    float dg[GATES][2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float ig = sigmoid_f(__fadd_rn(in.gx[0][e], pre[0][e]));
      const float fg = sigmoid_f(__fadd_rn(in.gx[1][e], pre[1][e]));
      const float gg = tanhf(__fadd_rn(in.gx[2][e], pre[2][e]));
      const float og = sigmoid_f(__fadd_rn(in.gx[3][e], pre[3][e]));
      // the f32 builds' contraction: every product rounded, 1 - x^2 and
      // dc's update one FMA each
      const float dh = __fadd_rn(in.dhs[e], dh_c[e]);
      const float tanh_c = tanhf(in.c_t[e]);
      const float d_o = __fmul_rn(dh, tanh_c);
      const float dc = __fmaf_rn(__fmul_rn(dh, og),
                                 __fmaf_rn(-tanh_c, tanh_c, 1.0f), dc_c[e]);
      dg[0][e] = __fmul_rn(__fmul_rn(__fmul_rn(dc, gg), ig),
                           __fsub_rn(1.0f, ig));
      dg[1][e] = __fmul_rn(__fmul_rn(__fmul_rn(dc, in.c_prev[e]), fg),
                           __fsub_rn(1.0f, fg));
      dg[2][e] = __fmul_rn(__fmul_rn(dc, ig), __fmaf_rn(-gg, gg, 1.0f));
      dg[3][e] = __fmul_rn(__fmul_rn(d_o, og), __fsub_rn(1.0f, og));
      dc_c[e] = __fmul_rn(dc, fg);
    }
    bf16* dst = dgx + ((size_t)pos(s) * B + b) * G + u0 + cu;
#pragma unroll
    for (int q = 0; q < GATES; ++q)
      *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)q * H) =
          __floats2bfloat162_rn(dg[q][0], dg[q][1]);
  };

  // dh_{t-1} for the cell thread's row of tile b0 and units cu, cu + 1:
  // dgx[t]'s rows [b0, b0 + 64) (every block's dgates, in L2) times W_hh's
  // columns of this block's units, chunk j of 64 gate columns by warp j %
  // 8 through its two ring buffers, then the warps' sums in warp order.
  // Ends after a block barrier: the ring is free again once it returns.
  auto dh_product = [&](int s, int b0, float (&dh)[2]) {
    const int nc = G / XCHUNK;
    bf16* bufs = tile + (size_t)warp * XBUFS * XCHUNK_ELEMS;
    uint64_t* bars = gbar + warp * XBUFS;
    auto issue = [&](int j, int slot) {
      asm volatile("fence.proxy.async.global;" ::: "memory");
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      const fused::Chunk c{&map_g, j * XCHUNK, b0, pos(s)};
      mbar_expect(&bars[slot], XCHUNK_ELEMS * sizeof(bf16));
      fused::tma_half(bufs + (size_t)slot * XCHUNK_ELEMS, c, 0, &bars[slot]);
    };
    if (lane == 0)
      for (int i = 0; i < XBUFS && warp + i * WARPS < nc; ++i)
        issue(warp + i * WARPS, i);
    float acc[4][4];
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][e] = 0.0f;
    for (int j = warp, i = 0; j < nc; j += WARPS, ++i) {
      const int slot = i % XBUFS;
      const bf16* buf = bufs + (size_t)slot * XCHUNK_ELEMS;
      mbar_wait(&bars[slot], (gphase >> slot) & 1);
      gphase ^= 1u << slot;
      TL_MARK(TL_DH_STAGE);
      // B's matrices: units 0-7 at gate columns k0, +8, +16, +24
      const bf16* pb = wct + (size_t)(lane & 7) * WP + j * XCHUNK +
                       8 * (lane >> 3);
#pragma unroll
      for (int kp = 0; kp < XCHUNK / 32; ++kp) {
        uint32_t bw[4];
        fused::ldsm_x4(bw, pb + 32 * kp);
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            uint32_t a[4];
            fused::ldsm_x4(a, fused::tile_at(buf, 16 * m + arow,
                                             acol + 32 * kp + 16 * kk));
            fused::mma16816(acc[m], a[0], a[1], a[2], a[3], bw[2 * kk],
                            bw[2 * kk + 1]);
          }
      }
      __syncwarp();  // the buffer is read
      if (lane == 0 && j + XBUFS * WARPS < nc)
        issue(j + XBUFS * WARPS, slot);
      TL_MARK(TL_DH_PRODUCT);
    }
    // lane (g, t) of m-tile m holds rows 16 m + g (+ 8) at units 2t, 2t+1
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        red[((warp * 4 + m) * 2 + h) * 32 + lane] =
            make_float2(acc[m][2 * h], acc[m][2 * h + 1]);
    __syncthreads();
    dh[0] = dh[1] = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {  // (m * 2 + h) = this warp
      const float2 v = red[(w * 8 + warp) * 32 + lane];
      dh[0] = __fadd_rn(dh[0], v.x);
      dh[1] = __fadd_rn(dh[1], v.y);
    }
    TL_MARK(TL_DH_PRODUCT);
  };

  unsigned int arrivals = 0;
  if (SPLIT) {
    // one tile; the carries in registers
    float dh_c[2] = {0.0f, 0.0f}, dc_c[2] = {0.0f, 0.0f};
    if (cb < B) {
      const float2 v =
          *reinterpret_cast<const float2*>(dc_buf + (size_t)cb * H + u0 + cu);
      dc_c[0] = v.x;
      dc_c[1] = v.y;
    }
    float pre[GATES][2];
    CellIn in;
    recompute(Tn - 1, 0, pre);
    load_in(Tn - 1, 0, in);
    bool issued = false;  // step s-1's copies of h_{t-1} are in flight
    for (int s = Tn - 1;; --s) {
      TL_BEGIN();
      cell(s, 0, pre, in, dh_c, dc_c);
      if (s == 0) {
        TL_MARK(TL_CELL);
        TL_STORE(s);
        break;
      }
      // the other blocks' copies of this step's dgates read dgx[t]
      asm volatile("fence.proxy.async.global;" ::: "memory");
      grid_arrive(barrier);
      ++arrivals;
      TL_MARK(TL_CELL);
      TL_ARRIVED();
      // needs no other block's writes: step s-1's pre-activations, inputs
      recompute(s - 1, 0, pre, issued);
      load_in(s - 1, 0, in);
      TL_MARK(TL_LOADS);
      grid_wait(barrier, arrivals * nblk, 0, THREADS);
      TL_MARK(TL_WAIT);
      TL_WAITED();
      dh_product(s, 0, dh_c);
      // the tile is free until the next recompute: its copies (hs, an
      // input) land while the next cell runs
      issued = s >= 3;
      if (issued && tid == 0)
        stage_h(tile, &map_h, hbar, nk, prev_pos(s - 2), 0);
      TL_STORE(s);
    }
  } else {
    // the tiles in series, the carries in dh_buf / dc_buf
    for (int s = Tn - 1; s >= 0; --s) {
      TL_BEGIN();
      for (int b0 = 0; b0 < B; b0 += BT) {
        __syncthreads();  // the tile is free again
        float pre[GATES][2];
        CellIn in;
        recompute(s, b0, pre);
        load_in(s, b0, in);
        TL_MARK(TL_LOADS);
        const int b = b0 + cb;
        const size_t bu = (size_t)b * H + u0 + cu;
        float dh_c[2] = {0.0f, 0.0f}, dc_c[2] = {0.0f, 0.0f};
        if (b < B) {
          const float2 v = *reinterpret_cast<const float2*>(dh_buf + bu);
          const float2 c = *reinterpret_cast<const float2*>(dc_buf + bu);
          dh_c[0] = v.x;
          dh_c[1] = v.y;
          dc_c[0] = c.x;
          dc_c[1] = c.y;
        }
        cell(s, b0, pre, in, dh_c, dc_c);
        if (b < B)
          *reinterpret_cast<float2*>(dc_buf + bu) =
              make_float2(dc_c[0], dc_c[1]);
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
      for (int b0 = 0; b0 < B; b0 += BT) {
        float dh[2];
        dh_product(s, b0, dh);
        const int b = b0 + cb;
        if (b < B)
          *reinterpret_cast<float2*>(dh_buf + (size_t)b * H + u0 + cu) =
              make_float2(dh[0], dh[1]);
        __syncthreads();  // the dh sums and the ring are free again
      }
      TL_STORE(s);
    }
  }
}

// ---------------------------------------------------------------------------
// dW_hh = X^T Y: X (K, 4H) the shifted dgx, Y (K, H) the shifted hs, bf16;
// dW_hh (4H, H) f32
// ---------------------------------------------------------------------------

constexpr int DW_TILE = 128;   // rows and columns of dW_hh a block
constexpr int DW_BK = 64;      // K rows a chunk
constexpr int DW_STAGES = 3;   // chunks in flight
constexpr int DW_STAGE = 2 * DW_BK * DW_TILE;  // bf16: X's chunk, Y's chunk
static_assert(DW_BK == BT, "a chunk is 64 rows of the TMA's boxes");

size_t dw_smem_bytes() {
  return (size_t)DW_STAGES * (DW_STAGE * sizeof(bf16) + sizeof(uint64_t));
}

__global__ void __launch_bounds__(THREADS, 2)
lstm_dw_wide_bf16_kernel(float* __restrict__ dw, int K, int H,
                         const __grid_constant__ CUtensorMap map_x,
                         const __grid_constant__ CUtensorMap map_y) {
  extern __shared__ __align__(1024) float4 smem4[];
  bf16* stages = reinterpret_cast<bf16*>(smem4);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(stages + (size_t)DW_STAGES * DW_STAGE);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * DW_TILE;  // dW_hh's columns: Y's
  const int m0 = blockIdx.y * DW_TILE;  // dW_hh's rows: X's columns
  const int wm = warp >> 2, wn = warp & 3;  // 64 x 32 of the tile a warp
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
    bf16* b = a + DW_BK * DW_TILE;
    const fused::Chunk cx{&map_x, m0, kc * DW_BK, 0};
    const fused::Chunk cy{&map_y, n0, kc * DW_BK, 0};
    mbar_expect(&full[st], DW_STAGE * sizeof(bf16));
    fused::tma_half(a, cx, 0, &full[st]);
    fused::tma_half(a + BT * fused::HALF, cx, 1, &full[st]);
    fused::tma_half(b, cy, 0, &full[st]);
    fused::tma_half(b + BT * fused::HALF, cy, 1, &full[st]);
  };
  if (tid == 0)
    for (int kc = 0; kc < DW_STAGES && kc < nkc; ++kc) issue(kc);

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
  // ldmatrix.trans rows: A (m16 x k16 from X's [k][m]): k 0-7 / 8-15 by
  // lane >> 4, m 0-7 / 8-15 by lane bit 3; B (k16 x n8 pairs from Y's
  // [k][n]): k by lane bit 3, n 0-7 / 8-15 by lane >> 4
  const int ak = (lane & 7) + 8 * (lane >> 4);
  const int am = 64 * wm + 8 * ((lane >> 3) & 1);
  const int bk = (lane & 7) + 8 * ((lane >> 3) & 1);
  const int bn = 32 * wn + 8 * (lane >> 4);
  for (int kc = 0; kc < nkc; ++kc) {
    const int st = kc % DW_STAGES;
    mbar_wait(&full[st], (kc / DW_STAGES) & 1);
    const bf16* a = stages + (size_t)st * DW_STAGE;
    const bf16* b = a + DW_BK * DW_TILE;
#pragma unroll
    for (int k0 = 0; k0 < DW_BK; k0 += 16) {
      uint32_t af[4][4], bfr[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        fused::ldsm_x4_trans(af[i], fused::tile_at(a, k0 + ak, am + 16 * i));
#pragma unroll
      for (int p = 0; p < 2; ++p)
        fused::ldsm_x4_trans(bfr[p], fused::tile_at(b, k0 + bk, bn + 16 * p));
#pragma unroll
      for (int i = 0; i < 4; ++i)
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
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = m0 + 64 * wm + 16 * i + g;
      const int c = n0 + 32 * wn + 8 * j + 2 * t;
      *reinterpret_cast<float2*>(dw + (size_t)r * H + c) =
          make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(dw + (size_t)(r + 8) * H + c) =
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

}  // namespace

extern "C" {

const char* mlvae_lstm_bwd_wide_bf16_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The recurrence's launch plan for H, B: out[0] blocks, [1] threads, [2]
// dynamic shared memory bytes, [3] resident blocks an SM, [4] ring buffers
// of dgates chunks, [5] gate columns a chunk, [6] registers a thread, [7]
// local memory bytes a thread (spills), of the build B takes (one tile:
// the split barrier; more: the tiles in series). Returns a cudaError_t.
int mlvae_lstm_bwd_wide_bf16_plan(int H, int B, int* out) {
  if (!takes(1, B, H)) return cudaErrorInvalidValue;
  const int err =
      plan_of(B <= BT ? lstm_bwd_wide_bf16_kernel<true>
                      : lstm_bwd_wide_bf16_kernel<false>,
              bwd_smem_bytes(H), out);
  out[0] = H / UNITS;
  out[4] = RING;
  out[5] = XCHUNK;
  return err;
}

// The dW_hh kernel's plan for H: out[0] blocks, [4] stages, [5] K rows a
// stage, the rest as above.
int mlvae_lstm_dw_wide_bf16_plan(int H, int B, int* out) {
  if (!takes(2, B, H)) return cudaErrorInvalidValue;
  const int err = plan_of(lstm_dw_wide_bf16_kernel, dw_smem_bytes(), out);
  out[0] = (H / DW_TILE) * (GATES * H / DW_TILE);
  out[4] = DW_STAGES;
  out[5] = DW_BK;
  return err;
}

// gx (T,B,4H), w_hh (4H,H), dhs (T,B,H) bf16 and cs (T,B,H) f32 inputs;
// dgx (T,B,4H) bf16 output (every element written), 16-byte aligned (the
// TMA reads it back), hs (T,B,H) bf16 likewise; dh_buf (B,H) zeroed and
// dc_buf (B,H) holding dc_last, f32 scratch; barrier one zeroed counter. H
// a multiple of 128 up to 1024. dW_hh is mlvae_lstm_dw_wide_bf16's, after
// this. Returns a cudaError_t. The timing build (MLVAE_K1_BWD_TIMELINE) is
// mlvae_lstm_bwd_wide_bf16_timeline, which also takes the (T, H/8, 10)
// u64 timeline before the stream.
#ifdef MLVAE_K1_BWD_TIMELINE
int mlvae_lstm_bwd_wide_bf16_timeline(
#else
int mlvae_lstm_bwd_wide_bf16(
#endif
    const bf16* gx, const bf16* w_hh, const bf16* hs, const float* cs,
    const bf16* dhs, bf16* dgx, float* dh_buf, float* dc_buf,
    unsigned int* barrier, int T, int B, int H, int reverse TL_ARG,
    cudaStream_t stream) {
  if (!takes(T, B, H) || reinterpret_cast<uintptr_t>(hs) % 16 ||
      reinterpret_cast<uintptr_t>(dgx) % 16)
    return cudaErrorInvalidValue;
  CUtensorMap map_h, map_g;
  cudaError_t err = fused::chunk_map(&map_h, hs, H, B, T);
  if (err == cudaSuccess) err = fused::chunk_map(&map_g, dgx, GATES * H, B, T);
  if (err != cudaSuccess) return err;
  void* args[] = {(void*)&gx,     (void*)&w_hh,   (void*)&cs,
                  (void*)&dhs,    (void*)&dgx,    (void*)&dh_buf,
                  (void*)&dc_buf, (void*)&barrier, (void*)&T,
                  (void*)&B,      (void*)&H,      (void*)&reverse,
                  (void*)&map_h,  (void*)&map_g
#ifdef MLVAE_K1_BWD_TIMELINE
                  ,
                  (void*)&timeline
#endif
  };
  return launch_cooperative(B <= BT ? lstm_bwd_wide_bf16_kernel<true>
                                    : lstm_bwd_wide_bf16_kernel<false>,
                            H / UNITS, THREADS, args, bwd_smem_bytes(H),
                            stream);
}

// dW_hh (4H,H) f32 output (every element written) = sum over the steps s
// >= 1 of the processing order of dgx[t_s]^T hs[t_{s-1}], from K1-bwd's dgx
// and the forward's hs, both bf16 and 16-byte aligned; T >= 2. Returns a
// cudaError_t.
int mlvae_lstm_dw_wide_bf16(const bf16* dgx, const bf16* hs, float* dw,
                            int T, int B, int H, int reverse,
                            cudaStream_t stream) {
  if (!takes(T, B, H) || T < 2 || reinterpret_cast<uintptr_t>(hs) % 16 ||
      reinterpret_cast<uintptr_t>(dgx) % 16)
    return cudaErrorInvalidValue;
  const int G = GATES * H;
  const int K = (T - 1) * B;
  // forward: dgx[1:] against hs[:-1]; reverse: dgx[:-1] against hs[1:]
  const bf16* x = dgx + (reverse ? 0 : (size_t)B * G);
  const bf16* y = hs + (reverse ? (size_t)B * H : 0);
  CUtensorMap map_x, map_y;
  cudaError_t err = fused::chunk_map(&map_x, x, G, K, 1);
  if (err == cudaSuccess) err = fused::chunk_map(&map_y, y, H, K, 1);
  if (err != cudaSuccess) return err;
  const size_t smem = dw_smem_bytes();
  err = cudaFuncSetAttribute(lstm_dw_wide_bf16_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  lstm_dw_wide_bf16_kernel<<<dim3(H / DW_TILE, G / DW_TILE), THREADS, smem,
                             stream>>>(dw, K, H, map_x, map_y);
  return cudaGetLastError();
}

}  // extern "C"
