// K3/K4-fwd and K7b on f32 streams: the LSTM forward recurrence with the
// input projection inside, exact f32.
//
// Replaces the TPU kernels mlvae_tpu/ops/lstm_pallas.py `_fwd_fused_kernel`
// (launched by `_run_fwd_fused`) and mlvae_tpu/ops/lstm_unroll_exp.py
// `_fwd_fused_kernel_k` (launched by `run_fwd_fused_k`, K time steps per
// grid iteration) in f32 mode: gates = x_t @ W_ih^T + bias + h_{t-1} @
// W_hh^T in torch gate order, f32 operands, f32 sums (exact f32 FMAs: no
// tensor cores, no TF32), c_t and h_t in f32, zero initial state,
// `reverse` processing t = T-1 .. 0 (outputs in natural time order). The
// (T, B, 4H) gates never reach memory.
//
// What bounds it on an H100: at B=64, T=160, H=512 the products are
// 2*B*4H*(In+H)*T FLOP, 0.401 ms at In=128 and 0.641 ms at In=512 at 67
// TFLOP/s of f32 FMA, against 10-30 MB of x, hs, cs and the weights: the
// operations. What keeps it far from that: the T dependent steps, each of
// which needs all of h_{t-1} from every block behind a grid barrier, and
// one block per SM with 16 gate rows of work. At In=512 a block's two
// products are equal, 2 x 524,288 FMA a step at B=64.
//
// Design: a persistent cooperative grid of H/4 blocks of 544 threads; block
// k owns 4 hidden units, i.e. 16 gate rows. The block splits in two warp
// groups of eight warps and one warp that issues copies, so that the input
// products leave the chain of steps without taking FMA threads from the
// recurrence:
//   warps 0-7, the recurrence: K1-fwd's step (lstm_fwd.cu). W_hh's 16 rows
//     stay in shared memory; h_{t-1} arrives by the TMA from a (2, H, Bp)
//     ping-pong scratch in quarters of each K slice, each on its own
//     mbarrier, through a ring of `ring` copies a slice; the split-K
//     product, the cell update with c_{t-1} kept in registers (the first
//     MAXG batch tiles), the split grid barrier;
//   warps 8-15, the producer: the input products x_t @ W_ih^T + bias of
//     the work items ahead (an item: one step's 64-row batch tile) into
//     `slots` item slots of 64 x 16 f32. Each thread forms 4 rows x 8 gate
//     rows (two gates) over its eighth of each x box's columns, so that an
//     x float4 read from shared memory serves eight gate rows, and the
//     eight eighths are summed as a tree across the lanes;
//   warp 16, the issuer: x_t and W_ih's 16 rows by the TMA into x slots of
//     a 64 x 32 box of x (128-byte swizzled) and W_ih's rows of its 32
//     columns, a stream of boxes that runs across items through NXS x
//     slots. A TMA issue can stall the thread that issues it; issued by a
//     thread of the producer, the copies held the whole producer, whose
//     warps wait on each other for every slot.
// The groups hand each item slot over on two mbarriers of one arrival a
// warp (full: the producer's; empty: the recurrence's). The recurrence
// waits for an item's slot only after its hidden product, so the producer
// has that product's time as slack besides the barrier's. K3/K4-fwd
// keeps two steps of items; K7b K steps (a group), fewer where they do
// not fit (`plan_of`, computed here and mirrored by ops.lstm.
// fused_f32_fwd_plan). A slot's input product is the same sums in the same
// order for every K and ring depth, so K7b's outputs are K3/K4-fwd's bit
// for bit. The hidden product sums as K1-fwd's (each K slice in k order,
// then the slices in order), the input product each eighth of columns in
// order, then the eighths as a tree; the cell update is K1-fwd's pinned
// contraction. No atomics: every launch gives the same bits.
#include "fwd_timeline.cuh"
#include "grid_sync.cuh"
#include "mbarrier.cuh"

namespace {

constexpr int UNITS = 4;               // hidden units owned by one block
constexpr int GATES = 4;               // i, f, g, o
constexpr int ROWS = GATES * UNITS;    // gate rows owned by one block
constexpr int BT = 64;                 // batch rows per tile (an item)
constexpr int KSPLIT = 4;              // the hidden product's K slices
constexpr int QUARTERS = 4;            // TMA copies of a slice and tile
constexpr int GROUP = 256;             // threads of a warp group
constexpr int THREADS = 2 * GROUP + 32;  // recurrence, producer, issuer
constexpr int SLICE = GROUP / KSPLIT;  // threads of a K slice: two warps
constexpr int WARPS = GROUP / 32;      // arrivals on a slot's mbarriers
constexpr int MAXG = 4;                // tiles whose c carry stays in registers
constexpr int BOXC = 32;               // columns of an x box: 128 bytes
constexpr int BOX = BT * BOXC;         // floats of an x box (8 KB)
constexpr int WBOX = ROWS * BOXC;      // W_ih's 16 rows of a box's columns
constexpr int XSLOT = BOX + WBOX;      // floats of an x slot (10 KB)
constexpr int NXS = 4;                 // x slots
constexpr int ITEM = BT * ROWS;        // floats of an item slot
constexpr int RED = KSPLIT * BT * ROWS;  // the hidden product's partials
constexpr int BAR_R = 1;               // the recurrence's named barrier;
                                       // 2 + ks: slice ks's
constexpr size_t SMEM_LIMIT = 232448;  // an H100 block's shared memory
static_assert(GROUP == KSPLIT * GATES * (BT / 4), "product layout");
static_assert(GROUP == BT * UNITS, "cell layout");
static_assert(GROUP == (BT / 4) * (GATES / 2) * 8,
              "producer: eight lanes a 4 x 8 tile");
static_assert((XSLOT * 4) % 1024 == 0, "the swizzle's 1024-byte atoms");

enum Schedule { STREAM = 0, AHEAD = 1 };

// f32 elements of one h copy: H/16 rows of h_{t-1} x 64 batch columns
__host__ __device__ inline int quarter_elems(int H) {
  return H / (KSPLIT * QUARTERS) * BT;
}

// The 16-byte row pitch of the h ping-pong scratch, in floats.
__host__ __device__ inline int hbuf_pitch(int B) { return (B + 3) & ~3; }

// Shared memory of a launch: the x slots (first: the swizzle wants 1024-
// byte alignment), the h ring (nq copies a K slice), W_hh's rows
// [gate][k][unit], the hidden partials and ns item slots, f32; an mbarrier
// a ring copy, a full and an empty one an x slot and an item slot.
size_t smem_of(int H, int nq, int ns) {
  return sizeof(float) * ((size_t)NXS * XSLOT +
                          (size_t)KSPLIT * nq * quarter_elems(H) +
                          (size_t)ROWS * H + RED + (size_t)ns * ITEM) +
         sizeof(uint64_t) * (KSPLIT * nq + 2 * NXS + 2 * ns);
}

// The layout of a launch at (In, H, B, K): item slots `slots` (K3/K4-fwd
// two steps' tiles, K7b K steps'), the h ring's depth `ring` (every copy
// of a step where it fits); where both do not fit, the ring gives way
// first down to two copies a slice, then the slots down to two steps, then
// the ring to one, then the slots to one. `schedule` AHEAD where the slots
// hold two steps' tiles (the producer a step ahead), else STREAM (it runs
// `slots` tiles ahead). `scratch` the floats of the h ping-pong (2, H,
// Bp). False for a shape no layout holds.
struct Plan {
  int schedule, slots, ring;
  size_t smem, scratch;
};

bool plan_of(int In, int H, int B, int K, Plan* p) {
  if (In < 4 || In % 4 || H < 16 || H % 16 || B < 1 || K < 1) return false;
  const int ntiles = (B + BT - 1) / BT;
  const int per = QUARTERS * ntiles;  // a slice's copies a step
  const int two = 2 * ntiles;         // two steps' items
  const int want = (K < 2 ? 2 : K) * ntiles;
  int nq = per, ns = want;
  auto fits = [&] { return smem_of(H, nq, ns) <= SMEM_LIMIT; };
  while (!fits() && nq > (per < 2 ? per : 2)) --nq;
  while (!fits() && ns > two) --ns;
  while (!fits() && nq > 1) --nq;
  while (!fits() && ns > 1) --ns;
  if (!fits()) return false;
  *p = {ns >= two ? AHEAD : STREAM, ns, nq, smem_of(H, nq, ns),
        (size_t)2 * H * hbuf_pitch(B)};
  return true;
}

__device__ __forceinline__ void mbar_init_n(uint64_t* bar, unsigned int n) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(n)
               : "memory");
}

// The warp's arrival on `bar` (which counts one a warp): its lanes'
// shared-memory accesses before it are ordered before the arrival.
__device__ __forceinline__ void warp_arrive(uint64_t* bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0)
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                     smem_u32(bar))
                 : "memory");
}

__device__ __forceinline__ void group_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(GROUP) : "memory");
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

// Offset of element (b, c) of a 64 x 32 box, as the TMA's 128-byte swizzle
// writes it: row b of 128 bytes, 16-byte unit c / 4 at that unit ^ (b % 8).
__device__ __forceinline__ int box_off(int b, int c) {
  return b * BOXC + ((((c >> 2) & 7) ^ (b & 7)) << 2) + (c & 3);
}

__global__ void __launch_bounds__(THREADS, 1)
lstm_fused_fwd_f32_kernel(const float* __restrict__ bias,
                          const float* __restrict__ w_hh,
                          float* __restrict__ hs, float* __restrict__ cs,
                          float* hbuf, unsigned int* barrier, int T, int B,
                          int In, int H, int reverse, int nq, int ns,
                          const __grid_constant__ CUtensorMap map_x,
                          const __grid_constant__ CUtensorMap map_w,
                          const __grid_constant__ CUtensorMap map_h
                              FWD_TIMELINE_ARG) {
  extern __shared__ __align__(1024) float4 smem4[];
  const int qe = quarter_elems(H);
  float* xsl = reinterpret_cast<float*>(smem4);
  float* ring = xsl + (size_t)NXS * XSLOT;
  float* w_s = ring + (size_t)KSPLIT * nq * qe;
  float* red_s = w_s + (size_t)ROWS * H;
  float* slots = red_s + RED;
  uint64_t* mb = reinterpret_cast<uint64_t*>(slots + (size_t)ns * ITEM);
  uint64_t* xfull = mb + KSPLIT * nq;
  uint64_t* xempty = xfull + NXS;
  uint64_t* sfull = xempty + NXS;
  uint64_t* sempty = sfull + ns;

  const int tid = threadIdx.x;
  const int u0 = blockIdx.x * UNITS;
  const int ntiles = (B + BT - 1) / BT;
  const unsigned int items = (unsigned int)T * ntiles;

  // this block's W_hh rows, laid out [gate][k][unit] so that one float4
  // holds the four units' weights for one k
  for (int idx = tid; idx < GATES * UNITS * H; idx += THREADS) {
    const int k = idx % H;
    const int j = (idx / H) % UNITS;
    const int gate = idx / (H * UNITS);
    w_s[((size_t)gate * H + k) * UNITS + j] =
        w_hh[(size_t)(gate * H + u0 + j) * H + k];
  }
  if (tid == 0) {
    if (smem_u32(xsl) & 1023) __trap();  // the swizzle's 1024-byte atoms
    for (int i = 0; i < KSPLIT * nq; ++i) mbar_init(&mb[i]);
    for (int i = 0; i < NXS; ++i) {
      mbar_init(&xfull[i]);
      mbar_init_n(&xempty[i], WARPS);
    }
    for (int i = 0; i < ns; ++i) {
      mbar_init_n(&sfull[i], WARPS);
      mbar_init_n(&sempty[i], WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  auto pos = [&](int s) { return reverse ? T - 1 - s : s; };
  FWD_CLOCK;

  const int nxb = (In + BOXC - 1) / BOXC;  // x boxes of an item
  const unsigned int nbox = items * nxb;
  if (tid >= 2 * GROUP) {
    // the issuer: box g of the stream (box g % nxb of item g / nxb), with
    // W_ih's 16 rows of its columns, into x slot g % NXS once every warp
    // of the producer has read box g - NXS. A TMA issue can stall its
    // thread; here it stalls no thread that forms a product
    if (tid == 2 * GROUP) {
      for (unsigned int g = 0; g < nbox; ++g) {
        const unsigned int n = g / nxb;
        const int xs = g % NXS;
        if (g >= NXS) mbar_wait(&xempty[xs], (g / NXS - 1) & 1);
        float* dst = xsl + (size_t)xs * XSLOT;
        mbar_expect(&xfull[xs], XSLOT * sizeof(float));
        tma3(dst, &map_x, (g % nxb) * BOXC, (n % ntiles) * BT,
             pos(n / ntiles), &xfull[xs]);
        tma3(dst + BOX, &map_w, (g % nxb) * BOXC, u0, 0, &xfull[xs]);
      }
    }
    return;
  }
  if (tid >= GROUP) {
    // the producer: thread (K eighth k8, tile tl): gates 2 gp and 2 gp + 1
    // (gp = tl / 16), batch rows (tl % 16) + 16 r, columns 4 k8 .. 4 k8 + 3
    // of each box; each x float4 read serves eight gate rows
    const int p = tid - GROUP;
    const int lane = p & 31;
    const int k8 = lane & 7;
    const int tl = (p >> 5) * 4 + (lane >> 3);
    const int gp = tl >> 4;
    const int b4 = tl & 15;
    // the gate and row this lane ends with (below): the bias of its units
    const int gate = 2 * gp + (k8 >> 2);
    float bq[UNITS];
#pragma unroll
    for (int j = 0; j < UNITS; ++j) bq[j] = bias[(size_t)gate * H + u0 + j];
    unsigned int g = 0;  // boxes read so far
    for (unsigned int n = 0; n < items; ++n) {
      const int s = n / ntiles;
      const int i = n % ntiles;
      if (i == 0) FWD_BEGIN_BY(GROUP);
      float acc[4][2 * UNITS];  // [row][gate row of the pair]
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 2 * UNITS; ++q) acc[r][q] = 0.0f;
      for (int jb = 0; jb < nxb; ++jb, ++g) {
        const int xs = g % NXS;
        mbar_wait(&xfull[xs], (g / NXS) & 1);
        const float* xb = xsl + (size_t)xs * XSLOT;
        const float* wg = xb + BOX + gp * 2 * UNITS * BOXC + 4 * k8;
        float4 xv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          xv[r] = *reinterpret_cast<const float4*>(
              xb + box_off(b4 + 16 * r, 4 * k8));
#pragma unroll
        for (int q = 0; q < 2 * UNITS; ++q) {
          const float4 wv = *reinterpret_cast<const float4*>(wg + q * BOXC);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            float a = acc[r][q];
            a = fmaf(xv[r].x, wv.x, a);
            a = fmaf(xv[r].y, wv.y, a);
            a = fmaf(xv[r].z, wv.z, a);
            a = fmaf(xv[r].w, wv.w, a);
            acc[r][q] = a;
          }
        }
        warp_arrive(&xempty[xs]);
      }
      // the eight K eighths summed as a tree across the lanes k8:
      // ((0 + 4) + (2 + 6)) + ((1 + 5) + (3 + 7)). Lane k8 keeps the gate
      // 2 gp + k8 / 4 (xor 4), then rows (k8 & 2) .. + 1 (xor 2), then
      // row k8 & 3 (xor 1): its four units
      const bool hi2 = k8 & 4;
      float h1[4][UNITS];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < UNITS; ++j) {
          const float send = hi2 ? acc[r][j] : acc[r][UNITS + j];
          const float mine = hi2 ? acc[r][UNITS + j] : acc[r][j];
          h1[r][j] = mine + __shfl_xor_sync(0xffffffffu, send, 4);
        }
      const bool hi1 = k8 & 2;
      float h2[2][UNITS];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int j = 0; j < UNITS; ++j) {
          const float send = hi1 ? h1[r][j] : h1[r + 2][j];
          const float mine = hi1 ? h1[r + 2][j] : h1[r][j];
          h2[r][j] = mine + __shfl_xor_sync(0xffffffffu, send, 2);
        }
      const bool hi0 = k8 & 1;
      float v[UNITS];
#pragma unroll
      for (int j = 0; j < UNITS; ++j) {
        const float send = hi0 ? h2[0][j] : h2[1][j];
        const float mine = hi0 ? h2[1][j] : h2[0][j];
        v[j] = mine + __shfl_xor_sync(0xffffffffu, send, 1);
      }
      FWD_MARK_BY(FWD_OFFCHAIN, GROUP);
      const int sl = n % ns;
      if (n >= (unsigned int)ns) mbar_wait(&sempty[sl], (n / ns - 1) & 1);
      FWD_MARK_BY(1, GROUP);  // the wait for a free slot is not counted
      *reinterpret_cast<float4*>(slots + (size_t)sl * ITEM +
                                 (b4 + 16 * (k8 & 3)) * ROWS +
                                 gate * UNITS) =
          make_float4(v[0] + bq[0], v[1] + bq[1], v[2] + bq[2],
                      v[3] + bq[3]);
      warp_arrive(&sfull[sl]);
      if (i == ntiles - 1) FWD_STORE(s, GROUP);
    }
    return;
  }

  // the recurrence. Product layout: thread -> (K slice, gate, 4 batch rows)
  const int ks = tid / (GATES * (BT / 4));
  const int gate = (tid / (BT / 4)) % GATES;
  const int b4 = tid % (BT / 4);
  const int kper = H / KSPLIT;
  const int k_lo = ks * kper;
  const int kq = kper / QUARTERS;  // rows of h_{t-1} a copy
  // cell-update layout: thread -> (batch row, unit)
  const int cb = tid / UNITS;
  const int cj = tid % UNITS;
  const int Bp = hbuf_pitch(B);

  const int per = QUARTERS * ntiles;  // a slice's copies a step
  const bool copier = tid % SLICE == 0;
  float* my_ring = ring + (size_t)ks * nq * qe;
  uint64_t* my_mb = mb + ks * nq;
  unsigned int jq = 0;  // this slice's copies before this step
  // copies [from, to) of step s: tile j / 4, quarter j % 4, from slot
  // s & 1 of the scratch; by the slice's first thread
  auto issue = [&](int s, int from, int to) {
    for (int j = from; j < to; ++j) {
      const unsigned int J = jq + j;
      uint64_t* bar = &my_mb[J % nq];
      mbar_expect(bar, qe * sizeof(float));
      tma3(my_ring + (size_t)(J % nq) * qe, &map_h, (j / QUARTERS) * BT,
           k_lo + (j % QUARTERS) * kq, s & 1, bar);
    }
  };
  float c_keep[MAXG];  // the cell thread's c_{t-1}, tiles below MAXG

  for (int s = 0; s < T; ++s) {
    const int t = pos(s);
    const int tp = reverse ? t + 1 : t - 1;  // previous processed position
    float* h_next = hbuf + (size_t)((s + 1) & 1) * H * Bp;
    FWD_BEGIN();
    if (s > 0 && copier) {
      // h_prev was written by plain stores of every block: the TMA's
      // async proxy must see them
      asm volatile("fence.proxy.async.global;" ::: "memory");
      issue(s, 0, min(per, nq));
    }
    for (int i = 0; i < ntiles; ++i) {
      const int b0 = i * BT;
      const int nb = min(BT, B - b0);
      float acc[4][UNITS];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < UNITS; ++j) acc[r][j] = 0.0f;
      if (s > 0) {
        const float4* w4 = reinterpret_cast<const float4*>(w_s) +
                           (size_t)gate * H + k_lo;
        for (int qi = 0; qi < QUARTERS; ++qi) {
          const int j = i * QUARTERS + qi;
          const unsigned int J = jq + j;
          mbar_wait(&my_mb[J % nq], (J / nq) & 1);
          FWD_MARK(FWD_STAGE);
          const float4* h4 =
              reinterpret_cast<const float4*>(my_ring + (size_t)(J % nq) * qe);
          const float4* wq = w4 + qi * kq;
#pragma unroll 8
          for (int k = 0; k < kq; ++k) {
            const float4 hv = h4[k * (BT / 4) + b4];
            const float4 wv = wq[k];
            const float hb[4] = {hv.x, hv.y, hv.z, hv.w};
            const float wj[UNITS] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
              for (int jj = 0; jj < UNITS; ++jj)
                acc[r][jj] = fmaf(hb[r], wj[jj], acc[r][jj]);
          }
          FWD_MARK(FWD_PRODUCT);
          if (j + nq < per) {  // free the buffer for copy j + nq
            asm volatile("bar.sync %0, %1;" ::"r"(2 + ks), "r"(SLICE)
                         : "memory");
            if (copier) issue(s, j + nq, j + nq + 1);
          }
        }
      }
      if (i > 0) group_sync(BAR_R);  // the last tile's cell read red_s
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < UNITS; ++j)
          red_s[((size_t)ks * BT + b4 * 4 + r) * ROWS + gate * UNITS + j] =
              acc[r][j];
      group_sync(BAR_R);

      // the item's input products, from the producer's slot
      const unsigned int n = (unsigned int)s * ntiles + i;
      const int sl = n % ns;
      mbar_wait(&sfull[sl], (n / ns) & 1);
      FWD_MARK(FWD_INPUT);
      float xp[GATES];
#pragma unroll
      for (int q = 0; q < GATES; ++q)
        xp[q] = slots[(size_t)sl * ITEM + cb * ROWS + q * UNITS + cj];
      warp_arrive(&sempty[sl]);

      if (cb < nb) {
        const int b = b0 + cb;
        float pre[GATES];
#pragma unroll
        for (int q = 0; q < GATES; ++q) {
          float sum = 0.0f;
          if (s > 0) {
#pragma unroll
            for (int kk = 0; kk < KSPLIT; ++kk)
              sum += red_s[((size_t)kk * BT + cb) * ROWS + q * UNITS + cj];
          }
          pre[q] = xp[q] + sum;
        }
        const float ig = sigmoid_f(pre[0]);
        const float fg = sigmoid_f(pre[1]);
        const float gg = tanhf(pre[2]);
        const float og = sigmoid_f(pre[3]);
        const size_t o = ((size_t)t * B + b) * H + u0 + cj;
        // c_{t-1} was written by this same thread one step earlier
        float c_prev = 0.0f;
        if (s > 0) {
#pragma unroll
          for (int ii = 0; ii < MAXG; ++ii)
            if (ii == i) c_prev = c_keep[ii];
          if (i >= MAXG) c_prev = cs[((size_t)tp * B + b) * H + u0 + cj];
        }
        // K1-fwd's contraction: f * c_{t-1} rounded, then i * g + it
        const float c = __fmaf_rn(ig, gg, __fmul_rn(fg, c_prev));
#pragma unroll
        for (int ii = 0; ii < MAXG; ++ii)
          if (ii == i) c_keep[ii] = c;
        const float h = og * tanhf(c);
        cs[o] = c;
        hs[o] = h;
        h_next[(size_t)(u0 + cj) * Bp + b] = h;
      }
      FWD_MARK(FWD_CELL);
    }
    if (s > 0) jq += per;
    // the next step's TMA copies in other blocks read h_next
    asm volatile("fence.proxy.async.global;" ::: "memory");
    grid_arrive_by(barrier, BAR_R, GROUP);
    FWD_MARK(FWD_CELL);
    if (s + 1 < T) {
      grid_wait(barrier, (unsigned int)(s + 1) * gridDim.x, BAR_R, GROUP);
      FWD_MARK(FWD_BARRIER);
    }
    FWD_STORE(s, GROUP);
  }
}

// A tensor map over the 3-D f32 tensor `base` (dims innermost first, byte
// strides of dims 1 and 2), boxes of box0 x box1 x box2, zeros past the
// ends.
cudaError_t f32_map(CUtensorMap* map, const float* base,
                    const cuuint64_t (&dims)[3], const cuuint64_t (&st)[2],
                    const cuuint32_t (&box)[3], bool swizzle) {
  PFN_cuTensorMapEncodeTiled_v12000 encode;
  const cudaError_t err = tensor_map_encoder(&encode);
  if (err != cudaSuccess) return err;
  const cuuint32_t step[3] = {1, 1, 1};
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
             const_cast<float*>(base), dims, st, box, step,
             CU_TENSOR_MAP_INTERLEAVE_NONE,
             swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

cudaError_t launch(const float* x, const float* w_ih, const float* bias,
                   const float* w_hh, float* hs, float* cs, float* scratch,
                   unsigned int* barrier, int T, int B, int In, int H, int K,
                   int reverse, long long scratch_size FWD_TIMELINE_ARG,
                   cudaStream_t stream) {
  Plan plan;
  if (T < 1 || K < 1 || T % K || !plan_of(In, H, B, K, &plan))
    return cudaErrorInvalidValue;
  // the kernel writes the whole h ping-pong it plans
  if (scratch_size < 0 || (size_t)scratch_size < plan.scratch)
    return cudaErrorInvalidValue;
  // x (In, B, T): boxes of 32 columns x 64 rows, 128-byte swizzled; W_ih
  // as (In, H, 4 gates): boxes of 32 columns x the block's 4 units x 4
  // gates, [gate][unit][column]; h_{t-1} as (slot, row k, batch column),
  // batch innermost at pitch Bp: boxes of 64 columns x H/16 rows of one
  // slot; all zeros past B and In
  const cuuint64_t in = In, b = B, h = H, bp = hbuf_pitch(B);
  CUtensorMap map_x, map_w, map_h;
  cudaError_t err = f32_map(&map_x, x, {in, b, (cuuint64_t)T},
                            {in * 4, in * b * 4}, {BOXC, BT, 1}, true);
  if (err == cudaSuccess)
    err = f32_map(&map_w, w_ih, {in, h, GATES}, {in * 4, in * h * 4},
                  {BOXC, UNITS, GATES}, false);
  if (err == cudaSuccess)
    err = f32_map(&map_h, scratch, {b, h, 2}, {bp * 4, bp * h * 4},
                  {BT, (cuuint32_t)(H / (KSPLIT * QUARTERS)), 1}, false);
  if (err != cudaSuccess) return err;
  int nq = plan.ring, ns = plan.slots;
  void* args[] = {(void*)&bias, (void*)&w_hh,  (void*)&hs,    (void*)&cs,
                  (void*)&scratch, (void*)&barrier, (void*)&T, (void*)&B,
                  (void*)&In,   (void*)&H,     (void*)&reverse, (void*)&nq,
                  (void*)&ns,   (void*)&map_x, (void*)&map_w, (void*)&map_h
#ifdef MLVAE_FWD_TIMELINE
                  ,
                  (void*)&timeline
#endif
  };
  return launch_cooperative(lstm_fused_fwd_f32_kernel, H / UNITS, THREADS,
                            args, plan.smem, stream);
}

}  // namespace

extern "C" {

const char* mlvae_lstm_fused_fwd_f32_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K3/K4-fwd: x (T,B,In), w_ih (4H,In), bias (4H,), w_hh (4H,H), f32; hs, cs
// (T,B,H) f32 outputs; scratch (scratch_size floats, at least the plan's:
// see mlvae_lstm_fused_fwd_f32_plan) the h ping-pong; barrier one zeroed
// counter. In a multiple of 4, H of 16, x, w_ih and the scratch 16-byte
// aligned. Returns a cudaError_t. The timing build (MLVAE_FWD_TIMELINE) is
// mlvae_lstm_fused_fwd_f32_timeline, which also takes the (T, H/4, 8) u64
// timeline before the stream.
#ifdef MLVAE_FWD_TIMELINE
int mlvae_lstm_fused_fwd_f32_timeline(
#else
int mlvae_lstm_fused_fwd_f32(
#endif
    const float* x, const float* w_ih, const float* bias, const float* w_hh,
    float* hs, float* cs, float* scratch, unsigned int* barrier, int T, int B,
    int In, int H, int reverse, long long scratch_size FWD_TIMELINE_ARG,
    cudaStream_t stream) {
  return launch(x, w_ih, bias, w_hh, hs, cs, scratch, barrier, T, B, In, H, 1,
                reverse, scratch_size,
#ifdef MLVAE_FWD_TIMELINE
                timeline,
#endif
                stream);
}

// K7b: as mlvae_lstm_fused_fwd_f32 with the input products of K steps
// ahead in K steps' slots where they fit; T a multiple of K.
#ifdef MLVAE_FWD_TIMELINE
int mlvae_lstm_unroll_fused_fwd_f32_timeline(
#else
int mlvae_lstm_unroll_fused_fwd_f32(
#endif
    const float* x, const float* w_ih, const float* bias, const float* w_hh,
    float* hs, float* cs, float* scratch, unsigned int* barrier, int T, int B,
    int In, int H, int K, int reverse, long long scratch_size FWD_TIMELINE_ARG,
    cudaStream_t stream) {
  return launch(x, w_ih, bias, w_hh, hs, cs, scratch, barrier, T, B, In, H, K,
                reverse, scratch_size,
#ifdef MLVAE_FWD_TIMELINE
                timeline,
#endif
                stream);
}

// The plan of a launch at (In, H, B, K) (not a launch): out[0] its
// schedule (0 stream, 1 ahead), out[1] item slots, out[2] the h ring's
// copies a slice, out[3] x slots, out[4] threads a block, out[5] shared
// memory bytes, out[6] the floats of its scratch, out[7] and out[8] the
// kernel's registers and local memory bytes a thread. Returns a
// cudaError_t: invalid value for a shape no layout holds.
int mlvae_lstm_fused_fwd_f32_plan(int In, int H, int B, int K,
                                  long long* out) {
  Plan plan;
  if (!plan_of(In, H, B, K, &plan)) return cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t err =
      cudaFuncGetAttributes(&attr, (const void*)lstm_fused_fwd_f32_kernel);
  out[0] = plan.schedule;
  out[1] = plan.slots;
  out[2] = plan.ring;
  out[3] = NXS;
  out[4] = THREADS;
  out[5] = (long long)plan.smem;
  out[6] = (long long)plan.scratch;
  out[7] = err == cudaSuccess ? attr.numRegs : 0;
  out[8] = err == cudaSuccess ? (long long)attr.localSizeBytes : 0;
  return static_cast<int>(err);
}

}  // extern "C"
