// K3/K4-fwd: the LSTM forward recurrence with the input projection inside,
// bf16 streams.
//
// Replaces the TPU kernel mlvae_tpu/ops/lstm_pallas.py `_fwd_fused_kernel`
// (launched by `_run_fwd_fused`), the forward of both fused tiers:
// gates = x_t @ W_ih^T + bias + bf16(h_{t-1}) @ W_hh^T in torch gate order
// (i, f, g, o), products of bf16 operands summed in f32, the bias f32;
// c_t = f * c_{t-1} + i * g and h_t = o * tanh(c_t) in f32; hs[t] leaves
// as bf16 and cs[t] as f32. Zero initial state; `reverse` processes
// t = T-1 .. 0 by indexing, outputs stay in natural time order.
//
// What bounds it on an H100: at B=64, H=512, T=160 and In=512 the products
// are 2*B*4H*(In+H)*T = 42.9 GFLOP (43 us at 989 TFLOP/s of bf16 tensor
// cores) against x, hs, cs and the weights, about 46 MB (14 us at
// 3.35 TB/s): the floor is the operations. What keeps this kernel far from
// it: the T dependent steps, each of which needs all of h_{t-1} from every
// block, and one block per SM with 16 gate rows of work, which keeps the
// tensor cores idle most of each step. Every block reads all of x_t and
// h_{t-1} from L2 each step (B * (In + H) bf16).
//
// Design: K1-fwd's persistent cooperative grid, each block holding its 16
// rows of [W_ih | W_hh] in shared memory, its B x 16 pre-activations formed
// on the tensor cores (mma.sync m16n8k16), then the cell update of its 4
// units. Only the hidden product needs the other blocks' h_{t-1}, so the
// block splits in two warp groups:
//   warps 4-7 (group X): the input products x_t @ W_ih^T of the steps
//     ahead, every batch tile, into a slot of f32 accumulators in shared
//     memory (two slots: a step ahead of group H), chunk after chunk of
//     x_t copied by the TMA;
//   warps 0-3 (group H): per step, the grid barrier's wait, the slot's
//     accumulators as the mma C operand of the hidden product over the
//     chunks of h_{t-1} (all of them in flight at once where they fit,
//     the batch tiles' chains interleaved k-step by k-step so that their
//     mma latencies overlap), the cell update (c_{t-1} kept in registers),
//     and the arrival.
// The groups hand the slots over on named barriers (full: X to H; empty:
// H to X). Each accumulator runs the mma operations of the parent design
// in its order (input columns, then hidden columns, 16 at a time), and the
// cell update is pinned to the parent's contraction, so the outputs are
// bit-identical to the single-group design's. Chunks are 64 rows x 128
// columns, copied by the TMA from 3-D descriptors that zero-fill past B
// and In, 128-byte swizzled and read by ldmatrix (lstm_fused_tma.cuh).
// A launch with more than MAXT batch tiles, or whose layout passes 227 KB,
// runs the serial schedule of the same code: one tile a pass, one slot,
// the groups in turns on two shared chunk tiles, c_{t-1} reloaded from cs;
// group X's input products of the next pass still overlap the barrier.
#include "fwd_timeline.cuh"
#include "lstm_fused_tma.cuh"

using namespace fused;

namespace {

constexpr int MAXT = 4;  // batch tiles of the schedule that keeps them all
constexpr int BAR_H = 1, BAR_XG = 2;  // the groups' own named barriers
constexpr int BAR_FULL = 3;   // slots 0, 1: group X's accumulators ready
constexpr int BAR_EMPTY = 5;  // slots 0, 1: group H has taken them
static_assert(GROUP == (BT / 16) * 32, "a warp of a group: 16 batch rows");

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(THREADS) : "memory");
}

__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(THREADS) : "memory");
}

// Shared memory of a launch: the chunk tiles first (1024-byte aligned for
// the swizzle): group H's nhb, and (ahead) group X's two, which the serial
// schedule shares with group H's (nhb = 2); the accumulator slots (ahead:
// two of nt tiles, then nt tiles of pre-activations; serial: one slot of
// one tile, which the pre-activations reuse), f32; the weights, bf16; the
// chunk tiles' mbarriers (X's two, H's nhb).
size_t fwd_smem_bytes(int In, int H, int nt, int nhb, bool ahead) {
  const size_t acc = (ahead ? 3 * (size_t)nt : 1) * BT * ROWS;
  return sizeof(bf16) * (size_t)(nhb + (ahead ? 2 : 0)) * TILE +
         sizeof(float) * acc +
         sizeof(bf16) * (size_t)ROWS * weight_pitch(In, H) +
         sizeof(uint64_t) * (2 + nhb);
}

// The schedule of a launch over B rows: ahead (every tile in one pass, as
// many of the h_{t-1} chunks' tiles as fit, at least one a tile) or the
// serial one; false if even that passes 227 KB.
bool fwd_schedule(int In, int H, int B, int* ahead, int* nhb) {
  const int ntiles = (B + BT - 1) / BT;
  const int nh = (H + KCB - 1) / KCB;
  if (ntiles <= MAXT) {
    for (int n = ntiles * nh; n >= ntiles; --n) {
      if (fwd_smem_bytes(In, H, ntiles, n, true) <= SMEM_LIMIT) {
        *ahead = 1;
        *nhb = n;
        return true;
      }
    }
  }
  *ahead = 0;
  *nhb = 2;
  return fwd_smem_bytes(In, H, 1, 2, false) <= SMEM_LIMIT;
}

__global__ void __launch_bounds__(THREADS)
lstm_fused_fwd_kernel(const bf16* __restrict__ x,
                      const bf16* __restrict__ w_ih,
                      const float* __restrict__ bias,
                      const bf16* __restrict__ w_hh, bf16* hs,
                      float* __restrict__ cs, unsigned int* barrier, int T,
                      int B, int In, int H, int reverse, int ahead, int nhb,
                      const __grid_constant__ CUtensorMap map_x,
                      const __grid_constant__ CUtensorMap map_h
                          FWD_TIMELINE_ARG) {
  const int ntiles = (B + BT - 1) / BT;
  const int NT = ahead ? ntiles : 1;     // batch tiles a pass
  const int npass = ahead ? 1 : ntiles;  // passes a step
  const int nslot = ahead ? 2 : 1;
  const int total = T * npass;
  const int LDW = weight_pitch(In, H);
  const int nblk = gridDim.x;
  extern __shared__ __align__(1024) float4 smem4[];
  bf16* hbufs = reinterpret_cast<bf16*>(smem4);  // group H's chunk tiles
  bf16* xbufs = ahead ? hbufs + (size_t)nhb * TILE : hbufs;
  // xacc[slot][tile]: group X's accumulators, warp w's lane l at
  // [(w - 4) * 32 + l] as two float4 (its two 16 x 8 tiles)
  float* xacc = reinterpret_cast<float*>(
      hbufs + (size_t)(nhb + (ahead ? 2 : 0)) * TILE);
  float* red_s = ahead ? xacc + (size_t)nslot * NT * BT * ROWS : xacc;
  bf16* w_s = reinterpret_cast<bf16*>(
      xacc + (ahead ? 3 * (size_t)NT : 1) * BT * ROWS);
  uint64_t* mbx = reinterpret_cast<uint64_t*>(w_s + (size_t)ROWS * LDW);
  uint64_t* mbh = mbx + 2;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wg = warp & 3;  // the warp within its group: batch rows 16 wg ..
  const int u0 = blockIdx.x * UNITS;
  load_weights(w_s, w_ih, w_hh, In, H, u0);
  if (tid == 0) {
    if (smem_u32(smem4) & 1023) __trap();  // the swizzled tiles' alignment
    for (int i = 0; i < 2 + nhb; ++i) mbar_init(&mbx[i]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  auto pos = [&](int s) { return reverse ? T - 1 - s : s; };
  const int nx = (In + KCB - 1) / KCB;  // chunks of x_t
  const int nh = (H + KCB - 1) / KCB;   // chunks of h_{t-1}
  FWD_CLOCK;

  if (tid >= GROUP) {
    // group X: the input products of pass q into slot q % nslot
    unsigned int phase = 0;  // its two tiles' next parities
    float c[2][4];
    for (int q = 0; q < total; ++q) {
      const int s = q / npass;
      const int p = q % npass;
      const int slot = q % nslot;
      const int t = pos(s);
      const int ntp = min(NT, ntiles - p * NT);
      if (p == 0) FWD_BEGIN_BY(GROUP);
      if (q >= nslot) named_sync(BAR_EMPTY + slot);
      FWD_MARK_BY(1, GROUP);  // the wait for the slot is not counted
      float* acc = xacc + (size_t)slot * NT * BT * ROWS;
      pipeline(
          xbufs, mbx, phase, ntp * nx, GROUP, BAR_XG, false,
          [&](int j) {
            return Chunk{&map_x, (j % nx) * KCB, (p * NT + j / nx) * BT, t};
          },
          [&](int j, const bf16* tile) {
            const int r = j % nx;
            if (r == 0) {
#pragma unroll
              for (int e = 0; e < 8; ++e) c[e / 4][e % 4] = 0.0f;
            }
            pre_chunk_mma(c, tile, w_s, LDW, r * KCB, min(KCB, In - r * KCB),
                          wg);
            if (r == nx - 1) {
              float4* dst = reinterpret_cast<float4*>(
                  acc + (size_t)(j / nx) * BT * ROWS) +
                  2 * (wg * 32 + lane);
              dst[0] = make_float4(c[0][0], c[0][1], c[0][2], c[0][3]);
              dst[1] = make_float4(c[1][0], c[1][1], c[1][2], c[1][3]);
            }
          });
      named_arrive(BAR_FULL + slot);
      FWD_MARK_BY(FWD_OFFCHAIN, GROUP);
      if (p == npass - 1) FWD_STORE(s, GROUP);
    }
    return;
  }

  // group H. Cell layout: thread -> rows cb0 and cb0 + 32 of each tile,
  // unit cj; the same thread owns their c carry.
  const int cb0 = tid / UNITS;
  const int cj = tid % UNITS;
  float bq[GATES];
#pragma unroll
  for (int q = 0; q < GATES; ++q) bq[q] = bias[(size_t)q * H + u0 + cj];
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int arow = 16 * wg + (lane & 7) + 8 * ((lane >> 3) & 1);
  const int acol = 8 * (lane >> 4);
  // B's matrices (as pre_chunk_mma): weight rows 0-7 at k0, at k0 + 8,
  // rows 8-15 at k0, at k0 + 8
  const bf16* pb = w_s + (size_t)((lane & 7) + 8 * (lane >> 4)) * LDW +
                   8 * ((lane >> 3) & 1);
  float c[MAXT][2][4];
  float c_keep[MAXT][2];  // ahead: c_{t-1} of the thread's cells
  unsigned int jh = 0;    // group H's chunk copies so far
  for (int q = 0; q < total; ++q) {
    const int s = q / npass;
    const int p = q % npass;
    const int slot = q % nslot;
    const int t = pos(s);
    const int tp = reverse ? t + 1 : t - 1;  // previous processed position
    const int ntp = min(NT, ntiles - p * NT);
    if (p == 0) FWD_BEGIN();
    named_sync(BAR_FULL + slot);
    FWD_MARK(FWD_INPUT);
    const float4* src = reinterpret_cast<const float4*>(
        xacc + (size_t)slot * NT * BT * ROWS);
#pragma unroll
    for (int i = 0; i < MAXT; ++i) {
      if (i >= ntp) break;
      const float4 a = src[(size_t)i * BT * ROWS / 4 + 2 * (wg * 32 + lane)];
      const float4 b = src[(size_t)i * BT * ROWS / 4 + 2 * (wg * 32 + lane) +
                           1];
      c[i][0][0] = a.x;
      c[i][0][1] = a.y;
      c[i][0][2] = a.z;
      c[i][0][3] = a.w;
      c[i][1][0] = b.x;
      c[i][1][1] = b.y;
      c[i][1][2] = b.z;
      c[i][1][3] = b.w;
    }
    // ahead: the slot is free once read; serial: it holds the
    // pre-activations until the cell update has read them
    if (ahead && q + nslot < total) named_arrive(BAR_EMPTY + slot);

    if (s > 0) {
      // the hidden product: copy k of this pass is chunk k / ntp of tile
      // k % ntp, into tile (jh + k) % nhb; chunk r's copies of every tile
      // are consumed together, k-step by k-step
      const int n = nh * ntp;
      auto issue = [&](int from, int to) {
        if (tid != 0) return;
        for (int k = from; k < to; ++k) {
          const unsigned int J = jh + k;
          const int b = J % nhb;
          const Chunk ch{&map_h, (k / ntp) * KCB, (p * NT + k % ntp) * BT,
                         tp};
          mbar_expect(&mbh[b], 2 * HALF * STAGED_ROWS * sizeof(bf16));
          tma_half(hbufs + (size_t)b * TILE, ch, 0, &mbh[b]);
          tma_half(hbufs + (size_t)b * TILE + BT * HALF, ch, 1, &mbh[b]);
        }
      };
      // hs[tp] was written by plain stores of every block: the TMA's
      // async proxy must see them
      if (tid == 0) asm volatile("fence.proxy.async.global;" ::: "memory");
      issue(0, min(n, nhb));
      for (int r = 0; r < nh; ++r) {
        const bf16* tiles[MAXT];
#pragma unroll
        for (int i = 0; i < MAXT; ++i) {
          if (i >= ntp) break;
          const unsigned int J = jh + r * ntp + i;
          mbar_wait(&mbh[J % nhb], (J / nhb) & 1);
          tiles[i] = hbufs + (size_t)(J % nhb) * TILE;
        }
        FWD_MARK(FWD_STAGE);
        const int width = min(KCB, H - r * KCB);
        const bf16* pbr = pb + In + r * KCB;
#pragma unroll 4
        for (int k0 = 0; k0 < width; k0 += 16) {
          uint32_t bw[4];
          ldsm_x4(bw, pbr + k0);
#pragma unroll
          for (int i = 0; i < MAXT; ++i) {
            if (i >= ntp) break;
            uint32_t a[4];
            ldsm_x4(a, tile_at(tiles[i], arow, acol + k0));
            mma16816(c[i][0], a[0], a[1], a[2], a[3], bw[0], bw[1]);
            mma16816(c[i][1], a[0], a[1], a[2], a[3], bw[2], bw[3]);
          }
        }
        FWD_MARK(FWD_PRODUCT);
        const int lim = min(n, (r + 1) * ntp + nhb);
        const int had = min(n, r * ntp + nhb);
        if (lim > had) {  // free chunk r's tiles for the next copies
          group_sync(BAR_H);
          issue(had, lim);
        }
      }
      jh += n;
    }

    // the pre-activations (without the bias) into red_s[tile][b][q]
#pragma unroll
    for (int i = 0; i < MAXT; ++i) {
      if (i >= ntp) break;
      float* red = red_s + (size_t)i * BT * ROWS;
      const int row = wg * 16 + g;
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
        const int qq = ni * 8 + 2 * tq;
        red[row * ROWS + qq] = c[i][ni][0];
        red[row * ROWS + qq + 1] = c[i][ni][1];
        red[(row + 8) * ROWS + qq] = c[i][ni][2];
        red[(row + 8) * ROWS + qq + 1] = c[i][ni][3];
      }
    }
    group_sync(BAR_H);
#pragma unroll
    for (int i = 0; i < MAXT; ++i) {
      if (i >= ntp) break;
      const float* red = red_s + (size_t)i * BT * ROWS;
      const int b0 = (p * NT + i) * BT;
      const int nb = min(BT, B - b0);
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int cb = cb0 + 32 * h2;
        if (cb >= nb) continue;
        const int b = b0 + cb;
        const float ig = sigmoid_f(preact(red, cb, 0, cj, bq[0]));
        const float fg = sigmoid_f(preact(red, cb, 1, cj, bq[1]));
        const float gg = tanhf(preact(red, cb, 2, cj, bq[2]));
        const float og = sigmoid_f(preact(red, cb, 3, cj, bq[3]));
        const size_t o = ((size_t)t * B + b) * H + u0 + cj;
        // c_{t-1}: this thread's own, from the step before
        const float c_prev =
            s == 0 ? 0.0f
                   : (ahead ? c_keep[i][h2]
                            : cs[((size_t)tp * B + b) * H + u0 + cj]);
        // the parent's contraction: f * c_{t-1} rounded, then i * g + it
        const float cn = __fmaf_rn(ig, gg, __fmul_rn(fg, c_prev));
        if (ahead) c_keep[i][h2] = cn;
        cs[o] = cn;
        hs[o] = __float2bfloat16_rn(og * tanhf(cn));
      }
    }
    if (!ahead && q + nslot < total) named_arrive(BAR_EMPTY + slot);
    FWD_MARK(FWD_CELL);
    if (p == npass - 1) {
      // the next step's TMA copies in other blocks read hs[t]
      asm volatile("fence.proxy.async.global;" ::: "memory");
      grid_arrive_by(barrier, BAR_H, GROUP);
      if (s + 1 < T) grid_wait(barrier, (unsigned int)(s + 1) * nblk, BAR_H,
                               GROUP);
      FWD_MARK(FWD_BARRIER);
      FWD_STORE(s, GROUP);
    } else {
      group_sync(BAR_H);  // red_s is free for the next pass
    }
  }
}

}  // namespace

extern "C" {

const char* mlvae_lstm_fused_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (T,B,In) bf16, w_ih (4H,In) bf16, bias (4H) f32, w_hh (4H,H) bf16; hs
// (T,B,H) bf16 and cs (T,B,H) f32 outputs; barrier one zeroed counter. In
// a multiple of 8, H of 16, rows 16-byte aligned. Returns a cudaError_t.
// The timing build (MLVAE_FWD_TIMELINE) is mlvae_lstm_fused_fwd_timeline,
// which also takes the (T, H/4, 8) u64 timeline before the stream.
#ifdef MLVAE_FWD_TIMELINE
int mlvae_lstm_fused_fwd_timeline(
#else
int mlvae_lstm_fused_fwd(
#endif
    const bf16* x, const bf16* w_ih, const float* bias, const bf16* w_hh,
    bf16* hs, float* cs, unsigned int* barrier, int T, int B, int In, int H,
    int reverse FWD_TIMELINE_ARG, cudaStream_t stream) {
  if (In < 8 || In % 8 || H % 16 || T < 1 || B < 1)
    return cudaErrorInvalidValue;
  int ahead, nhb;
  if (!fwd_schedule(In, H, B, &ahead, &nhb)) return cudaErrorInvalidValue;
  const size_t smem =
      fwd_smem_bytes(In, H, ahead ? (B + BT - 1) / BT : 1, nhb, ahead);
  CUtensorMap map_x, map_h;
  cudaError_t err = chunk_map(&map_x, x, In, B, T);
  if (err == cudaSuccess) err = chunk_map(&map_h, hs, H, B, T);
  if (err != cudaSuccess) return err;
  void* args[] = {(void*)&x,       (void*)&w_ih, (void*)&bias, (void*)&w_hh,
                  (void*)&hs,      (void*)&cs,   (void*)&barrier,
                  (void*)&T,       (void*)&B,    (void*)&In,   (void*)&H,
                  (void*)&reverse, (void*)&ahead, (void*)&nhb,
                  (void*)&map_x,   (void*)&map_h
#ifdef MLVAE_FWD_TIMELINE
                  ,
                  (void*)&timeline
#endif
  };
  return launch_cooperative(lstm_fused_fwd_kernel, H / UNITS, THREADS, args,
                            smem, stream);
}

}  // extern "C"
