// K7b on bf16 streams: the LSTM forward recurrence with the input
// projection inside and the input products of a group of K consecutive
// steps formed ahead of their barriers.
//
// Replaces the TPU kernel mlvae_tpu/ops/lstm_unroll_exp.py
// `_fwd_fused_kernel_k` (launched by `run_fwd_fused_k`), K3/K4-fwd
// (`lstm_pallas._fwd_fused_kernel`) with K time steps per grid iteration
// and their input projections formed as one (K*B, In) @ (In, 4H) product:
// gates = x_t @ W_ih^T + bias + bf16(h_{t-1}) @ W_hh^T in torch gate order,
// products of bf16 operands summed in f32, the bias f32, c_t and h_t in
// f32, hs leaving as bf16 and cs as f32, zero initial state, T a multiple
// of K, `reverse` processing t = T-1 .. 0 (outputs in natural time order).
// Each accumulator runs the mma operations of K3/K4-fwd (lstm_fused_fwd.cu)
// on the same operands in the same order and the cell update is pinned to
// the same contraction, so the result is bit-identical to K3/K4-fwd's for
// every K. f32 streams take the K entry point of lstm_fused_fwd_f32.cu.
//
// What bounds it on an H100: at B=128, H=512, T=160 and In=512 the products
// are 2*B*4H*(In+H)*T = 85.9 GFLOP: 0.087 ms at 989 TFLOP/s of bf16 tensor
// cores, against about 92 MB of x, hs, cs and the weights (0.027 ms at
// 3.35 TB/s): the floor is the operations. What keeps it far from that, as
// K3/K4-fwd: the T dependent steps, each of which needs all of h_{t-1} from
// every block before a grid barrier, and one block per SM with 16 gate
// rows of work.
//
// Design: K3/K4-fwd's. A persistent cooperative grid of H/4 blocks,
// each holding its 16 rows of [W_ih | W_hh] in shared memory, the block
// split in two warp groups:
//   warps 4-7 (group X): a group's K steps of x, every batch tile, as one
//     product: one pipeline of the group's K * tiles * chunks TMA copies
//     of x, each step's f32 accumulators stored into a slot of its own (K
//     slots: X runs up to a group ahead of group H);
//   warps 0-3 (group H): per step, the grid barrier's wait, the slot's
//     accumulators as the mma C operand of the hidden product over the
//     chunks of h_{t-1} (all of them in flight at once where they fit,
//     the batch tiles' chains interleaved k-step by k-step), the cell
//     update (c_{t-1} kept in registers), and the arrival.
// K3/K4-fwd hands its two slots over on named barriers; K slots would
// need 2K of the 16 an SM has, so here each slot has two mbarriers of four
// arrivals, one a warp once its lanes are past (full: group X's warps have
// stored it; empty: group H's have read it). Chunks are 64 rows x 128
// columns, copied by the TMA from 3-D descriptors that zero-fill past B and
// In, 128-byte swizzled and read by ldmatrix (lstm_fused_tma.cuh). A launch with more than MAXT batch tiles,
// or whose K slots pass 227 KB, runs K3/K4-fwd's serial schedule of the
// same code: one tile a pass, one slot (which the pre-activations
// reuse), the groups in turns on two shared chunk tiles, c_{t-1} reloaded
// from cs; group X's input product of the next pass overlaps the barrier.
#include "fwd_timeline.cuh"
#include "lstm_fused_tma.cuh"

using namespace fused;

namespace {

constexpr int MAXT = 4;  // batch tiles of the schedule that keeps them all
constexpr int BAR_H = 1, BAR_XG = 2;  // the groups' own named barriers
static_assert(GROUP == (BT / 16) * 32, "a warp of a group: 16 batch rows");

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

// Shared memory of a launch: the chunk tiles first (1024-byte aligned for
// the swizzle): group H's nhb, and (ahead) group X's two, which the serial
// schedule shares with group H's (nhb = 2); the accumulator slots (ahead:
// nslot of nt tiles, then nt tiles of pre-activations; serial: one slot of
// one tile, which the pre-activations reuse), f32; the weights, bf16; the
// chunk tiles' mbarriers (X's two, H's nhb), then each slot's full and
// empty.
size_t fwd_smem_bytes(int In, int H, int nt, int nhb, int nslot,
                      bool ahead) {
  const size_t acc = (ahead ? (size_t)(nslot + 1) * nt : 1) * BT * ROWS;
  return sizeof(bf16) * (size_t)(nhb + (ahead ? 2 : 0)) * TILE +
         sizeof(float) * acc +
         sizeof(bf16) * (size_t)ROWS * weight_pitch(In, H) +
         sizeof(uint64_t) * (2 + nhb + 2 * nslot);
}

// The schedule of a launch over B rows: ahead (every tile in one pass, K
// slots, as many of the h_{t-1} chunks' tiles as fit, at least one a
// tile) or the serial one (one slot); false if even that passes 227 KB.
bool fwd_schedule(int In, int H, int B, int K, int* ahead, int* nhb,
                  int* nslot) {
  const int ntiles = (B + BT - 1) / BT;
  const int nh = (H + KCB - 1) / KCB;
  if (ntiles <= MAXT) {
    for (int n = ntiles * nh; n >= ntiles; --n) {
      if (fwd_smem_bytes(In, H, ntiles, n, K, true) <= SMEM_LIMIT) {
        *ahead = 1;
        *nhb = n;
        *nslot = K;
        return true;
      }
    }
  }
  *ahead = 0;
  *nhb = 2;
  *nslot = 1;
  return fwd_smem_bytes(In, H, 1, 2, 1, false) <= SMEM_LIMIT;
}

__global__ void __launch_bounds__(THREADS)
lstm_unroll_fused_fwd_kernel(const bf16* __restrict__ x,
                             const bf16* __restrict__ w_ih,
                             const float* __restrict__ bias,
                             const bf16* __restrict__ w_hh, bf16* hs,
                             float* __restrict__ cs, unsigned int* barrier,
                             int T, int B, int In, int H, int K, int reverse,
                             int ahead, int nhb, int nslot,
                             const __grid_constant__ CUtensorMap map_x,
                             const __grid_constant__ CUtensorMap map_h
                                 FWD_TIMELINE_ARG) {
  const int ntiles = (B + BT - 1) / BT;
  const int NT = ahead ? ntiles : 1;     // batch tiles a pass
  const int npass = ahead ? 1 : ntiles;  // passes a step
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
      xacc + (ahead ? (size_t)(nslot + 1) * NT : 1) * BT * ROWS);
  uint64_t* mbx = reinterpret_cast<uint64_t*>(w_s + (size_t)ROWS * LDW);
  uint64_t* mbh = mbx + 2;
  uint64_t* full = mbh + nhb;    // a slot's: group X has stored it
  uint64_t* empty = full + nslot;  // group H has read it

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wg = warp & 3;  // the warp within its group: batch rows 16 wg ..
  const int u0 = blockIdx.x * UNITS;
  load_weights(w_s, w_ih, w_hh, In, H, u0);
  if (tid == 0) {
    if (smem_u32(smem4) & 1023) __trap();  // the swizzled tiles' alignment
    for (int i = 0; i < 2 + nhb; ++i) mbar_init(&mbx[i]);
    for (int i = 0; i < 2 * nslot; ++i) mbar_init_n(&full[i], GROUP / 32);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  auto pos = [&](int s) { return reverse ? T - 1 - s : s; };
  const int nx = (In + KCB - 1) / KCB;  // chunks of x_t
  const int nh = (H + KCB - 1) / KCB;   // chunks of h_{t-1}
  FWD_CLOCK;

  if (tid >= GROUP) {
    // group X: the input products of passes q0 .. q0 + span - 1 as one
    // pipeline (ahead: a group's K steps; serial: one pass), pass q into
    // slot q % nslot
    const int span = ahead ? K : 1;
    const int per = NT * nx;  // chunks a pass
    unsigned int phase = 0;   // its two tiles' next parities
    float c[2][4];
    // the slot of pass q is free once group H has read pass q - nslot
    auto wait_empty = [&](int q) {
      if (q >= nslot) mbar_wait(&empty[q % nslot], (q / nslot - 1) & 1);
      FWD_MARK_BY(1, GROUP);  // the wait for the slot is not counted
    };
    for (int q0 = 0; q0 < total; q0 += span) {
      if (!ahead) {  // serial: the shared chunk tiles are free with it
        if (q0 % npass == 0) FWD_BEGIN_BY(GROUP);
        wait_empty(q0);
      }
      pipeline(
          xbufs, mbx, phase, span * per, GROUP, BAR_XG, false,
          [&](int j) {
            const int q = q0 + j / per;
            const int jj = j % per;
            return Chunk{&map_x, (jj % nx) * KCB,
                         ((q % npass) * NT + jj / nx) * BT, pos(q / npass)};
          },
          [&](int j, const bf16* tile) {
            const int q = q0 + j / per;
            const int jj = j % per;
            const int r = jj % nx;
            const int i = jj / nx;
            if (ahead && jj == 0) FWD_BEGIN_BY(GROUP);
            if (r == 0) {
#pragma unroll
              for (int e = 0; e < 8; ++e) c[e / 4][e % 4] = 0.0f;
            }
            pre_chunk_mma(c, tile, w_s, LDW, r * KCB, min(KCB, In - r * KCB),
                          wg);
            if (r == nx - 1) {
              if (ahead && i == 0) wait_empty(q);
              float4* dst = reinterpret_cast<float4*>(
                  xacc + ((size_t)(q % nslot) * NT + i) * BT * ROWS) +
                  2 * (wg * 32 + lane);
              dst[0] = make_float4(c[0][0], c[0][1], c[0][2], c[0][3]);
              dst[1] = make_float4(c[1][0], c[1][1], c[1][2], c[1][3]);
              if (i == NT - 1) {
                warp_arrive(&full[q % nslot]);
                FWD_MARK_BY(FWD_OFFCHAIN, GROUP);
                if (q % npass == npass - 1) FWD_STORE(q / npass, GROUP);
              }
            }
          });
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
    mbar_wait(&full[slot], (q / nslot) & 1);
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
    if (ahead && q + nslot < total) warp_arrive(&empty[slot]);

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
    if (!ahead && q + nslot < total) warp_arrive(&empty[slot]);
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

bool takes(int T, int B, int In, int H, int K) {
  return In >= 8 && In % 8 == 0 && H >= 16 && H % 16 == 0 && T >= 1 &&
         B >= 1 && K >= 1 && T % K == 0;
}

}  // namespace

extern "C" {

const char* mlvae_lstm_unroll_fused_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The launch plan for (In, H, B, K): out[0] blocks, [1] threads, [2]
// dynamic shared memory bytes, [3] group H's chunk tiles of h_{t-1}, [4]
// accumulator slots (K ahead, 1 serial), [5] batch tiles a pass, [6]
// serial (1) or ahead (0), [7] registers a thread, [8] local memory bytes
// a thread (spills). Returns a cudaError_t.
int mlvae_lstm_unroll_fused_fwd_plan(int In, int H, int B, int K,
                                     int* out) {
  int ahead, nhb, nslot;
  if (!takes(K, B, In, H, K) ||
      !fwd_schedule(In, H, B, K, &ahead, &nhb, &nslot))
    return cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t err =
      cudaFuncGetAttributes(&attr, lstm_unroll_fused_fwd_kernel);
  if (err != cudaSuccess) return err;
  const int nt = ahead ? (B + BT - 1) / BT : 1;
  out[0] = H / UNITS;
  out[1] = THREADS;
  out[2] = static_cast<int>(fwd_smem_bytes(In, H, nt, nhb, nslot, ahead));
  out[3] = nhb;
  out[4] = nslot;
  out[5] = nt;
  out[6] = !ahead;
  out[7] = attr.numRegs;
  out[8] = static_cast<int>(attr.localSizeBytes);
  return cudaSuccess;
}

// x (T,B,In) bf16, w_ih (4H,In) bf16, bias (4H) f32, w_hh (4H,H) bf16; hs
// (T,B,H) bf16 and cs (T,B,H) f32 outputs; barrier one zeroed counter. In
// a multiple of 8, H of 16, T of K, rows 16-byte aligned. Returns a
// cudaError_t. The timing build (MLVAE_FWD_TIMELINE) is
// mlvae_lstm_unroll_fused_fwd_timeline, which also takes the (T, H/4, 8)
// u64 timeline before the stream.
#ifdef MLVAE_FWD_TIMELINE
int mlvae_lstm_unroll_fused_fwd_timeline(
#else
int mlvae_lstm_unroll_fused_fwd(
#endif
    const bf16* x, const bf16* w_ih, const float* bias, const bf16* w_hh,
    bf16* hs, float* cs, unsigned int* barrier, int T, int B, int In, int H,
    int K, int reverse FWD_TIMELINE_ARG, cudaStream_t stream) {
  int ahead, nhb, nslot;
  if (!takes(T, B, In, H, K) ||
      !fwd_schedule(In, H, B, K, &ahead, &nhb, &nslot))
    return cudaErrorInvalidValue;
  const size_t smem = fwd_smem_bytes(
      In, H, ahead ? (B + BT - 1) / BT : 1, nhb, nslot, ahead);
  CUtensorMap map_x, map_h;
  cudaError_t err = chunk_map(&map_x, x, In, B, T);
  if (err == cudaSuccess) err = chunk_map(&map_h, hs, H, B, T);
  if (err != cudaSuccess) return err;
  void* args[] = {(void*)&x,     (void*)&w_ih,  (void*)&bias,
                  (void*)&w_hh,  (void*)&hs,    (void*)&cs,
                  (void*)&barrier, (void*)&T,   (void*)&B,
                  (void*)&In,    (void*)&H,     (void*)&K,
                  (void*)&reverse, (void*)&ahead, (void*)&nhb,
                  (void*)&nslot, (void*)&map_x, (void*)&map_h
#ifdef MLVAE_FWD_TIMELINE
                  ,
                  (void*)&timeline
#endif
  };
  return launch_cooperative(lstm_unroll_fused_fwd_kernel, H / UNITS,
                            THREADS, args, smem, stream);
}

}  // extern "C"
