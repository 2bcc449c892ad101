// K1-fwd for 528 < H <= 1024 on f32 streams: the LSTM forward recurrence
// over precomputed input gates, where the narrow build (lstm_fwd.cu, four
// units a block) would need more blocks than an H100 has SMs. bf16 streams
// take lstm_fwd_wide_bf16.cu, whose products run on the tensor cores.
//
// Replaces the TPU kernel mlvae_tpu/ops/lstm_pallas.py `_fwd_kernel`
// (launched by `_run_fwd`), which takes any H % 128 == 0: hs[t] = o *
// tanh(c_t), c_t = f * c_{t-1} + i * g, with the gates (i, f, g, o) = gx[t]
// + h_{t-1} @ W_hh^T in torch gate order, zero initial state, f32 carries,
// and `reverse` by indexing (outputs stay in natural time order). Its one
// recipe is LSTM_FC: four layers at H=1024.
//
// What bounds it on an H100: at B=64, H=1024, T=160 the recurrent products
// are 2*B*H*4H*T = 85.9 GFLOP of f32 FMA work (1.282 ms at 67 TFLOP/s)
// against about 210 MB of gx/hs/cs/W_hh traffic (63 us at 3.35 TB/s): the
// floor is the operations. As at H=512, every step needs all of h_{t-1}
// before any of h_t can start.
//
// Design (lstm_wide.cuh): one persistent cooperative grid of H/8 blocks
// (128 at H=1024, one an SM). A block owns 8 units and keeps their 32 gate
// rows of W_hh in shared memory (128 KB). Each step and 64-row batch tile
// it forms its B x 32 pre-activations with 8 x 8 register tiles (8 batch
// rows x one gate's 8 units a thread, four float4 reads for 64 FMAs) split
// eight ways over K, a warp a slice: warp ks sums rows kb .. kb + 15 of
// each 128-row chunk of k (kb = 128 c + 16 ks), chunk after chunk. h_{t-1}
// lies in an f32 ping-pong buffer (H, Bp) in L2, and each warp stages its
// own rows of it: one TMA box of 16 rows x 64 batch columns (4 KB, zeros
// past B) a chunk, through a ring of RING=3 boxes of its own, each with its
// own mbarrier, issued by the warp's lane 0. A warp waits only for its own
// box, and refills the buffer as soon as it has read it (a __syncwarp, no
// block barrier), so the copies of later chunks land behind the products
// of earlier ones. Once a warp's boxes are read its sums go to its own
// ring, laid out for the cell (lstm_wide.cuh's red): one block barrier,
// then the cell thread of (row, two units) adds the eight slices in order,
// applies the cell update with c_{t-1} in registers (first tile) and
// writes its slice of h_t to the buffer. The step ends in the split grid
// barrier of grid_sync.cuh, the next step's gx for the first tile loaded
// between the arrival and the wait. Three block barriers a step where the
// first wide design (cp.async chunks) took two a chunk and three for its
// slice-sum pass. The sums, their order and the cell update's pinned
// contraction are that design's, so the outputs are bit-identical to it.
// Not tried: TMA multicast of each box to a cluster of blocks (every block
// reads all 256 KB of h_{t-1} from L2 each step, 32 MB a step over 128
// blocks). Shared memory: 224 KB at H=1024.
#include <cuda_runtime.h>

#include "fwd_timeline.cuh"
#include "grid_sync.cuh"
#include "lstm_wide.cuh"
#include "mbarrier.cuh"

// The step timeline (fwd_timeline.cuh, only with -DMLVAE_FWD_TIMELINE):
// stage is thread 0's wait for its warp's boxes, product the rest of its
// warp's slice and the block barrier after the sums, cell the slices'
// sums, the cell update and its stores, barrier the grid barrier's wait,
// offchain the next step's gx loads between its arrival and wait.

namespace {

using namespace wide;

constexpr int KS = 8;              // K slices, a warp each
constexpr int BOXK = CHUNK / KS;   // rows of k a box: a slice's part
constexpr int BOX = BOXK * BT;     // floats of a box (4 KB)
constexpr int RING = 3;            // boxes a warp
constexpr int REGION = RING * BOX; // a warp's ring, floats
constexpr int TB = 8, TR = 8;      // the product's register tile
static_assert(KS * 32 == THREADS, "a warp a slice");
static_assert(RED_SLICE <= REGION, "a slice's sums fit in its ring");

size_t smem_bytes(int H) {
  // rings [KS][RING][BOXK][BT] + w_s [H][ROWS], f32; an mbarrier a box
  return sizeof(float) * ((size_t)KS * REGION + (size_t)ROWS * H) +
         sizeof(uint64_t) * KS * RING;
}

// QUADS: H % 32 == 0, so every K slice's rows of every chunk start on a
// multiple of 4 and come in fours (else the last chunk's may not: H % 32
// == 16 takes the build with a k-at-a-time branch for them, which costs
// the main loop a few percent when compiled in).
template <bool QUADS>
__global__ void __launch_bounds__(THREADS, 1)
lstm_fwd_wide_kernel(const float* __restrict__ gx,
                     const float* __restrict__ w_hh, float* __restrict__ hs,
                     float* __restrict__ cs, float* hbuf,
                     unsigned int* barrier, int T, int B, int H, int reverse,
                     const __grid_constant__ CUtensorMap map_h
                         FWD_TIMELINE_ARG) {
  extern __shared__ __align__(128) float smem[];
  float* ring = smem;
  float* w_s = ring + (size_t)KS * REGION;
  uint64_t* mb = reinterpret_cast<uint64_t*>(w_s + (size_t)ROWS * H);
  const int tid = threadIdx.x;
  const int u0 = blockIdx.x * UNITS;
  const int G = GATES * H;
  const int Bp = pitch_of(B);
  load_w(w_s, w_hh, H, u0);
  if (tid == 0) {
    for (int i = 0; i < KS * RING; ++i) mbar_init(&mb[i]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // product layout: warp -> K slice ks; lane -> (gate g: row quads 2g and
  // 2g + 1, batch group bg: rows 4 bg + j and 4 bg + j + 32)
  const int ks = tid / 32, lane = tid % 32;
  const int rq0 = (lane / 8) * (TR / 4);
  const int bg = lane % 8;
  float* my_ring = ring + (size_t)ks * REGION;
  uint64_t* my_mb = mb + ks * RING;
  // cell layout: thread -> (batch row cb of the tile, units cu, cu + 1)
  const int cb = tid / (UNITS / 2);
  const int cu = (tid % (UNITS / 2)) * 2;
  const int ntiles = (B + BT - 1) / BT;
  const int nc = n_chunks(H);
  const float4* w4 = reinterpret_cast<const float4*>(w_s);

  // this warp's box of chunk c for the tile from b0, slot `slot` of the h
  // buffer, into its ring buffer n % RING (by lane 0)
  auto issue = [&](unsigned int n, int c, int b0, int slot) {
    const int kb = c * CHUNK + ks * slice_part(H, c, KS);
    uint64_t* bar = &my_mb[n % RING];
    mbar_expect(bar, BOX * sizeof(float));
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(
            smem_u32(my_ring + (size_t)(n % RING) * BOX)),
        "l"(&map_h), "r"(b0), "r"(kb), "r"(slot), "r"(smem_u32(bar))
        : "memory");
  };

  // the first tile's gx of step s and its c_{t-1}, by the cell thread
  float gx0[2][GATES];
  float c0[2] = {0.0f, 0.0f};
  auto load_gx0 = [&](int s) {
    const int t = reverse ? T - 1 - s : s;
    if (cb < B) {
      const float* gxr = gx + ((size_t)t * B + cb) * G + u0 + cu;
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int q = 0; q < GATES; ++q) gx0[e][q] = gxr[(size_t)q * H + e];
    }
  };
  load_gx0(0);
  FWD_CLOCK;

  unsigned int taken = 0;  // this warp's boxes read so far
  unsigned int arrivals = 0;
  for (int s = 0; s < T; ++s) {
    FWD_BEGIN();
    const int t = reverse ? T - 1 - s : s;
    const int tp = reverse ? t + 1 : t - 1;  // previous processed position
    float* h_next = hbuf + (size_t)((s + 1) & 1) * H * Bp;
    for (int i = 0; i < ntiles; ++i) {
      const int b0 = i * BT;
      const int b = b0 + cb;
      if (s > 0) {
        if (lane == 0) {
          // h_{t-1} was written by plain stores of every block, and the
          // ring by this block's plain stores of the last sums: the TMA's
          // async proxy must see both
          asm volatile("fence.proxy.async.global;" ::: "memory");
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          for (int c = 0; c < RING && c < nc; ++c)
            issue(taken + c, c, b0, s & 1);
        }
        float acc[TB][TR];
#pragma unroll
        for (int bb = 0; bb < TB; ++bb)
#pragma unroll
          for (int r = 0; r < TR; ++r) acc[bb][r] = 0.0f;
        for (int c = 0; c < nc; ++c) {
          const unsigned int n = taken + c;
          FWD_MARK(FWD_PRODUCT);
          mbar_wait(&my_mb[n % RING], (n / RING) & 1);
          FWD_MARK(FWD_STAGE);
          const int part = slice_part(H, c, KS);
          const int kb = c * CHUNK + ks * part;  // this slice's first k
          const float* hb = my_ring + (size_t)(n % RING) * BOX + bg * 4;
          if (QUADS || ((kb | part) & 3) == 0) {
#pragma unroll 4
            for (int k4 = 0; k4 < part / 4; ++k4) {
              // W_hh's rows at k = kb + 4 k4 + i: slots of one swizzle
              // (kb is a multiple of 4), eight float4s apart
              const float4* wk0 = w4 + w_slot(kb + 4 * k4, rq0);
              const float4* wk1 = w4 + w_slot(kb + 4 * k4, rq0 + 1);
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int k = 4 * k4 + i;
                float hr[TB], wr[TR];
#pragma unroll
                for (int q = 0; q < TB / 4; ++q) {
                  const float4 v = *reinterpret_cast<const float4*>(
                      hb + k * BT + q * 32);
                  hr[4 * q + 0] = v.x;
                  hr[4 * q + 1] = v.y;
                  hr[4 * q + 2] = v.z;
                  hr[4 * q + 3] = v.w;
                }
                const float4 v0 = wk0[i * (ROWS / 4)];
                const float4 v1 = wk1[i * (ROWS / 4)];
                wr[0] = v0.x;
                wr[1] = v0.y;
                wr[2] = v0.z;
                wr[3] = v0.w;
                wr[4] = v1.x;
                wr[5] = v1.y;
                wr[6] = v1.z;
                wr[7] = v1.w;
#pragma unroll
                for (int bb = 0; bb < TB; ++bb)
#pragma unroll
                  for (int r = 0; r < TR; ++r)
                    acc[bb][r] = fmaf(hr[bb], wr[r], acc[bb][r]);
              }
            }
          } else {
            // the last chunk's parts where H % 32 == 16: not in fours
            for (int k = 0; k < part; ++k) {
              float hr[TB], wr[TR];
#pragma unroll
              for (int q = 0; q < TB / 4; ++q) {
                const float4 v = *reinterpret_cast<const float4*>(
                    hb + k * BT + q * 32);
                hr[4 * q + 0] = v.x;
                hr[4 * q + 1] = v.y;
                hr[4 * q + 2] = v.z;
                hr[4 * q + 3] = v.w;
              }
#pragma unroll
              for (int q = 0; q < TR / 4; ++q) {
                const float4 v = w4[w_slot(kb + k, rq0 + q)];
                wr[4 * q + 0] = v.x;
                wr[4 * q + 1] = v.y;
                wr[4 * q + 2] = v.z;
                wr[4 * q + 3] = v.w;
              }
#pragma unroll
              for (int bb = 0; bb < TB; ++bb)
#pragma unroll
                for (int r = 0; r < TR; ++r)
                  acc[bb][r] = fmaf(hr[bb], wr[r], acc[bb][r]);
            }
          }
          __syncwarp();  // the buffer is read
          if (lane == 0 && c + RING < nc) issue(n + RING, c + RING, b0,
                                                s & 1);
        }
        taken += nc;
        // the slice's sums into its own ring: gate rq0 / 2, units 0..7,
        // rows 4 bg + j (+ 32), a float4 of four rows
#pragma unroll
        for (int r = 0; r < TR; ++r)
#pragma unroll
          for (int q = 0; q < TB / 4; ++q)
            *reinterpret_cast<float4*>(
                my_ring + red_at(rq0 / 2, r, bg * 4 + q * 32)) =
                make_float4(acc[4 * q][r], acc[4 * q + 1][r],
                            acc[4 * q + 2][r], acc[4 * q + 3][r]);
        __syncthreads();  // every slice's sums written
        FWD_MARK(FWD_PRODUCT);
      }
      if (b < B) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int u = u0 + cu + e;
          float pre[GATES];
#pragma unroll
          for (int q = 0; q < GATES; ++q) {
            const float sum =
                s > 0 ? slice_sum<KS>(ring, REGION, q, cu + e, cb) : 0.0f;
            const float g_in =
                i == 0 ? gx0[e][q]
                       : gx[((size_t)t * B + b) * G + (size_t)q * H + u];
            pre[q] = g_in + sum;
          }
          const float ig = sigmoid_f(pre[0]);
          const float fg = sigmoid_f(pre[1]);
          const float gg = tanhf(pre[2]);
          const float og = sigmoid_f(pre[3]);
          const size_t o = ((size_t)t * B + b) * H + u;
          // c_{t-1} was written by this same thread one step earlier
          const float c_prev =
              s == 0 ? 0.0f
                     : (i == 0 ? c0[e] : cs[((size_t)tp * B + b) * H + u]);
          // f * c_{t-1} rounded, then i * g + it, as the narrow build
          const float c = __fmaf_rn(ig, gg, __fmul_rn(fg, c_prev));
          const float h = og * tanhf(c);
          if (i == 0) c0[e] = c;
          cs[o] = c;
          hs[o] = h;
          h_next[(size_t)u * Bp + b] = h;
        }
      }
      FWD_MARK(FWD_CELL);
      // the sums (the rings) read before the next tile's boxes land there
      if (i + 1 < ntiles) __syncthreads();
    }
    // the next step's TMA copies in other blocks read h_next
    asm volatile("fence.proxy.async.global;" ::: "memory");
    grid_arrive(barrier);
    ++arrivals;
    FWD_MARK(FWD_CELL);
    if (s + 1 < T) {
      load_gx0(s + 1);  // needs no other block's writes
      FWD_MARK(FWD_OFFCHAIN);
      grid_wait(barrier, arrivals * gridDim.x, 0, THREADS);
      FWD_MARK(FWD_BARRIER);
    }
    FWD_STORE(s, 0);
  }
}

// The build H takes (QUADS above).
const void* kernel_for(int H) {
  return H % 32 ? (const void*)lstm_fwd_wide_kernel<false>
                : (const void*)lstm_fwd_wide_kernel<true>;
}

// The tensor map of the (2, H, Bp) h buffer: (batch column, row k, slot),
// batch innermost; boxes of 64 columns x 16 rows of one slot, zeros past
// B and past H.
cudaError_t h_map(CUtensorMap* map, float* hbuf, int B, int H) {
  PFN_cuTensorMapEncodeTiled_v12000 encode;
  const cudaError_t err = tensor_map_encoder(&encode);
  if (err != cudaSuccess) return err;
  const int Bp = pitch_of(B);
  const cuuint64_t dims[3] = {(cuuint64_t)B, (cuuint64_t)H, 2};
  const cuuint64_t strides[2] = {(cuuint64_t)Bp * sizeof(float),
                                 (cuuint64_t)Bp * H * sizeof(float)};
  const cuuint32_t box[3] = {BT, BOXK, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, hbuf, dims, strides,
             box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace

extern "C" {

const char* mlvae_lstm_fwd_wide_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The launch plan for H (B does not change it): out[0] blocks, [1]
// threads, [2] dynamic shared memory bytes, [3] resident blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), [4] ring buffers a
// warp, [5] rows of k a chunk, [6] registers a thread, [7] local memory
// bytes a thread (spills). Returns a cudaError_t.
int mlvae_lstm_fwd_wide_plan(int H, int B, int* out) {
  if (!takes(1, B, H)) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(H);
  const void* kernel = kernel_for(H);
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
  out[0] = H / UNITS;
  out[1] = THREADS;
  out[2] = static_cast<int>(smem);
  out[3] = occ;
  out[4] = RING;
  out[5] = CHUNK;
  out[6] = attr.numRegs;
  out[7] = static_cast<int>(attr.localSizeBytes);
  return cudaSuccess;
}

// As mlvae_lstm_fwd: gx (T,B,4H) f32, w_hh (4H,H) f32, hs/cs (T,B,H) f32
// outputs, hbuf (2,H,Bp) f32 scratch zeroed (Bp = B rounded up to 4),
// barrier one zeroed counter. Returns a cudaError_t. The timing build
// (MLVAE_FWD_TIMELINE) is mlvae_lstm_fwd_wide_timeline, which also takes
// the (T, H/8, 8) u64 timeline before the stream.
#ifdef MLVAE_FWD_TIMELINE
int mlvae_lstm_fwd_wide_timeline(
#else
int mlvae_lstm_fwd_wide(
#endif
    const float* gx, const float* w_hh, float* hs, float* cs, float* hbuf,
    unsigned int* barrier, int T, int B, int H, int reverse FWD_TIMELINE_ARG,
    cudaStream_t stream) {
  if (!takes(T, B, H)) return cudaErrorInvalidValue;
  CUtensorMap map_h;
  const cudaError_t err = h_map(&map_h, hbuf, B, H);
  if (err != cudaSuccess) return err;
  void* args[] = {(void*)&gx, (void*)&w_hh,    (void*)&hs, (void*)&cs,
                  (void*)&hbuf, (void*)&barrier, (void*)&T, (void*)&B,
                  (void*)&H,  (void*)&reverse, (void*)&map_h
#ifdef MLVAE_FWD_TIMELINE
                  ,
                  (void*)&timeline
#endif
  };
  return H % 32 ? launch_cooperative(lstm_fwd_wide_kernel<false>, H / UNITS,
                                     THREADS, args, smem_bytes(H), stream)
                : launch_cooperative(lstm_fwd_wide_kernel<true>, H / UNITS,
                                     THREADS, args, smem_bytes(H), stream);
}

}  // extern "C"
