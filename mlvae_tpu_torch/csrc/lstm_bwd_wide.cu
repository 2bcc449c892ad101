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
// Design (lstm_wide.cuh): one persistent cooperative grid of H/8 blocks; a
// block owns 8 units, i.e. 32 gate rows, and keeps those rows of W_hh in
// shared memory (128 KB at H=1024) for the recompute and for dh_{t-1}.
// Its 32 rows of dW_hh stay in registers for the whole sequence: a thread
// owns four consecutive columns of H and all 32 rows, 128 accumulators,
// so dW_hh needs no atomics and repeated launches are bit-equal. hs is
// first copied once into a (T, H, Bp) slab, k-major (a plain transpose
// launched just before), so that h_{t-1} stages for the recompute as
// K1-fwd's h buffer does. A step, for each 64-row batch tile in series:
// stage h_{t-1} in k chunks and recompute the pre-activations (8 x 4
// register tiles, four K slices); the cell forms the dgates from the dh
// and dc carries (dh_buf, dc_buf, one thread an entry) and writes them to
// dgx[t] and shared memory; each thread forms its four columns of its
// split-K share of dh_{t-1}, partial[b][k] = sum over the block's rows of
// dgates[b][row] * W_hh[row][k], eight batch rows at a time (twelve
// float4 reads for 128 FMAs), while h_{t-1} lands a second time, now eight
// batch rows a chunk straight from hs, since it does not fit whole beside
// W_hh; then dW_hh[rows][k] += dgates[b][row] * h_{t-1}[b][k] over the
// chunk's rows (nine float4 reads for 128 FMAs). After a grid barrier each
// block sums the partials of every block for its own 8 units in block
// order.
//
// The exchange keeps the narrow build's split-K partials, laid out
// (slot, writing block, unit group of 8, row, unit), so that a reducing
// block reads its 8 units of a row as two float4s of one 32-byte sector:
// (2, H/8, B, H) f32, 64 MB at H=1024, B=64, of which one step writes and
// reads one 32 MB slot. Publishing the dgates instead (B x 4H a step)
// would have every block read all of them, 128 MB a step, and the W_hh
// columns of its units beside its rows, which do not fit beside them.
// Shared memory: 204 KB at H=1024. The tiles run in series and the
// barrier is not split; the copies of h_{t-1} (twice a step) and the
// exchange share the block's warps with the products.
#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_sync.cuh"
#include "lstm_wide.cuh"

namespace {

using namespace wide;

// hst[t][k][b] = hs[t][b][k] for b < B, 0 for B <= b < Bp: 32 x 32 tiles
// through shared memory, blocks (32, 8), grid (H/32, Bp/32, T) rounded up.
__global__ void transpose_hs(const float* __restrict__ hs,
                             float* __restrict__ hst, int B, int H, int Bp) {
  __shared__ float tile[32][33];
  const int t = blockIdx.z;
  const int k0 = blockIdx.x * 32, b0 = blockIdx.y * 32;
  for (int j = threadIdx.y; j < 32; j += 8) {
    const int b = b0 + j, k = k0 + threadIdx.x;
    tile[j][threadIdx.x] =
        b < B && k < H ? hs[((size_t)t * B + b) * H + k] : 0.0f;
  }
  __syncthreads();
  for (int j = threadIdx.y; j < 32; j += 8) {
    const int k = k0 + j, b = b0 + threadIdx.x;
    if (k < H && b < Bp)
      hst[((size_t)t * H + k) * Bp + b] = tile[threadIdx.x][j];
  }
}

// Rows [b0 + 8c, b0 + 8c + 8) of h at one position, (B, H) in hs, into
// ring buffer c % RING as [row][k], one copy group; rows past B as zeros.
__device__ inline void stage_rows(float* ring, const float* h, int B, int H,
                                  int b0, int c) {
  float* buf = ring_buf(ring, c);
  const int n4 = H / 4;
  for (int i = threadIdx.x; i < 8 * n4; i += THREADS) {
    const int r = i / n4, j = i % n4;
    const int b = b0 + 8 * c + r;
    const bool ok = b < B;
    cp_async16(buf + (size_t)r * H + 4 * j,
               h + (size_t)(ok ? b : 0) * H + 4 * j, ok);
  }
  cp_commit();
}

constexpr int TB = 8, TR = 4;  // the recompute's register tile: 4 K slices

__global__ void __launch_bounds__(THREADS, 1)
lstm_bwd_wide_kernel(const float* __restrict__ gx,
                     const float* __restrict__ w_hh,
                     const float* __restrict__ hs,
                     const float* __restrict__ cs,
                     const float* __restrict__ dhs,
                     const float* __restrict__ hst, float* __restrict__ dgx,
                     float* __restrict__ dw_hh, float* part, float* dh_buf,
                     float* dc_buf, unsigned int* barrier, int T, int B,
                     int H, int reverse) {
  extern __shared__ __align__(16) float smem[];
  const Smem sm = carve(smem, H);
  const int tid = threadIdx.x;
  const int nblk = gridDim.x;
  const int u0 = blockIdx.x * UNITS;
  const int G = GATES * H;
  const int Bp = pitch_of(B);
  load_w(sm.w, w_hh, H, u0);
  __syncthreads();

  // cell layout: thread -> (batch row cb of the tile, units cu, cu + 1);
  // the same thread owns those (row, unit) carries and reduces them
  const int cb = tid / (UNITS / 2);
  const int cu = (tid % (UNITS / 2)) * 2;
  // column layout (the partials and dW_hh): thread -> columns kq .. kq+3
  const int kq = tid * 4;
  float dw[4][ROWS];  // dW_hh[row][kq + c]
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int r = 0; r < ROWS; ++r) dw[c][r] = 0.0f;

  const float4* w4 = reinterpret_cast<const float4*>(sm.w);
  const float4* dg4 = reinterpret_cast<const float4*>(sm.dg);
  unsigned int arrivals = 0;

  for (int s = T - 1; s >= 0; --s) {
    const bool first = s == 0;  // h_{t-1} = c_{t-1} = 0
    const int t = reverse ? T - 1 - s : s;
    const int tp = reverse ? t + 1 : t - 1;
    const float* h_prev = hst + (size_t)(first ? 0 : tp) * H * Bp;
    const float* hs_prev = hs + (size_t)(first ? 0 : tp) * B * H;
    float* my_part = part + ((size_t)(s & 1) * nblk + blockIdx.x) * B * H;
    for (int b0 = 0; b0 < B; b0 += BT) {
      const int nb = min(BT, B - b0);
      const int b = b0 + cb;
      if (!first) product<TB, TR>(sm, h_prev, H, Bp, b0);

      // the cell: dgates to dgx[t] and dg_s (zero past the tile's end)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int uu = cu + e;
        float dg[GATES] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (b < B) {
          const size_t row = (size_t)t * B + b;
          const size_t o = row * H + u0 + uu;
          const size_t bu = (size_t)b * H + u0 + uu;
          float pre[GATES];
#pragma unroll
          for (int q = 0; q < GATES; ++q) {
            const float sum =
                first ? 0.0f : red_at(sm.red, q, e);
            pre[q] = __fadd_rn(gx[row * G + (size_t)q * H + u0 + uu], sum);
          }
          const float c_t = cs[o];
          const float c_prev =
              first ? 0.0f : cs[((size_t)tp * B + b) * H + u0 + uu];
          const float ig = sigmoid_f(pre[0]);
          const float fg = sigmoid_f(pre[1]);
          const float gg = tanhf(pre[2]);
          const float og = sigmoid_f(pre[3]);
          // the narrow build's contraction: every product rounded,
          // 1 - x^2 and dc's update one FMA each
          const float dh = __fadd_rn(dhs[o], dh_buf[bu]);
          const float tanh_c = tanhf(c_t);
          const float d_o = __fmul_rn(dh, tanh_c);
          const float dc = __fmaf_rn(__fmul_rn(dh, og),
                                     __fmaf_rn(-tanh_c, tanh_c, 1.0f),
                                     dc_buf[bu]);
          dg[0] = __fmul_rn(__fmul_rn(__fmul_rn(dc, gg), ig),
                            __fsub_rn(1.0f, ig));
          dg[1] = __fmul_rn(__fmul_rn(__fmul_rn(dc, c_prev), fg),
                            __fsub_rn(1.0f, fg));
          dg[2] = __fmul_rn(__fmul_rn(dc, ig), __fmaf_rn(-gg, gg, 1.0f));
          dg[3] = __fmul_rn(__fmul_rn(d_o, og), __fsub_rn(1.0f, og));
          dc_buf[bu] = __fmul_rn(dc, fg);
          float* dgr = dgx + row * G + u0 + uu;
#pragma unroll
          for (int q = 0; q < GATES; ++q) dgr[(size_t)q * H] = dg[q];
        }
#pragma unroll
        for (int q = 0; q < GATES; ++q)
          sm.dg[cb * ROWS + q * UNITS + uu] = dg[q];
      }
      __syncthreads();  // dg_s written, red_s (the ring) read
      if (first) continue;

      // h_{t-1} lands again, eight rows a chunk, while the partials form
      const int nbc = (nb + 7) / 8;
      for (int c = 0; c < RING && c < nbc; ++c)
        stage_rows(sm.ring, hs_prev, B, H, b0, c);
      if (kq < H) {
        // partial[b][kq + c], the block's gate rows in order
        for (int b8 = 0; b8 < nb; b8 += 8) {
          float acc[8][4];
#pragma unroll
          for (int bb = 0; bb < 8; ++bb)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[bb][c] = 0.0f;
#pragma unroll 2
          for (int q = 0; q < ROWS / 4; ++q) {
            float wv[4][4];  // [column][row 4q + j]
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const float4 v = w4[w_slot(kq + c, q)];
              wv[c][0] = v.x;
              wv[c][1] = v.y;
              wv[c][2] = v.z;
              wv[c][3] = v.w;
            }
#pragma unroll
            for (int bb = 0; bb < 8; ++bb) {
              const float4 v = dg4[(b8 + bb) * (ROWS / 4) + q];
              const float d[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
              for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int c = 0; c < 4; ++c)
                  acc[bb][c] = fmaf(d[j], wv[c][j], acc[bb][c]);
            }
          }
#pragma unroll
          for (int bb = 0; bb < 8; ++bb)
            if (b8 + bb < nb)
              *reinterpret_cast<float4*>(
                  my_part + ((size_t)(kq >> 3) * B + b0 + b8 + bb) * UNITS +
                  (kq & 7)) =
                  make_float4(acc[bb][0], acc[bb][1], acc[bb][2], acc[bb][3]);
        }
      }
      // dW_hh[row][kq + c] += dgates[b][row] * h_{t-1}[b][kq + c], b in
      // order (rows past the tile's end have zero dgates and zero h)
      for (int c = 0; c < nbc; ++c) {
        const float* buf = chunk_ready(sm.ring, c, nbc);
        if (kq < H) {
#pragma unroll 2
          for (int bb = 0; bb < 8; ++bb) {
            const float4 hv =
                *reinterpret_cast<const float4*>(buf + (size_t)bb * H + kq);
            const float hr[4] = {hv.x, hv.y, hv.z, hv.w};
            float d[ROWS];
#pragma unroll
            for (int q = 0; q < ROWS / 4; ++q) {
              const float4 v = dg4[(8 * c + bb) * (ROWS / 4) + q];
              d[4 * q + 0] = v.x;
              d[4 * q + 1] = v.y;
              d[4 * q + 2] = v.z;
              d[4 * q + 3] = v.w;
            }
#pragma unroll
            for (int cc = 0; cc < 4; ++cc)
#pragma unroll
              for (int r = 0; r < ROWS; ++r)
                dw[cc][r] = fmaf(d[r], hr[cc], dw[cc][r]);
          }
        }
        __syncthreads();  // the buffer is free
        if (c + RING < nbc) stage_rows(sm.ring, hs_prev, B, H, b0, c + RING);
      }
    }
    if (first) break;
    grid_barrier(barrier, ++arrivals * nblk);

    // dh_{t-1} for row b0 + cb, units cu and cu + 1: the partials of every
    // block through L2 in block order, four lanes a row, then shuffles
    const int q4 = tid % 4;
    const float* slot = part + (size_t)(s & 1) * nblk * B * H;
    for (int b0 = 0; b0 < B; b0 += BT) {
      const int b = b0 + cb;
      float acc[UNITS];
#pragma unroll
      for (int j = 0; j < UNITS; ++j) acc[j] = 0.0f;
      if (b < B) {
        for (int w = q4; w < nblk; w += 4) {
          const float4* src = reinterpret_cast<const float4*>(
              slot + (size_t)w * B * H +
              ((size_t)blockIdx.x * B + b) * UNITS);
          const float4 lo = __ldcg(src), hi = __ldcg(src + 1);
          acc[0] += lo.x;
          acc[1] += lo.y;
          acc[2] += lo.z;
          acc[3] += lo.w;
          acc[4] += hi.x;
          acc[5] += hi.y;
          acc[6] += hi.z;
          acc[7] += hi.w;
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1)
#pragma unroll
        for (int j = 0; j < UNITS; ++j)
          acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off);
      if (b < B) {
#pragma unroll
        for (int e = 0; e < 2; ++e)
          dh_buf[(size_t)b * H + u0 + cu + e] = acc[cu + e];
      }
    }
  }

  if (kq < H) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r)  // gate * 8 + unit
      *reinterpret_cast<float4*>(
          dw_hh + (size_t)((r / UNITS) * H + u0 + r % UNITS) * H + kq) =
          make_float4(dw[0][r], dw[1][r], dw[2][r], dw[3][r]);
  }
}

}  // namespace

extern "C" {

const char* mlvae_lstm_bwd_wide_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The launch plan for H, as mlvae_lstm_fwd_wide_plan's out[0..7].
int mlvae_lstm_bwd_wide_plan(int H, int B, int* out) {
  if (!takes(1, B, H)) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(H, true);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_bwd_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int occ = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &occ, lstm_bwd_wide_kernel, THREADS, smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, lstm_bwd_wide_kernel);
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

// gx (T,B,4H), w_hh (4H,H), hs/cs/dhs (T,B,H) f32 inputs, hs 16-byte
// aligned; dgx (T,B,4H) and dw_hh (4H,H) f32 outputs (every element
// written); part (2, H/8, H/8, B, 8) f32 scratch (slot, writing block,
// unit group, row, unit); dh_buf (B,H) zeroed and dc_buf (B,H) holding
// dc_last, both scratch; hst (T,H,Bp) f32 scratch for hs transposed, Bp =
// B rounded up to 4; barrier one zeroed counter. Two launches on the
// stream: the transpose, then the recurrence. Returns a cudaError_t.
int mlvae_lstm_bwd_wide(const float* gx, const float* w_hh, const float* hs,
                        const float* cs, const float* dhs, float* dgx,
                        float* dw_hh, float* part, float* dh_buf,
                        float* dc_buf, float* hst, unsigned int* barrier,
                        int T, int B, int H, int reverse,
                        cudaStream_t stream) {
  if (!takes(T, B, H)) return cudaErrorInvalidValue;
  const int Bp = pitch_of(B);
  transpose_hs<<<dim3((H + 31) / 32, (Bp + 31) / 32, T), dim3(32, 8), 0,
                 stream>>>(hs, hst, B, H, Bp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const float* hst_c = hst;
  void* args[] = {(void*)&gx,    (void*)&w_hh,   (void*)&hs,
                  (void*)&cs,    (void*)&dhs,    (void*)&hst_c,
                  (void*)&dgx,
                  (void*)&dw_hh, (void*)&part,   (void*)&dh_buf,
                  (void*)&dc_buf, (void*)&barrier, (void*)&T,
                  (void*)&B,     (void*)&H,      (void*)&reverse};
  return launch_cooperative(lstm_bwd_wide_kernel, H / UNITS, THREADS, args,
                            smem_bytes(H, true), stream);
}

}  // extern "C"
