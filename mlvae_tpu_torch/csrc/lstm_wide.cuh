// What the f32 wide K1 kernels share (lstm_fwd_wide.cu, lstm_bwd_wide.cu):
// the layout of a block for 528 < H <= 1024, W_hh's rows in shared memory,
// the chunked staging of h_{t-1} and the recurrent product of one batch
// tile. The bf16-stream builds (lstm_fwd_wide_bf16.cu,
// lstm_bwd_wide_bf16.cu) have a layout of their own (lstm_wide_mma.cuh):
// their products run on the tensor cores.
//
// At H above 528 the narrow kernels' four units a block would need more
// than the H100's 132 SMs (every block of the cooperative grid resident at
// once). Here a block owns UNITS=8 hidden units, so H/8 <= 128 blocks.
// Its 32 gate rows of W_hh (row r = gate*8 + unit is W_hh's row gate*H +
// u0 + unit) sit in shared memory for the whole sequence, k-major: for each
// k, the 32 rows as eight float4s, the float4 of rows 4q .. 4q+3 at slot q ^
// ((k >> 2) & 7), so that threads reading one row group at eight
// consecutive groups of four k meet eight different banks (K1-bwd's
// partials) while the product's readers of one k share a broadcast: 128 KB
// at H=1024. h_{t-1} for a 64-row batch tile (256 KB at H=1024) does not
// fit beside them, so it comes in chunks of CHUNK=128 rows of k x 64 batch
// columns (32 KB), laid out [k][b] at a pitch of 68 floats, through a ring
// of RING=2 buffers filled by cp.async (16 bytes a copy, zeros past the
// padded row): the product of chunk c runs while chunk c+1 lands. The
// source is an (H, Bp) slab, Bp = B rounded up to 4, whose columns past B
// hold zeros: K1-fwd's h ping-pong buffer, or K1-bwd's transposed copy of
// hs.
//
// The product of a tile: thread -> (K slice, row group of TR gate rows,
// batch group of TB rows: 4 consecutive rows, or two such 32 rows apart),
// a TB x TR register tile summed over its slice of each chunk in k order,
// chunk after chunk. A shared-memory read of 16 bytes costs a warp four
// passes of the shared-memory pipe however many threads share it, so the
// tile is what sets the FMA rate: 8 x 8 (K1-fwd) reads four float4s for 64
// FMAs, the FMA rate of the card; 8 x 4 (K1-bwd, whose dW_hh holds 128
// registers a thread) three for 32. The K slices' sums go to red_s
// [ks][row][32], which reuses the ring once its last chunk is read; one
// pass adds them in slice order and lays the sums out by cell thread. The
// order of every sum is fixed, so repeated launches are bit-equal.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace wide {

constexpr int UNITS = 8;             // hidden units owned by one block
constexpr int GATES = 4;             // i, f, g, o
constexpr int ROWS = GATES * UNITS;  // gate rows owned by one block
constexpr int BT = 64;               // batch rows a tile
constexpr int THREADS = 256;
constexpr int CHUNK = 128;           // rows of k a staged chunk
constexpr int RING = 2;              // chunk buffers
constexpr int PITCH = BT + 4;        // floats a staged row of k
constexpr int MAX_H = 1024;
static_assert(THREADS == BT * UNITS / 2, "cell layout: two units a thread");
static_assert(THREADS * 4 == MAX_H, "K1-bwd's pass: four columns a thread");
// the widest product's K slices' sums fit in the ring they reuse
static_assert(8 * BT * ROWS <= RING * CHUNK * PITCH, "red_s in the ring");

__host__ __device__ inline int n_chunks(int H) {
  return (H + CHUNK - 1) / CHUNK;
}

// w_s [H][ROWS] + ring [RING][CHUNK][PITCH] (red_s [KS][BT][ROWS] reuses
// it) + dg_s [BT][ROWS] for K1-bwd, f32
inline size_t smem_bytes(int H, bool bwd) {
  return sizeof(float) * ((size_t)ROWS * H + (size_t)RING * CHUNK * PITCH +
                          (bwd ? (size_t)BT * ROWS : 0));
}

// The launch checks both wide kernels share: H a multiple of 16 (so that
// each chunk's K slices are whole rows), at most MAX_H.
inline bool takes(int T, int B, int H) {
  return H >= 16 && H % 16 == 0 && H <= MAX_H && T >= 1 && B >= 1;
}

__host__ __device__ inline int pitch_of(int B) { return (B + 3) & ~3; }

struct Smem {
  float* w;
  float* ring;
  float* red;  // the ring's own memory, between a product and the cell
  float* dg;
};

__device__ inline Smem carve(float* base, int H) {
  Smem s;
  s.w = base;
  s.ring = s.w + (size_t)ROWS * H;
  s.red = s.ring;
  s.dg = s.ring + (size_t)RING * CHUNK * PITCH;
  return s;
}

// The float4 slot of W_hh's rows 4q .. 4q+3 at column k in w_s.
__device__ __forceinline__ int w_slot(int k, int q) {
  return k * (ROWS / 4) + (q ^ ((k >> 2) & 7));
}

// this block's 32 rows of W_hh into w_s
__device__ inline void load_w(float* w_s, const float* __restrict__ w_hh,
                              int H, int u0) {
  for (int idx = threadIdx.x; idx < ROWS * H; idx += THREADS) {
    const int k = idx % H;
    const int r = idx / H;  // gate * 8 + unit
    const int gate = r / UNITS, unit = r % UNITS;
    w_s[w_slot(k, r >> 2) * 4 + (r & 3)] =
        w_hh[(size_t)(gate * H + u0 + unit) * H + k];
  }
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned int d =
      static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// until every copy group but the newest `pending` has landed
__device__ __forceinline__ void cp_wait(int pending) {
  if (pending)
    asm volatile("cp.async.wait_group 1;" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ float* ring_buf(float* ring, int c) {
  return ring + (size_t)(c % RING) * CHUNK * PITCH;
}

// Chunk c of the (H, Bp) slab h for batch columns [b0, b0 + 64) into ring
// buffer c % RING, as one copy group (by every thread). Columns past Bp
// arrive as zeros; the slab's own columns past B are zeros.
__device__ inline void stage(float* ring, const float* h, int H, int Bp,
                             int c, int b0) {
  const int k0 = c * CHUNK;
  const int kc = min(CHUNK, H - k0);
  float* buf = ring_buf(ring, c);
  for (int i = threadIdx.x; i < kc * (BT / 4); i += THREADS) {
    const int r = i / (BT / 4);
    const int j = i % (BT / 4);
    const int b = b0 + 4 * j;
    const bool ok = b < Bp;
    cp_async16(buf + r * PITCH + 4 * j,
               h + (size_t)(k0 + r) * Bp + (ok ? b : 0), ok);
  }
  cp_commit();
}

// Before chunk c of an n-chunk pass is read: its copies landed (each
// thread's own), then every thread's.
__device__ __forceinline__ const float* chunk_ready(float* ring, int c,
                                                    int n) {
  cp_wait(c + 1 < n ? 1 : 0);
  __syncthreads();
  return ring_buf(ring, c);
}

// h_{t-1} @ W_hh^T for the tile's 64 rows from b0 and this block's 32 gate
// rows, the slab h staged chunk by chunk, with TB x TR register tiles:
// the K slices' sums into red_s [ks][row][gate row]. Returns after a
// barrier: red_s is written (the ring is taken until the cell reads it).
template <int TB, int TR>
__device__ inline void product(const Smem& sm, const float* h, int H, int Bp,
                               int b0) {
  constexpr int KS = TB * TR * THREADS / (BT * ROWS);  // K slices
  constexpr int NBG = BT / TB;                          // batch groups
  constexpr int PER = THREADS / KS;                     // threads a slice
  constexpr int BSTEP = BT * 4 / TB;  // rows between a thread's row quads
  static_assert(PER == NBG * (ROWS / TR), "product layout");
  const int tid = threadIdx.x;
  const int ks = tid / PER;
  const int rq0 = (tid % PER) / NBG * (TR / 4);  // first row quad
  const int bg = tid % NBG;
  const int nc = n_chunks(H);
  const float4* w4 = reinterpret_cast<const float4*>(sm.w);
  float acc[TB][TR];
#pragma unroll
  for (int b = 0; b < TB; ++b)
#pragma unroll
    for (int r = 0; r < TR; ++r) acc[b][r] = 0.0f;
  for (int c = 0; c < RING && c < nc; ++c) stage(sm.ring, h, H, Bp, c, b0);
  for (int c = 0; c < nc; ++c) {
    const float* buf = chunk_ready(sm.ring, c, nc);
    const int part = min(CHUNK, H - c * CHUNK) / KS;
    const int kb = c * CHUNK + ks * part;  // this slice's first k
    const float* hb = buf + (size_t)ks * part * PITCH + bg * 4;
#pragma unroll 4
    for (int k = 0; k < part; ++k) {
      float hr[TB], wr[TR];
#pragma unroll
      for (int q = 0; q < TB / 4; ++q) {
        const float4 v =
            *reinterpret_cast<const float4*>(hb + k * PITCH + q * BSTEP);
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
      for (int b = 0; b < TB; ++b)
#pragma unroll
        for (int r = 0; r < TR; ++r) acc[b][r] = fmaf(hr[b], wr[r], acc[b][r]);
    }
    __syncthreads();  // the buffer is free
    if (c + RING < nc) stage(sm.ring, h, H, Bp, c + RING, b0);
  }
  // every chunk is read: the K slices' sums take the ring as [ks][row][r]
#pragma unroll
  for (int b = 0; b < TB; ++b)
#pragma unroll
    for (int q = 0; q < TR / 4; ++q)
      *reinterpret_cast<float4*>(
          sm.red + ((size_t)ks * BT + bg * 4 + (b & 3) + (b >> 2) * BSTEP) *
                       ROWS + (rq0 + q) * 4) =
          make_float4(acc[b][4 * q], acc[b][4 * q + 1], acc[b][4 * q + 2],
                      acc[b][4 * q + 3]);
  __syncthreads();
  // one pass adds the slices in order, 16 bytes a read along [row][r], and
  // puts each sum where its cell thread reads it without bank conflicts
  constexpr int SLICE4 = BT * ROWS / 4;  // float4s of a slice
  float4 sum[SLICE4 / THREADS];
#pragma unroll
  for (int i = 0; i < SLICE4 / THREADS; ++i) {
    sum[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      const float4 v = reinterpret_cast<const float4*>(
          sm.red)[k * SLICE4 + tid + i * THREADS];
      sum[i].x = __fadd_rn(sum[i].x, v.x);
      sum[i].y = __fadd_rn(sum[i].y, v.y);
      sum[i].z = __fadd_rn(sum[i].z, v.z);
      sum[i].w = __fadd_rn(sum[i].w, v.w);
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < SLICE4 / THREADS; ++i) {
    const int e = 4 * (tid + i * THREADS);
    const float v[4] = {sum[i].x, sum[i].y, sum[i].z, sum[i].w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int b = e / ROWS, r = e % ROWS + j;
      sm.red[((r / UNITS) * 2 + (r & 1)) * THREADS + b * (UNITS / 2) +
             (r % UNITS) / 2] = v[j];
    }
  }
  __syncthreads();
}

// The recurrent part of the cell thread's pre-activation of gate q for its
// unit cu + e (cell layout: thread = row * 4 + cu / 2), after product().
__device__ __forceinline__ float red_at(const float* red, int q, int e) {
  return red[(2 * q + e) * THREADS + threadIdx.x];
}

}  // namespace wide
