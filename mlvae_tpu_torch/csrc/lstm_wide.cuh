// What the f32 wide K1 kernels share (lstm_fwd_wide.cu, lstm_bwd_wide.cu):
// the layout of a block for 528 < H <= 1024, W_hh's rows in shared memory,
// and the split-K sums of the recurrent product laid out for the cell. The
// bf16-stream builds (lstm_fwd_wide_bf16.cu, lstm_bwd_wide_bf16.cu) have a
// layout of their own (lstm_wide_mma.cuh): their products run on the
// tensor cores.
//
// At H above 528 the narrow kernels' four units a block would need more
// than the H100's 132 SMs (every block of the cooperative grid resident at
// once). Here a block owns UNITS=8 hidden units, so H/8 <= 128 blocks.
// Its 32 gate rows of W_hh (row r = gate*8 + unit is W_hh's row gate*H +
// u0 + unit) sit in shared memory for the whole sequence, k-major: for each
// k, the 32 rows as eight float4s, the float4 of rows 4q .. 4q+3 at slot q ^
// ((k >> 2) & 7), so that threads reading one row group at eight
// consecutive groups of four k meet eight different banks (K1-bwd's
// partials take their W_hh columns from here) while the products' readers
// of one k share a broadcast: 128 KB at H=1024. h_{t-1} for a 64-row batch
// tile (256 KB at H=1024) does not fit beside them, so each kernel stages
// it by the TMA, box by box, through rings of its own (see each source).
//
// The products split K into slices, each summed by its own threads in k
// order over its part of every 128-row chunk of k, chunk after chunk (K1-fwd
// eight slices of 16 rows a chunk, K1-bwd's recompute four of 32). Each
// slice's sums land in its own ring once its boxes are read ("red", laid
// out [gate][unit][batch row] at pitches RED_GATE and RED_UNIT), and the
// cell thread of (row, unit) adds the slices in order from slice 0. The
// pitches put the 32 lanes of a warp on 32 banks both for the writers and
// for the cell's readers. The order of every sum is fixed, so repeated
// launches are bit-equal.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace wide {

constexpr int UNITS = 8;             // hidden units owned by one block
constexpr int GATES = 4;             // i, f, g, o
constexpr int ROWS = GATES * UNITS;  // gate rows owned by one block
constexpr int BT = 64;               // batch rows a tile
constexpr int THREADS = 256;
constexpr int CHUNK = 128;           // rows of k whose slices a product sums
constexpr int MAX_H = 1024;
// a slice's sums: [gate][unit][64 rows], a unit's rows 68 floats apart and
// a gate's 552 (both 16-byte multiples; 4 and 8 banks apart)
constexpr int RED_UNIT = BT + 4;
constexpr int RED_GATE = UNITS * RED_UNIT + 8;
constexpr int RED_SLICE = GATES * RED_GATE;  // floats
static_assert(THREADS == BT * UNITS / 2, "cell layout: two units a thread");
static_assert(THREADS * 4 == MAX_H, "K1-bwd's pass: four columns a thread");

__host__ __device__ inline int n_chunks(int H) {
  return (H + CHUNK - 1) / CHUNK;
}

// The launch checks both wide kernels share: H a multiple of 16 (so that
// each chunk's K slices are whole rows and 16-byte aligned), at most MAX_H.
inline bool takes(int T, int B, int H) {
  return H >= 16 && H % 16 == 0 && H <= MAX_H && T >= 1 && B >= 1;
}

__host__ __device__ inline int pitch_of(int B) { return (B + 3) & ~3; }

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

// Offset of (gate q, unit u, tile row b) in a slice's sums.
__device__ __forceinline__ int red_at(int q, int u, int b) {
  return q * RED_GATE + u * RED_UNIT + b;
}

// The recurrent part of the pre-activation of gate q, unit u, tile row b:
// the NKS slices' sums (slice ks at red + ks * region) added in slice
// order from 0.
template <int NKS>
__device__ __forceinline__ float slice_sum(const float* red, int region,
                                           int q, int u, int b) {
  float sum = 0.0f;
#pragma unroll
  for (int ks = 0; ks < NKS; ++ks)
    sum = __fadd_rn(sum, red[(size_t)ks * region + red_at(q, u, b)]);
  return sum;
}

// The k rows a K slice sums in chunk c: `part` rows from `kb`.
__device__ __forceinline__ int slice_part(int H, int c, int nks) {
  return min(CHUNK, H - c * CHUNK) / nks;
}

}  // namespace wide
