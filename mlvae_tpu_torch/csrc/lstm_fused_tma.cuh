// The TMA staging and ldmatrix fragments shared by the fused kernels that
// stage their chunks with the Tensor Memory Accelerator: K3-bwd and K4-bwd
// (lstm_fused_bwd.cuh), K3/K4-fwd (lstm_fused_fwd.cu) and K7b
// (lstm_unroll_fused_fwd.cu). A chunk is 64 batch rows x 128 columns of a
// 3-D bf16 tensor (columns, rows, slices), copied as two 64-column halves
// into a 16 KB tile with the TMA's 128-byte swizzle and read by ldmatrix;
// the descriptor zero-fills rows and columns past the tensor's ends. A
// warp group is four warps, 128 threads, synced on a named barrier of its
// own.
#pragma once

#include "lstm_fused_common.cuh"
#include "mbarrier.cuh"

namespace fused {

constexpr int KCB = 128;      // columns per staged chunk
constexpr int TILE = BT * KCB;  // bf16 elements of a chunk tile (16 KB)
constexpr int GROUP = THREADS / 2;  // threads of a warp group (4 warps)

// bar.sync on named barrier `id` for the 128 threads of one warp group.
__device__ __forceinline__ void group_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(GROUP) : "memory");
}

// This lane's ldmatrix address for the A fragments (k0 = 0) of rows r0 ..
// r0 + 15 of a row-major bf16 tile of pitch ld: matrices rows 0-7 / 8-15
// at columns 0-7, then at 8-15.
__device__ __forceinline__ const bf16* a_frag_addr(const bf16* tile, int ld,
                                                   int r0) {
  const int lane = threadIdx.x & 31;
  return tile + (size_t)(r0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * ld +
         8 * (lane >> 4);
}

// Element (r, c) of a staged chunk tile: two boxes of 64 rows x 64
// columns, swizzled as the TMA writes them (swz_at, mma_tma.cuh).
__device__ __forceinline__ const bf16* tile_at(const bf16* tile, int r,
                                               int c) {
  return swz_at<BT>(tile, r, c);
}

// The pre-activations' product of one staged chunk for warp mi (0-3) of
// group W: c[ni] += the chunk's rows 16 mi .. (A) times the weight rows
// 8 ni .. (B, k = column), ni = 0, 1, 16 columns at a time in column
// order, each accumulator one chain.
__device__ __forceinline__ void pre_chunk_mma(float (&c)[2][4],
                                              const bf16* tile,
                                              const bf16* w_s, int LDW,
                                              int wcol, int width, int mi) {
  const int lane = threadIdx.x & 31;
  const int arow = 16 * mi + (lane & 7) + 8 * ((lane >> 3) & 1);
  const int acol = 8 * (lane >> 4);
  // B's matrices: weight rows 0-7 at k0, at k0 + 8, rows 8-15 at k0, at
  // k0 + 8
  const bf16* pb = w_s + (size_t)((lane & 7) + 8 * (lane >> 4)) * LDW + wcol +
                   8 * ((lane >> 3) & 1);
#pragma unroll 4
  for (int k0 = 0; k0 < width; k0 += 16) {
    uint32_t a[4], b[4];
    ldsm_x4(a, tile_at(tile, arow, acol + k0));
    ldsm_x4(b, pb + k0);
    mma16816(c[0], a[0], a[1], a[2], a[3], b[0], b[1]);
    mma16816(c[1], a[0], a[1], a[2], a[3], b[2], b[3]);
  }
}

// The timing build's ablation (MLVAE_BWD_STAGE_ROWS=r): the descriptors'
// boxes take only r of a chunk's 64 rows (none for r = 0), the rest of
// the tile stays as it was, so the step's time without (r = 0) or with
// half (r = 32) of its copies' L2 traffic can be read off the timeline.
// Its outputs are wrong by design.
#ifdef MLVAE_BWD_STAGE_ROWS
constexpr int STAGED_ROWS = MLVAE_BWD_STAGE_ROWS;
#else
constexpr int STAGED_ROWS = BT;
#endif

// Jobs 0 .. n-1 of one warp group (threads [t0, t0 + GROUP), named barrier
// `bar`; n the same in all of them), each a chunk (chunk(j)) copied by the
// TMA into tile j & 1 of `bufs` (thread t0 issues both halves and the
// tile's mbarrier full[j & 1] takes their bytes; `phase` holds each
// tile's next parity) and then consumed by work(j, tile): chunk j + 1 is in
// flight while chunk j's products run. One group barrier a chunk, and one
// before the first copy, so the tiles' earlier readers are done.
// fence_src: the source was written in this launch by plain stores (the
// exchange), which the TMA's async proxy must see.
template <class ChunkOf, class Work>
__device__ __forceinline__ void pipeline(bf16* bufs, uint64_t* full,
                                         unsigned int& phase, int n, int t0,
                                         int bar, bool fence_src,
                                         ChunkOf chunk, Work work) {
  if (n <= 0) return;
  auto stage = [&](int j) {
    if ((int)threadIdx.x != t0) return;
    const int b = j & 1;
    const Chunk c = chunk(j);
    if (fence_src) asm volatile("fence.proxy.async.global;" ::: "memory");
    mbar_expect(&full[b], 2 * HALF * STAGED_ROWS * sizeof(bf16));
    if (STAGED_ROWS > 0) {
      tma_half(bufs + (size_t)b * TILE, c, 0, &full[b]);
      tma_half(bufs + (size_t)b * TILE + BT * HALF, c, 1, &full[b]);
    }
  };
  group_sync(bar);
  stage(0);
  for (int j = 0; j < n; ++j) {
    const int b = j & 1;
    mbar_wait(&full[b], (phase >> b) & 1);
    phase ^= 1u << b;
    group_sync(bar);
    if (j + 1 < n) stage(j + 1);
    work(j, bufs + (size_t)b * TILE);
  }
}

// A TMA descriptor of the 3-D bf16 tensor `base` (cols x rows x slices,
// innermost first, dense), in boxes of 64 columns x STAGED_ROWS rows of one
// slice, 128-byte swizzled, zeros past the ends.
inline cudaError_t chunk_map(CUtensorMap* map, const void* base, int cols,
                             int rows, int slices) {
  return tensor_map(map, base, cols, cols, rows, slices,
                    STAGED_ROWS > 0 ? STAGED_ROWS : 1);
}

}  // namespace fused
