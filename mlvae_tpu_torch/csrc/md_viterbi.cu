// K2: the MD-Viterbi decode in one launch (forward lattice, then the
// backtrace), bit-exact.
//
// Replaces the TPU kernels mlvae_tpu/ops/decode_pallas.py `_fwd_kernel`
// (K2-lattice) and `_bwd_kernel` (K2-backtrace), both launched by
// `md_viterbi_batch_pallas`. The semantics are those of
// mlvae_tpu/ops/decode.md_viterbi_batch:
//
//   e[t,l,k]  = log_p_yx[b,t,y[b,l],k] - log_p_y[y[b,l],k]
//   hold      = (dp[l,k] + lpb[t,0]) + e
//   sw        = (lpb[t,1] + w*lpi[t,k]) + e
//   from_c    = dp[l-1,0] + sw,  from_i = dp[l-1,1] + sw  (NEG_INF at l=0)
//   path      = hold>=fc && hold>=fi ? 0 : (fc>=fi ? 1 : 2)  (first max wins)
//
// with steps t >= t_len masked (path 0, dp kept) and beta0 = 1 when the two
// end states tie. The weight is folded into lpi by the wrapper, as the TPU
// wrapper does, and this file is compiled with -fmad=false so that no
// a*b + c is contracted into an FMA: every sum rounds exactly as in the
// plain version, in the association order written above. The int8 choices
// (B, T, L, 2) and beta0 are outputs, as the TPU lattice kernel's are.
//
// What bounds it on an H100: neither bytes (~0.5 MB needed at B=64, T=160,
// N=14, L=8: under a microsecond at 3.35 TB/s) nor operations (about a
// million adds and compares). The lattice is a chain of T dependent steps
// and the backtrace a chain of T dependent loads: latency bounds both, so
// the design keeps everything but shuffles, adds and compares off the
// chain and leaves no block barrier and no global load on it.
//
// Design: one warp a batch row, a block each. Lane l holds slots l, l + 32,
// ... of the (L, 2) carry in registers (SLOTS a lane, a template); dp[l-1]
// comes by __shfl_up_sync, and lane 0 takes lane 31's value of the slot
// before: no barrier on the chain. The emissions log_p_yx[b, t, y[l], :]
// (log_p_y is subtracted in registers), log p(b) and the weighted log pi
// of a chunk of steps are gathered by cp.async into one half of a ring in
// shared memory while the warp works on the chunk before, so a step's
// chain is shuffles, adds and compares. Where the whole (T, L, 2) of
// choices fits in CHOICE_BYTES of shared memory they are recorded there,
// copied out in 16-byte stores, and lane 0 walks the backtrace from them;
// otherwise they go straight to global memory and lane 0 reads them back
// from there (L2). The choice is made by shape before the launch
// (`make_plan`, mirrored by ops/decode.py `viterbi_plan`).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_L = 512;               // 16 slots a lane: at 32 the
                                         // carry no longer fits in registers
constexpr int RING_FLOATS = 4096;        // one half of the ring: 16 KB
constexpr int MAX_CHUNK = 32;            // steps a half holds at most
constexpr int CHOICE_BYTES = 64 * 1024;  // choices kept in shared memory

struct Plan {
  int slots;   // carry slots a lane: ceil(L / 32) rounded up to a power of 2
  int chunk;   // steps a half of the ring holds
  int shared;  // the choices kept in shared memory
  int smem;    // bytes: the ring, y, the walk's bits, the choices if kept
};

// 32-bit words of one bit a step, rounded up to a whole 16 bytes
__host__ __device__ inline int words(int T) { return (T + 127) / 128 * 4; }

__host__ __device__ inline Plan make_plan(int T, int L) {
  Plan p;
  const int need = (L + 31) / 32;
  p.slots = 1;
  while (p.slots < need) p.slots *= 2;
  const int step = 2 * L + 4;  // floats a step: L (e0, e1), lpb, lpi
  p.chunk = RING_FLOATS / step < MAX_CHUNK ? RING_FLOATS / step : MAX_CHUNK;
  const long long choices = 2LL * T * L;
  p.shared = choices <= CHOICE_BYTES;
  p.smem = 4 * (2 * p.chunk * step + (L + 3) / 4 * 4 + 2 * words(T)) +
           (p.shared ? static_cast<int>((choices + 15) / 16 * 16) : 0);
  return p;
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// chunk c of the steps 1 .. t_end - 1 (chunk steps from 1 + c * chunk)
// into half c & 1 of the ring: the gathered (e0, e1) pairs [step][slot],
// then lpb [step], then lpi [step]; one commit group a lane
__device__ __forceinline__ void stage_chunk(
    float* ring, const float* yx_b, const float* lpb_b, const float* lpi_b,
    const int32_t* y_s, int c, int chunk, int step, int t_end, int N, int L,
    int lane) {
  float* half = ring + (c & 1) * chunk * step;
  const int t0 = 1 + c * chunk;
  const int ns = min(chunk, t_end - t0);
  for (int i = lane; i < ns * L; i += 32) {
    const int s = i / L;
    const int l = i - s * L;
    cp_async8(half + 2 * i, yx_b + ((size_t)(t0 + s) * N + y_s[l]) * 2);
  }
  float* side = half + 2 * chunk * L;
  for (int i = lane; i < ns; i += 32) {
    cp_async8(side + 2 * i, lpb_b + (size_t)(t0 + i) * 2);
    cp_async8(side + 2 * (chunk + i), lpi_b + (size_t)(t0 + i) * 2);
  }
  cp_async_commit();
}

// lane 0's walk from step T - 1, slot last_l and state `start` back to
// step 1 over the choices `ch` (the row's; in shared memory, or in global
// memory read through L2): one bit a step of the boundaries (bnd_bits, bit
// t) and of the frame-level MD states (md_bits, bit t - 1), flushed to
// shared memory a 32-bit word at a time, and the phone-level states where
// a boundary is crossed. The walk's MD state is its beta: a boundary sets
// both to the choice less one, a hold keeps both.
template <bool SHARED>
__device__ __forceinline__ void walk(const int8_t* ch, int T, int L,
                                     int last_l, int start,
                                     uint32_t* bnd_bits, uint32_t* md_bits,
                                     int32_t* plvl_b) {
  int l = last_l;
  int beta = start;
  uint32_t bw = 0, mw = 0;
  // bit T - 1 of md_bits is 0 here; its word is written below unless it
  // starts at T - 1
  if (((T - 1) & 31) == 0) md_bits[(T - 1) >> 5] = 0;
  int row = (T - 1) * L * 2;
  for (int t = T - 1; t >= 1; --t, row -= 2 * L) {
    // a slot outside [0, L) reads as "hold", as the TPU kernel's one-hot
    // gather does; a decodable input (T >= L) never leaves the range
    int p = 0;
    if (static_cast<unsigned>(l) < static_cast<unsigned>(L)) {
      const int at = row + 2 * l + beta;
      p = SHARED ? ch[at] : __ldcg(ch + at);
    }
    beta = p ? p - 1 : beta;
    l -= p != 0;
    if (p && static_cast<unsigned>(l) < static_cast<unsigned>(L)) {
      plvl_b[l] = beta;
    }
    bw |= static_cast<uint32_t>(p != 0) << (t & 31);
    if ((t & 31) == 0) {
      bnd_bits[t >> 5] = bw;
      bw = 0;
    }
    const int u = t - 1;
    mw |= static_cast<uint32_t>(beta) << (u & 31);
    if ((u & 31) == 0) {
      md_bits[u >> 5] = mw;
      mw = 0;
    }
  }
  bnd_bits[0] = bw | 1u;  // step 0 is a boundary
}

// SHARED: the choices kept in shared memory (the plan's `shared`)
template <int SLOTS, bool SHARED>
__global__ void __launch_bounds__(32) md_viterbi_kernel(
    const float* __restrict__ log_p_yx,  // (B, T, N, 2)
    const float* __restrict__ log_p_y,   // (N, 2)
    const int32_t* __restrict__ y,       // (B, L)
    const float* __restrict__ log_p_b,   // (B, T, 2)
    const float* __restrict__ lpi_w,     // (B, T, 2), weight folded in
    const int32_t* __restrict__ t_lens,  // (B,)
    const int32_t* __restrict__ l_lens,  // (B,)
    int8_t* __restrict__ paths,          // (B, T, L, 2)
    int32_t* __restrict__ beta0,         // (B,)
    int32_t* __restrict__ boundary,      // (B, T)
    int32_t* __restrict__ flvl,          // (B, T)
    int32_t* __restrict__ plvl,          // (B, L)
    int T, int N, int L) {
  extern __shared__ __align__(16) float smem[];
  const Plan plan = make_plan(T, L);
  const int step = 2 * L + 4;
  const int chunk = plan.chunk;
  float* ring = smem;  // two halves of chunk * step floats
  int32_t* y_s = reinterpret_cast<int32_t*>(ring + 2 * chunk * step);
  uint32_t* bnd_bits = reinterpret_cast<uint32_t*>(y_s + (L + 3) / 4 * 4);
  uint32_t* md_bits = bnd_bits + words(T);
  int8_t* ch_s = reinterpret_cast<int8_t*>(md_bits + words(T));
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const float* yx_b = log_p_yx + (size_t)b * T * N * 2;
  const float* lpb_b = log_p_b + (size_t)b * T * 2;
  const float* lpi_b = lpi_w + (size_t)b * T * 2;
  int8_t* path_b = paths + (size_t)b * T * L * 2;
  const int t_len = t_lens[b];
  const int last_l = l_lens[b] - 1;
  // steps 1 .. t_end - 1 update the carry; the rest hold
  const int t_end = t_len < 1 ? 1 : (t_len > T ? T : t_len);
  const int used = (L + 31) / 32;  // slots that hold a phoneme somewhere

  for (int l = lane; l < L; l += 32) y_s[l] = y[(size_t)b * L + l];
  // step 0's choices and the masked steps' are "hold" (0)
  if (SHARED) {
    int4* z = reinterpret_cast<int4*>(ch_s);
    for (int i = lane; i < (2 * T * L + 15) / 16; i += 32) {
      z[i] = make_int4(0, 0, 0, 0);
    }
  } else {
    for (int i = lane; i < 2 * L; i += 32) path_b[i] = 0;
    for (size_t i = (size_t)t_end * L * 2 + lane; i < (size_t)T * L * 2;
         i += 32) {
      path_b[i] = 0;
    }
  }
  __syncwarp();

  // the carry at t = 0, and each slot's log p(y)
  float lpy0[SLOTS], lpy1[SLOTS], dp0[SLOTS], dp1[SLOTS];
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    const int l = lane + 32 * j;
    lpy0[j] = 0.f;
    lpy1[j] = 0.f;
    dp0[j] = NEG_INF;
    dp1[j] = NEG_INF;
    if (l < L) {
      const int n = y_s[l];
      lpy0[j] = log_p_y[n * 2];
      lpy1[j] = log_p_y[n * 2 + 1];
      if (l == 0) {
        dp0[j] = lpi_b[0] + (yx_b[n * 2] - lpy0[j]);
        dp1[j] = lpi_b[1] + (yx_b[n * 2 + 1] - lpy1[j]);
      }
    }
  }

  const int n_chunks = (t_end - 1 + chunk - 1) / chunk;
  if (n_chunks > 0) {
    stage_chunk(ring, yx_b, lpb_b, lpi_b, y_s, 0, chunk, step, t_end, N, L,
                lane);
  }
  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) {
      stage_chunk(ring, yx_b, lpb_b, lpi_b, y_s, c + 1, chunk, step, t_end,
                  N, L, lane);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const float2* e_s =
        reinterpret_cast<const float2*>(ring + (c & 1) * chunk * step);
    const float2* side = e_s + chunk * L;
    const int t0 = 1 + c * chunk;
    const int ns = min(chunk, t_end - t0);
    // each step's inputs are read from the ring one step ahead, before the
    // step's choices are stored, so that no load waits on the chain. Every
    // lane runs every step, with no branch around the chain: a slot past L
    // reads slot L - 1's inputs, and its carry, never read by a slot below
    // L, goes unused; only the choices' stores are predicated. The chunk's
    // last step reads its own inputs again as the next step's, unused: a
    // read past the chunk could leave the ring.
    float2 x_next[SLOTS];
    float2 pb_next = side[0];
    float2 pi_next = side[chunk];
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) x_next[j] = e_s[min(lane + 32 * j, L - 1)];
    for (int s = 0; s < ns; ++s) {
      const int row = (t0 + s) * L;  // the step's choices, in char2
      const float2 pb = pb_next;
      const float2 pi = pi_next;
      float2 x[SLOTS];
#pragma unroll
      for (int j = 0; j < SLOTS; ++j) x[j] = x_next[j];
      const int sn = s + 1 < ns ? s + 1 : s;
      pb_next = side[sn];
      pi_next = side[chunk + sn];
#pragma unroll
      for (int j = 0; j < SLOTS; ++j) {
        x_next[j] = e_s[sn * L + min(lane + 32 * j, L - 1)];
      }
      // dp[l-1] before this step: lane - 1's slot j, or for lane 0 lane
      // 31's slot j - 1 (NEG_INF for slot 0)
      float top0 = NEG_INF, top1 = NEG_INF;
#pragma unroll
      for (int j = 0; j < SLOTS; ++j) {
        if (j < used) {  // the same on every lane
          const float up0 = __shfl_up_sync(FULL, dp0[j], 1);
          const float up1 = __shfl_up_sync(FULL, dp1[j], 1);
          const float prev0 = lane ? up0 : top0;
          const float prev1 = lane ? up1 : top1;
          top0 = __shfl_sync(FULL, dp0[j], 31);
          top1 = __shfl_sync(FULL, dp1[j], 31);
          const float e0 = x[j].x - lpy0[j];
          const float e1 = x[j].y - lpy1[j];
          const float hold0 = (dp0[j] + pb.x) + e0;
          const float sw0 = (pb.y + pi.x) + e0;
          const float fc0 = prev0 + sw0;
          const float fi0 = prev1 + sw0;
          const float hold1 = (dp1[j] + pb.x) + e1;
          const float sw1 = (pb.y + pi.y) + e1;
          const float fc1 = prev0 + sw1;
          const float fi1 = prev1 + sw1;
          dp0[j] = fmaxf(hold0, fmaxf(fc0, fi0));
          dp1[j] = fmaxf(hold1, fmaxf(fc1, fi1));
          const signed char c0 =
              (hold0 >= fc0 && hold0 >= fi0) ? 0 : (fc0 >= fi0 ? 1 : 2);
          const signed char c1 =
              (hold1 >= fc1 && hold1 >= fi1) ? 0 : (fc1 >= fi1 ? 1 : 2);
          const int l = lane + 32 * j;
          if (l < L) {
            const char2 c = make_char2(c0, c1);
            if (SHARED) {
              reinterpret_cast<char2*>(ch_s)[row + l] = c;
            } else {
              reinterpret_cast<char2*>(path_b)[(size_t)row + l] = c;
            }
          }
        }
      }
    }
    __syncwarp();  // the half is read before the next stage refills it
  }

  // beta0 from the end states of slot l_len - 1: each slot's verdict as a
  // bit, so that no slot is picked by a run-time index (which would put
  // the carry in local memory)
  const int src_l = last_l < 0 ? 0 : (last_l >= L ? L - 1 : last_l);
  unsigned ends = 0;
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) ends |= (dp0[j] > dp1[j] ? 0u : 1u) << j;
  const int start =
      (__shfl_sync(FULL, ends, src_l & 31) >> (src_l >> 5)) & 1;

  int32_t* plvl_b = plvl + (size_t)b * L;
  for (int i = lane; i < L; i += 32) plvl_b[i] = i == last_l ? start : 0;
  __syncwarp();  // every choice recorded, plvl set before the walk
  if (SHARED) {
    const int total = 2 * T * L;
    if (total % 16 == 0) {
      const int4* s4 = reinterpret_cast<const int4*>(ch_s);
      int4* g4 = reinterpret_cast<int4*>(path_b);
      for (int i = lane; i < total / 16; i += 32) g4[i] = s4[i];
    } else {
      for (int i = lane; i < total; i += 32) path_b[i] = ch_s[i];
    }
  }

  if (lane == 0) {
    beta0[b] = start;
    if (SHARED) {
      walk<true>(ch_s, T, L, last_l, start, bnd_bits, md_bits, plvl_b);
    } else {
      walk<false>(path_b, T, L, last_l, start, bnd_bits, md_bits, plvl_b);
    }
    // the last valid step's frame-level state is `start`
    const int last_t = t_len - 1;
    if (last_t >= 0 && last_t < T) {
      const uint32_t bit = 1u << (last_t & 31);
      md_bits[last_t >> 5] =
          (md_bits[last_t >> 5] & ~bit) | (start ? bit : 0u);
    }
  }
  __syncwarp();
  int32_t* bnd_b = boundary + (size_t)b * T;
  int32_t* flvl_b = flvl + (size_t)b * T;
  for (int i = lane; i < T; i += 32) {
    bnd_b[i] = (bnd_bits[i >> 5] >> (i & 31)) & 1;
    flvl_b[i] = (md_bits[i >> 5] >> (i & 31)) & 1;
  }
}

using KernelFn = void (*)(const float*, const float*, const int32_t*,
                          const float*, const float*, const int32_t*,
                          const int32_t*, int8_t*, int32_t*, int32_t*,
                          int32_t*, int32_t*, int, int, int);

template <bool SHARED>
KernelFn kernel_for(int slots) {
  switch (slots) {
    case 1: return md_viterbi_kernel<1, SHARED>;
    case 2: return md_viterbi_kernel<2, SHARED>;
    case 4: return md_viterbi_kernel<4, SHARED>;
    case 8: return md_viterbi_kernel<8, SHARED>;
    default: return md_viterbi_kernel<16, SHARED>;
  }
}

KernelFn kernel_for(const Plan& plan) {
  return plan.shared ? kernel_for<true>(plan.slots)
                     : kernel_for<false>(plan.slots);
}

}  // namespace

extern "C" {

const char* mlvae_md_viterbi_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The decode of B rows, one launch: the choices (B, T, L, 2) int8, beta0
// (B,), boundary and flvl (B, T), plvl (B, L), int32. The float inputs must
// be 8-byte aligned (cp.async). Refuses (as an invalid value) an empty
// batch, T, N or L < 1 and L above 512.
int mlvae_md_viterbi(const float* log_p_yx, const float* log_p_y,
                     const int32_t* y, const float* log_p_b,
                     const float* lpi_w, const int32_t* t_lens,
                     const int32_t* l_lens, int8_t* paths, int32_t* beta0,
                     int32_t* boundary, int32_t* flvl, int32_t* plvl, int B,
                     int T, int N, int L, cudaStream_t stream) {
  if (B < 1 || T < 1 || N < 1 || L < 1 || L > MAX_L) {
    return cudaErrorInvalidValue;
  }
  const Plan plan = make_plan(T, L);
  const KernelFn kernel = kernel_for(plan);
  if (plan.smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<B, 32, plan.smem, stream>>>(log_p_yx, log_p_y, y, log_p_b, lpi_w,
                                       t_lens, l_lens, paths, beta0, boundary,
                                       flvl, plvl, T, N, L);
  return cudaGetLastError();
}

// What a launch at T, L takes: slots a lane, steps a half of the ring,
// whether the choices stay in shared memory, shared memory bytes, and the
// build's registers and local memory bytes a thread.
int mlvae_md_viterbi_plan(int T, int L, int* out) {
  if (T < 1 || L < 1 || L > MAX_L) return cudaErrorInvalidValue;
  const Plan plan = make_plan(T, L);
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel_for(plan));
  if (err != cudaSuccess) return err;
  out[0] = plan.slots;
  out[1] = plan.chunk;
  out[2] = plan.shared;
  out[3] = plan.smem;
  out[4] = attr.numRegs;
  out[5] = static_cast<int>(attr.localSizeBytes);
  return cudaSuccess;
}

}  // extern "C"
