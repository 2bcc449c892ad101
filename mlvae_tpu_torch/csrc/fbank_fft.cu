// K6, the FFT build: the log-mel filterbank on frames whose width N is even
// and whose N/2 factors into 2, 3, 4 and 5 (the recipes' Kaldi N = 512 and
// SpeechBrain N = 400), in the two modes of csrc/fbank.cu.
//
// Replaces the TPU kernel mlvae_tpu/ops/fbank_pallas.py `_fbank_kernel`
// (launched by `kaldi_fbank_pallas`) at those widths, and runs the same
// chain for the SpeechBrain extractor, which the JAX package leaves to XLA
// (mlvae_tpu/ops/fbank.py `sb_fbank_batch`). ops/fbank.py `fbank_plan`
// picks this build by N before the launch; csrc/fbank.cu, the DFT build,
// takes every other N up to 512. The chain per frame is fbank.cu's: DC
// removal and 0.97 pre-emphasis (Kaldi), the window, the power of bins 0 ..
// N/2, the mel filters over their nonzero bins, the log; only the transform
// differs:
//
//   z[n] = x[2n] + i x[2n+1], n < M = N/2    (the real frame packed)
//   Z = the M-point complex FFT of z          (mixed radix: 2, 3, 4, 5, 8)
//   X[k] = ((A + B) + W^k (-i)(A - B)) / 2,  A = Z[k mod M],
//          B = conj(Z[(M - k) mod M]), W = exp(-2 pi i / N), k = 0 .. M
//
// The FFT is Stockham's: a pass of radix R over sub-transforms of p points
// takes butterfly i < M/R (k = i mod p) from in[i + r M/R], multiplies
// point r by exp(-2 pi i r k / (p R)), forms the R-point DFT and writes
// point s to out[(i - k) R + k + s p]; the result lands in natural order.
// The passes' twiddles and the split factors W^k are computed on the host
// in float64 and rounded to f32 (ops/fbank.py `fft_tables`), and read from
// shared memory; no __sincosf, no --use_fast_math.
//
// What bounds it on an H100: bytes. At the Kaldi pass's batch (83,200
// frames) the window's 400 columns in and the 40 log-mels out are 146 MB,
// 0.044 ms at 3.35 TB/s, against about 15 k flops a frame (1.3 GFLOP,
// 0.019 ms at 67 TFLOP/s of f32). The DFT build's products over the
// window's columns (2 * 400 * 257 * 2 flops a frame) made it bound by
// operations at 0.52 ms.
//
// Design: one warp a frame, up to eight warps a block, and as many blocks
// as the SMs hold at once (fewer warps a block when the frames are few,
// so that B = 1's 160 frames spread over 80 SMs); each warp walks its
// frames in a grid-stride loop and loads its next frame into registers
// before it works on the current one. A lane loads 16 bytes of each 128
// columns of the frame (coalesced, the window's columns only: the zero
// columns past it are never read), removes the DC with a butterfly sum
// over the warp (one fixed order), takes the pre-emphasis' left neighbour
// by a shuffle, and stores its four windowed columns as two complex points
// into the warp's buffer in shared memory. The passes run between the
// warp's two buffers with a __syncwarp each; no block barrier past the
// tables' staging. At the recipes' widths the passes are fixed when the
// kernel is compiled (N = 512: 4, 4, 4, 4, whose first pass takes each
// lane's own points and so runs from registers; N = 400: 8, 5, 5); any
// other width reads its radices at run time. The split forms bins k and
// M - k from the same two points. Every sum has one fixed order and there
// are no atomics: the same bits on every launch. The roundings fbank.cu
// pins stay pinned here (__fsub_rn, __fmul_rn in the pre-emphasis and
// window, the power as re*re + im*im); logf and log10f stay precise.
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int MAX_N = 512;       // the widest frame (ops/fbank.py MAX_N)
constexpr int MAX_WARPS = 8;     // frames in flight a block, one a warp
constexpr int MAX_PASSES = 8;    // radices, four bits each, in one int
constexpr int CHUNK = 128;       // columns a warp loads at once: 32 float4
constexpr int CHUNKS = MAX_N / CHUNK;
constexpr unsigned FULL = 0xffffffffu;
constexpr float PREEMPH = 0.97f;

// the R-point DFTs' constants, f32 roundings of cos and sin
constexpr float HALF_SQRT2 = 0.70710678118654752f;   // radix 8
constexpr float SIN_2PI_3 = 0.86602540378443865f;    // radix 3
constexpr float COS_2PI_5 = 0.30901699437494742f;    // radix 5
constexpr float COS_4PI_5 = -0.80901699437494742f;
constexpr float SIN_2PI_5 = 0.95105651629515357f;
constexpr float SIN_4PI_5 = 0.58778525229247313f;

__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }

// Shared memory, in floats from the start: the block's tables, then two
// buffers a warp of M + 1 complex points each (the second buffer also
// holds the power, M + 1 floats). Every region starts 16-byte aligned.
struct Layout {
  int tw, split, win, melw, lo, len, frames, buf, per_warp, total;
};

__host__ __device__ Layout layout(int N, int n_mels, int mel_width,
                                  int warps) {
  const int M = N / 2;
  Layout s;
  s.tw = 0;                                        // (M - 1) float2
  s.split = s.tw + round4(2 * (M > 1 ? M - 1 : 0));  // (M + 1) float2
  s.win = s.split + round4(2 * (M + 1));           // N
  s.melw = s.win + round4(N);                      // n_mels * mel_width
  s.lo = s.melw + round4(n_mels * mel_width);      // n_mels int32
  s.len = s.lo + round4(n_mels);                   // n_mels int32
  s.frames = s.len + round4(n_mels);
  s.buf = round4(2 * (M + 1));
  s.per_warp = 2 * s.buf;
  s.total = s.frames + warps * s.per_warp;
  return s;
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cscale(float s, float2 a) {
  return make_float2(s * a.x, s * a.y);
}
// -i z
__device__ __forceinline__ float2 mul_mi(float2 z) {
  return make_float2(z.y, -z.x);
}

// the R-point DFT y_s = sum_r x_r exp(-2 pi i r s / R), in place
template <int R>
__device__ __forceinline__ void butterfly(float2 (&x)[R]);

template <>
__device__ __forceinline__ void butterfly<2>(float2 (&x)[2]) {
  const float2 a = x[0], b = x[1];
  x[0] = cadd(a, b);
  x[1] = csub(a, b);
}

template <>
__device__ __forceinline__ void butterfly<4>(float2 (&x)[4]) {
  const float2 a = cadd(x[0], x[2]), b = csub(x[0], x[2]);
  const float2 c = cadd(x[1], x[3]), d = mul_mi(csub(x[1], x[3]));
  x[0] = cadd(a, c);
  x[1] = cadd(b, d);
  x[2] = csub(a, c);
  x[3] = csub(b, d);
}

template <>
__device__ __forceinline__ void butterfly<8>(float2 (&x)[8]) {
  // two 4-point DFTs of the even and the odd points, joined by
  // exp(-2 pi i s / 8), s = 0 .. 3
  float2 e[4] = {x[0], x[2], x[4], x[6]};
  float2 o[4] = {x[1], x[3], x[5], x[7]};
  butterfly<4>(e);
  butterfly<4>(o);
  o[1] = make_float2(HALF_SQRT2 * (o[1].x + o[1].y),
                     HALF_SQRT2 * (o[1].y - o[1].x));
  o[2] = mul_mi(o[2]);
  o[3] = make_float2(HALF_SQRT2 * (o[3].y - o[3].x),
                     -HALF_SQRT2 * (o[3].x + o[3].y));
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    x[s] = cadd(e[s], o[s]);
    x[s + 4] = csub(e[s], o[s]);
  }
}

template <>
__device__ __forceinline__ void butterfly<3>(float2 (&x)[3]) {
  const float2 t = cadd(x[1], x[2]), u = csub(x[1], x[2]);
  const float2 m = csub(x[0], cscale(0.5f, t));
  const float2 v = mul_mi(cscale(SIN_2PI_3, u));
  x[0] = cadd(x[0], t);
  x[1] = cadd(m, v);
  x[2] = csub(m, v);
}

template <>
__device__ __forceinline__ void butterfly<5>(float2 (&x)[5]) {
  const float2 a1 = cadd(x[1], x[4]), b1 = csub(x[1], x[4]);
  const float2 a2 = cadd(x[2], x[3]), b2 = csub(x[2], x[3]);
  const float2 m1 = cadd(x[0], cadd(cscale(COS_2PI_5, a1),
                                     cscale(COS_4PI_5, a2)));
  const float2 m2 = cadd(x[0], cadd(cscale(COS_4PI_5, a1),
                                     cscale(COS_2PI_5, a2)));
  const float2 v1 = mul_mi(cadd(cscale(SIN_2PI_5, b1),
                                cscale(SIN_4PI_5, b2)));
  const float2 v2 = mul_mi(csub(cscale(SIN_4PI_5, b1),
                                cscale(SIN_2PI_5, b2)));
  x[0] = cadd(x[0], cadd(a1, a2));
  x[1] = cadd(m1, v1);
  x[4] = csub(m1, v1);
  x[2] = cadd(m2, v2);
  x[3] = csub(m2, v2);
}

// butterfly i of a Stockham pass of radix R over sub-transforms of p
// points (S = M / R butterflies); tw holds the pass's (R - 1) p twiddles,
// which are exactly 1 where p = 1
template <int R>
__device__ __forceinline__ void butterfly_at(const float2* src, float2* dst,
                                             const float2* tw, int S, int p,
                                             int i) {
  const int k = i % p;
  float2 x[R];
#pragma unroll
  for (int r = 0; r < R; ++r) x[r] = src[i + r * S];
  if (p > 1) {
#pragma unroll
    for (int r = 1; r < R; ++r) x[r] = cmul(x[r], tw[(r - 1) * p + k]);
  }
  butterfly<R>(x);
  const int j = (i - k) * R + k;
#pragma unroll
  for (int r = 0; r < R; ++r) dst[j + r * p] = x[r];
}

// one pass over M points, the warp's lanes striding over the butterflies
template <int R>
__device__ __forceinline__ void radix_pass(const float2* src, float2* dst,
                                           const float2* tw, int M, int p,
                                           int lane) {
  const int S = M / R;
  for (int i = lane; i < S; i += 32) butterfly_at<R>(src, dst, tw, S, p, i);
}

// the passes of an M-point FFT whose radices are known when it is compiled
// (the recipes' N = 512 and 400): the same passes, with p, S and the
// index arithmetic folded; src ends holding the transform
template <int M, int P, int R, int... REST>
__device__ __forceinline__ void fixed_passes(float2*& src, float2*& dst,
                                             const float2* tw, int lane) {
  constexpr int S = M / R;
#pragma unroll
  for (int i0 = 0; i0 < S; i0 += 32) {
    if (S % 32 == 0 || i0 + lane < S) {
      butterfly_at<R>(src, dst, tw, S, P, i0 + lane);
    }
  }
  __syncwarp();
  float2* t = src;
  src = dst;
  dst = t;
  if constexpr (sizeof...(REST) > 0) {
    fixed_passes<M, P * R, REST...>(src, dst, tw + (R - 1) * P, lane);
  }
}

// the power of bin k from A = Z[k mod M], bz = Z[(M - k) mod M] (B is its
// conjugate) and W^k: X = ((A + B) + W^k (-i)(A - B)) / 2, re^2 + im^2
__device__ __forceinline__ float bin_power(float2 a, float2 bz, float2 w) {
  const float2 e = make_float2(a.x + bz.x, a.y - bz.y);  // A + B
  const float2 d = make_float2(a.y + bz.y, bz.x - a.x);  // -i (A - B)
  const float2 y = cadd(e, cmul(w, d));
  const float re = 0.5f * y.x;
  const float im = 0.5f * y.y;
  return __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
}

// a lane's columns of one frame: 4 lane + 128 q .. +3 for each chunk q,
// zero from `window` on; 16-byte loads where the row allows them
__device__ __forceinline__ void load_frame(float4 (&v)[CHUNKS],
                                           const float* row, int window,
                                           bool vec, int lane) {
#pragma unroll
  for (int q = 0; q < CHUNKS; ++q) {
    const int c = q * CHUNK + 4 * lane;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (vec && c + 3 < window) {
      x = __ldg(reinterpret_cast<const float4*>(row + c));
    } else {
      if (c < window) x.x = __ldg(row + c);
      if (c + 1 < window) x.y = __ldg(row + c + 1);
      if (c + 2 < window) x.z = __ldg(row + c + 2);
      if (c + 3 < window) x.w = __ldg(row + c + 3);
    }
    v[q] = x;
  }
}

__device__ __forceinline__ float pre(float cur, float prev, float w) {
  return __fmul_rn(__fsub_rn(cur, __fmul_rn(PREEMPH, prev)), w);
}

// FIXED_M: 0 for any M (the radices read at run time), 256 for N = 512 as
// (4, 4, 4, 4) with the first pass in registers, 200 for N = 400 as
// (8, 5, 5)
template <bool KALDI, int FIXED_M>
__global__ void __launch_bounds__(32 * MAX_WARPS) fbank_fft_kernel(
    const float* __restrict__ frames,   // (rows, N)
    const float* __restrict__ win,      // (N,), zero from `window` on
    const float2* __restrict__ tw,      // (M - 1,) the passes' twiddles
    const float2* __restrict__ split,   // (M + 1,) exp(-2 pi i k / N)
    const float* __restrict__ mel_w,    // (n_mels, mel_width) packed
    const int32_t* __restrict__ mel_lo,   // (n_mels,) first bin of a filter
    const int32_t* __restrict__ mel_len,  // (n_mels,) bins it spans
    float* __restrict__ out,            // (rows, n_mels)
    int rows, int N, int window, int n_mels, int mel_width, int radices,
    int n_passes) {
  extern __shared__ __align__(16) float smem[];
  const int M = N / 2;
  const int warps = blockDim.x / 32;
  const Layout s = layout(N, n_mels, mel_width, warps);
  float2* tw_s = reinterpret_cast<float2*>(smem + s.tw);
  float2* split_s = reinterpret_cast<float2*>(smem + s.split);
  float* win_s = smem + s.win;
  float* melw_s = smem + s.melw;
  int32_t* lo_s = reinterpret_cast<int32_t*>(smem + s.lo);
  int32_t* len_s = reinterpret_cast<int32_t*>(smem + s.len);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float* buf0 = smem + s.frames + warp * s.per_warp;
  float* buf1 = buf0 + s.buf;

  for (int i = tid; i < M - 1; i += blockDim.x) tw_s[i] = tw[i];
  for (int i = tid; i <= M; i += blockDim.x) split_s[i] = split[i];
  // the window zero-extended to a whole float4
  for (int i = tid; i < round4(N); i += blockDim.x) {
    win_s[i] = i < N ? win[i] : 0.f;
  }
  for (int i = tid; i < n_mels * mel_width; i += blockDim.x) {
    melw_s[i] = mel_w[i];
  }
  for (int i = tid; i < n_mels; i += blockDim.x) {
    lo_s[i] = mel_lo[i];
    len_s[i] = mel_len[i];
  }
  __syncthreads();

  const bool vec =
      N % 4 == 0 && (reinterpret_cast<uintptr_t>(frames) & 15) == 0;
  const int nq = (N + CHUNK - 1) / CHUNK;  // chunks that hold columns < N
  const int stride = gridDim.x * warps;
  int row = blockIdx.x * warps + warp;
  float4 next[CHUNKS];
  if (row < rows) {
    load_frame(next, frames + (size_t)row * N, window, vec, lane);
  }

  for (; row < rows; row += stride) {
    float4 v[CHUNKS];
#pragma unroll
    for (int q = 0; q < CHUNKS; ++q) v[q] = next[q];
    if (row + stride < rows) {
      load_frame(next, frames + (size_t)(row + stride) * N, window, vec,
                 lane);
    }

    // DC removal and pre-emphasis (Kaldi), the window: f[q] holds columns
    // 4 lane + 128 q .. + 3, the complex points 64 q + 2 lane and + 1
    float mean = 0.f;
    if (KALDI) {
      float sum = 0.f;
#pragma unroll
      for (int q = 0; q < CHUNKS; ++q) {
        sum += v[q].x;
        sum += v[q].y;
        sum += v[q].z;
        sum += v[q].w;
      }
#pragma unroll
      for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(FULL, sum, o);
      mean = __fmul_rn(sum, 1.0f / (float)window);
    }
    float4 f[CHUNKS];
    float carry = 0.f;  // the DC-removed last column of the chunk before
#pragma unroll
    for (int q = 0; q < CHUNKS; ++q) {
      f[q] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q >= nq) continue;  // the same on every lane
      const int c = q * CHUNK + 4 * lane;
      const float4 wv = c < N ? *reinterpret_cast<const float4*>(win_s + c)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
      const float w0 = wv.x, w1 = wv.y, w2 = wv.z, w3 = wv.w;
      if (KALDI) {
        // the columns past the window stay zero, as the DFT build leaves
        // them; the window is zero there too
        const float d0 = c < window ? __fsub_rn(v[q].x, mean) : 0.f;
        const float d1 = c + 1 < window ? __fsub_rn(v[q].y, mean) : 0.f;
        const float d2 = c + 2 < window ? __fsub_rn(v[q].z, mean) : 0.f;
        const float d3 = c + 3 < window ? __fsub_rn(v[q].w, mean) : 0.f;
        const float up = __shfl_up_sync(FULL, d3, 1);
        const float top = __shfl_sync(FULL, d3, 31);
        const float prev = lane ? up : (q ? carry : d0);
        carry = top;
        f[q] = make_float4(pre(d0, prev, w0), pre(d1, d0, w1),
                           pre(d2, d1, w2), pre(d3, d2, w3));
      } else {
        f[q] = make_float4(__fmul_rn(v[q].x, w0), __fmul_rn(v[q].y, w1),
                           __fmul_rn(v[q].z, w2), __fmul_rn(v[q].w, w3));
      }
    }

    // the M-point FFT, Stockham passes between the warp's two buffers
    float2* src = reinterpret_cast<float2*>(buf0);
    float2* dst = reinterpret_cast<float2*>(buf1);
    if constexpr (FIXED_M == 256) {
      // the first pass (radix 4, p = 1, twiddles 1) takes butterflies
      // 2 lane and 2 lane + 1 from points 2 lane + 64 r and + 1: the
      // lane's own; it writes points 8 lane .. + 7 of buf1
      float2 x[4] = {make_float2(f[0].x, f[0].y), make_float2(f[1].x, f[1].y),
                     make_float2(f[2].x, f[2].y), make_float2(f[3].x, f[3].y)};
      float2 y[4] = {make_float2(f[0].z, f[0].w), make_float2(f[1].z, f[1].w),
                     make_float2(f[2].z, f[2].w), make_float2(f[3].z, f[3].w)};
      butterfly<4>(x);
      butterfly<4>(y);
      float4* out4 = reinterpret_cast<float4*>(dst + 8 * lane);
      out4[0] = make_float4(x[0].x, x[0].y, x[1].x, x[1].y);
      out4[1] = make_float4(x[2].x, x[2].y, x[3].x, x[3].y);
      out4[2] = make_float4(y[0].x, y[0].y, y[1].x, y[1].y);
      out4[3] = make_float4(y[2].x, y[2].y, y[3].x, y[3].y);
      __syncwarp();
      src = dst;
      dst = reinterpret_cast<float2*>(buf0);
      fixed_passes<256, 4, 4, 4, 4>(src, dst, tw_s + 3, lane);
    } else {
#pragma unroll
      for (int q = 0; q < CHUNKS; ++q) {
        const int zc = q * (CHUNK / 2) + 2 * lane;  // points zc, zc + 1
        if (q < nq && zc < M) {
          *reinterpret_cast<float4*>(buf0 + 2 * zc) = f[q];
        }
      }
      __syncwarp();
      if constexpr (FIXED_M == 200) {
        fixed_passes<200, 1, 8, 5, 5>(src, dst, tw_s, lane);
      } else {
        int p = 1;
        const float2* tw_p = tw_s;
        for (int pass = 0; pass < n_passes; ++pass) {
          const int R = (radices >> (4 * pass)) & 15;
          switch (R) {
            case 2: radix_pass<2>(src, dst, tw_p, M, p, lane); break;
            case 3: radix_pass<3>(src, dst, tw_p, M, p, lane); break;
            case 4: radix_pass<4>(src, dst, tw_p, M, p, lane); break;
            case 5: radix_pass<5>(src, dst, tw_p, M, p, lane); break;
            default: radix_pass<8>(src, dst, tw_p, M, p, lane); break;
          }
          __syncwarp();
          float2* t = src;
          src = dst;
          dst = t;
          tw_p += (R - 1) * p;
          p *= R;
        }
      }
    }

    // the split into bins 0 .. M and their power, into the free buffer:
    // bins k and M - k from the same two points
    float* pw = reinterpret_cast<float*>(dst);
    for (int k = lane; 2 * k <= M; k += 32) {
      const int kk = M - k;
      const float2 a = src[k];
      const float2 bz = src[kk == M ? 0 : kk];
      pw[k] = bin_power(a, bz, split_s[k]);
      if (kk != k) pw[kk] = bin_power(bz, a, split_s[kk]);
    }
    __syncwarp();

    // mel filters over their nonzero bins, then the log
    for (int m = lane; m < n_mels; m += 32) {
      const float* pp = pw + lo_s[m];
      const float* ww = melw_s + m * mel_width;
      float acc = 0.f;
      const int len = len_s[m];
#pragma unroll 4
      for (int b = 0; b < len; ++b) acc = fmaf(pp[b], ww[b], acc);
      out[(size_t)row * n_mels + m] =
          KALDI ? logf(fmaxf(acc, FLT_EPSILON))
                : 10.0f * log10f(fmaxf(acc, 1e-10f));
    }
    __syncwarp();
  }
}

using KernelFn = void (*)(const float*, const float*, const float2*,
                          const float2*, const float*, const int32_t*,
                          const int32_t*, float*, int, int, int, int, int,
                          int, int);

// the build for a mode and a frame width: 512 as (4, 4, 4, 4) and 400 as
// (8, 5, 5) have passes fixed when compiled, any other width reads them
// (read at run time, N = 512 took 8 % longer on the Kaldi pass's batch on
// an H100: PERF.md section 6)
KernelFn kernel_for(bool kaldi, int N, int radices) {
  const int fixed = N == 512 && radices == 0x4444   ? 256
                    : N == 400 && radices == 0x558 ? 200
                                                   : 0;
  if (kaldi) {
    return fixed == 256   ? fbank_fft_kernel<true, 256>
           : fixed == 200 ? fbank_fft_kernel<true, 200>
                          : fbank_fft_kernel<true, 0>;
  }
  return fixed == 256   ? fbank_fft_kernel<false, 256>
         : fixed == 200 ? fbank_fft_kernel<false, 200>
                        : fbank_fft_kernel<false, 0>;
}

// the launch: warps a block (fewer when the frames are few, so that they
// spread over the SMs), shared memory, blocks an SM holds, and blocks
struct Plan {
  int warps, blocks, blocks_per_sm;
  size_t smem;
};

cudaError_t make_plan(KernelFn kernel, int rows, int N, int n_mels,
                      int mel_width, Plan* plan) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return err;
  const int per_sm = (rows + sms - 1) / sms;
  plan->warps = per_sm < 1 ? 1 : (per_sm > MAX_WARPS ? MAX_WARPS : per_sm);
  plan->smem = sizeof(float) *
               (size_t)layout(N, n_mels, mel_width, plan->warps).total;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(plan->smem));
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &plan->blocks_per_sm, kernel, 32 * plan->warps, plan->smem);
  if (err != cudaSuccess) return err;
  if (plan->blocks_per_sm < 1) return cudaErrorInvalidConfiguration;
  const int wanted = (rows + plan->warps - 1) / plan->warps;
  const int resident = plan->blocks_per_sm * sms;
  plan->blocks = wanted < resident ? wanted : resident;
  return cudaSuccess;
}

// the radices multiply to N / 2, each one of 2, 3, 4, 5, 8
bool radices_ok(int N, int radices, int n_passes) {
  if (n_passes < 0 || n_passes > MAX_PASSES) return false;
  if (n_passes < MAX_PASSES && (radices >> (4 * n_passes)) != 0) {
    return false;
  }
  int prod = 1;
  for (int i = 0; i < n_passes; ++i) {
    const int r = (radices >> (4 * i)) & 15;
    if (r != 2 && r != 3 && r != 4 && r != 5 && r != 8) return false;
    prod *= r;
  }
  return prod == N / 2;
}

}  // namespace

extern "C" {

const char* mlvae_fbank_fft_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// kaldi != 0: the Kaldi mode, else the SpeechBrain mode. `radices` holds
// the passes' radices four bits each, the first pass lowest. Refuses (as an
// invalid value) an odd N, N above 512, radices that do not multiply to
// N/2, a window outside [1, N] and an empty launch.
int mlvae_fbank_fft(const float* frames, const float* win, const float* tw,
                    const float* split, const float* mel_w,
                    const int32_t* mel_lo, const int32_t* mel_len, float* out,
                    int rows, int N, int window, int n_mels, int mel_width,
                    int radices, int n_passes, int kaldi,
                    cudaStream_t stream) {
  if (rows <= 0 || N < 2 || N > MAX_N || N % 2 || window < 1 ||
      window > N || n_mels < 1 || mel_width < 0 ||
      !radices_ok(N, radices, n_passes)) {
    return cudaErrorInvalidValue;
  }
  const KernelFn kernel = kernel_for(kaldi != 0, N, radices);
  Plan plan;
  cudaError_t err = make_plan(kernel, rows, N, n_mels, mel_width, &plan);
  if (err != cudaSuccess) return err;
  kernel<<<plan.blocks, 32 * plan.warps, plan.smem, stream>>>(
      frames, win, reinterpret_cast<const float2*>(tw),
      reinterpret_cast<const float2*>(split), mel_w, mel_lo, mel_len, out,
      rows, N, window, n_mels, mel_width, radices, n_passes);
  return cudaGetLastError();
}

// What a launch on `rows` frames of N columns with these radices takes:
// blocks, warps a block, shared memory bytes, resident blocks an SM,
// registers and local memory bytes a thread of the build it launches (the
// Kaldi mode's where kaldi != 0), and whether that build's passes are fixed
// when compiled (1) or read at run time (0).
int mlvae_fbank_fft_plan(int rows, int N, int n_mels, int mel_width,
                         int radices, int n_passes, int kaldi, int* out) {
  if (rows <= 0 || N < 2 || N > MAX_N || N % 2 || n_mels < 1 ||
      mel_width < 0 || !radices_ok(N, radices, n_passes)) {
    return cudaErrorInvalidValue;
  }
  const KernelFn kernel = kernel_for(kaldi != 0, N, radices);
  Plan plan;
  cudaFuncAttributes attr;
  cudaError_t err = make_plan(kernel, rows, N, n_mels, mel_width, &plan);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  out[0] = plan.blocks;
  out[1] = plan.warps;
  out[2] = static_cast<int>(plan.smem);
  out[3] = plan.blocks_per_sm;
  out[4] = attr.numRegs;
  out[5] = static_cast<int>(attr.localSizeBytes);
  out[6] = kernel != kernel_for(kaldi != 0, 0, 0);
  return cudaSuccess;
}

}  // extern "C"
