// K6: the log-mel filterbank on frames, in two compile-time modes.
//
// Replaces the TPU kernel mlvae_tpu/ops/fbank_pallas.py `_fbank_kernel`
// (launched by `kaldi_fbank_pallas`), and runs the same chain for the
// SpeechBrain extractor, which the JAX package leaves to XLA
// (mlvae_tpu/ops/fbank.py `sb_fbank_batch`). Per frame of N columns:
//
//   Kaldi (N = 512, the first `window` = 400 columns hold the frame):
//     f -= mean(f[:window]) on the valid columns       (DC removal)
//     f[j] -= 0.97 * f[j-1], f[0] -= 0.97 * f[0]       (pre-emphasis)
//     f *= symmetric Hamming (zero from `window` on)   (so the padded
//                                                       column 400, which
//                                                       pre-emphasis makes
//                                                       -0.97 f[399], is 0)
//     re, im = the N-point DFT, bins 0 .. N/2
//     out = log(max(mel(re^2 + im^2), FLT_EPSILON))
//   SpeechBrain (N = n_fft = 400, no DC removal, no pre-emphasis):
//     f *= periodic Hamming; DFT; power; mel;
//     out = 10 * log10(max(mel, 1e-10))
//
// The framing gather, the mask of frames past each utterance's count and
// SpeechBrain's top_db clamp stay torch ops around the kernel, as the
// gather stays XLA around the TPU kernel.
//
// What bounds it on an H100: as a DFT, operations. At the Kaldi pass's
// batch (83,200 frames) the two products over the window's 400 columns are
// 2*400*257*2 flops a frame, 34 GFLOP in all, 0.51 ms at 67 TFLOP/s of f32
// (the TPU kernel counts all 512 columns: 0.68 ms), against 146 MB of the
// window's columns and the output (0.044 ms). An FFT would need about
// 2.5 N log2 N flops a frame and leave the bytes to bound it. The products
// stay in full f32 on the CUDA cores: TF32 moves the log-mels by about
// 1e-3, past the 1e-4 golden gate.
//
// Design: one block of round_up(N/2+1, 32) threads per 32 frames, two
// blocks an SM. The frames' `window` columns are loaded transposed into
// shared memory and pre-processed there; the columns past the window are
// zero after it and are neither loaded nor summed. The DFT is a product of
// the (32, window) frame tile with the (window, bins) cos and -sin
// matrices, whose entries take only N distinct values,
// cos/sin(2*pi*((j*k) mod N)/N): an N-entry twiddle table in shared memory
// takes the place of the two matrices (1 MB at N=512), and each step of 16
// j stages its (16, bins) slices from the table. Each thread sums 4 frames
// by 8 bins (re and im: 64 f32 accumulators), reading one float4 of frames
// and four of twiddles for 64 FMAs. The power goes to shared memory over
// the frame tile, and each (frame, mel) output sums only its filter's
// nonzero bins, whose weights the wrapper packs. Every sum has one fixed
// order and there are no atomics: the same bits on every launch. Build
// without --use_fast_math: logf and log10f stay precise.
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 32;            // frames per block
constexpr int TM = 4;               // frames per thread
constexpr int TN = 8;               // bins per thread
constexpr int BK = 16;              // DFT rows (j) staged per step
constexpr int A_STRIDE = ROWS + 4;  // frame tile [j][frame], padded
constexpr int CHUNKS = 8;           // column chunks of the pre-emphasis walk
constexpr int MAX_N = 512;
constexpr int MAX_THREADS = 288;    // round_up(512/2 + 1, 32)

// the Kaldi mode's 288 threads fit two blocks an SM only at <= 112
// registers; the SpeechBrain mode's 224 fit two as the compiler likes
template <bool KALDI>
__global__ void __launch_bounds__(MAX_THREADS, KALDI ? 2 : 1) fbank_kernel(
    const float* __restrict__ frames,  // (rows, N)
    const float* __restrict__ win,     // (N,), zero from `window` on
    const float* __restrict__ cos_t,   // (N,)  cos(2 pi m / N)
    const float* __restrict__ sin_t,   // (N,) -sin(2 pi m / N)
    const float* __restrict__ mel_w,   // (n_mels, mel_width) packed weights
    const int32_t* __restrict__ mel_lo,   // (n_mels,) first bin of a filter
    const int32_t* __restrict__ mel_len,  // (n_mels,) bins it spans
    float* __restrict__ out,           // (rows, n_mels)
    int rows, int N, int window, int n_bins, int n_mels, int mel_width) {
  extern __shared__ __align__(16) float smem[];
  const int nb_pad = blockDim.x;  // bins padded to a multiple of 32
  float* a_s = smem;                               // window * A_STRIDE
  float* bc_s = a_s + (size_t)window * A_STRIDE;   // BK * nb_pad
  float* bs_s = bc_s + BK * nb_pad;                // BK * nb_pad
  float* twc_s = bs_s + BK * nb_pad;               // N
  float* tws_s = twc_s + N;                        // N
  float* win_s = tws_s + N;                        // N
  float* mean_s = win_s + N;                       // ROWS
  float* part_s = mean_s + ROWS;                   // CHUNKS * ROWS
  float* prev_s = part_s + CHUNKS * ROWS;          // CHUNKS * ROWS
  float* melw_s = prev_s + CHUNKS * ROWS;          // n_mels * mel_width
  int32_t* lo_s = reinterpret_cast<int32_t*>(melw_s + n_mels * mel_width);
  int32_t* len_s = lo_s + n_mels;
  float* p_s = a_s;  // the power (ROWS, nb_pad), over the frame tile

  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const size_t row0 = (size_t)blockIdx.x * ROWS;

  for (int i = tid; i < N; i += nthr) {
    twc_s[i] = cos_t[i];
    tws_s[i] = sin_t[i];
    win_s[i] = win[i];
  }
  for (int i = tid; i < n_mels * mel_width; i += nthr) melw_s[i] = mel_w[i];
  for (int i = tid; i < n_mels; i += nthr) {
    lo_s[i] = mel_lo[i];
    len_s[i] = mel_len[i];
  }
  // the frame tile's first `window` columns, transposed (the rest are
  // zero and, the window being zero there, add nothing to any sum); frames
  // past `rows` read as zeros
  for (int i = tid; i < ROWS * window; i += nthr) {
    const int r = i / window;
    const int j = i - r * window;
    const size_t row = row0 + r;
    a_s[j * A_STRIDE + r] = row < (size_t)rows ? frames[row * N + j] : 0.f;
  }
  __syncthreads();

  if (KALDI) {
    // DC removal and pre-emphasis, one task per (chunk of columns, frame);
    // each task's raw value left of its chunk is kept before any write
    const int clen = (window + CHUNKS - 1) / CHUNKS;
    for (int t = tid; t < CHUNKS * ROWS; t += nthr) {
      const int r = t % ROWS;
      const int j0 = (t / ROWS) * clen;
      const int j1 = min(j0 + clen, window);
      float s = 0.f;
      for (int j = j0; j < j1; ++j) s += a_s[j * A_STRIDE + r];
      part_s[t] = s;
      prev_s[t] = j0 < window ? a_s[max(j0 - 1, 0) * A_STRIDE + r] : 0.f;
    }
    __syncthreads();
    if (tid < ROWS) {
      float s = 0.f;
      for (int c = 0; c < CHUNKS; ++c) s += part_s[c * ROWS + tid];
      mean_s[tid] = __fmul_rn(s, 1.0f / (float)window);
    }
    __syncthreads();
    for (int t = tid; t < CHUNKS * ROWS; t += nthr) {
      const int r = t % ROWS;
      const int j0 = (t / ROWS) * clen;
      const int j1 = min(j0 + clen, window);
      const float m = mean_s[r];
      float prev = __fsub_rn(prev_s[t], m);
      for (int j = j0; j < j1; ++j) {
        const float cur = __fsub_rn(a_s[j * A_STRIDE + r], m);
        a_s[j * A_STRIDE + r] =
            __fmul_rn(__fsub_rn(cur, __fmul_rn(0.97f, prev)), win_s[j]);
        prev = cur;
      }
    }
  } else {
    for (int i = tid; i < ROWS * N; i += nthr) {
      const int j = i / ROWS;
      a_s[j * A_STRIDE + (i % ROWS)] =
          __fmul_rn(a_s[j * A_STRIDE + (i % ROWS)], win_s[j]);
    }
  }
  __syncthreads();

  // the DFT: thread (rg, bg) owns frames 4rg..4rg+3 and bins 8bg..8bg+7
  const int lane = tid & 31;
  const int rg = lane & 7;
  const int bg = (tid >> 5) * 4 + (lane >> 3);
  float re[TM][TN], im[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int s = 0; s < TN; ++s) {
      re[i][s] = 0.f;
      im[i][s] = 0.f;
    }
  }
  for (int j0 = 0; j0 < window; j0 += BK) {
    // stage the cos and -sin rows j0 .. j0+BK-1 for every bin (k = tid):
    // m = j k mod N, stepped by k (k < N: one subtraction wraps it)
    int m = (j0 * tid) % N;
    for (int jj = 0; jj < BK; ++jj) {
      float cv = 0.f, sv = 0.f;
      if (j0 + jj < window && tid < n_bins) {
        cv = twc_s[m];
        sv = tws_s[m];
      }
      bc_s[jj * nb_pad + tid] = cv;
      bs_s[jj * nb_pad + tid] = sv;
      m += tid;
      if (m >= N) m -= N;
    }
    __syncthreads();
    const int jn = min(BK, window - j0);
#pragma unroll 2
    for (int jj = 0; jj < jn; ++jj) {
      const float4 a = *reinterpret_cast<const float4*>(
          &a_s[(j0 + jj) * A_STRIDE + 4 * rg]);
      const float4* cp =
          reinterpret_cast<const float4*>(&bc_s[jj * nb_pad + TN * bg]);
      const float4* sp =
          reinterpret_cast<const float4*>(&bs_s[jj * nb_pad + TN * bg]);
      const float4 c0 = cp[0], c1 = cp[1], s0 = sp[0], s1 = sp[1];
      const float av[TM] = {a.x, a.y, a.z, a.w};
      const float cv[TN] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
      const float sv[TN] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int s = 0; s < TN; ++s) {
          re[i][s] = fmaf(av[i], cv[s], re[i][s]);
          im[i][s] = fmaf(av[i], sv[s], im[i][s]);
        }
      }
    }
    __syncthreads();
  }

  // power, as the plain version rounds it: re*re + im*im
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int s = 0; s < TN; ++s) {
      p_s[(4 * rg + i) * nb_pad + TN * bg + s] = __fadd_rn(
          __fmul_rn(re[i][s], re[i][s]), __fmul_rn(im[i][s], im[i][s]));
    }
  }
  __syncthreads();

  // mel filters over their nonzero bins, then the log
  for (int i = tid; i < ROWS * n_mels; i += nthr) {
    const int r = i / n_mels;
    const int m = i - r * n_mels;
    const size_t row = row0 + r;
    if (row >= (size_t)rows) continue;
    const float* p = p_s + r * nb_pad + lo_s[m];
    const float* w = melw_s + m * mel_width;
    float acc = 0.f;
    for (int b = 0; b < len_s[m]; ++b) acc = fmaf(p[b], w[b], acc);
    out[row * n_mels + m] = KALDI ? logf(fmaxf(acc, FLT_EPSILON))
                                  : 10.0f * log10f(fmaxf(acc, 1e-10f));
  }
}

size_t smem_bytes(int N, int window, int nb_pad, int n_mels,
                  int mel_width) {
  return sizeof(float) * ((size_t)window * A_STRIDE + 2 * BK * nb_pad + 3 * N +
                          ROWS + 2 * CHUNKS * ROWS + n_mels * mel_width) +
         sizeof(int32_t) * 2 * n_mels;
}

template <bool KALDI>
cudaError_t launch(const float* frames, const float* win, const float* cos_t,
                   const float* sin_t, const float* mel_w,
                   const int32_t* mel_lo, const int32_t* mel_len, float* out,
                   int rows, int N, int window, int n_mels, int mel_width,
                   cudaStream_t stream) {
  const int n_bins = N / 2 + 1;
  const int nb_pad = (n_bins + 31) / 32 * 32;
  const size_t smem = smem_bytes(N, window, nb_pad, n_mels, mel_width);
  cudaError_t err = cudaFuncSetAttribute(
      fbank_kernel<KALDI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int blocks = (rows + ROWS - 1) / ROWS;
  fbank_kernel<KALDI><<<blocks, nb_pad, smem, stream>>>(
      frames, win, cos_t, sin_t, mel_w, mel_lo, mel_len, out, rows, N, window,
      n_bins, n_mels, mel_width);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* mlvae_fbank_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// kaldi != 0: the Kaldi mode, else the SpeechBrain mode. Refuses (as an
// invalid value) a frame wider than 512 or narrower than its padded bin
// count (the twiddle index steps by k < N), a window outside [1, N], a
// power tile that does not fit over the frame tile, and an empty launch.
int mlvae_fbank(const float* frames, const float* win, const float* cos_t,
                const float* sin_t, const float* mel_w, const int32_t* mel_lo,
                const int32_t* mel_len, float* out, int rows, int N,
                int window, int n_mels, int mel_width, int kaldi,
                cudaStream_t stream) {
  const int nb_pad = (N / 2 + 1 + 31) / 32 * 32;
  if (rows <= 0 || N < nb_pad || N > MAX_N || window < 1 || window > N ||
      n_mels < 1 || mel_width < 0 || ROWS * nb_pad > window * A_STRIDE ||
      nb_pad > MAX_THREADS) {
    return cudaErrorInvalidValue;
  }
  return kaldi ? launch<true>(frames, win, cos_t, sin_t, mel_w, mel_lo,
                              mel_len, out, rows, N, window, n_mels,
                              mel_width, stream)
               : launch<false>(frames, win, cos_t, sin_t, mel_w, mel_lo,
                               mel_len, out, rows, N, window, n_mels,
                               mel_width, stream);
}

}  // extern "C"
