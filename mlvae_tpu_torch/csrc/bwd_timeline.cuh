// The step timeline of the K1 backward recurrences (lstm_bwd.cu,
// lstm_bwd_wide_bf16.cu), compiled in only with -DMLVAE_K1_BWD_TIMELINE
// (the timing builds of tools/bench_bwd_timeline.py).
//
// Thread 0 reads %globaltimer at the boundaries of its phases, adds each
// interval to its phase's sum and at the end of each step writes
// timeline[s][block][k] (int64 ns): k = 0 the step's start, 1 its end,
// then the sums of 2 stage (waiting for its slice of h_{t-1}), 3 recompute
// (the pre-activations), 4 cell (the dgates and their stores), 6 wait (in
// the grid barrier), 8 barrier (from the arrival to the end of the wait,
// whatever ran between) and 9 loads (the next step's cell inputs). Slots 5
// and 7 are the exchange's two halves, named by each source. Without the
// define every macro is empty and the kernels take no timeline argument.
#pragma once

#ifdef MLVAE_K1_BWD_TIMELINE
constexpr int TL_SLOTS = 10;
enum TlPhase { TL_STAGE = 2, TL_RECOMPUTE = 3, TL_CELL = 4, TL_WAIT = 6,
               TL_BARRIER = 8, TL_LOADS = 9 };

__device__ __forceinline__ unsigned long long tl_now() {
  unsigned long long ns;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
  return ns;
}

struct TlClock {
  unsigned long long start, last, arrived, sum[TL_SLOTS];
  __device__ __forceinline__ void begin() {
    start = last = tl_now();
#pragma unroll
    for (int k = 0; k < TL_SLOTS; ++k) sum[k] = 0;
  }
  __device__ __forceinline__ void mark(int k) {
    const unsigned long long now = tl_now();
    sum[k] += now - last;
    last = now;
  }
};

#define TL_ARG , unsigned long long* timeline
#define TL_CLOCK TlClock tl_clock_
#define TL_BEGIN()                               \
  do {                                           \
    if (threadIdx.x == 0) tl_clock_.begin();     \
  } while (0)
#define TL_MARK(k)                               \
  do {                                           \
    if (threadIdx.x == 0) tl_clock_.mark(k);     \
  } while (0)
#define TL_ARRIVED()                                           \
  do {                                                         \
    if (threadIdx.x == 0) tl_clock_.arrived = tl_clock_.last;  \
  } while (0)
#define TL_WAITED()                                            \
  do {                                                         \
    if (threadIdx.x == 0)                                      \
      tl_clock_.sum[TL_BARRIER] += tl_clock_.last - tl_clock_.arrived; \
  } while (0)
#define TL_STORE(s)                                                       \
  do {                                                                    \
    if (threadIdx.x == 0) {                                               \
      unsigned long long* row_ =                                          \
          timeline + ((size_t)(s) * gridDim.x + blockIdx.x) * TL_SLOTS;   \
      row_[0] = tl_clock_.start;                                          \
      row_[1] = tl_now();                                                 \
      for (int k_ = TL_STAGE; k_ < TL_SLOTS; ++k_)                        \
        row_[k_] = tl_clock_.sum[k_];                                     \
    }                                                                     \
  } while (0)
#else
#define TL_ARG
#define TL_CLOCK
#define TL_BEGIN() \
  do {             \
  } while (0)
#define TL_MARK(k) \
  do {             \
  } while (0)
#define TL_ARRIVED() \
  do {               \
  } while (0)
#define TL_WAITED() \
  do {              \
  } while (0)
#define TL_STORE(s) \
  do {              \
  } while (0)
#endif
