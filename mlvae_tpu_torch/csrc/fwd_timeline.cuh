// The step timeline of the LSTM forward recurrences (K1-fwd in lstm_fwd.cu,
// K3/K4-fwd in lstm_fused_fwd.cu), compiled in only with
// -DMLVAE_FWD_TIMELINE (the timing builds of tools/bench_fwd_timeline.py).
//
// A lead thread reads %globaltimer at the phase boundaries of its own
// chain of work and adds each interval to its phase's sum; at the end of
// each step it writes timeline[s][block][k] (int64 ns):
//   k = 0 the step's start, 1 its end (after the grid barrier's wait),
//   2 input (the x_t product on the chain), 3 stage (waiting for h_{t-1}
//   to land in shared memory), 4 product (the recurrent product), 5 cell
//   (pre-activations to the cell update and its stores), 6 barrier (from
//   the arrival to the end of the wait), summed over the step's batch
//   tiles by thread 0, and 7 the input product formed off the chain (by
//   the lead of the warps that form it), 0 where the design has none.
// Without the define every macro is empty and the kernels take no
// timeline argument.
#pragma once

#ifdef MLVAE_FWD_TIMELINE
constexpr int FWD_SLOTS = 8;
enum FwdPhase { FWD_INPUT = 2, FWD_STAGE, FWD_PRODUCT, FWD_CELL, FWD_BARRIER,
                FWD_OFFCHAIN };

__device__ __forceinline__ unsigned long long fwd_now() {
  unsigned long long ns;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
  return ns;
}

// The lead thread's clock: its last mark and the phases' sums of a step.
struct FwdClock {
  unsigned long long start, last, sum[FWD_SLOTS];
  __device__ __forceinline__ void begin() {
    start = last = fwd_now();
#pragma unroll
    for (int k = 0; k < FWD_SLOTS; ++k) sum[k] = 0;
  }
  __device__ __forceinline__ void mark(int k) {
    const unsigned long long now = fwd_now();
    sum[k] += now - last;
    last = now;
  }
};

#define FWD_TIMELINE_ARG , unsigned long long* timeline
#define FWD_CLOCK FwdClock fwd_clock_
#define FWD_BEGIN_BY(lead)                          \
  do {                                              \
    if (threadIdx.x == (lead)) fwd_clock_.begin();  \
  } while (0)
#define FWD_MARK_BY(k, lead)                        \
  do {                                              \
    if (threadIdx.x == (lead)) fwd_clock_.mark(k);  \
  } while (0)
// thread 0 writes the step's start, end and slots 2-6; `lead` slot 7
#define FWD_STORE(s, lead)                                                \
  do {                                                                    \
    unsigned long long* row_ =                                            \
        timeline + ((size_t)(s) * gridDim.x + blockIdx.x) * FWD_SLOTS;    \
    if (threadIdx.x == 0) {                                               \
      row_[0] = fwd_clock_.start;                                         \
      row_[1] = fwd_now();                                                \
      for (int k_ = FWD_INPUT; k_ < FWD_OFFCHAIN; ++k_)                   \
        row_[k_] = fwd_clock_.sum[k_];                                    \
    }                                                                     \
    if (threadIdx.x == (lead)) row_[FWD_OFFCHAIN] =                       \
        fwd_clock_.sum[FWD_OFFCHAIN];                                     \
  } while (0)
#else
#define FWD_TIMELINE_ARG
#define FWD_CLOCK
#define FWD_BEGIN_BY(lead) \
  do {                     \
  } while (0)
#define FWD_MARK_BY(k, lead) \
  do {                       \
  } while (0)
#define FWD_STORE(s, lead) \
  do {                     \
  } while (0)
#endif
#define FWD_BEGIN() FWD_BEGIN_BY(0)
#define FWD_MARK(k) FWD_MARK_BY(k, 0)
