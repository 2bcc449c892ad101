// K3-bwd: backpropagation through the fully fused LSTM recurrence, bf16
// streams; dX, dW_ih, db and dW_hh all formed here.
//
// Replaces the TPU kernel mlvae_tpu/ops/lstm_pallas.py `_bwd_fused_kernel`
// (launched by `_run_bwd_fused`). The walk, the rounding points and the
// design are in lstm_fused_bwd.cuh (SEMI = false): gates recomputed from x
// and the saved hs, dX[t] = dgates @ W_ih and dh_{t-1} = dgates @ W_hh
// from an exchange of the step's bf16 dgates through L2, dW_ih and dW_hh
// owned per block in shared memory (no atomics), db from the f32 dgates;
// every product on the tensor cores.
//
// What bounds it on an H100: at B=64, H=512, T=160 and In=512 there are
// five products per step over the widened input: the recompute
// (2*B*4H*(In+H)), dX with dh_{t-1} (the same count) and dW (the same
// again), 128.8 GFLOP (0.13 ms at 989 TFLOP/s of bf16 tensor cores),
// against x, dX, hs, dhs, cs and the weights and their grads, about
// 76 MB (23 us at 3.35 TB/s): the floor is the operations. What keeps this
// kernel far from it: the T dependent steps, each ending in a grid barrier
// and an exchange that every block reads whole (B x 4H bf16, 256 KB at
// B=64) from L2, x_t and h_{t-1} staged twice a step (for the recompute,
// then for dW), and one block per SM with 16 gate rows of work, which
// leaves the tensor cores idle most of each step. The schedule runs the
// recompute and dW on warps 4-7 while warps 0-3 wait at the split barrier
// and run the exchange, so that the chains of dependent products overlap,
// and stages every chunk with the TMA behind the products of the one
// before it. Shared memory holds 199.2 KB at In=512, H=512, B=64.
#include "lstm_fused_bwd.cuh"

using namespace fused;

extern "C" {

const char* mlvae_lstm_fused_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (T,B,In), w_ih (4H,In), w_hh (4H,H), hs and dhs (T,B,H) bf16; bias
// (4H) and cs (T,B,H) f32. Outputs, every element written: dx (T,B,In)
// bf16, dw_ih (4H,In), db (4H) and dw_hh (4H,H) f32. Scratch: dgbuf
// (2,B,4H) bf16, dh_buf (B,H) zeroed, dc_buf (B,H) holding dc_last,
// barrier one zeroed counter. In a multiple of 8 and at most 4H, H of 16.
// Returns a cudaError_t. The timing build (MLVAE_BWD_TIMELINE) is
// mlvae_lstm_fused_bwd_timeline, which also takes the (T, H/4, 6) u64
// timeline before the stream.
#ifdef MLVAE_BWD_TIMELINE
int mlvae_lstm_fused_bwd_timeline(
#else
int mlvae_lstm_fused_bwd(
#endif
    const bf16* x, const bf16* w_ih, const float* bias, const bf16* w_hh,
    const bf16* hs, const float* cs, const bf16* dhs, bf16* dx, float* dw_ih,
    float* db, float* dw_hh, bf16* dgbuf, float* dh_buf, float* dc_buf,
    unsigned int* barrier, int T, int B, int In, int H,
    int reverse BWD_TIMELINE_ARG, cudaStream_t stream) {
  return launch_bwd<false>(x, w_ih, bias, w_hh, hs, cs, dhs, dx, dw_ih, db,
                           dw_hh, dgbuf, dh_buf, dc_buf, barrier, T, B, In,
                           H, reverse,
#ifdef MLVAE_BWD_TIMELINE
                           timeline,
#endif
                           stream);
}

}  // extern "C"
