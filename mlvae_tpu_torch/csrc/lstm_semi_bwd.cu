// K4-bwd: backpropagation through the half-fused LSTM recurrence, bf16
// streams; emits dgx and dW_hh.
//
// Replaces the TPU kernel mlvae_tpu/ops/lstm_pallas.py `_bwd_semi_kernel`
// (launched by `_run_bwd_semi`), the tier the JAX package takes where the
// fully fused kernel's f32 dW_ih would not fit its budget: the decoder's
// In=1024 layers. It is K1-bwd (lstm_bwd.cu) with the gate recompute
// reading x_t @ W_ih^T + bias instead of a gx residual; dgx (T,B,4H) leaves
// in bf16 and dX, dW_ih and db are formed from it outside
// (ops/lstm.semi_input_grads), as the JAX package forms them in XLA. The
// walk and the design are in lstm_fused_bwd.cuh (SEMI = true): dgx[t]
// itself is the exchange from which every block forms its units'
// dh_{t-1}, and dW_hh is owned per block.
//
// What bounds it on an H100: at B=64, H=512, T=160 and In=1024 the
// recompute is 2*B*4H*(In+H)*T = 64.4 GFLOP and dh_{t-1} with dW_hh
// 2*2*B*4H*H*T = 42.9 GFLOP, 107.4 GFLOP in all (0.11 ms at 989 TFLOP/s of
// bf16 tensor cores), against x, dgx, hs, dhs, cs and the weights, about
// 115 MB (34 us at 3.35 TB/s): the floor is the operations. Shared memory
// holds 167.1 KB at B=64, of which the 16 rows of [W_ih | W_hh] are 48 KB
// and the four chunk tiles 64 KB.
#include "lstm_fused_bwd.cuh"

using namespace fused;

extern "C" {

const char* mlvae_lstm_semi_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// As mlvae_lstm_fused_bwd, but dgx (T,B,4H) bf16 and dw_hh (4H,H) f32 are
// the outputs, and there is no dgbuf. The timing build is
// mlvae_lstm_semi_bwd_timeline, as mlvae_lstm_fused_bwd_timeline.
#ifdef MLVAE_BWD_TIMELINE
int mlvae_lstm_semi_bwd_timeline(
#else
int mlvae_lstm_semi_bwd(
#endif
    const bf16* x, const bf16* w_ih, const float* bias, const bf16* w_hh,
    const bf16* hs, const float* cs, const bf16* dhs, bf16* dgx,
    float* dw_hh, float* dh_buf, float* dc_buf, unsigned int* barrier, int T,
    int B, int In, int H, int reverse BWD_TIMELINE_ARG,
    cudaStream_t stream) {
  return launch_bwd<true>(x, w_ih, bias, w_hh, hs, cs, dhs, dgx, nullptr,
                          nullptr, dw_hh, nullptr, dh_buf, dc_buf, barrier, T,
                          B, In, H, reverse,
#ifdef MLVAE_BWD_TIMELINE
                          timeline,
#endif
                          stream);
}

}  // extern "C"
