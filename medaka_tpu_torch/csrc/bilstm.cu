// Fused bidirectional LSTM layer over pre-projected inputs (read-level
// inference), written for Hopper (sm_90a: thread-block clusters,
// distributed shared memory, mma.sync on the tensor cores) and bound to
// Python with ctypes through a plain C interface.
//
// bilstm_fused  replaces medaka_tpu/ops/pallas_gru.py _bilstm_kernel
//               (called by bilstm_pallas).
//
// What it computes, per direction and step (gate order i, f, g, o):
//   gates = f32(bf16(h) . W_hh_bf16^T) + b_hh + f32(x_proj[t])
//   c' = sigmoid(f) c + sigmoid(i) tanh(g);  h' = sigmoid(o) tanh(c')
// h and c are f32 and frozen where t >= length; out[t] = bf16(h). The
// backward direction walks from T-1 down, so a row's padded tail writes
// the zero state. Both directions run in one launch.
//
// Design. The TPU kernel walks time blocks on a sequential grid and
// carries h and c in VMEM scratch. Here the launch is lstm_fwd.cuh's
// cluster forward (lstm_fwd_kernel, shared with lstm_train.cu's lstm_fwd)
// with both directions' clusters in one grid and no cell-state output: a
// cluster of C blocks owns one direction and a tile of BT batch columns,
// each block keeps its units' bf16 W_hh rows in shared memory (at H = 128
// all 4 x 128 x 136 x 2 = 139,264 B fit one block, so C may be 1) and
// runs the step's product on the tensor cores; the h slices travel by
// st.async into the blocks' shared memory. ops/bilstm.py chooses C and BT
// on the host.
//
// Numerics follow the plain PyTorch version in
// medaka_tpu_torch/ops/bilstm.py operation by operation (lstm_fwd.cuh):
// what differs is the order of the f32 sums of the recurrent product (the
// tensor cores' chain over 16-element chunks here, cuBLAS there), which
// can move a bf16 rounding of h by one step.
//
// What bounds it on an H100: per layer the inputs (2 x T*B*4H bf16) and
// outputs (2 x T*B*H bf16) cross HBM once, 0.1 ms at T=1000, B=128,
// H=128; its 33.6 GFLOP of products would take 0.03 ms on the tensor
// cores. The serial chain of T dependent steps binds it: the time of one
// step (the product's mma chain, the gates, the h exchange).
#include "lstm_fwd.cuh"

extern "C" {

size_t bilstm_smem(int C, int BT, int H) {
  return lstm_fwd_smem_bytes(LstmGeo(H, C, BT));
}

// clusters of C blocks of the LSTM forward that can be resident at once
// at (C, BT, H); a negative value is minus a cudaError_t
int bilstm_max_clusters(int C, int BT, int H) {
  return lstm_fwd_max_clusters(C, BT, H);
}

// both directions: xp_f, xp_b (T, B, 4H) bf16, w_sl (2, C, 4U, Hp) bf16
// slices (ops/lstm_train.py w_slices of each direction), b_hh (2, 4H) f32,
// out_f, out_b (T, B, H) bf16
int bilstm_launch(const void* xp_f, const void* xp_b, const void* w_sl,
                  const float* b_hh, const int* lengths, void* out_f,
                  void* out_b, int T, int B, int H, int C, int BT,
                  void* stream) {
  const bf16* const x[2] = {static_cast<const bf16*>(xp_f),
                            static_cast<const bf16*>(xp_b)};
  bf16* const o[2] = {static_cast<bf16*>(out_f), static_cast<bf16*>(out_b)};
  float* const c[2] = {nullptr, nullptr};
  return static_cast<int>(launch_lstm_fwd(x, w_sl, b_hh, lengths, o, c, T, B,
                                          H, C, BT, 2, 0,
                                          static_cast<cudaStream_t>(stream)));
}

const char* bilstm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
