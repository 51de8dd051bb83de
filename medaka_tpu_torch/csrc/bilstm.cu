// Fused bidirectional LSTM layer over pre-projected inputs, written for
// Hopper (sm_90a) and bound to Python with ctypes through a plain C
// interface.
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
// carries h and c in VMEM scratch. Here one block owns one direction and
// a tile of BT = CPT * NQ batch columns and loops over all T steps
// itself; blocks never exchange state. Thread (j, q) owns hidden unit j
// (gate rows j, H+j, 2H+j, 3H+j) for the CPT columns q*CPT .. q*CPT+CPT-1,
// so the four gate pre-activations of a unit meet in one thread, c stays
// in registers, and a step needs one __syncthreads on the double-buffered
// bf16 h in shared memory. The next step's projections are loaded into
// registers while the current step computes.
//
// W_hh is chunk-interleaved (16-byte chunk kc of row r at kc * 4H + r), so
// a warp of 32 consecutive units reads 512 contiguous bytes. At H = 128
// one direction's bf16 W_hh (131,072 B) sits in dynamic shared memory;
// where it does not fit (H = 384: 1,179,648 B) it is read through the
// read-only cache from L2 on every step (W_SMEM = false).
//
// Numerics follow the plain PyTorch version in
// medaka_tpu_torch/ops/bilstm.py operation by operation: bf16 x bf16
// products are exact in f32 and fmaf rounds only the sums; sigmoid is
// 1 / (1 + expf(-v)) and tanh is tanhf in both; __fadd_rn/__fmul_rn keep
// nvcc from contracting the gate sums and the c and h updates into FMAs
// the plain version does not do. The difference left is the order of
// the f32 sums of the recurrent product (a sequential loop here, cuBLAS
// there), which can move a bf16 rounding of h by one step.
//
// What bounds it on an H100: per layer the inputs (2 x T*B*4H bf16) and
// outputs (2 x T*B*H bf16) cross HBM once, 0.1 ms at T=1000, B=128,
// H=128; its 33.6 GFLOP of products would take 0.03 ms on the tensor
// cores. In practice the serial chain of T dependent steps and the CUDA
// core dot products bound it. Tensor-core mma/wgmma for the per-step
// product is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float sigmoid_f(float v) {
  return 1.0f / (1.0f + expf(-v));
}

__device__ __forceinline__ float dot8_bf16(uint4 w, uint4 a, float acc) {
  const __nv_bfloat162* wp = reinterpret_cast<const __nv_bfloat162*>(&w);
  const __nv_bfloat162* ap = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const float2 wf = __bfloat1622float2(wp[p]);
    const float2 af = __bfloat1622float2(ap[p]);
    // bf16 x bf16 is exact in f32, so the fma rounds only the sum
    acc = fmaf(wf.x, af.x, acc);
    acc = fmaf(wf.y, af.y, acc);
  }
  return acc;
}

__host__ __device__ __forceinline__ size_t align16(size_t v) {
  return (v + 15) & ~static_cast<size_t>(15);
}

size_t smem_bytes(bool w_smem, int BT, int H) {
  return (w_smem ? align16(static_cast<size_t>(8) * H * H) : 0) +
         align16(2 * static_cast<size_t>(BT) * H * sizeof(__nv_bfloat16));
}

// grid (ceil(B / BT), 2 directions), block H * NQ threads, BT = CPT * NQ.
template <int CPT, bool W_SMEM>
__global__ void __launch_bounds__(512)
    bilstm_kernel(const __nv_bfloat16* __restrict__ xp_f,
                  const __nv_bfloat16* __restrict__ xp_b,
                  const uint4* __restrict__ w_hh,
                  const float* __restrict__ b_hh,
                  const int* __restrict__ lengths, __nv_bfloat16* out_f,
                  __nv_bfloat16* out_b, int T, int B, int H, int NQ) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int d = blockIdx.y;
  const int BT = CPT * NQ;
  const int b0 = blockIdx.x * BT;
  const int tid = threadIdx.x;
  const int j = tid % H;
  const int c0 = (tid / H) * CPT;
  const int H4 = 4 * H;
  const int kchunks = H / 8;  // 16-byte chunks of 8 bf16 per row

  unsigned char* p = smem;
  uint4* w_s = reinterpret_cast<uint4*>(p);
  if (W_SMEM) p += align16(static_cast<size_t>(8) * H * H);
  __nv_bfloat16* act_s = reinterpret_cast<__nv_bfloat16*>(p);  // [2][BT][H]

  const uint4* w_dir = w_hh + static_cast<size_t>(d) * kchunks * H4;
  if (W_SMEM) {
    for (int i = tid; i < kchunks * H4; i += blockDim.x) w_s[i] = w_dir[i];
  }
  const uint4* wmat = W_SMEM ? w_s : w_dir;
  for (int i = tid; i < 2 * BT * H; i += blockDim.x)
    act_s[i] = __float2bfloat16_rn(0.0f);

  float bh[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) bh[g] = b_hh[d * H4 + g * H + j];
  int len[CPT];
  float h[CPT], c[CPT];
#pragma unroll
  for (int cc = 0; cc < CPT; ++cc) {
    const int b = b0 + c0 + cc;
    len[cc] = b < B ? lengths[b] : 0;
    h[cc] = 0.0f;
    c[cc] = 0.0f;
  }
  const __nv_bfloat16* xp = d == 0 ? xp_f : xp_b;
  __nv_bfloat16* out = d == 0 ? out_f : out_b;

  // this thread's projections of step tt: x_proj[tt, b, g*H + j]
  auto load_x = [&](int tt, __nv_bfloat16 (&dst)[4][CPT]) {
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) {
      const int b = b0 + c0 + cc;
      const size_t row = (static_cast<size_t>(tt) * B + b) * H4 + j;
#pragma unroll
      for (int g = 0; g < 4; ++g)
        dst[g][cc] = b < B ? xp[row + g * H] : __float2bfloat16_rn(0.0f);
    }
  };
  __nv_bfloat16 x_cur[4][CPT], x_next[4][CPT];
  load_x(d == 0 ? 0 : T - 1, x_cur);
  __syncthreads();

  for (int i = 0; i < T; ++i) {
    const int cur = i & 1;
    const int t = d == 0 ? i : T - 1 - i;
    if (i + 1 < T) load_x(d == 0 ? i + 1 : T - 2 - i, x_next);

    // recurrent product bf16(h) . W_hh^T, f32 accumulation
    float acc[4][CPT] = {};
    const uint4* act = reinterpret_cast<const uint4*>(act_s + cur * BT * H);
    for (int kc = 0; kc < kchunks; ++kc) {
      uint4 w[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        if constexpr (W_SMEM)
          w[g] = wmat[kc * H4 + g * H + j];
        else
          w[g] = __ldg(&wmat[kc * H4 + g * H + j]);
      }
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        const uint4 a = act[(c0 + cc) * kchunks + kc];
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[g][cc] = dot8_bf16(w[g], a, acc[g][cc]);
      }
    }

    __nv_bfloat16* act_n = act_s + (cur ^ 1) * BT * H;
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) {
      float gate[4];
#pragma unroll
      for (int g = 0; g < 4; ++g)
        gate[g] = __fadd_rn(__fadd_rn(acc[g][cc], bh[g]),
                            __bfloat162float(x_cur[g][cc]));
      const float gi = sigmoid_f(gate[0]);
      const float gf = sigmoid_f(gate[1]);
      const float gg = tanhf(gate[2]);
      const float go = sigmoid_f(gate[3]);
      const float cn = __fadd_rn(__fmul_rn(gf, c[cc]), __fmul_rn(gi, gg));
      const float hn = __fmul_rn(go, tanhf(cn));
      if (t < len[cc]) {
        h[cc] = hn;
        c[cc] = cn;
      }
      const __nv_bfloat16 hb = __float2bfloat16_rn(h[cc]);
      act_n[(c0 + cc) * H + j] = hb;
      const int b = b0 + c0 + cc;
      if (b < B) out[(static_cast<size_t>(t) * B + b) * H + j] = hb;
    }
    if (i + 1 < T) {
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc) x_cur[g][cc] = x_next[g][cc];
    }
    __syncthreads();
  }
}

template <int CPT, bool W_SMEM>
cudaError_t launch(const void* xp_f, const void* xp_b, const void* w_hh,
                   const float* b_hh, const int* lengths, void* out_f,
                   void* out_b, int T, int B, int H, int NQ,
                   cudaStream_t stream) {
  const int BT = CPT * NQ;
  const size_t smem = smem_bytes(W_SMEM, BT, H);
  auto kern = bilstm_kernel<CPT, W_SMEM>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((B + BT - 1) / BT, 2);
  kern<<<grid, H * NQ, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(xp_f),
      static_cast<const __nv_bfloat16*>(xp_b),
      static_cast<const uint4*>(w_hh), b_hh, lengths,
      static_cast<__nv_bfloat16*>(out_f), static_cast<__nv_bfloat16*>(out_b),
      T, B, H, NQ);
  return cudaGetLastError();
}

template <bool W_SMEM, typename... Args>
cudaError_t dispatch(int cpt, Args... args) {
  switch (cpt) {
    case 1: return launch<1, W_SMEM>(args...);
    case 2: return launch<2, W_SMEM>(args...);
    case 4: return launch<4, W_SMEM>(args...);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

size_t bilstm_smem(int w_smem, int bt, int hidden) {
  return smem_bytes(w_smem != 0, bt, hidden);
}

int bilstm_launch(const void* xp_f, const void* xp_b, const void* w_hh,
                  const float* b_hh, const int* lengths, void* out_f,
                  void* out_b, int T, int B, int H, int cpt, int nq,
                  int w_smem, void* stream) {
  if (H % 32 != 0 || H > 512 || H * nq > 512)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (w_smem)
    e = dispatch<true>(cpt, xp_f, xp_b, w_hh, b_hh, lengths, out_f, out_b, T,
                       B, H, nq, s);
  else
    e = dispatch<false>(cpt, xp_f, xp_b, w_hh, b_hh, lengths, out_f, out_b, T,
                        B, H, nq, s);
  return static_cast<int>(e);
}

const char* bilstm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
