// Split-path 2-layer bidirectional GRU + linear head, written for Hopper
// (sm_90a) and bound to Python with ctypes through a plain C interface.
//
// gru_l1_split      replaces medaka_tpu/ops/pallas_gru.py
//                   _bigru_l1_split_t_kernel (mode "t") and
//                   _bigru_l1_split_kernel (mode "rows").
// gru_l2head_split  replaces medaka_tpu/ops/pallas_gru.py
//                   _bigru_l2head_t_kernel (mode "t") and
//                   _bigru_l2head_kernel (mode "rows").
//
// Design. The TPU kernels walk time on a sequential grid and carry h in
// VMEM scratch. Here one block owns one direction and a tile of BT batch
// columns and loops over all T steps itself; blocks never exchange state.
// Thread (j, q) owns hidden unit j (gate rows j, H+j, 2H+j) for the CPT
// columns q*CPT .. q*CPT+CPT-1 of the tile, so the three gate
// pre-activations of a unit meet in one thread and a step needs a single
// __syncthreads (h is double-buffered in shared memory).
//
// Numerics follow the TPU kernels operation by operation: int8 x int8 ->
// int32 (__dp4a) recurrences and layer-2 projections with the same
// per-row scales, round-half-even (__float2int_rn) for round(127 h),
// bf16 roundings (__float2bfloat16_rn) where the TPU kernels cast, and
// __fmul_rn/__fadd_rn where a fused multiply-add would round differently
// from the plain PyTorch version in medaka_tpu_torch/ops/gru_split.py.
//
// What bounds it on an H100: a step is a (3H x K) x (K x BT) product per
// block with K = H (layer 1) or 3H (layer 2), so the kernels are bound by
// the int8 dot-product rate of the CUDA cores and by the serial chain of
// T dependent steps, not by device memory (each byte of input and output
// crosses HBM once). The int8 W_hh (3H*H = 196,608 bytes at H = 256) lives
// in dynamic shared memory; the bf16 W_hh of quant=False and the layer-2
// W_ih stream from L2. Tensor-core mma/wgmma and batching steps are later
// work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MODE_T = 0;
constexpr int MODE_ROWS = 1;
constexpr int CMAX = 8;  // largest head width the l2 kernel holds in registers

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float sigmoid_f(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// One GRU update of one hidden unit of one column (gate order r, z, n).
template <bool QUANT, int MODE>
__device__ __forceinline__ float gru_update(float h, float xr, float xz,
                                            float xn, float hr, float hz,
                                            float hn) {
  float r, z, n;
  if (QUANT && MODE == MODE_T) {
    // bf16 tanh-form gates of _gru_cell_t: every op rounded to bf16
    const float rin = bf16r(__fadd_rn(xr, hr));
    const float zin = bf16r(__fadd_rn(xz, hz));
    r = bf16r(0.5f * bf16r(1.0f + bf16r(tanhf(bf16r(rin * 0.5f)))));
    z = bf16r(0.5f * bf16r(1.0f + bf16r(tanhf(bf16r(zin * 0.5f)))));
    n = bf16r(tanhf(bf16r(__fadd_rn(xn, __fmul_rn(r, hn)))));
  } else {
    r = sigmoid_f(__fadd_rn(xr, hr));
    z = sigmoid_f(__fadd_rn(xz, hz));
    n = tanhf(__fadd_rn(xn, __fmul_rn(r, hn)));
  }
  return __fadd_rn(__fmul_rn(__fsub_rn(1.0f, z), n), __fmul_rn(z, h));
}

// acc[g][cc] += W[g*H + j, k-range] . act[c0 + cc, k-range] for 16-byte
// chunks. W is chunk-interleaved: chunk kc of row r at w[kc * H3 + r], so a
// warp (32 consecutive j) reads 512 contiguous bytes. act rows are
// act_stride chunks apart; every lane of a warp reads the same act chunk.
template <int CPT>
__device__ __forceinline__ void dot_int8(const int4* __restrict__ w, int H3,
                                         int H, int j,
                                         const int4* __restrict__ act,
                                         int act_stride, int c0, int nchunks,
                                         int (&acc)[3][CPT]) {
  for (int kc = 0; kc < nchunks; ++kc) {
    const int4 w0 = w[kc * H3 + j];
    const int4 w1 = w[kc * H3 + H + j];
    const int4 w2 = w[kc * H3 + 2 * H + j];
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) {
      const int4 a = act[(c0 + cc) * act_stride + kc];
      acc[0][cc] = __dp4a(w0.x, a.x, acc[0][cc]);
      acc[0][cc] = __dp4a(w0.y, a.y, acc[0][cc]);
      acc[0][cc] = __dp4a(w0.z, a.z, acc[0][cc]);
      acc[0][cc] = __dp4a(w0.w, a.w, acc[0][cc]);
      acc[1][cc] = __dp4a(w1.x, a.x, acc[1][cc]);
      acc[1][cc] = __dp4a(w1.y, a.y, acc[1][cc]);
      acc[1][cc] = __dp4a(w1.z, a.z, acc[1][cc]);
      acc[1][cc] = __dp4a(w1.w, a.w, acc[1][cc]);
      acc[2][cc] = __dp4a(w2.x, a.x, acc[2][cc]);
      acc[2][cc] = __dp4a(w2.y, a.y, acc[2][cc]);
      acc[2][cc] = __dp4a(w2.z, a.z, acc[2][cc]);
      acc[2][cc] = __dp4a(w2.w, a.w, acc[2][cc]);
    }
  }
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

// bf16 counterpart of dot_int8 (8 values a chunk, f32 accumulation).
template <int CPT>
__device__ __forceinline__ void dot_bf16(const uint4* __restrict__ w, int H3,
                                         int H, int j,
                                         const uint4* __restrict__ act,
                                         int act_stride, int c0, int nchunks,
                                         float (&acc)[3][CPT]) {
  for (int kc = 0; kc < nchunks; ++kc) {
    const uint4 w0 = w[kc * H3 + j];
    const uint4 w1 = w[kc * H3 + H + j];
    const uint4 w2 = w[kc * H3 + 2 * H + j];
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) {
      const uint4 a = act[(c0 + cc) * act_stride + kc];
      acc[0][cc] = dot8_bf16(w0, a, acc[0][cc]);
      acc[1][cc] = dot8_bf16(w1, a, acc[1][cc]);
      acc[2][cc] = dot8_bf16(w2, a, acc[2][cc]);
    }
  }
}

// Recurrent pre-activations hp = W_hh h * scale + b_hh for one step.
template <int CPT, bool QUANT>
__device__ __forceinline__ void recurrent(const void* wmat, int H, int j,
                                          const unsigned char* act, int c0,
                                          const float (&sc)[3],
                                          const float (&bh)[3],
                                          float (&hp)[3][CPT]) {
  const int H3 = 3 * H;
  if (QUANT) {
    int acc[3][CPT] = {};
    dot_int8<CPT>(static_cast<const int4*>(wmat), H3, H, j,
                  reinterpret_cast<const int4*>(act), H / 16, c0, H / 16,
                  acc);
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc)
        hp[g][cc] = __fadd_rn(__fmul_rn(static_cast<float>(acc[g][cc]), sc[g]),
                              bh[g]);
  } else {
    float acc[3][CPT] = {};
    dot_bf16<CPT>(static_cast<const uint4*>(wmat), H3, H, j,
                  reinterpret_cast<const uint4*>(act), H / 8, c0, H / 8, acc);
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) hp[g][cc] = __fadd_rn(acc[g][cc], bh[g]);
  }
}

// Store h (f32) as the next step's matmul operand and as the emitted value.
template <bool QUANT>
__device__ __forceinline__ void emit_h(float h, unsigned char* act_n, int idx,
                                       unsigned char* out, size_t out_idx,
                                       bool write_out) {
  if (QUANT) {
    int q = __float2int_rn(__fmul_rn(h, 127.0f));
    q = max(-128, min(127, q));
    act_n[idx] = static_cast<unsigned char>(static_cast<int8_t>(q));
    if (write_out) out[out_idx] = static_cast<unsigned char>(static_cast<int8_t>(q));
  } else {
    const __nv_bfloat16 hb = __float2bfloat16_rn(h);
    reinterpret_cast<__nv_bfloat16*>(act_n)[idx] = hb;
    if (write_out) reinterpret_cast<__nv_bfloat16*>(out)[out_idx] = hb;
  }
}

__host__ __device__ __forceinline__ size_t align16(size_t v) {
  return (v + 15) & ~static_cast<size_t>(15);
}

size_t l1_smem_bytes(bool quant, int BT, int IN, int H) {
  const size_t esz = quant ? 1 : 2;
  return (quant ? align16(static_cast<size_t>(3) * H * H) : 0) +
         align16(2 * static_cast<size_t>(BT) * H * esz) +
         align16(2 * static_cast<size_t>(BT) * IN * sizeof(float)) +
         align16(static_cast<size_t>(IN) * 3 * H * sizeof(__nv_bfloat16));
}

size_t l2_smem_bytes(bool quant, int BT, int H, int nthreads, int CPT) {
  const size_t esz = quant ? 1 : 2;
  return (quant ? align16(static_cast<size_t>(3) * H * H) : 0) +
         align16(2 * static_cast<size_t>(BT) * 2 * H * esz) +
         align16(2 * static_cast<size_t>(BT) * H * esz) +
         align16(2 * static_cast<size_t>(nthreads / 32) * CPT * CMAX *
                 sizeof(float));
}

// Layer 1: x (T, B, IN) bf16 -> out_f, out_b (T, B, H) int8 (quant) or bf16.
// grid (ceil(B / BT), 2 directions), block H * NQ threads, BT = CPT * NQ.
template <int CPT, bool QUANT, int MODE>
__global__ void __launch_bounds__(512)
    gru_l1_split_kernel(const __nv_bfloat16* __restrict__ x,
                        const int* __restrict__ lengths,
                        const __nv_bfloat16* __restrict__ w_ih_t,
                        const float* __restrict__ b_ih,
                        const void* __restrict__ w_hh,
                        const float* __restrict__ hh_scale,
                        const float* __restrict__ b_hh, void* out_f,
                        void* out_b, int T, int B, int IN, int H, int NQ) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ESZ = QUANT ? 1 : 2;
  const int d = blockIdx.y;
  const int BT = CPT * NQ;
  const int b0 = blockIdx.x * BT;
  const int tid = threadIdx.x;
  const int j = tid % H;
  const int c0 = (tid / H) * CPT;
  const int H3 = 3 * H;
  const int kchunks = H * ESZ / 16;

  unsigned char* p = smem;
  unsigned char* w_s = p;
  if (QUANT) p += align16(static_cast<size_t>(H3) * H);
  unsigned char* act_s = p;
  p += align16(2 * static_cast<size_t>(BT) * H * ESZ);
  float* x_s = reinterpret_cast<float*>(p);
  p += align16(2 * static_cast<size_t>(BT) * IN * sizeof(float));
  __nv_bfloat16* wih_s = reinterpret_cast<__nv_bfloat16*>(p);

  const uint4* w_dir = static_cast<const uint4*>(w_hh) +
                       static_cast<size_t>(d) * kchunks * H3;
  if (QUANT) {
    for (int i = tid; i < kchunks * H3; i += blockDim.x)
      reinterpret_cast<uint4*>(w_s)[i] = w_dir[i];
  }
  const void* wmat = QUANT ? static_cast<const void*>(w_s)
                           : static_cast<const void*>(w_dir);
  for (int i = tid; i < IN * H3; i += blockDim.x)
    wih_s[i] = w_ih_t[static_cast<size_t>(d) * IN * H3 + i];
  for (int i = tid; i < 2 * BT * H * ESZ; i += blockDim.x) act_s[i] = 0;

  float sc[3], bh[3], bi[3];
#pragma unroll
  for (int g = 0; g < 3; ++g) {
    const int row = d * H3 + g * H + j;
    sc[g] = hh_scale[row];
    bh[g] = b_hh[row];
    bi[g] = b_ih[row];
  }
  int len[CPT];
  float h[CPT];
#pragma unroll
  for (int cc = 0; cc < CPT; ++cc) {
    const int b = b0 + c0 + cc;
    len[cc] = b < B ? lengths[b] : 0;
    h[cc] = 0.0f;
  }
  unsigned char* out = static_cast<unsigned char*>(d == 0 ? out_f : out_b);

  // thread tid < BT * IN stages one input value of the next step
  const bool xl = tid < BT * IN;
  const int xc = xl ? tid / IN : 0;
  const int xk = xl ? tid % IN : 0;
  const int xb = b0 + xc;
  if (xl) {
    const int t0 = d == 0 ? 0 : T - 1;
    x_s[xc * IN + xk] =
        xb < B ? __bfloat162float(x[(static_cast<size_t>(t0) * B + xb) * IN + xk])
               : 0.0f;
  }
  __syncthreads();

  for (int i = 0; i < T; ++i) {
    const int cur = i & 1;
    const int nxt = cur ^ 1;
    const int t = d == 0 ? i : T - 1 - i;
    float x_next = 0.0f;
    if (xl && i + 1 < T && xb < B) {
      const int tn = d == 0 ? i + 1 : T - 2 - i;
      x_next = __bfloat162float(x[(static_cast<size_t>(tn) * B + xb) * IN + xk]);
    }

    // input projection W_ih x + b_ih (f32 accumulation of bf16 products)
    float xp[3][CPT] = {};
    const float* xs = x_s + cur * BT * IN;
    for (int k = 0; k < IN; ++k) {
      const float w0 = __bfloat162float(wih_s[k * H3 + j]);
      const float w1 = __bfloat162float(wih_s[k * H3 + H + j]);
      const float w2 = __bfloat162float(wih_s[k * H3 + 2 * H + j]);
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        const float xv = xs[(c0 + cc) * IN + k];
        xp[0][cc] = fmaf(w0, xv, xp[0][cc]);
        xp[1][cc] = fmaf(w1, xv, xp[1][cc]);
        xp[2][cc] = fmaf(w2, xv, xp[2][cc]);
      }
    }
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        xp[g][cc] = __fadd_rn(xp[g][cc], bi[g]);
        if (MODE == MODE_ROWS) xp[g][cc] = bf16r(xp[g][cc]);
      }

    float hp[3][CPT];
    recurrent<CPT, QUANT>(wmat, H, j, act_s + cur * BT * H * ESZ, c0, sc, bh,
                          hp);

    unsigned char* act_n = act_s + nxt * BT * H * ESZ;
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) {
      const float hn = gru_update<QUANT, MODE>(h[cc], xp[0][cc], xp[1][cc],
                                               xp[2][cc], hp[0][cc], hp[1][cc],
                                               hp[2][cc]);
      if (t < len[cc]) h[cc] = hn;
      const int c = c0 + cc;
      const int b = b0 + c;
      emit_h<QUANT>(h[cc], act_n, c * H + j, out,
                    (static_cast<size_t>(t) * B + b) * H + j, b < B);
    }
    if (xl) x_s[nxt * BT * IN + xc * IN + xk] = x_next;
    __syncthreads();
  }
}

// Layer 2 + head: prev_f, prev_b (T, B, H) -> lg_f, lg_b (B, T, C) f32
// logit partials. The layer-2 input projection runs here, per step, from
// the chunk-interleaved (2H/chunk, 3H) W_ih read through L2.
template <int CPT, bool QUANT, int MODE>
__global__ void __launch_bounds__(512)
    gru_l2head_split_kernel(const void* __restrict__ prev_f,
                            const void* __restrict__ prev_b,
                            const int* __restrict__ lengths,
                            const void* __restrict__ w_in,
                            const float* __restrict__ in_scale,
                            const float* __restrict__ b_ih,
                            const void* __restrict__ w_hh,
                            const float* __restrict__ hh_scale,
                            const float* __restrict__ b_hh,
                            const float* __restrict__ w_head, float* lg_f,
                            float* lg_b, int T, int B, int H, int C, int NQ) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ESZ = QUANT ? 1 : 2;
  const int d = blockIdx.y;
  const int BT = CPT * NQ;
  const int b0 = blockIdx.x * BT;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int wpq = H / 32;  // warps per column group q
  const int j = tid % H;
  const int c0 = (tid / H) * CPT;
  const int H3 = 3 * H;
  const int kchunks = H * ESZ / 16;  // 16-byte chunks per H values

  unsigned char* p = smem;
  unsigned char* w_s = p;
  if (QUANT) p += align16(static_cast<size_t>(H3) * H);
  unsigned char* in_s = p;  // [2][BT][2H] = [prev_f | prev_b] per column
  p += align16(2 * static_cast<size_t>(BT) * 2 * H * ESZ);
  unsigned char* act_s = p;  // [2][BT][H]
  p += align16(2 * static_cast<size_t>(BT) * H * ESZ);
  float* red_s = reinterpret_cast<float*>(p);  // [2][nwarps][CPT][CMAX]

  const uint4* whh_dir = static_cast<const uint4*>(w_hh) +
                         static_cast<size_t>(d) * kchunks * H3;
  if (QUANT) {
    for (int i = tid; i < kchunks * H3; i += blockDim.x)
      reinterpret_cast<uint4*>(w_s)[i] = whh_dir[i];
  }
  const void* wmat = QUANT ? static_cast<const void*>(w_s)
                           : static_cast<const void*>(whh_dir);
  const uint4* win_dir = static_cast<const uint4*>(w_in) +
                         static_cast<size_t>(d) * 2 * kchunks * H3;
  for (int i = tid; i < 2 * BT * H * ESZ; i += blockDim.x) act_s[i] = 0;

  float sc[3], bh[3], bi[3], sa[3], sb[3];
#pragma unroll
  for (int g = 0; g < 3; ++g) {
    const int row = d * H3 + g * H + j;
    sc[g] = hh_scale[row];
    bh[g] = b_hh[row];
    bi[g] = b_ih[row];
    sa[g] = in_scale[(2 * d) * H3 + g * H + j];
    sb[g] = in_scale[(2 * d + 1) * H3 + g * H + j];
  }
  float wh[CMAX];
#pragma unroll
  for (int k = 0; k < CMAX; ++k)
    wh[k] = k < C ? w_head[(static_cast<size_t>(d) * C + k) * H + j] : 0.0f;
  int len[CPT];
  float h[CPT];
#pragma unroll
  for (int cc = 0; cc < CPT; ++cc) {
    const int b = b0 + c0 + cc;
    len[cc] = b < B ? lengths[b] : 0;
    h[cc] = 0.0f;
  }
  float* lg = d == 0 ? lg_f : lg_b;

  // thread tid < BT * 2 * kchunks stages one 16-byte input chunk
  const int col_chunks = 2 * kchunks;
  const bool il = tid < BT * col_chunks;
  const int ic = il ? tid / col_chunks : 0;
  const int ik = il ? tid % col_chunks : 0;
  const int ib = b0 + ic;
  const uint4* in_src = static_cast<const uint4*>(ik < kchunks ? prev_f : prev_b);
  const int ikk = ik % kchunks;
  auto load_in = [&](int tt) -> uint4 {
    if (ib >= B) return make_uint4(0, 0, 0, 0);
    return in_src[(static_cast<size_t>(tt) * B + ib) * kchunks + ikk];
  };
  if (il) {
    reinterpret_cast<uint4*>(in_s)[ic * col_chunks + ik] =
        load_in(d == 0 ? 0 : T - 1);
  }
  // thread tid < BT * C sums the per-warp head partials of one (column, class)
  const bool fl = tid < BT * C;
  const int fc = fl ? tid / C : 0;
  const int fk = fl ? tid % C : 0;
  const int fb = b0 + fc;
  auto flush = [&](int step) {
    const int buf = step & 1;
    const int q = fc / CPT;
    const int cc = fc % CPT;
    float s = 0.0f;
    for (int lw = 0; lw < wpq; ++lw)
      s += red_s[((buf * nwarps + q * wpq + lw) * CPT + cc) * CMAX + fk];
    const int ts = d == 0 ? step : T - 1 - step;
    if (fb < B) lg[(static_cast<size_t>(fb) * T + ts) * C + fk] = s;
  };
  __syncthreads();

  for (int i = 0; i < T; ++i) {
    const int cur = i & 1;
    const int nxt = cur ^ 1;
    const int t = d == 0 ? i : T - 1 - i;
    if (fl && i > 0) flush(i - 1);
    uint4 in_next = make_uint4(0, 0, 0, 0);
    if (il && i + 1 < T) in_next = load_in(d == 0 ? i + 1 : T - 2 - i);

    // input projection over [prev_f; prev_b], one accumulator per half
    float xp[3][CPT];
    const unsigned char* ins = in_s + cur * BT * 2 * H * ESZ;
    if (QUANT) {
      int acc_a[3][CPT] = {};
      int acc_b[3][CPT] = {};
      const int4* wv = reinterpret_cast<const int4*>(win_dir);
      const int4* av = reinterpret_cast<const int4*>(ins);
      dot_int8<CPT>(wv, H3, H, j, av, col_chunks, c0, kchunks, acc_a);
      dot_int8<CPT>(wv + kchunks * H3, H3, H, j, av + kchunks, col_chunks, c0,
                    kchunks, acc_b);
#pragma unroll
      for (int g = 0; g < 3; ++g)
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc) {
          if (MODE == MODE_T) {
            // merged (3H, 2H) projection with one per-row scale
            xp[g][cc] = __fadd_rn(
                __fmul_rn(static_cast<float>(acc_a[g][cc] + acc_b[g][cc]),
                          sa[g]),
                bi[g]);
          } else {
            const float pa = __fmul_rn(static_cast<float>(acc_a[g][cc]), sa[g]);
            const float pb = __fmul_rn(static_cast<float>(acc_b[g][cc]), sb[g]);
            xp[g][cc] = bf16r(__fadd_rn(__fadd_rn(pa, pb), bi[g]));
          }
        }
    } else {
      float acc_a[3][CPT] = {};
      float acc_b[3][CPT] = {};
      const uint4* av = reinterpret_cast<const uint4*>(ins);
      dot_bf16<CPT>(win_dir, H3, H, j, av, col_chunks, c0, kchunks, acc_a);
      dot_bf16<CPT>(win_dir + kchunks * H3, H3, H, j, av + kchunks,
                    col_chunks, c0, kchunks, acc_b);
#pragma unroll
      for (int g = 0; g < 3; ++g)
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc) {
          xp[g][cc] = __fadd_rn(__fadd_rn(acc_a[g][cc], acc_b[g][cc]), bi[g]);
          if (MODE == MODE_ROWS) xp[g][cc] = bf16r(xp[g][cc]);
        }
    }

    float hp[3][CPT];
    recurrent<CPT, QUANT>(wmat, H, j, act_s + cur * BT * H * ESZ, c0, sc, bh,
                          hp);

    unsigned char* act_n = act_s + nxt * BT * H * ESZ;
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) {
      const float hn = gru_update<QUANT, MODE>(h[cc], xp[0][cc], xp[1][cc],
                                               xp[2][cc], hp[0][cc], hp[1][cc],
                                               hp[2][cc]);
      if (t < len[cc]) h[cc] = hn;
      emit_h<QUANT>(h[cc], act_n, (c0 + cc) * H + j, nullptr, 0, false);
      // head partial: bf16(h) . W_head[:, j], reduced over the warp
      const float hb = bf16r(h[cc]);
#pragma unroll
      for (int k = 0; k < CMAX; ++k) {
        if (k >= C) break;
        float v = hb * wh[k];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane == 0) red_s[((cur * nwarps + warp) * CPT + cc) * CMAX + k] = v;
      }
    }
    if (il) reinterpret_cast<uint4*>(in_s)[(nxt * BT + ic) * col_chunks + ik] =
        in_next;
    __syncthreads();
  }
  if (fl) flush(T - 1);
}

template <int CPT, bool QUANT, int MODE>
cudaError_t launch_l1(const void* x, const int* lengths, const void* w_ih_t,
                      const float* b_ih, const void* w_hh,
                      const float* hh_scale, const float* b_hh, void* out_f,
                      void* out_b, int T, int B, int IN, int H, int NQ,
                      cudaStream_t stream) {
  const int BT = CPT * NQ;
  const size_t smem = l1_smem_bytes(QUANT, BT, IN, H);
  auto kern = gru_l1_split_kernel<CPT, QUANT, MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((B + BT - 1) / BT, 2);
  kern<<<grid, H * NQ, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), lengths,
      static_cast<const __nv_bfloat16*>(w_ih_t), b_ih, w_hh, hh_scale, b_hh,
      out_f, out_b, T, B, IN, H, NQ);
  return cudaGetLastError();
}

template <int CPT, bool QUANT, int MODE>
cudaError_t launch_l2(const void* prev_f, const void* prev_b,
                      const int* lengths, const void* w_in,
                      const float* in_scale, const float* b_ih,
                      const void* w_hh, const float* hh_scale,
                      const float* b_hh, const float* w_head, float* lg_f,
                      float* lg_b, int T, int B, int H, int C, int NQ,
                      cudaStream_t stream) {
  const int BT = CPT * NQ;
  const size_t smem = l2_smem_bytes(QUANT, BT, H, H * NQ, CPT);
  auto kern = gru_l2head_split_kernel<CPT, QUANT, MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((B + BT - 1) / BT, 2);
  kern<<<grid, H * NQ, smem, stream>>>(prev_f, prev_b, lengths, w_in, in_scale,
                                       b_ih, w_hh, hh_scale, b_hh, w_head,
                                       lg_f, lg_b, T, B, H, C, NQ);
  return cudaGetLastError();
}

template <bool QUANT, int MODE, typename... Args>
cudaError_t dispatch_l1(int cpt, Args... args) {
  switch (cpt) {
    case 1: return launch_l1<1, QUANT, MODE>(args...);
    case 2: return launch_l1<2, QUANT, MODE>(args...);
    case 4: return launch_l1<4, QUANT, MODE>(args...);
    default: return cudaErrorInvalidValue;
  }
}

template <bool QUANT, int MODE, typename... Args>
cudaError_t dispatch_l2(int cpt, Args... args) {
  switch (cpt) {
    case 1: return launch_l2<1, QUANT, MODE>(args...);
    case 2: return launch_l2<2, QUANT, MODE>(args...);
    case 4: return launch_l2<4, QUANT, MODE>(args...);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

size_t gru_l1_split_smem(int quant, int bt, int in_features, int hidden) {
  return l1_smem_bytes(quant != 0, bt, in_features, hidden);
}

size_t gru_l2head_split_smem(int quant, int cpt, int nq, int hidden) {
  return l2_smem_bytes(quant != 0, cpt * nq, hidden, hidden * nq, cpt);
}

int gru_l1_split_launch(const void* x, const int* lengths, const void* w_ih_t,
                        const float* b_ih, const void* w_hh,
                        const float* hh_scale, const float* b_hh, void* out_f,
                        void* out_b, int T, int B, int IN, int H, int cpt,
                        int nq, int quant, int mode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (quant && mode == MODE_T)
    e = dispatch_l1<true, MODE_T>(cpt, x, lengths, w_ih_t, b_ih, w_hh,
                                  hh_scale, b_hh, out_f, out_b, T, B, IN, H,
                                  nq, s);
  else if (quant)
    e = dispatch_l1<true, MODE_ROWS>(cpt, x, lengths, w_ih_t, b_ih, w_hh,
                                     hh_scale, b_hh, out_f, out_b, T, B, IN,
                                     H, nq, s);
  else if (mode == MODE_T)
    e = dispatch_l1<false, MODE_T>(cpt, x, lengths, w_ih_t, b_ih, w_hh,
                                   hh_scale, b_hh, out_f, out_b, T, B, IN, H,
                                   nq, s);
  else
    e = dispatch_l1<false, MODE_ROWS>(cpt, x, lengths, w_ih_t, b_ih, w_hh,
                                      hh_scale, b_hh, out_f, out_b, T, B, IN,
                                      H, nq, s);
  return static_cast<int>(e);
}

int gru_l2head_split_launch(const void* prev_f, const void* prev_b,
                            const int* lengths, const void* w_in,
                            const float* in_scale, const float* b_ih,
                            const void* w_hh, const float* hh_scale,
                            const float* b_hh, const float* w_head,
                            float* lg_f, float* lg_b, int T, int B, int H,
                            int C, int cpt, int nq, int quant, int mode,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C > CMAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (quant && mode == MODE_T)
    e = dispatch_l2<true, MODE_T>(cpt, prev_f, prev_b, lengths, w_in,
                                  in_scale, b_ih, w_hh, hh_scale, b_hh, w_head,
                                  lg_f, lg_b, T, B, H, C, nq, s);
  else if (quant)
    e = dispatch_l2<true, MODE_ROWS>(cpt, prev_f, prev_b, lengths, w_in,
                                     in_scale, b_ih, w_hh, hh_scale, b_hh,
                                     w_head, lg_f, lg_b, T, B, H, C, nq, s);
  else if (mode == MODE_T)
    e = dispatch_l2<false, MODE_T>(cpt, prev_f, prev_b, lengths, w_in,
                                   in_scale, b_ih, w_hh, hh_scale, b_hh,
                                   w_head, lg_f, lg_b, T, B, H, C, nq, s);
  else
    e = dispatch_l2<false, MODE_ROWS>(cpt, prev_f, prev_b, lengths, w_in,
                                      in_scale, b_ih, w_hh, hh_scale, b_hh,
                                      w_head, lg_f, lg_b, T, B, H, C, nq, s);
  return static_cast<int>(e);
}

const char* gru_split_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
