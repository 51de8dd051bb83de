// One GRU direction over pre-projected inputs, forward and backward, for
// training; written for Hopper (sm_90a) and bound to Python with ctypes
// through a plain C interface.
//
// gru_fwd  replaces medaka_tpu/ops/pallas_gru.py _gru_kernel (called by
//          gru_pallas).
// gru_bwd  replaces medaka_tpu/ops/pallas_gru.py _gru_bwd_kernel (called
//          by gru_bwd_pallas): three kernels launched in order on one
//          stream, gru_bwd_kernel (the recurrence), then rnn_dw_kernel
//          (dW_hh) and rnn_bwd_reduce_kernel (the fixed-order sums), which
//          rnn_train.cuh shares with lstm_train.cu.
//
// Forward, per step (gate order r, z, n):
//   hp = f32(bf16(h) . W_hh_bf16^T) + b_hh
//   r = sigmoid(x_r + hp_r), z = sigmoid(x_z + hp_z),
//   n = tanh(x_n + r hp_n), h' = (1 - z) n + z h
// h is f32, starts at 0 and is frozen where t >= length; out[t] = bf16(h),
// so forward-direction tails repeat the last valid h and reverse-direction
// tails stay 0. `reverse` walks time back to front, outputs stay in
// natural order.
//
// Backward walks time opposite to the forward with the through-time
// gradient dh in f32. h_prev is the forward's bf16 output shifted by one
// step (zero at the recurrence start), so the recomputed gates, dz and
// the dW product all use bf16-rounded h, as in the TPU kernel. Per step:
//   dh += dh_out[t]; recompute r, z, n from h_prev; v = (t < length)
//   dh_eff = dh v; dn = dh_eff (1 - z); dz = dh_eff (h_prev - n)
//   dn_pre = dn (1 - n n); dz_pre = dz z (1 - z); dr_pre = dn_pre hp_n r (1 - r)
//   dxp[t] = [dr_pre, dz_pre, dn_pre] (f32); dhp = [dr_pre, dz_pre, dn_pre r]
//   dW_hh += bf16(dhp)^T bf16(h_prev); db_hh += dhp (f32)
//   dh = dh_eff z + bf16(dhp) . W_hh_bf16 + dh (1 - v)
//
// Design. The TPU kernels walk time blocks on a sequential grid with the
// carry in VMEM scratch and dW_hh/db_hh in resident output blocks. Here
// one block owns a tile of BT = CPT * NQ batch columns of one direction
// and loops over all T steps itself; blocks never exchange state. Thread
// (j, q) owns hidden unit j (gate rows j, H+j, 2H+j) for columns
// q*CPT .. q*CPT+CPT-1, so a unit's three gates meet in one thread and
// its h (forward) or dh (backward) stays in registers. The forward needs
// one __syncthreads a step (double-buffered bf16 h in shared memory).
// The backward's product bf16(dhp) . W_hh needs a column's whole 3H-long
// dhp, which goes through shared memory: two __syncthreads a step. Its
// h_prev is an input, not a carry, so the next step's h_prev is loaded
// into the second buffer while the current step computes.
//
// W_hh is read in 16-byte chunks of 8 bf16 laid out so that a warp of 32
// consecutive units reads 512 contiguous bytes: the forward product reads
// W_hh's rows (chunk kc of row r at kc * 3H + r), the backward's dh
// product W_hh's columns (chunk kc of column j at kc * H + j, i.e. the
// rows of W_hh^T). One direction's bf16 W_hh is 6 H^2 bytes: at H=128
// (98,304 B; the backward's two layouts 196,608 B) it sits in dynamic
// shared memory; at H=256, the counts model's width, it does not
// (393,216 B > 232,448 B), and the kernels read it through the read-only
// cache from L2 on every step (W_SMEM = false). Splitting the gate rows
// over a 2-block cluster with distributed shared memory is later work.
//
// dW_hh is 3H x H f32 (786,432 B at H=256), more than a block's shared
// memory or registers can hold across the walk, and it sums over every
// batch column and step, which run in parallel blocks. So the recurrence
// writes bf16(dhp) to a scratch (the operand the TPU kernel feeds its
// product with), and rnn_dw_kernel computes bf16(dhp)^T bf16(h_prev) as
// a tiled reduction over (t, b): each block owns a 32 x 32 tile of dW_hh
// and one of `splits` contiguous ranges of (t, b), and writes its partial
// tile. db_hh is summed per thread in registers over its columns and
// steps and written per (block, q). rnn_bwd_reduce_kernel adds the
// partials in a fixed order. No atomics: a run repeats bit for bit.
//
// Numerics follow the plain PyTorch versions in
// medaka_tpu_torch/ops/gru_train.py operation by operation: bf16 x bf16
// products are exact in f32 and fmaf rounds only the sums; sigmoid is
// 1 / (1 + expf(-v)) and tanh is tanhf in both; __fadd_rn/__fmul_rn/
// __fsub_rn keep nvcc from contracting sums and products into FMAs the
// plain versions do not do. What is left is the order of f32 sums (the
// recurrent products, dW_hh and db_hh), which can move a bf16 rounding.
//
// What bounds them on an H100, at B=128, T=1000, H=256: the forward moves
// 262 MB (bf16 x_proj in, bf16 h out), 0.078 ms at 3.35 TB/s, and its
// 50 GFLOP of products would take 0.051 ms on the tensor cores; the
// backward moves 786 MB (0.235 ms) for 151 GFLOP (0.153 ms). In practice
// the serial chain of T dependent steps, the CUDA-core dot products and
// re-reading W_hh from L2 every step bound both. Tensor-core mma for the
// per-step products and W_hh resident in a cluster's shared memory are
// later work.
#include "rnn_train.cuh"

namespace {

// bytes of one direction's bf16 W_hh (3H x H)
__host__ __device__ __forceinline__ size_t w_bytes(int H) {
  return static_cast<size_t>(6) * H * H;
}

size_t fwd_smem_bytes(bool w_smem, int BT, int H) {
  return (w_smem ? align16(w_bytes(H)) : 0) +
         align16(2 * static_cast<size_t>(BT) * H * sizeof(bf16));
}

size_t bwd_smem_bytes(bool w_smem, int BT, int H) {
  return (w_smem ? 2 * align16(w_bytes(H)) : 0) +
         align16(2 * static_cast<size_t>(BT) * H * sizeof(bf16)) +
         align16(static_cast<size_t>(BT) * 3 * H * sizeof(bf16));
}

// ---------------------------------------------------------------------------
// forward: grid (ceil(B / BT)), block H * NQ threads
// ---------------------------------------------------------------------------

template <int CPT, bool W_SMEM>
__global__ void __launch_bounds__(512)
    gru_fwd_kernel(const bf16* __restrict__ xp,
                   const uint4* __restrict__ w_rows,
                   const float* __restrict__ b_hh,
                   const int* __restrict__ lengths, bf16* __restrict__ out,
                   int T, int B, int H, int NQ, int reverse) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int BT = CPT * NQ;
  const int b0 = blockIdx.x * BT;
  const int tid = threadIdx.x;
  const int j = tid % H;
  const int c0 = (tid / H) * CPT;
  const int H3 = 3 * H;
  const int kchunks = H / 8;  // 16-byte chunks of 8 bf16 per row

  unsigned char* p = smem;
  uint4* w_s = reinterpret_cast<uint4*>(p);
  if (W_SMEM) p += align16(w_bytes(H));
  bf16* act_s = reinterpret_cast<bf16*>(p);  // [2][BT][H]

  if (W_SMEM) {
    for (int i = tid; i < kchunks * H3; i += blockDim.x) w_s[i] = w_rows[i];
  }
  const uint4* wmat = W_SMEM ? w_s : w_rows;
  for (int i = tid; i < 2 * BT * H; i += blockDim.x)
    act_s[i] = __float2bfloat16_rn(0.0f);

  float bh[3];
#pragma unroll
  for (int g = 0; g < 3; ++g) bh[g] = b_hh[g * H + j];
  int len[CPT];
  float h[CPT];
#pragma unroll
  for (int cc = 0; cc < CPT; ++cc) {
    const int b = b0 + c0 + cc;
    len[cc] = b < B ? lengths[b] : 0;
    h[cc] = 0.0f;
  }

  // this thread's projections of step tt: x_proj[tt, b, g*H + j]
  auto load_x = [&](int tt, bf16 (&dst)[3][CPT]) {
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) {
      const int b = b0 + c0 + cc;
      const size_t row = (static_cast<size_t>(tt) * B + b) * H3 + j;
#pragma unroll
      for (int g = 0; g < 3; ++g)
        dst[g][cc] = b < B ? xp[row + g * H] : __float2bfloat16_rn(0.0f);
    }
  };
  bf16 x_cur[3][CPT], x_next[3][CPT];
  load_x(reverse ? T - 1 : 0, x_cur);
  __syncthreads();

  for (int i = 0; i < T; ++i) {
    const int cur = i & 1;
    const int t = reverse ? T - 1 - i : i;
    if (i + 1 < T) load_x(reverse ? T - 2 - i : i + 1, x_next);

    // recurrent product bf16(h) . W_hh^T, f32 accumulation
    float acc[3][CPT] = {};
    const uint4* act = reinterpret_cast<const uint4*>(act_s + cur * BT * H);
    for (int kc = 0; kc < kchunks; ++kc) {
      uint4 w[3];
#pragma unroll
      for (int g = 0; g < 3; ++g)
        w[g] = load_w(wmat, static_cast<size_t>(kc) * H3 + g * H + j, W_SMEM);
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        const uint4 a = act[(c0 + cc) * kchunks + kc];
#pragma unroll
        for (int g = 0; g < 3; ++g) acc[g][cc] = dot8_bf16(w[g], a, acc[g][cc]);
      }
    }

    bf16* act_n = act_s + (cur ^ 1) * BT * H;
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) {
      const float hr = __fadd_rn(acc[0][cc], bh[0]);
      const float hz = __fadd_rn(acc[1][cc], bh[1]);
      const float hn = __fadd_rn(acc[2][cc], bh[2]);
      const float r = sigmoid_f(__fadd_rn(__bfloat162float(x_cur[0][cc]), hr));
      const float z = sigmoid_f(__fadd_rn(__bfloat162float(x_cur[1][cc]), hz));
      const float n = tanhf(
          __fadd_rn(__bfloat162float(x_cur[2][cc]), __fmul_rn(r, hn)));
      const float h_new = __fadd_rn(__fmul_rn(__fsub_rn(1.0f, z), n),
                                    __fmul_rn(z, h[cc]));
      if (t < len[cc]) h[cc] = h_new;
      const bf16 hb = __float2bfloat16_rn(h[cc]);
      act_n[(c0 + cc) * H + j] = hb;
      const int b = b0 + c0 + cc;
      if (b < B) out[(static_cast<size_t>(t) * B + b) * H + j] = hb;
    }
    if (i + 1 < T) {
#pragma unroll
      for (int g = 0; g < 3; ++g)
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc) x_cur[g][cc] = x_next[g][cc];
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// backward recurrence: grid (ceil(B / BT)), block H * NQ threads
// ---------------------------------------------------------------------------

template <int CPT, bool W_SMEM>
__global__ void __launch_bounds__(512)
    gru_bwd_kernel(const bf16* __restrict__ xp,
                   const bf16* __restrict__ h_out,
                   const float* __restrict__ dh_out,
                   const uint4* __restrict__ w_rows,
                   const uint4* __restrict__ w_cols,
                   const float* __restrict__ b_hh,
                   const int* __restrict__ lengths, float* __restrict__ dxp,
                   bf16* __restrict__ dhp_out, float* __restrict__ db_part,
                   int T, int B, int H, int NQ, int reverse) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int BT = CPT * NQ;
  const int b0 = blockIdx.x * BT;
  const int tid = threadIdx.x;
  const int j = tid % H;
  const int q = tid / H;
  const int c0 = q * CPT;
  const int H3 = 3 * H;
  const int kch_h = H / 8;   // chunks of a row of W_hh / of h
  const int kch_g = H3 / 8;  // chunks of a row of W_hh^T / of dhp

  unsigned char* p = smem;
  uint4* wr_s = reinterpret_cast<uint4*>(p);
  if (W_SMEM) p += align16(w_bytes(H));
  uint4* wc_s = reinterpret_cast<uint4*>(p);
  if (W_SMEM) p += align16(w_bytes(H));
  bf16* hbuf = reinterpret_cast<bf16*>(p);  // [2][BT][H] bf16 h_prev
  p += align16(2 * static_cast<size_t>(BT) * H * sizeof(bf16));
  bf16* dhp_s = reinterpret_cast<bf16*>(p);  // [BT][3H] bf16(dhp)

  if (W_SMEM) {
    for (int i = tid; i < kch_h * H3; i += blockDim.x) {
      wr_s[i] = w_rows[i];
      wc_s[i] = w_cols[i];  // same count: 3H x H either way
    }
  }
  const uint4* wrow = W_SMEM ? wr_s : w_rows;
  const uint4* wcol = W_SMEM ? wc_s : w_cols;

  float bh[3];
#pragma unroll
  for (int g = 0; g < 3; ++g) bh[g] = b_hh[g * H + j];
  int len[CPT];
  float dh[CPT];
#pragma unroll
  for (int cc = 0; cc < CPT; ++cc) {
    const int b = b0 + c0 + cc;
    len[cc] = b < B ? lengths[b] : 0;
    dh[cc] = 0.0f;
  }
  float db_acc[3] = {0.0f, 0.0f, 0.0f};

  // walk opposite to the forward: t = T-1 .. 0 for a forward-direction
  // GRU, t = 0 .. T-1 for a reverse one
  auto t_of = [&](int i) { return reverse ? i : T - 1 - i; };
  // h_prev of step tt into dst[BT][H]: h_out[tt - 1] (forward) or
  // h_out[tt + 1] (reverse), zero at the recurrence start
  auto load_hprev = [&](int tt, bf16* dst) {
    const int tp = reverse ? tt + 1 : tt - 1;
    uint4* d = reinterpret_cast<uint4*>(dst);
    for (int e = tid; e < BT * kch_h; e += blockDim.x) {
      const int c = e / kch_h;
      const int kc = e - c * kch_h;
      const int b = b0 + c;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (tp >= 0 && tp < T && b < B)
        v = *reinterpret_cast<const uint4*>(
            h_out + (static_cast<size_t>(tp) * B + b) * H + kc * 8);
      d[e] = v;
    }
  };
  auto load_x = [&](int tt, bf16 (&xd)[3][CPT], float (&gd)[CPT]) {
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) {
      const int b = b0 + c0 + cc;
      const size_t col = static_cast<size_t>(tt) * B + b;
#pragma unroll
      for (int g = 0; g < 3; ++g)
        xd[g][cc] = b < B ? xp[col * H3 + g * H + j]
                          : __float2bfloat16_rn(0.0f);
      gd[cc] = b < B ? dh_out[col * H + j] : 0.0f;
    }
  };

  bf16 x_cur[3][CPT], x_next[3][CPT];
  float g_cur[CPT], g_next[CPT];
  load_hprev(t_of(0), hbuf);
  load_x(t_of(0), x_cur, g_cur);
  __syncthreads();

  for (int i = 0; i < T; ++i) {
    const int cur = i & 1;
    const int t = t_of(i);
    const bf16* hb = hbuf + cur * BT * H;
    if (i + 1 < T) {
      load_hprev(t_of(i + 1), hbuf + (cur ^ 1) * BT * H);
      load_x(t_of(i + 1), x_next, g_next);
    }

    // recompute hp = bf16(h_prev) . W_hh^T (f32 accumulation)
    float acc[3][CPT] = {};
    const uint4* act = reinterpret_cast<const uint4*>(hb);
    for (int kc = 0; kc < kch_h; ++kc) {
      uint4 w[3];
#pragma unroll
      for (int g = 0; g < 3; ++g)
        w[g] = load_w(wrow, static_cast<size_t>(kc) * H3 + g * H + j, W_SMEM);
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        const uint4 a = act[(c0 + cc) * kch_h + kc];
#pragma unroll
        for (int g = 0; g < 3; ++g) acc[g][cc] = dot8_bf16(w[g], a, acc[g][cc]);
      }
    }

    float dh_z[CPT], dh_pass[CPT];
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) {
      const int b = b0 + c0 + cc;
      const float h_prev = __bfloat162float(hb[(c0 + cc) * H + j]);
      const float dhv = __fadd_rn(dh[cc], g_cur[cc]);
      const float hr = __fadd_rn(acc[0][cc], bh[0]);
      const float hz = __fadd_rn(acc[1][cc], bh[1]);
      const float hn = __fadd_rn(acc[2][cc], bh[2]);
      const float r = sigmoid_f(__fadd_rn(__bfloat162float(x_cur[0][cc]), hr));
      const float z = sigmoid_f(__fadd_rn(__bfloat162float(x_cur[1][cc]), hz));
      const float n = tanhf(
          __fadd_rn(__bfloat162float(x_cur[2][cc]), __fmul_rn(r, hn)));
      const float valid = t < len[cc] ? 1.0f : 0.0f;
      const float dh_eff = __fmul_rn(dhv, valid);
      const float dn = __fmul_rn(dh_eff, __fsub_rn(1.0f, z));
      const float dz = __fmul_rn(dh_eff, __fsub_rn(h_prev, n));
      const float dn_pre = __fmul_rn(dn, __fsub_rn(1.0f, __fmul_rn(n, n)));
      const float dr = __fmul_rn(dn_pre, hn);
      const float dz_pre = __fmul_rn(__fmul_rn(dz, z), __fsub_rn(1.0f, z));
      const float dr_pre = __fmul_rn(__fmul_rn(dr, r), __fsub_rn(1.0f, r));
      const float dhp_n = __fmul_rn(dn_pre, r);
      const bf16 br = __float2bfloat16_rn(dr_pre);
      const bf16 bz = __float2bfloat16_rn(dz_pre);
      const bf16 bn = __float2bfloat16_rn(dhp_n);
      if (b < B) {
        const size_t row = (static_cast<size_t>(t) * B + b) * H3 + j;
        dxp[row] = dr_pre;
        dxp[row + H] = dz_pre;
        dxp[row + 2 * H] = dn_pre;
        dhp_out[row] = br;
        dhp_out[row + H] = bz;
        dhp_out[row + 2 * H] = bn;
      }
      db_acc[0] = __fadd_rn(db_acc[0], dr_pre);
      db_acc[1] = __fadd_rn(db_acc[1], dz_pre);
      db_acc[2] = __fadd_rn(db_acc[2], dhp_n);
      bf16* drow = dhp_s + (c0 + cc) * H3;
      drow[j] = br;
      drow[H + j] = bz;
      drow[2 * H + j] = bn;
      dh_z[cc] = __fmul_rn(dh_eff, z);
      dh_pass[cc] = __fmul_rn(dhv, __fsub_rn(1.0f, valid));
    }
    __syncthreads();  // dhp_s complete (and the next h_prev loaded)

    // dh_prev = dh_eff z + bf16(dhp) . W_hh + dh (1 - valid)
    float acc2[CPT] = {};
    const uint4* dact = reinterpret_cast<const uint4*>(dhp_s);
    for (int kc = 0; kc < kch_g; ++kc) {
      const uint4 w = load_w(wcol, static_cast<size_t>(kc) * H + j, W_SMEM);
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc)
        acc2[cc] = dot8_bf16(w, dact[(c0 + cc) * kch_g + kc], acc2[cc]);
    }
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc)
      dh[cc] = __fadd_rn(__fadd_rn(dh_z[cc], acc2[cc]), dh_pass[cc]);
    if (i + 1 < T) {
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        g_cur[cc] = g_next[cc];
#pragma unroll
        for (int g = 0; g < 3; ++g) x_cur[g][cc] = x_next[g][cc];
      }
    }
    __syncthreads();  // dhp_s and this step's h_prev are free again
  }

  float* dbp = db_part + (static_cast<size_t>(blockIdx.x) * NQ + q) * H3;
#pragma unroll
  for (int g = 0; g < 3; ++g) dbp[g * H + j] = db_acc[g];
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <int CPT, bool W_SMEM>
cudaError_t launch_fwd(const void* xp, const void* w_rows, const float* b_hh,
                       const int* lengths, void* out, int T, int B, int H,
                       int NQ, int reverse, cudaStream_t stream) {
  const int BT = CPT * NQ;
  const size_t smem = fwd_smem_bytes(W_SMEM, BT, H);
  auto kern = gru_fwd_kernel<CPT, W_SMEM>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kern<<<(B + BT - 1) / BT, H * NQ, smem, stream>>>(
      static_cast<const bf16*>(xp), static_cast<const uint4*>(w_rows), b_hh,
      lengths, static_cast<bf16*>(out), T, B, H, NQ, reverse);
  return cudaGetLastError();
}

template <int CPT, bool W_SMEM>
cudaError_t launch_bwd(const void* xp, const void* h_out, const float* dh_out,
                       const void* w_rows, const void* w_cols,
                       const float* b_hh, const int* lengths, float* dxp,
                       void* dhp, float* db_part, int T, int B, int H,
                       int NQ, int reverse, cudaStream_t stream) {
  const int BT = CPT * NQ;
  const size_t smem = bwd_smem_bytes(W_SMEM, BT, H);
  auto kern = gru_bwd_kernel<CPT, W_SMEM>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kern<<<(B + BT - 1) / BT, H * NQ, smem, stream>>>(
      static_cast<const bf16*>(xp), static_cast<const bf16*>(h_out), dh_out,
      static_cast<const uint4*>(w_rows), static_cast<const uint4*>(w_cols),
      b_hh, lengths, dxp, static_cast<bf16*>(dhp), db_part, T, B, H, NQ,
      reverse);
  return cudaGetLastError();
}

template <bool W_SMEM, typename... Args>
cudaError_t dispatch_fwd(int cpt, Args... args) {
  switch (cpt) {
    case 1: return launch_fwd<1, W_SMEM>(args...);
    case 2: return launch_fwd<2, W_SMEM>(args...);
    case 4: return launch_fwd<4, W_SMEM>(args...);
    default: return cudaErrorInvalidValue;
  }
}

template <bool W_SMEM, typename... Args>
cudaError_t dispatch_bwd(int cpt, Args... args) {
  switch (cpt) {
    case 1: return launch_bwd<1, W_SMEM>(args...);
    case 2: return launch_bwd<2, W_SMEM>(args...);
    case 4: return launch_bwd<4, W_SMEM>(args...);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

size_t gru_fwd_smem(int w_smem, int bt, int hidden) {
  return fwd_smem_bytes(w_smem != 0, bt, hidden);
}

size_t gru_bwd_smem(int w_smem, int bt, int hidden) {
  return bwd_smem_bytes(w_smem != 0, bt, hidden);
}

int gru_fwd_launch(const void* xp, const void* w_rows, const float* b_hh,
                   const int* lengths, void* out, int T, int B, int H,
                   int cpt, int nq, int w_smem, int reverse, void* stream) {
  if (bad_shape(H, nq)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      w_smem ? dispatch_fwd<true>(cpt, xp, w_rows, b_hh, lengths, out, T, B,
                                  H, nq, reverse, s)
             : dispatch_fwd<false>(cpt, xp, w_rows, b_hh, lengths, out, T, B,
                                   H, nq, reverse, s);
  return static_cast<int>(e);
}

// the recurrence, the dW partial tiles and the fixed-order sums, in order
// on `stream`; dhp (T, B, 3H) bf16, db_part (ceil(B / BT) * nq, 3H) f32
// and dw_part (splits, 3H, H) f32 are scratch
int gru_bwd_launch(const void* xp, const void* h_out, const float* dh_out,
                   const void* w_rows, const void* w_cols, const float* b_hh,
                   const int* lengths, float* dxp, void* dhp, float* db_part,
                   float* dw_part, float* dw, float* db, int T, int B, int H,
                   int cpt, int nq, int w_smem, int reverse, int splits,
                   void* stream) {
  if (bad_shape(H, nq) || splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      w_smem ? dispatch_bwd<true>(cpt, xp, h_out, dh_out, w_rows, w_cols,
                                  b_hh, lengths, dxp, dhp, db_part, T, B, H,
                                  nq, reverse, s)
             : dispatch_bwd<false>(cpt, xp, h_out, dh_out, w_rows, w_cols,
                                   b_hh, lengths, dxp, dhp, db_part, T, B, H,
                                   nq, reverse, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int BT = cpt * nq;
  return static_cast<int>(launch_dw_reduce(dhp, h_out, dw_part, db_part, dw,
                                           db, T, B, H, 3 * H, reverse,
                                           splits, (B + BT - 1) / BT * nq, s));
}

const char* gru_train_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
