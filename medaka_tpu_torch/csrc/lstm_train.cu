// One LSTM direction over pre-projected inputs, forward and backward, for
// training; written for Hopper (sm_90a) and bound to Python with ctypes
// through a plain C interface.
//
// lstm_fwd  replaces medaka_tpu/ops/pallas_gru.py _lstm_kernel (called by
//           lstm_pallas).
// lstm_bwd  replaces medaka_tpu/ops/pallas_gru.py _lstm_bwd_kernel (called
//           by lstm_bwd_pallas): three kernels launched in order on one
//           stream, lstm_bwd_kernel (the recurrence), then rnn_dw_kernel
//           (dW_hh) and rnn_bwd_reduce_kernel (the fixed-order sums) of
//           rnn_train.cuh, which gru_train.cu shares.
//
// Forward, per step (gate order i, f, g, o):
//   gates = f32(bf16(h) . W_hh_bf16^T) + b_hh + f32(x_proj[t])
//   c' = sigmoid(f) c + sigmoid(i) tanh(g);  h' = sigmoid(o) tanh(c')
// h and c are f32, start at 0 and are frozen where t >= length;
// out[t] = bf16(h) and c_out[t] = c (f32), the cell states the backward
// recomputes its gates from. `reverse` walks time back to front, outputs
// stay in natural order.
//
// Backward walks time opposite to the forward with the through-time
// gradients dh and dc in f32. h_prev is the forward's bf16 output and
// c_prev its f32 cell state, each shifted by one step (zero at the
// recurrence start). Per step, v = (t < length):
//   dh += dh_out[t]; recompute the gates from h_prev; c = f c_prev + i g
//   do = dh tanh(c) o (1 - o);  dc_tot = dc + dh o (1 - tanh(c)^2)
//   di = dc_tot g i (1 - i);  df = dc_tot c_prev f (1 - f)
//   dg = dc_tot i (1 - g^2);  dgates = [di, df, dg, do] v
//   dxp[t] = dgates (f32); dW_hh += bf16(dgates)^T bf16(h_prev);
//   db_hh += dgates (f32)
//   dh = bf16(dgates) . W_hh_bf16 + dh (1 - v)
//   dc = dc_tot f v + dc (1 - v)
//
// Design. As gru_train.cu: the TPU kernels walk time blocks on a
// sequential grid with the carry in VMEM scratch and dW_hh/db_hh in
// resident output blocks; here one block owns a tile of BT = CPT * NQ
// batch columns of one direction and loops over all T steps itself,
// blocks never exchange state. Thread (j, q) owns hidden unit j (gate rows
// j, H+j, 2H+j, 3H+j) for columns q*CPT .. q*CPT+CPT-1, so a unit's four
// gates meet in one thread and its c (forward) or dh and dc (backward)
// never leave its registers. The forward needs one __syncthreads a step
// (double-buffered bf16 h in shared memory). The backward's product
// bf16(dgates) . W_hh needs a column's whole 4H-long dgates, which goes
// through shared memory: two __syncthreads a step; its h_prev (shared
// memory) and c_prev (registers) are inputs, so the next step's are
// loaded while the current step computes.
//
// W_hh is read in 16-byte chunks of 8 bf16 laid out so that a warp of 32
// consecutive units reads 512 contiguous bytes: the forward product reads
// W_hh's rows (chunk kc of row r at kc * 4H + r), the backward's dh
// product W_hh's columns (chunk kc of column j at kc * H + j). One
// direction's bf16 W_hh is 8 H^2 bytes. At H=128 (131,072 B) the forward
// keeps it in dynamic shared memory; the backward's two layouts fit only
// up to H=96. At H=384, the read-level training default, it is
// 1,179,648 B, and the kernels read it through the read-only cache from L2
// on every step (W_SMEM = false).
//
// dW_hh (4H x H f32, 2.4 MB at H=384) sums over every batch column and
// step: the recurrence writes bf16(dgates) (the operand the TPU kernel
// feeds its product with) to a scratch, rnn_dw_kernel sums 32 x 32 tiles
// of bf16(dgates)^T bf16(h_prev) over split (t, b) ranges, and
// rnn_bwd_reduce_kernel adds the split tiles and the per-(block, q) db_hh
// sums in index order. No atomics: a run repeats bit for bit.
//
// Numerics follow the plain PyTorch versions in
// medaka_tpu_torch/ops/lstm_train.py operation by operation: bf16 x bf16
// products are exact in f32 and fmaf rounds only the sums; sigmoid is
// 1 / (1 + expf(-v)) and tanh is tanhf in both; __fadd_rn/__fmul_rn/
// __fsub_rn keep nvcc from contracting sums and products into FMAs the
// plain versions do not do. What is left is the order of f32 sums (the
// recurrent products, dW_hh and db_hh), which can move a bf16 rounding.
// No value is rounded to an integer here.
//
// What bounds them on an H100, at B=128, T=1000, H=384: the forward moves
// about 0.69 GB (bf16 x_proj in, bf16 h and f32 c out), 0.21 ms at
// 3.35 TB/s, against 151 GFLOP of products (0.15 ms on the tensor cores);
// the backward moves about 1.7 GB (0.50 ms) against 453 GFLOP (0.46 ms).
// In practice the serial chain of T dependent steps, the CUDA-core dot
// products and re-reading 1.18 MB of W_hh from L2 every step (twice in
// the backward) bound both. The design keeps each block on 4 columns (32
// blocks at B=128) so that W_hh crosses each SM's L2 port once a step for
// 4 columns rather than once for each. Tensor-core mma for the per-step
// products and W_hh split over a cluster's shared memory are later work.
#include "rnn_train.cuh"

namespace {

// bytes of one direction's bf16 W_hh (4H x H)
__host__ __device__ __forceinline__ size_t w_bytes(int H) {
  return static_cast<size_t>(8) * H * H;
}

size_t fwd_smem_bytes(bool w_smem, int BT, int H) {
  return (w_smem ? align16(w_bytes(H)) : 0) +
         align16(2 * static_cast<size_t>(BT) * H * sizeof(bf16));
}

size_t bwd_smem_bytes(bool w_smem, int BT, int H) {
  return (w_smem ? 2 * align16(w_bytes(H)) : 0) +
         align16(2 * static_cast<size_t>(BT) * H * sizeof(bf16)) +
         align16(static_cast<size_t>(BT) * 4 * H * sizeof(bf16));
}

// ---------------------------------------------------------------------------
// forward: grid (ceil(B / BT)), block H * NQ threads
// ---------------------------------------------------------------------------

template <int CPT, bool W_SMEM>
__global__ void __launch_bounds__(512)
    lstm_fwd_kernel(const bf16* __restrict__ xp,
                    const uint4* __restrict__ w_rows,
                    const float* __restrict__ b_hh,
                    const int* __restrict__ lengths, bf16* __restrict__ out,
                    float* __restrict__ c_out, int T, int B, int H, int NQ,
                    int reverse) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int BT = CPT * NQ;
  const int b0 = blockIdx.x * BT;
  const int tid = threadIdx.x;
  const int j = tid % H;
  const int c0 = (tid / H) * CPT;
  const int H4 = 4 * H;
  const int kchunks = H / 8;  // 16-byte chunks of 8 bf16 per row

  unsigned char* p = smem;
  uint4* w_s = reinterpret_cast<uint4*>(p);
  if (W_SMEM) p += align16(w_bytes(H));
  bf16* act_s = reinterpret_cast<bf16*>(p);  // [2][BT][H]

  if (W_SMEM) {
    for (int i = tid; i < kchunks * H4; i += blockDim.x) w_s[i] = w_rows[i];
  }
  const uint4* wmat = W_SMEM ? w_s : w_rows;
  for (int i = tid; i < 2 * BT * H; i += blockDim.x)
    act_s[i] = __float2bfloat16_rn(0.0f);

  float bh[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) bh[g] = b_hh[g * H + j];
  int len[CPT];
  float h[CPT], c[CPT];
#pragma unroll
  for (int cc = 0; cc < CPT; ++cc) {
    const int b = b0 + c0 + cc;
    len[cc] = b < B ? lengths[b] : 0;
    h[cc] = 0.0f;
    c[cc] = 0.0f;
  }

  // this thread's projections of step tt: x_proj[tt, b, g*H + j]
  auto load_x = [&](int tt, bf16 (&dst)[4][CPT]) {
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) {
      const int b = b0 + c0 + cc;
      const size_t row = (static_cast<size_t>(tt) * B + b) * H4 + j;
#pragma unroll
      for (int g = 0; g < 4; ++g)
        dst[g][cc] = b < B ? xp[row + g * H] : __float2bfloat16_rn(0.0f);
    }
  };
  bf16 x_cur[4][CPT], x_next[4][CPT];
  load_x(reverse ? T - 1 : 0, x_cur);
  __syncthreads();

  for (int i = 0; i < T; ++i) {
    const int cur = i & 1;
    const int t = reverse ? T - 1 - i : i;
    if (i + 1 < T) load_x(reverse ? T - 2 - i : i + 1, x_next);

    // recurrent product bf16(h) . W_hh^T, f32 accumulation
    float acc[4][CPT] = {};
    const uint4* act = reinterpret_cast<const uint4*>(act_s + cur * BT * H);
    for (int kc = 0; kc < kchunks; ++kc) {
      uint4 w[4];
#pragma unroll
      for (int g = 0; g < 4; ++g)
        w[g] = load_w(wmat, static_cast<size_t>(kc) * H4 + g * H + j, W_SMEM);
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        const uint4 a = act[(c0 + cc) * kchunks + kc];
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[g][cc] = dot8_bf16(w[g], a, acc[g][cc]);
      }
    }

    bf16* act_n = act_s + (cur ^ 1) * BT * H;
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
      const bf16 hb = __float2bfloat16_rn(h[cc]);
      act_n[(c0 + cc) * H + j] = hb;
      const int b = b0 + c0 + cc;
      if (b < B) {
        const size_t o = (static_cast<size_t>(t) * B + b) * H + j;
        out[o] = hb;
        c_out[o] = c[cc];
      }
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

// ---------------------------------------------------------------------------
// backward recurrence: grid (ceil(B / BT)), block H * NQ threads
// ---------------------------------------------------------------------------

template <int CPT, bool W_SMEM>
__global__ void __launch_bounds__(512)
    lstm_bwd_kernel(const bf16* __restrict__ xp,
                    const bf16* __restrict__ h_out,
                    const float* __restrict__ c_out,
                    const float* __restrict__ dh_out,
                    const uint4* __restrict__ w_rows,
                    const uint4* __restrict__ w_cols,
                    const float* __restrict__ b_hh,
                    const int* __restrict__ lengths, float* __restrict__ dxp,
                    bf16* __restrict__ dg_out, float* __restrict__ db_part,
                    int T, int B, int H, int NQ, int reverse) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int BT = CPT * NQ;
  const int b0 = blockIdx.x * BT;
  const int tid = threadIdx.x;
  const int j = tid % H;
  const int q = tid / H;
  const int c0 = q * CPT;
  const int H4 = 4 * H;
  const int kch_h = H / 8;   // chunks of a row of W_hh / of h
  const int kch_g = H4 / 8;  // chunks of a row of W_hh^T / of dgates

  unsigned char* p = smem;
  uint4* wr_s = reinterpret_cast<uint4*>(p);
  if (W_SMEM) p += align16(w_bytes(H));
  uint4* wc_s = reinterpret_cast<uint4*>(p);
  if (W_SMEM) p += align16(w_bytes(H));
  bf16* hbuf = reinterpret_cast<bf16*>(p);  // [2][BT][H] bf16 h_prev
  p += align16(2 * static_cast<size_t>(BT) * H * sizeof(bf16));
  bf16* dg_s = reinterpret_cast<bf16*>(p);  // [BT][4H] bf16(dgates)

  if (W_SMEM) {
    for (int i = tid; i < kch_h * H4; i += blockDim.x) {
      wr_s[i] = w_rows[i];
      wc_s[i] = w_cols[i];  // same count: 4H x H either way
    }
  }
  const uint4* wrow = W_SMEM ? wr_s : w_rows;
  const uint4* wcol = W_SMEM ? wc_s : w_cols;

  float bh[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) bh[g] = b_hh[g * H + j];
  int len[CPT];
  float dh[CPT], dc[CPT];
#pragma unroll
  for (int cc = 0; cc < CPT; ++cc) {
    const int b = b0 + c0 + cc;
    len[cc] = b < B ? lengths[b] : 0;
    dh[cc] = 0.0f;
    dc[cc] = 0.0f;
  }
  float db_acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};

  // walk opposite to the forward: t = T-1 .. 0 for a forward-direction
  // LSTM, t = 0 .. T-1 for a reverse one
  auto t_of = [&](int i) { return reverse ? i : T - 1 - i; };
  // the step before tt in the forward's order: tt - 1 (forward) or
  // tt + 1 (reverse); out of range at the recurrence start
  auto prev_of = [&](int tt) { return reverse ? tt + 1 : tt - 1; };
  // h_prev of step tt into dst[BT][H], zero at the recurrence start
  auto load_hprev = [&](int tt, bf16* dst) {
    const int tp = prev_of(tt);
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
  // this thread's projections, upstream gradient and c_prev of step tt
  auto load_x = [&](int tt, bf16 (&xd)[4][CPT], float (&gd)[CPT],
                    float (&cd)[CPT]) {
    const int tp = prev_of(tt);
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) {
      const int b = b0 + c0 + cc;
      const size_t col = static_cast<size_t>(tt) * B + b;
#pragma unroll
      for (int g = 0; g < 4; ++g)
        xd[g][cc] = b < B ? xp[col * H4 + g * H + j]
                          : __float2bfloat16_rn(0.0f);
      gd[cc] = b < B ? dh_out[col * H + j] : 0.0f;
      cd[cc] = (b < B && tp >= 0 && tp < T)
                   ? c_out[(static_cast<size_t>(tp) * B + b) * H + j]
                   : 0.0f;
    }
  };

  bf16 x_cur[4][CPT], x_next[4][CPT];
  float g_cur[CPT], g_next[CPT], cp_cur[CPT], cp_next[CPT];
  load_hprev(t_of(0), hbuf);
  load_x(t_of(0), x_cur, g_cur, cp_cur);
  __syncthreads();

  for (int i = 0; i < T; ++i) {
    const int cur = i & 1;
    const int t = t_of(i);
    const bf16* hb = hbuf + cur * BT * H;
    if (i + 1 < T) {
      load_hprev(t_of(i + 1), hbuf + (cur ^ 1) * BT * H);
      load_x(t_of(i + 1), x_next, g_next, cp_next);
    }

    // recompute bf16(h_prev) . W_hh^T (f32 accumulation)
    float acc[4][CPT] = {};
    const uint4* act = reinterpret_cast<const uint4*>(hb);
    for (int kc = 0; kc < kch_h; ++kc) {
      uint4 w[4];
#pragma unroll
      for (int g = 0; g < 4; ++g)
        w[g] = load_w(wrow, static_cast<size_t>(kc) * H4 + g * H + j, W_SMEM);
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        const uint4 a = act[(c0 + cc) * kch_h + kc];
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[g][cc] = dot8_bf16(w[g], a, acc[g][cc]);
      }
    }

    float dh_pass[CPT], dc_next[CPT];
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) {
      const int b = b0 + c0 + cc;
      const float c_prev = cp_cur[cc];
      const float dhv = __fadd_rn(dh[cc], g_cur[cc]);
      float gate[4];
#pragma unroll
      for (int g = 0; g < 4; ++g)
        gate[g] = __fadd_rn(__fadd_rn(acc[g][cc], bh[g]),
                            __bfloat162float(x_cur[g][cc]));
      const float gi = sigmoid_f(gate[0]);
      const float gf = sigmoid_f(gate[1]);
      const float gg = tanhf(gate[2]);
      const float go = sigmoid_f(gate[3]);
      const float c_t = __fadd_rn(__fmul_rn(gf, c_prev), __fmul_rn(gi, gg));
      const float th = tanhf(c_t);
      const float valid = t < len[cc] ? 1.0f : 0.0f;
      const float do_pre = __fmul_rn(__fmul_rn(__fmul_rn(dhv, th), go),
                                     __fsub_rn(1.0f, go));
      const float dc_tot = __fadd_rn(
          dc[cc], __fmul_rn(__fmul_rn(dhv, go),
                            __fsub_rn(1.0f, __fmul_rn(th, th))));
      const float di_pre = __fmul_rn(__fmul_rn(__fmul_rn(dc_tot, gg), gi),
                                     __fsub_rn(1.0f, gi));
      const float df_pre = __fmul_rn(__fmul_rn(__fmul_rn(dc_tot, c_prev), gf),
                                     __fsub_rn(1.0f, gf));
      const float dg_pre = __fmul_rn(__fmul_rn(dc_tot, gi),
                                     __fsub_rn(1.0f, __fmul_rn(gg, gg)));
      const float d[4] = {__fmul_rn(di_pre, valid), __fmul_rn(df_pre, valid),
                          __fmul_rn(dg_pre, valid), __fmul_rn(do_pre, valid)};
      bf16* drow = dg_s + (c0 + cc) * H4;
      const size_t row = (static_cast<size_t>(t) * B + b) * H4 + j;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const bf16 db16 = __float2bfloat16_rn(d[g]);
        if (b < B) {
          dxp[row + g * H] = d[g];
          dg_out[row + g * H] = db16;
        }
        db_acc[g] = __fadd_rn(db_acc[g], d[g]);
        drow[g * H + j] = db16;
      }
      dh_pass[cc] = __fmul_rn(dhv, __fsub_rn(1.0f, valid));
      dc_next[cc] = __fadd_rn(__fmul_rn(__fmul_rn(dc_tot, gf), valid),
                              __fmul_rn(dc[cc], __fsub_rn(1.0f, valid)));
    }
    __syncthreads();  // dg_s complete (and the next h_prev loaded)

    // dh_prev = bf16(dgates) . W_hh + dh (1 - valid)
    float acc2[CPT] = {};
    const uint4* dact = reinterpret_cast<const uint4*>(dg_s);
    for (int kc = 0; kc < kch_g; ++kc) {
      const uint4 w = load_w(wcol, static_cast<size_t>(kc) * H + j, W_SMEM);
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc)
        acc2[cc] = dot8_bf16(w, dact[(c0 + cc) * kch_g + kc], acc2[cc]);
    }
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) {
      dh[cc] = __fadd_rn(acc2[cc], dh_pass[cc]);
      dc[cc] = dc_next[cc];
    }
    if (i + 1 < T) {
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        g_cur[cc] = g_next[cc];
        cp_cur[cc] = cp_next[cc];
#pragma unroll
        for (int g = 0; g < 4; ++g) x_cur[g][cc] = x_next[g][cc];
      }
    }
    __syncthreads();  // dg_s and this step's h_prev are free again
  }

  float* dbp = db_part + (static_cast<size_t>(blockIdx.x) * NQ + q) * H4;
#pragma unroll
  for (int g = 0; g < 4; ++g) dbp[g * H + j] = db_acc[g];
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <int CPT, bool W_SMEM>
cudaError_t launch_fwd(const void* xp, const void* w_rows, const float* b_hh,
                       const int* lengths, void* out, float* c_out, int T,
                       int B, int H, int NQ, int reverse,
                       cudaStream_t stream) {
  const int BT = CPT * NQ;
  const size_t smem = fwd_smem_bytes(W_SMEM, BT, H);
  auto kern = lstm_fwd_kernel<CPT, W_SMEM>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kern<<<(B + BT - 1) / BT, H * NQ, smem, stream>>>(
      static_cast<const bf16*>(xp), static_cast<const uint4*>(w_rows), b_hh,
      lengths, static_cast<bf16*>(out), c_out, T, B, H, NQ, reverse);
  return cudaGetLastError();
}

template <int CPT, bool W_SMEM>
cudaError_t launch_bwd(const void* xp, const void* h_out, const float* c_out,
                       const float* dh_out, const void* w_rows,
                       const void* w_cols, const float* b_hh,
                       const int* lengths, float* dxp, void* dg, float* db_part,
                       int T, int B, int H, int NQ, int reverse,
                       cudaStream_t stream) {
  const int BT = CPT * NQ;
  const size_t smem = bwd_smem_bytes(W_SMEM, BT, H);
  auto kern = lstm_bwd_kernel<CPT, W_SMEM>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kern<<<(B + BT - 1) / BT, H * NQ, smem, stream>>>(
      static_cast<const bf16*>(xp), static_cast<const bf16*>(h_out), c_out,
      dh_out, static_cast<const uint4*>(w_rows),
      static_cast<const uint4*>(w_cols), b_hh, lengths, dxp,
      static_cast<bf16*>(dg), db_part, T, B, H, NQ, reverse);
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

size_t lstm_fwd_smem(int w_smem, int bt, int hidden) {
  return fwd_smem_bytes(w_smem != 0, bt, hidden);
}

size_t lstm_bwd_smem(int w_smem, int bt, int hidden) {
  return bwd_smem_bytes(w_smem != 0, bt, hidden);
}

// out (T, B, H) bf16 and c_out (T, B, H) f32
int lstm_fwd_launch(const void* xp, const void* w_rows, const float* b_hh,
                    const int* lengths, void* out, float* c_out, int T, int B,
                    int H, int cpt, int nq, int w_smem, int reverse,
                    void* stream) {
  if (bad_shape(H, nq)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      w_smem ? dispatch_fwd<true>(cpt, xp, w_rows, b_hh, lengths, out, c_out,
                                  T, B, H, nq, reverse, s)
             : dispatch_fwd<false>(cpt, xp, w_rows, b_hh, lengths, out, c_out,
                                   T, B, H, nq, reverse, s);
  return static_cast<int>(e);
}

// the recurrence, the dW partial tiles and the fixed-order sums, in order
// on `stream`; dg (T, B, 4H) bf16, db_part (ceil(B / BT) * nq, 4H) f32 and
// dw_part (splits, 4H, H) f32 are scratch
int lstm_bwd_launch(const void* xp, const void* h_out, const float* c_out,
                    const float* dh_out, const void* w_rows,
                    const void* w_cols, const float* b_hh, const int* lengths,
                    float* dxp, void* dg, float* db_part, float* dw_part,
                    float* dw, float* db, int T, int B, int H, int cpt, int nq,
                    int w_smem, int reverse, int splits, void* stream) {
  if (bad_shape(H, nq) || splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      w_smem ? dispatch_bwd<true>(cpt, xp, h_out, c_out, dh_out, w_rows,
                                  w_cols, b_hh, lengths, dxp, dg, db_part, T,
                                  B, H, nq, reverse, s)
             : dispatch_bwd<false>(cpt, xp, h_out, c_out, dh_out, w_rows,
                                   w_cols, b_hh, lengths, dxp, dg, db_part, T,
                                   B, H, nq, reverse, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int BT = cpt * nq;
  return static_cast<int>(launch_dw_reduce(dg, h_out, dw_part, db_part, dw,
                                           db, T, B, H, 4 * H, reverse,
                                           splits, (B + BT - 1) / BT * nq, s));
}

const char* lstm_train_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
