// One LSTM direction over pre-projected inputs, forward and backward, for
// training; written for Hopper (sm_90a: thread-block clusters, distributed
// shared memory, mma.sync on the tensor cores) and bound to Python with
// ctypes through a plain C interface.
//
// lstm_fwd  replaces medaka_tpu/ops/pallas_gru.py _lstm_kernel (called by
//           lstm_pallas): lstm_fwd.cuh's cluster forward (lstm_fwd_kernel,
//           shared with bilstm.cu), one direction a launch, with the f32
//           cell states.
// lstm_bwd  replaces medaka_tpu/ops/pallas_gru.py _lstm_bwd_kernel (called
//           by lstm_bwd_pallas): three kernels launched in order on one
//           stream, lstm_bwd_kernel (the recurrence), then rnn_dw_kernel
//           (dW_hh on the tensor cores) and rnn_bwd_reduce_kernel (the
//           fixed-order sums) of rnn_train.cuh, which gru_train.cu shares.
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
// What bounds them on an H100, at B=128, T=1000, H=384 (chip_smoke.py's
// train_bound, over the valid columns): the forward moves about 0.69 GB
// (bf16 x_proj in, bf16 h and f32 c out), 0.21 ms at 3.35 TB/s, against
// 151 GFLOP of products (0.15 ms on the tensor cores); the backward moves
// about 1.7 GB (0.50 ms) against 453 GFLOP (0.46 ms). Both are a serial
// chain of T dependent steps, so what bounds them in practice is the time
// of one step, and before this design that was W_hh: one direction's bf16
// W_hh is 8 H^2 bytes (1,179,648 B at H=384), five times an SM's shared
// memory, and every block streamed all of it from L2 through its SM's port
// on every step (twice a step in the backward), 26 us a step.
//
// Design. A thread-block cluster of C blocks owns one tile of BT batch
// columns of one direction and walks all T steps. Block r of the cluster
// owns U = Hp / C hidden units (H padded to Hp with zero units) and keeps
// their 4U gate rows of W_hh, bf16, in its shared memory for the whole
// walk: no block reads W_hh from L2 after the prologue. At H=384 (C=8,
// U=48) that is 192 x 392 x 2 = 150,528 B a block. C and BT are chosen on
// the host (ops/rnn_cluster.py choose_geometry) from H, B and
// cudaOccupancyMaxActiveClusters: the smallest C whose slice fits with at
// most 64 units a block, the smallest BT in {8, 16, 32} whose clusters
// run in one wave.
//
// Rows of a slice: warp unit group q (8 units) holds rows q*32 + g*8 + u
// (gate g, unit u), so in the m16n8k16 accumulator fragments of its two
// 16-row tiles a thread holds gates i, f, g and o of one unit for two
// batch columns: the gate nonlinearity and c stay in registers.
//
// Forward step: lstm_fwd.cuh's (the product on the tensor cores with the
// first k-chunks of A in registers, the gates in registers, the h
// exchange by st.async without a cluster barrier).
//
// Backward step: the gates recomputed from h_prev (BT x Hp, cp.async
// from out, prefetched a step ahead) with the same slice and mma; then
// dgates of the block's units; then its partial dh_prev = bf16(dgates)
// [:, its rows] . W[its rows, :] (BT x Hp, f32) on the tensor cores
// (W_slice^T read with ldmatrix.trans), whose fragments go straight to
// the owning block's receive buffer (slot r) through distributed shared
// memory. The next step sums the C slots of its own units in rank order
// (deterministic) after the cluster barrier, which the next step's gate
// product overlaps. db_hh is summed per thread, then per cluster in a
// fixed order; dW_hh is rnn_dw_kernel's.
//
// Numerics follow the plain PyTorch versions in
// medaka_tpu_torch/ops/lstm_train.py operation by operation: bf16 x bf16
// products are exact in f32 and the tensor cores' f32 accumulation rounds
// only the sums; sigmoid is 1 / (1 + expf(-v)) and tanh is tanhf in
// both; __fadd_rn/__fmul_rn/__fsub_rn keep nvcc from contracting sums and
// products into FMAs the plain versions do not do. What is left is the
// order of f32 sums (the recurrent products, dW_hh and db_hh), which can
// move a bf16 rounding. No atomics: a run repeats bit for bit.
#include "lstm_fwd.cuh"

namespace {

// rows of a slice: unit group q (UG units) holds rows q*32 + g*8 + u
constexpr int UG = LSTM_UG;
typedef LstmGeo Geo;

// ---------------------------------------------------------------------------
// backward recurrence: grid (clusters * C), cluster (C), block 32 * NG * NP
// ---------------------------------------------------------------------------

template <int NT>
__global__ void __launch_bounds__(CLUSTER_MAX_THREADS)
    lstm_bwd_kernel(const bf16* __restrict__ xp,
                    const bf16* __restrict__ h_out,
                    const float* __restrict__ c_out,
                    const float* __restrict__ dh_out,
                    const bf16* __restrict__ w_sl,
                    const float* __restrict__ b_hh,
                    const int* __restrict__ lengths, float* __restrict__ dxp,
                    bf16* __restrict__ dg_out, float* __restrict__ db_part,
                    int T, int B, int H, int C, int BT, int reverse) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const Geo g(H, C, BT);
  const int r = static_cast<int>(cluster.block_rank());
  const int cid = static_cast<int>(blockIdx.x) / C;
  const int b0 = cid * BT;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q = warp % g.NG;
  const int p = warp / g.NG;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int U = g.U;
  const int H4 = 4 * H;
  constexpr int CELLS = 2 * NT;

  bf16* w_s = reinterpret_cast<bf16*>(smem);  // [4U][ldw]
  bf16* h_s = reinterpret_cast<bf16*>(smem + g.w_bytes());  // [2][BT][ldw]
  bf16* dg_s = reinterpret_cast<bf16*>(smem + g.w_bytes() +
                                       g.h_bytes());  // [BT][ldg]
  // dh partials [2][C][U][BT]: slot s holds block s's partial for this
  // block's units
  float* recv = reinterpret_cast<float*>(smem + g.w_bytes() + g.h_bytes() +
                                         g.dg_bytes());
  const int slot = C * U * BT;

  load_slice(w_s, w_sl, g, r);
  for (int e = threadIdx.x; e < 2 * BT * g.ldw; e += blockDim.x)
    h_s[e] = __float2bfloat16_rn(0.0f);

  // walk opposite to the forward: t = T-1 .. 0 for a forward-direction
  // LSTM, t = 0 .. T-1 for a reverse one
  auto t_of = [&](int i) { return reverse ? i : T - 1 - i; };
  // the step before tt in the forward's order; out of range at the start
  auto prev_of = [&](int tt) { return reverse ? tt + 1 : tt - 1; };
  // h_prev of step i (all H units of the tile's columns) into h buffer buf
  const int h8 = H / 8;
  auto load_h = [&](int i, int buf) {
    const int tp = prev_of(t_of(i));
    const bool t_in = tp >= 0 && tp < T;
    bf16* dst = h_s + buf * BT * g.ldw;
    for (int e = threadIdx.x; e < BT * h8; e += blockDim.x) {
      const int n = e / h8;
      const int k8 = e - n * h8;
      const int b = b0 + n;
      const bool in = t_in && b < B;
      cp_async16(dst + n * g.ldw + k8 * 8,
                 in ? h_out + (static_cast<size_t>(tp) * B + b) * H + k8 * 8
                    : h_out,
                 in);
    }
    cp_async_commit();
  };

  const int ul = q * UG + gid;
  const int j = r * U + ul;
  const bool unit_in = j < H;
  float bh[4];
#pragma unroll
  for (int gt = 0; gt < 4; ++gt) bh[gt] = unit_in ? b_hh[gt * H + j] : 0.0f;
  int ncol[CELLS], len[CELLS];
  float dh_pass[CELLS], dc[CELLS];
#pragma unroll
  for (int ci = 0; ci < CELLS; ++ci) {
    ncol[ci] = (p * NT + ci / 2) * 8 + tig * 2 + ci % 2;
    const int b = b0 + ncol[ci];
    len[ci] = b < B ? lengths[b] : 0;
    dh_pass[ci] = 0.0f;
    dc[ci] = 0.0f;
  }
  float db_acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  // this thread's projections, upstream gradient and c_prev of step i
  bf16 xr[CELLS][4];
  float gup[CELLS], cprev[CELLS];
  auto load_x = [&](int i) {
    const int tt = t_of(i);
    const int tp = prev_of(tt);
    const bool p_in = tp >= 0 && tp < T;
#pragma unroll
    for (int ci = 0; ci < CELLS; ++ci) {
      const int b = b0 + ncol[ci];
      const bool in = unit_in && b < B;
      const size_t col = static_cast<size_t>(tt) * B + b;
#pragma unroll
      for (int gt = 0; gt < 4; ++gt)
        xr[ci][gt] = in ? xp[col * H4 + gt * H + j]
                        : __float2bfloat16_rn(0.0f);
      gup[ci] = in ? dh_out[col * H + j] : 0.0f;
      cprev[ci] = (in && p_in)
                      ? c_out[(static_cast<size_t>(tp) * B + b) * H + j]
                      : 0.0f;
    }
  };
  load_x(0);
  cluster.sync();  // every block running, its h buffers zero
  load_h(0, 0);

  for (int i = 0; i < T; ++i) {
    const int cur = i & 1;
    const int t = t_of(i);
    cp_async_wait_all();
    __syncthreads();  // h_prev of step i in h[cur]; dg_s free
    if (i + 1 < T) load_h(i + 1, cur ^ 1);

    float acc[2][NT][4] = {};
    gate_product(acc, w_s, h_s + cur * BT * g.ldw, g, q, p, lane);
    if (i > 0) cluster_wait();  // step i-1's dh partials received
    const float* rv = recv + ((i - 1) & 1) * slot;

#pragma unroll
    for (int ci = 0; ci < CELLS; ++ci) {
      const int n = ncol[ci];
      // dh = (sum of the C partials, in rank order) + dh (1 - valid)
      float dh = 0.0f;
      if (i > 0) {
        dh = rv[ul * BT + n];
        for (int s = 1; s < C; ++s)
          dh = __fadd_rn(dh, rv[(s * U + ul) * BT + n]);
      }
      dh = __fadd_rn(dh, dh_pass[ci]);
      const float c_prev = cprev[ci];
      const float dhv = __fadd_rn(dh, gup[ci]);
      float gate[4];
#pragma unroll
      for (int gt = 0; gt < 4; ++gt)
        gate[gt] = __fadd_rn(
            __fadd_rn(gate_acc<NT>(acc, gt, ci / 2, ci % 2), bh[gt]),
            __bfloat162float(xr[ci][gt]));
      const float gi = sigmoid_f(gate[0]);
      const float gf = sigmoid_f(gate[1]);
      const float gg = tanhf(gate[2]);
      const float go = sigmoid_f(gate[3]);
      const float c_t = __fadd_rn(__fmul_rn(gf, c_prev), __fmul_rn(gi, gg));
      const float th = tanhf(c_t);
      const float valid = t < len[ci] ? 1.0f : 0.0f;
      const float do_pre = __fmul_rn(__fmul_rn(__fmul_rn(dhv, th), go),
                                     __fsub_rn(1.0f, go));
      const float dc_tot = __fadd_rn(
          dc[ci], __fmul_rn(__fmul_rn(dhv, go),
                            __fsub_rn(1.0f, __fmul_rn(th, th))));
      const float di_pre = __fmul_rn(__fmul_rn(__fmul_rn(dc_tot, gg), gi),
                                     __fsub_rn(1.0f, gi));
      const float df_pre = __fmul_rn(__fmul_rn(__fmul_rn(dc_tot, c_prev), gf),
                                     __fsub_rn(1.0f, gf));
      const float dg_pre = __fmul_rn(__fmul_rn(dc_tot, gi),
                                     __fsub_rn(1.0f, __fmul_rn(gg, gg)));
      const float d[4] = {__fmul_rn(di_pre, valid), __fmul_rn(df_pre, valid),
                          __fmul_rn(dg_pre, valid), __fmul_rn(do_pre, valid)};
      const int b = b0 + n;
      const size_t row = (static_cast<size_t>(t) * B + b) * H4 + j;
#pragma unroll
      for (int gt = 0; gt < 4; ++gt) {
        const bf16 d16 = __float2bfloat16_rn(d[gt]);
        if (unit_in && b < B) {
          dxp[row + gt * H] = d[gt];
          dg_out[row + gt * H] = d16;
        }
        db_acc[gt] = __fadd_rn(db_acc[gt], d[gt]);
        dg_s[n * g.ldg + q * 32 + gt * 8 + gid] = d16;
      }
      dh_pass[ci] = __fmul_rn(dhv, __fsub_rn(1.0f, valid));
      dc[ci] = __fadd_rn(__fmul_rn(__fmul_rn(dc_tot, gf), valid),
                         __fmul_rn(dc[ci], __fsub_rn(1.0f, valid)));
    }
    __syncthreads();  // dg_s complete

    // partial dh_prev = bf16(dgates)[:, rows] . W[rows, :] for every unit
    // into the owners' receive buffers (not after the last step)
    if (i + 1 < T)
      dh_partials<NT>(cluster, recv + cur * slot, w_s, dg_s, g, r, q, p, lane);
    cluster_arrive();
    if (i + 1 < T) load_x(i + 1);
  }
  cluster_wait();  // every partial delivered; recv free for the db sums

  // db_hh of the cluster: each thread's sums over its columns and steps,
  // then over (p, tig) in a fixed order
  float* dbs = recv;  // [NP * 4][4U]
#pragma unroll
  for (int gt = 0; gt < 4; ++gt)
    dbs[(p * 4 + tig) * 4 * U + q * 32 + gt * 8 + gid] = db_acc[gt];
  __syncthreads();
  for (int row = threadIdx.x; row < 4 * U; row += blockDim.x) {
    float s = dbs[row];
    for (int k = 1; k < g.NP * 4; ++k) s = __fadd_rn(s, dbs[k * 4 * U + row]);
    const int jj = r * U + (row / 32) * UG + row % 8;
    const int gt = (row % 32) / 8;
    if (jj < H) db_part[static_cast<size_t>(cid) * H4 + gt * H + jj] = s;
  }
}

// ---------------------------------------------------------------------------
// launcher of the backward
// ---------------------------------------------------------------------------

template <typename Kern, typename... Args>
cudaError_t launch(Kern kern, const Geo& g, int B, size_t smem,
                   cudaStream_t stream, Args... args) {
  return launch_cluster(kern, g.C, (B + g.BT - 1) / g.BT, g.threads(), smem,
                        stream, args...);
}

}  // namespace

extern "C" {

size_t lstm_fwd_smem(int C, int BT, int H) {
  return lstm_fwd_smem_bytes(Geo(H, C, BT));
}

size_t lstm_bwd_smem(int C, int BT, int H) { return Geo(H, C, BT).bwd_smem(); }

// clusters of C blocks that can be resident at once for the forward
// (bwd = 0) or backward (bwd = 1) kernel at (C, BT, H); a negative value
// is minus a cudaError_t
int lstm_max_clusters(int bwd, int C, int BT, int H) {
  if (!bwd) return lstm_fwd_max_clusters(C, BT, H);
  if (Geo::bad(H, C, BT)) return -static_cast<int>(cudaErrorInvalidValue);
  const Geo g(H, C, BT);
  return g.NT == 2
             ? max_clusters(lstm_bwd_kernel<2>, C, g.threads(), g.bwd_smem())
             : max_clusters(lstm_bwd_kernel<1>, C, g.threads(), g.bwd_smem());
}

// one direction: out (T, B, H) bf16 and c_out (T, B, H) f32; w_sl (C, 4U,
// Hp) bf16 from ops/lstm_train.py w_slices
int lstm_fwd_launch(const void* xp, const void* w_sl, const float* b_hh,
                    const int* lengths, void* out, float* c_out, int T, int B,
                    int H, int C, int BT, int reverse, void* stream) {
  const bf16* const x[2] = {static_cast<const bf16*>(xp), nullptr};
  bf16* const o[2] = {static_cast<bf16*>(out), nullptr};
  float* const c[2] = {c_out, nullptr};
  return static_cast<int>(launch_lstm_fwd(x, w_sl, b_hh, lengths, o, c, T, B,
                                          H, C, BT, 1, reverse,
                                          static_cast<cudaStream_t>(stream)));
}

// the recurrence, the dW partial tiles and the fixed-order sums, in order
// on `stream`; dg (T, B, 4H) bf16, db_part (ceil(B / BT), 4H) f32 and
// dw_part (splits, 4H, H) f32 are scratch
int lstm_bwd_launch(const void* xp, const void* h_out, const float* c_out,
                    const float* dh_out, const void* w_sl, const float* b_hh,
                    const int* lengths, float* dxp, void* dg, float* db_part,
                    float* dw_part, float* dw, float* db, int T, int B, int H,
                    int C, int BT, int reverse, int splits, void* stream) {
  if (Geo::bad(H, C, BT) || T < 1 || B < 1 || splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geo g(H, C, BT);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* x = static_cast<const bf16*>(xp);
  const bf16* h = static_cast<const bf16*>(h_out);
  const bf16* w = static_cast<const bf16*>(w_sl);
  bf16* d = static_cast<bf16*>(dg);
  const cudaError_t e =
      g.NT == 2
          ? launch(lstm_bwd_kernel<2>, g, B, g.bwd_smem(), s, x, h, c_out,
                   dh_out, w, b_hh, lengths, dxp, d, db_part, T, B, H, C, BT,
                   reverse)
          : launch(lstm_bwd_kernel<1>, g, B, g.bwd_smem(), s, x, h, c_out,
                   dh_out, w, b_hh, lengths, dxp, d, db_part, T, B, H, C, BT,
                   reverse);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(launch_dw_reduce(dg, h_out, dw_part, db_part, dw,
                                           db, T, B, H, 4 * H, reverse,
                                           splits, (B + BT - 1) / BT, s));
}

const char* lstm_train_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
