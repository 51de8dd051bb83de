// One GRU direction over pre-projected inputs, forward and backward, for
// training; written for Hopper (sm_90a: thread-block clusters, distributed
// shared memory, mma.sync on the tensor cores) and bound to Python with
// ctypes through a plain C interface.
//
// gru_fwd  replaces medaka_tpu/ops/pallas_gru.py _gru_kernel (called by
//          gru_pallas): gru_rec.cuh's cluster recurrence
//          (gru_cluster_fwd_kernel through launch_gru_cluster, shared with
//          gru_fullfused.cu), one direction a launch, f32 gates.
// gru_bwd  replaces medaka_tpu/ops/pallas_gru.py _gru_bwd_kernel (called
//          by gru_bwd_pallas): three kernels launched in order on one
//          stream, gru_cluster_bwd_kernel (the recurrence), then
//          rnn_dw_kernel (dW_hh on the tensor cores) and
//          rnn_bwd_reduce_kernel (the fixed-order sums), which rnn_train.cuh
//          shares with lstm_train.cu.
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
// What bounds the forward on an H100, at B=128, T=1000, H=256: it moves
// 262 MB (0.078 ms at 3.35 TB/s) for 50 GFLOP (0.051 ms on the tensor
// cores), but each step needs the last one's h, so the time of one step
// bounds it. Each block of a cluster keeps the gate rows of its units in
// shared memory and runs the step's product on mma.sync, as the backward
// below does; a cluster owns one tile of columns, so at B=128 sixteen
// clusters of 4 blocks take 64 of the 132 SMs (one direction a launch).
//
// What bounds the backward on an H100, at B=128, T=1000, H=256: it moves
// 786 MB (0.235 ms at 3.35 TB/s) for 151 GFLOP (0.153 ms on the tensor
// cores), but it is a serial chain of T dependent steps, so the time of
// one step bounds it. Before this design that step was W_hh: the two bf16
// layouts a step needs (W_hh's rows for the recomputed gates, its columns
// for the dh product) are 786,432 B, more than three SMs' shared memory,
// and every block streamed both from L2 on every step into CUDA-core dot
// products, with two __syncthreads a step: 43.7 us a step.
//
// Design (the cluster recurrence of lstm_train.cu's backward, with the
// GRU's three gates). A thread-block cluster of C blocks owns one tile of
// BT batch columns and walks all T steps. Block r owns U = Hp / C hidden
// units and keeps their 3U gate rows of W_hh, bf16, in its shared memory
// for the whole walk (192 x 264 x 2 = 101,376 B at H=256, C=4); the one
// slice serves both products. Rows of a slice: unit group q (16 units)
// holds rows q*48 + g*16 + u (gate g, unit u), three m16 tiles, so in the
// m16n8k16 accumulator fragments a thread holds r, z and n of units u and
// u + 8 for two batch columns of each n8 tile. C and BT are chosen on the
// host (ops/rnn_cluster.py choose_geometry) from H, B and
// cudaOccupancyMaxActiveClusters.
//
// A step: the gates recomputed from h_prev (BT x Hp, cp.async from the
// forward's output, prefetched a step ahead: h_prev is an input, not the
// carry) with the slice on the tensor cores (mma.sync, W_slice read with
// ldmatrix), issued before the wait on the cluster barrier so that it
// overlaps it; hp_n stays apart from x_n (dr_pre needs it); then the
// dgates of the block's units, to dxp, to the bf16(dhp) scratch of
// rnn_dw_kernel and to a shared-memory tile; then the block's partial
// dh_prev = bf16(dhp)[:, its rows] . W[its rows, :] (BT x Hp, f32) on the
// tensor cores (W_slice^T read with ldmatrix.trans), whose fragments go
// straight to the owning block's receive buffer (slot r) through
// distributed shared memory. The next step sums the C slots of its own
// units in rank order after the cluster barrier (split into arrive.release
// / wait.acquire): no atomics, so a run repeats bit for bit. db_hh is
// summed per thread, then per cluster in a fixed order; dW_hh is
// rnn_dw_kernel's. Padded units (H to Hp) and padded columns stay exactly
// 0.
//
// Numerics follow the plain PyTorch versions in
// medaka_tpu_torch/ops/gru_train.py operation by operation: bf16 x bf16
// products are exact in f32 and the tensor cores' f32 accumulation rounds
// only the sums (the forward's h comes from the same mma.sync product
// order with which the backward recomputes the gates); sigmoid is
// 1 / (1 + expf(-v)) and tanh is tanhf in both; __fadd_rn/__fmul_rn/
// __fsub_rn keep nvcc from contracting sums and products into FMAs the
// plain versions do not do.
// What is left is the order of f32 sums (the recurrent products, dW_hh and
// db_hh), which can move a bf16 rounding.
#include "gru_rec.cuh"

namespace {

// ---------------------------------------------------------------------------
// backward recurrence: grid (ceil(B / BT) * C), cluster (C), block
// 32 * NG * NP threads
// ---------------------------------------------------------------------------

template <int NT>
__global__ void __launch_bounds__(GRU_MAX_THREADS)
    gru_cluster_bwd_kernel(const bf16* __restrict__ xp,
                           const bf16* __restrict__ h_out,
                           const float* __restrict__ dh_out,
                           const bf16* __restrict__ w_sl,
                           const float* __restrict__ b_hh,
                           const int* __restrict__ lengths,
                           float* __restrict__ dxp,
                           bf16* __restrict__ dhp_out,
                           float* __restrict__ db_part, int T, int B, int H,
                           int C, int BT, int reverse) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const GruGeo g(H, C, BT);
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
  const int H3 = 3 * H;
  constexpr int NC = 2 * NT;  // batch columns of a thread

  bf16* w_s = reinterpret_cast<bf16*>(smem);  // [3U][ldw]
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
  // GRU, t = 0 .. T-1 for a reverse one
  auto t_of = [&](int i) { return reverse ? i : T - 1 - i; };
  // the step before tt in the forward's order; out of range at the start
  auto prev_of = [&](int tt) { return reverse ? tt + 1 : tt - 1; };
  // h_prev of step i (all H units of the tile's columns) into h buffer buf;
  // units H .. Hp stay 0
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

  // this thread's cells: units ul[hh] (block-local) for columns ncol[c]
  int ul[2], j[2];
  bool unit_in[2];
  float bh[2][3];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    ul[hh] = q * GRU_UG + gid + 8 * hh;
    j[hh] = r * U + ul[hh];
    unit_in[hh] = j[hh] < H;
#pragma unroll
    for (int gt = 0; gt < 3; ++gt)
      bh[hh][gt] = unit_in[hh] ? b_hh[gt * H + j[hh]] : 0.0f;
  }
  int ncol[NC], len[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    ncol[c] = (p * NT + c / 2) * 8 + tig * 2 + c % 2;
    const int b = b0 + ncol[c];
    len[c] = b < B ? lengths[b] : 0;
  }
  // the carried dh's local terms, dh_eff z and dh (1 - v)
  float dh_z[2][NC], dh_pass[2][NC];
  float db_acc[2][3];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dh_z[hh][c] = 0.0f;
      dh_pass[hh][c] = 0.0f;
    }
#pragma unroll
    for (int gt = 0; gt < 3; ++gt) db_acc[hh][gt] = 0.0f;
  }
  // this thread's projections and upstream gradient of step i
  bf16 xr[2][NC][3];
  float gup[2][NC];
  auto load_x = [&](int i) {
    const int tt = t_of(i);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int b = b0 + ncol[c];
        const bool in = unit_in[hh] && b < B;
        const size_t col = static_cast<size_t>(tt) * B + b;
#pragma unroll
        for (int gt = 0; gt < 3; ++gt)
          xr[hh][c][gt] = in ? xp[col * H3 + gt * H + j[hh]]
                             : __float2bfloat16_rn(0.0f);
        gup[hh][c] = in ? dh_out[col * H + j[hh]] : 0.0f;
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

    const bf16* hb = h_s + cur * BT * g.ldw;
    float acc[3][NT][4] = {};
    gate_product(acc, w_s, hb, g, q, p, lane);
    if (i > 0) cluster_wait();  // step i-1's dh partials received
    const float* rv = recv + ((i - 1) & 1) * slot;

#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int n = ncol[c];
        // dh = dh_eff z + (sum of the C partials, in rank order)
        //      + dh (1 - valid)
        float prod = 0.0f;
        if (i > 0) {
          prod = rv[ul[hh] * BT + n];
          for (int s = 1; s < C; ++s)
            prod = __fadd_rn(prod, rv[(s * U + ul[hh]) * BT + n]);
        }
        const float dh =
            __fadd_rn(__fadd_rn(dh_z[hh][c], prod), dh_pass[hh][c]);
        const float dhv = __fadd_rn(dh, gup[hh][c]);
        const float h_prev = __bfloat162float(hb[n * g.ldw + j[hh]]);
        const float hr = __fadd_rn(gru_gate_acc<NT>(acc, 0, hh, c), bh[hh][0]);
        const float hz = __fadd_rn(gru_gate_acc<NT>(acc, 1, hh, c), bh[hh][1]);
        const float hn = __fadd_rn(gru_gate_acc<NT>(acc, 2, hh, c), bh[hh][2]);
        const float rg =
            sigmoid_f(__fadd_rn(__bfloat162float(xr[hh][c][0]), hr));
        const float z =
            sigmoid_f(__fadd_rn(__bfloat162float(xr[hh][c][1]), hz));
        const float ng = tanhf(
            __fadd_rn(__bfloat162float(xr[hh][c][2]), __fmul_rn(rg, hn)));
        const float valid = t < len[c] ? 1.0f : 0.0f;
        const float dh_eff = __fmul_rn(dhv, valid);
        const float dn = __fmul_rn(dh_eff, __fsub_rn(1.0f, z));
        const float dz = __fmul_rn(dh_eff, __fsub_rn(h_prev, ng));
        const float dn_pre = __fmul_rn(dn, __fsub_rn(1.0f, __fmul_rn(ng, ng)));
        const float dr = __fmul_rn(dn_pre, hn);
        const float dz_pre = __fmul_rn(__fmul_rn(dz, z), __fsub_rn(1.0f, z));
        const float dr_pre = __fmul_rn(__fmul_rn(dr, rg), __fsub_rn(1.0f, rg));
        const float dhp[3] = {dr_pre, dz_pre, __fmul_rn(dn_pre, rg)};
        const float dx[3] = {dr_pre, dz_pre, dn_pre};
        const int b = b0 + n;
        const size_t row = (static_cast<size_t>(t) * B + b) * H3 + j[hh];
#pragma unroll
        for (int gt = 0; gt < 3; ++gt) {
          const bf16 d16 = __float2bfloat16_rn(dhp[gt]);
          if (unit_in[hh] && b < B) {
            dxp[row + gt * H] = dx[gt];
            dhp_out[row + gt * H] = d16;
          }
          db_acc[hh][gt] = __fadd_rn(db_acc[hh][gt], dhp[gt]);
          dg_s[n * g.ldg + q * 48 + gt * GRU_UG + gid + 8 * hh] = d16;
        }
        dh_z[hh][c] = __fmul_rn(dh_eff, z);
        dh_pass[hh][c] = __fmul_rn(dhv, __fsub_rn(1.0f, valid));
      }
    __syncthreads();  // dg_s complete

    // partial dh_prev = bf16(dhp)[:, rows] . W[rows, :] for every unit into
    // the owners' receive buffers (not after the last step)
    if (i + 1 < T)
      dh_partials<NT>(cluster, recv + cur * slot, w_s, dg_s, g, r, q, p, lane);
    cluster_arrive();
    if (i + 1 < T) load_x(i + 1);
  }
  cluster_wait();  // every partial delivered; recv free for the db sums

  // db_hh of the cluster: each thread's sums over its columns and steps,
  // then over (p, tig) in a fixed order
  const int rows = 3 * U;
  float* dbs = recv;  // [NP * 4][3U]
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int gt = 0; gt < 3; ++gt)
      dbs[(p * 4 + tig) * rows + q * 48 + gt * GRU_UG + gid + 8 * hh] =
          db_acc[hh][gt];
  __syncthreads();
  for (int row = threadIdx.x; row < rows; row += blockDim.x) {
    float s = dbs[row];
    for (int k = 1; k < g.NP * 4; ++k) s = __fadd_rn(s, dbs[k * rows + row]);
    const int jj = r * U + (row / 48) * GRU_UG + row % GRU_UG;
    const int gt = (row % 48) / GRU_UG;
    if (jj < H) db_part[static_cast<size_t>(cid) * H3 + gt * H + jj] = s;
  }
}

}  // namespace

extern "C" {

size_t gru_fwd_cluster_smem(int C, int BT, int H) {
  return gru_cluster_fwd_smem(NUM_F32, GruGeo(H, C, BT));
}

// clusters of C blocks of the forward recurrence that can be resident at
// once at (C, BT, H); a negative value is minus a cudaError_t
int gru_fwd_max_clusters(int C, int BT, int H) {
  return gru_cluster_fwd_max_clusters<NUM_F32>(C, BT, H);
}

size_t gru_bwd_smem(int C, int BT, int H) { return GruGeo(H, C, BT).bwd_smem(); }

// clusters of C blocks of the backward recurrence that can be resident at
// once at (C, BT, H); a negative value is minus a cudaError_t
int gru_bwd_max_clusters(int C, int BT, int H) {
  if (GruGeo::bad(H, C, BT)) return -static_cast<int>(cudaErrorInvalidValue);
  const GruGeo g(H, C, BT);
  return g.NT == 2 ? max_clusters(gru_cluster_bwd_kernel<2>, C, g.threads(),
                                  g.bwd_smem())
                   : max_clusters(gru_cluster_bwd_kernel<1>, C, g.threads(),
                                  g.bwd_smem());
}

// one direction of the cluster recurrence on clusters of C blocks and
// tiles of BT columns; w_sl (C, 3U, Hp) bf16 from ops/rnn_cluster.py
// w_slices
int gru_fwd_launch(const void* xp, const void* w_sl, const float* b_hh,
                   const int* lengths, void* out, int T, int B, int H, int C,
                   int BT, int reverse, void* stream) {
  return static_cast<int>(launch_gru_cluster<NUM_F32>(
      static_cast<const bf16*>(xp), nullptr, w_sl, nullptr, b_hh,
      lengths, out, nullptr, H, T, B, H, C, BT, 1, reverse,
      static_cast<cudaStream_t>(stream)));
}

// the recurrence, the dW partial tiles and the fixed-order sums, in order
// on `stream`; w_sl (C, 3U, Hp) bf16 from ops/rnn_cluster.py w_slices;
// dhp (T, B, 3H) bf16, db_part (ceil(B / BT), 3H) f32 and dw_part
// (splits, 3H, H) f32 are scratch
int gru_bwd_launch(const void* xp, const void* h_out, const float* dh_out,
                   const void* w_sl, const float* b_hh, const int* lengths,
                   float* dxp, void* dhp, float* db_part, float* dw_part,
                   float* dw, float* db, int T, int B, int H, int C, int BT,
                   int reverse, int splits, void* stream) {
  if (GruGeo::bad(H, C, BT) || T < 1 || B < 1 || splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const GruGeo g(H, C, BT);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* x = static_cast<const bf16*>(xp);
  const bf16* h = static_cast<const bf16*>(h_out);
  const bf16* w = static_cast<const bf16*>(w_sl);
  bf16* d = static_cast<bf16*>(dhp);
  const int clusters = (B + BT - 1) / BT;
  const cudaError_t e =
      g.NT == 2
          ? launch_cluster(gru_cluster_bwd_kernel<2>, C, clusters,
                           g.threads(), g.bwd_smem(), s, x, h, dh_out, w,
                           b_hh, lengths, dxp, d, db_part, T, B, H, C, BT,
                           reverse)
          : launch_cluster(gru_cluster_bwd_kernel<1>, C, clusters,
                           g.threads(), g.bwd_smem(), s, x, h, dh_out, w,
                           b_hh, lengths, dxp, d, db_part, T, B, H, C, BT,
                           reverse);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(launch_dw_reduce(dhp, h_out, dw_part, db_part, dw,
                                           db, T, B, H, 3 * H, reverse,
                                           splits, clusters, s));
}

const char* gru_train_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
