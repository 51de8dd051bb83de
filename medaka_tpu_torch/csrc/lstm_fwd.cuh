// The LSTM forward recurrence on a thread-block cluster, shared by
// lstm_train.cu (lstm_fwd: one direction a launch, with the f32 cell
// states the backward needs) and bilstm.cu (bilstm_fused: both directions
// in one grid, no cell states).
//
// Per step (gate order i, f, g, o):
//   gates = f32(bf16(h) . W_hh_bf16^T) + b_hh + f32(x_proj[t])
//   c' = sigmoid(f) c + sigmoid(i) tanh(g);  h' = sigmoid(o) tanh(c')
// h and c are f32, start at 0 and are frozen where t >= length; out[t] =
// bf16(h) and, where c_out is given, c_out[t] = c (f32). `reverse` walks
// time back to front, outputs stay in natural order.
//
// A cluster of C blocks owns one direction and one tile of BT batch
// columns; every direction's clusters run in one grid (the cluster index
// gives the direction and the tile). Block r owns U = Hp / C hidden units
// (H padded to Hp with zero units) and keeps their 4U gate rows of W_hh,
// bf16, in its shared memory for the whole walk (rnn_train.cuh
// ClusterGeo; ops/rnn_cluster.py chooses C and BT on the host). Rows of a
// slice: warp unit group q (8 units) holds rows q*32 + g*8 + u (gate g,
// unit u), so in the m16n8k16 accumulator fragments of its two 16-row
// tiles a thread holds gates i, f, g and o of one unit for two batch
// columns: the gate nonlinearity and c stay in registers.
//
// A step: the product bf16(h) (BT x Hp) . W_slice^T on the tensor cores
// (mma.sync m16n8k16 bf16, f32 accumulation chained over the k-chunks in
// order; W_slice is the A operand, read with ldmatrix, and a block of at
// most 256 threads keeps the A fragments of its first LSTM_KREG k-chunks
// in registers for the whole walk, bf16(h) the B operand), then the
// gates, c and h of the warp's units; the warp's bf16 h goes through a
// staging buffer into every cluster block's next h buffer (st.async into
// distributed shared memory, each block waiting on its own mbarrier:
// rnn_train.cuh StepExchange) and, with c, to the outputs in 16-byte
// stores. No cluster barrier inside the step loop.
//
// Numerics: bf16 x bf16 products are exact in f32 and the tensor cores'
// f32 accumulation rounds only the sums; sigmoid is 1 / (1 + expf(-v))
// and tanh is tanhf; __fadd_rn/__fmul_rn keep nvcc from contracting sums
// and products into FMAs the plain versions do not do. What is left is
// the order of the f32 sums of the recurrent product. No atomics: a run
// repeats bit for bit.
#pragma once

#include "rnn_train.cuh"

namespace {

// rows of a slice: unit group q (LSTM_UG units) holds rows q*32 + g*8 + u
constexpr int LSTM_UG = 8;
typedef ClusterGeo<4, LSTM_UG> LstmGeo;
// units of a block at most: all of H = 128 in one block
constexpr int LSTM_MAX_U = 128;
// k-chunks of its W rows a warp keeps in registers where a block has at
// most 256 threads (2 x 4 registers a chunk)
constexpr int LSTM_KREG = 8;

// forward: W slice, h[2], staging of bf16 h [BT][U] and f32 c [BT][U],
// two mbarriers
__host__ __device__ inline size_t lstm_fwd_smem_bytes(const LstmGeo& g) {
  return g.w_bytes() + g.h_bytes() + g.st_bytes() +
         align16(static_cast<size_t>(g.BT) * g.U * sizeof(float)) + 16;
}

// per direction d < dirs: projections xp[d] (T, B, 4H) bf16, W_hh slices
// w_sl[d] (C, 4U, Hp) bf16 (ops/lstm_train.py w_slices), b_hh[d] (4H) f32,
// h (and, where c_out[d] is not null, c) of row (t, b) at
// out[d] + (t * B + b) * H
struct LstmArgs {
  const bf16* xp[2];
  const bf16* w_sl[2];
  const float* b_hh[2];
  bf16* out[2];
  float* c_out[2];
  int reverse[2];
  const int* lengths;  // (B,)
  int T, B, H, C, BT, dirs;
};

// gate g of the cell (nt, e) of a thread: rows u (i), u + 8 (f) of tile 0
// and u (g), u + 8 (o) of tile 1
template <int NT>
__device__ __forceinline__ float gate_acc(const float (&acc)[2][NT][4],
                                          int gate, int nt, int e) {
  return acc[gate >> 1][nt][(gate & 1) * 2 + e];
}

// grid (dirs * ceil(B / BT) * C), cluster (C), block 32 * NG * NP
// threads; KREG k-chunks of A in registers (0 or LSTM_KREG)
template <int NT, int KREG>
__global__ void __launch_bounds__(KREG ? 256 : CLUSTER_MAX_THREADS)
    lstm_fwd_kernel(LstmArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int T = a.T, B = a.B, H = a.H, C = a.C, BT = a.BT;
  const LstmGeo g(H, C, BT);
  const int r = static_cast<int>(cluster.block_rank());
  const int tiles = (B + BT - 1) / BT;
  const int cid = static_cast<int>(blockIdx.x) / C;
  const int d = cid / tiles;
  const int b0 = (cid - d * tiles) * BT;
  const bool reverse = pick(a.reverse, d) != 0;
  const bf16* xp = pick(a.xp, d);
  const float* b_hh = pick(a.b_hh, d);
  bf16* out = pick(a.out, d);
  float* c_out = pick(a.c_out, d);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q = warp % g.NG;
  const int p = warp / g.NG;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int U = g.U;
  const int H4 = 4 * H;
  const int ldb = g.ldw * static_cast<int>(sizeof(bf16));  // row bytes
  constexpr int CELLS = 2 * NT;

  bf16* w_s = reinterpret_cast<bf16*>(smem);  // [4U][ldw]
  bf16* h_s = reinterpret_cast<bf16*>(smem + g.w_bytes());  // [2][BT][ldw]
  // the block's h and c slices of a step, staged [BT][U]
  bf16* st_h = reinterpret_cast<bf16*>(smem + g.w_bytes() + g.h_bytes());
  float* st_c = reinterpret_cast<float*>(smem + g.w_bytes() + g.h_bytes() +
                                         g.st_bytes());
  const StepExchange xc{
      reinterpret_cast<uint64_t*>(
          smem + g.w_bytes() + g.h_bytes() + g.st_bytes() +
          align16(static_cast<size_t>(BT) * U * sizeof(float))),
      static_cast<uint32_t>(BT * g.Hp * sizeof(bf16)), T};

  load_slice(w_s, pick(a.w_sl, d), g, r);
  for (int e = threadIdx.x; e < 2 * BT * g.ldw; e += blockDim.x)
    h_s[e] = __float2bfloat16_rn(0.0f);
  xc.init();

  // this thread's cells: unit ul (block-local) for columns ncol[0..CELLS)
  const int ul = q * LSTM_UG + gid;
  const int j = r * U + ul;
  const bool unit_in = j < H;
  float bh[4];
#pragma unroll
  for (int gt = 0; gt < 4; ++gt) bh[gt] = unit_in ? b_hh[gt * H + j] : 0.0f;
  int ncol[CELLS], len[CELLS];
  float h[CELLS], c[CELLS];
#pragma unroll
  for (int ci = 0; ci < CELLS; ++ci) {
    ncol[ci] = (p * NT + ci / 2) * 8 + tig * 2 + ci % 2;
    const int b = b0 + ncol[ci];
    len[ci] = b < B ? a.lengths[b] : 0;
    h[ci] = 0.0f;
    c[ci] = 0.0f;
  }
  bf16 xr[CELLS][4];
  auto load_x = [&](int tt) {
#pragma unroll
    for (int ci = 0; ci < CELLS; ++ci) {
      const int b = b0 + ncol[ci];
      const bool in = unit_in && b < B;
      const size_t row = (static_cast<size_t>(tt) * B + b) * H4 + j;
#pragma unroll
      for (int gt = 0; gt < 4; ++gt)
        xr[ci][gt] = in ? xp[row + gt * H] : __float2bfloat16_rn(0.0f);
    }
  };
  load_x(reverse ? T - 1 : 0);
  cluster.sync();  // every block running, its W slice loaded, h zero

  const int nk = g.Hp / 16;
  const int n0 = p * NT * 8;  // the warp's first column
  uint32_t areg[KREG > 0 ? KREG : 1][2][4];
  if constexpr (KREG > 0) {
    const BF16Product<2, NT> p0(w_s, ldb, q * 2 * 16, h_s, ldb, n0, 0, lane);
#pragma unroll
    for (int ks = 0; ks < KREG; ++ks)
      if (ks < nk) p0.load_a(areg[ks], ks);
  }
  const uint32_t h_addr = smem_addr(h_s);

  for (int i = 0; i < T; ++i) {
    const int cur = i & 1;
    const int t = reverse ? T - 1 - i : i;
    if (i > 0) xc.wait(i);  // h[cur] complete in this block

    float acc[2][NT][4] = {};
    const BF16Product<2, NT> prod(w_s, ldb, q * 2 * 16,
                                  h_s + cur * BT * g.ldw, ldb, n0, 0, lane);
    if constexpr (KREG > 0) {
#pragma unroll
      for (int ks = 0; ks < KREG; ++ks)
        if (ks < nk) prod.mma(acc, areg[ks], ks);
    }
#pragma unroll 4
    for (int ks = KREG; ks < nk; ++ks) prod.step(acc, ks);

    __syncwarp();  // the warp's lanes have sent the last step's staging
#pragma unroll
    for (int ci = 0; ci < CELLS; ++ci) {
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
      const float cn = __fadd_rn(__fmul_rn(gf, c[ci]), __fmul_rn(gi, gg));
      const float hn = __fmul_rn(go, tanhf(cn));
      if (t < len[ci]) {
        h[ci] = hn;
        c[ci] = cn;
      }
      st_h[ncol[ci] * U + ul] = __float2bfloat16_rn(h[ci]);
      st_c[ncol[ci] * U + ul] = c[ci];
    }
    __syncwarp();  // the warp's h and c staged

    // the warp's 8 units of its NT * 8 columns (16 bytes of bf16 h a
    // column) into every cluster block's next h buffer (not after the last
    // step), h and c to the outputs, 16 bytes a store
    if (i + 1 < T) {
      const uint32_t dst0 = h_addr + (cur ^ 1) * BT * ldb +
                            (r * U + q * LSTM_UG) * sizeof(bf16);
      for (int e = lane; e < C * NT * 8; e += 32) {
        const int rank = e / (NT * 8);
        const int n = n0 + e - rank * NT * 8;
        st_async16(map_rank(dst0 + n * ldb, rank),
                   xc.remote_bar(cur ^ 1, rank),
                   *reinterpret_cast<const uint4*>(st_h + n * U +
                                                   q * LSTM_UG));
      }
    }
    const int j0 = r * U + q * LSTM_UG;
    if (lane < NT * 8) {
      const int n = n0 + lane;
      const int b = b0 + n;
      if (b < B && j0 < H)
        *reinterpret_cast<uint4*>(out + (static_cast<size_t>(t) * B + b) * H +
                                  j0) =
            *reinterpret_cast<const uint4*>(st_h + n * U + q * LSTM_UG);
    }
    if (c_out != nullptr && lane < NT * 16) {
      const int n = n0 + lane / 2;
      const int ch = lane % 2;
      const int b = b0 + n;
      if (b < B && j0 < H)
        *reinterpret_cast<float4*>(
            c_out + (static_cast<size_t>(t) * B + b) * H + j0 + ch * 4) =
            *reinterpret_cast<const float4*>(st_c + n * U + q * LSTM_UG +
                                             ch * 4);
    }
    if (i + 1 < T) load_x(reverse ? T - 2 - i : i + 1);
  }
  cluster.sync();  // no block leaves while another may still write to it
}

__host__ __device__ inline bool lstm_fwd_bad(int H, int C, int BT) {
  return LstmGeo::bad(H, C, BT, LSTM_MAX_U, CLUSTER_MAX_THREADS);
}

// the launch's kernel: A fragments in registers where a block has at
// most 256 threads
template <typename F>
cudaError_t with_lstm_fwd_kernel(const LstmGeo& g, F f) {
  if (g.threads() <= 256)
    return g.NT == 2 ? f(lstm_fwd_kernel<2, LSTM_KREG>)
                     : f(lstm_fwd_kernel<1, LSTM_KREG>);
  return g.NT == 2 ? f(lstm_fwd_kernel<2, 0>) : f(lstm_fwd_kernel<1, 0>);
}

// clusters of the LSTM forward that can be resident at once at (C, BT,
// H); a negative value is minus a cudaError_t
inline int lstm_fwd_max_clusters(int C, int BT, int H) {
  if (lstm_fwd_bad(H, C, BT)) return -static_cast<int>(cudaErrorInvalidValue);
  const LstmGeo g(H, C, BT);
  int n = 0;
  const cudaError_t e = with_lstm_fwd_kernel(g, [&](auto kern) {
    n = max_clusters(kern, C, g.threads(), lstm_fwd_smem_bytes(g));
    return cudaSuccess;
  });
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

// `dirs` directions of the LSTM forward on clusters of C blocks and tiles
// of BT columns. Direction d < dirs reads xp[d] (T, B, 4H) bf16, the W_hh
// slices w_sl + d C 4U Hp ((dirs, C, 4U, Hp) bf16, ops/lstm_train.py
// w_slices) and b_hh + d 4H ((dirs, 4H) f32) and writes out[d] (T, B, H)
// bf16 and, where c_out[d] is not null, c_out[d] (T, B, H) f32. One
// direction walks time back to front if `reverse`; two are the forward
// and the backward direction (reverse must be 0).
inline cudaError_t launch_lstm_fwd(const bf16* const (&xp)[2],
                                   const void* w_sl, const float* b_hh,
                                   const int* lengths, bf16* const (&out)[2],
                                   float* const (&c_out)[2], int T, int B,
                                   int H, int C, int BT, int dirs,
                                   int reverse, cudaStream_t s) {
  if (lstm_fwd_bad(H, C, BT) || T < 1 || B < 1 || dirs < 1 || dirs > 2 ||
      (dirs == 2 && reverse != 0))
    return cudaErrorInvalidValue;
  const LstmGeo g(H, C, BT);
  const bf16* w = static_cast<const bf16*>(w_sl);
  LstmArgs a{};
  for (int d = 0; d < 2; ++d) {
    a.xp[d] = xp[d];
    a.w_sl[d] = w + static_cast<size_t>(d) * C * g.rows() * g.Hp;
    a.b_hh[d] = b_hh + d * 4 * H;
    a.out[d] = out[d];
    a.c_out[d] = c_out[d];
  }
  a.reverse[0] = reverse != 0;
  a.reverse[1] = 1;
  a.lengths = lengths;
  a.T = T;
  a.B = B;
  a.H = H;
  a.C = C;
  a.BT = BT;
  a.dirs = dirs;
  const int clusters = dirs * ((B + BT - 1) / BT);
  return with_lstm_fwd_kernel(g, [&](auto kern) {
    return launch_cluster(kern, C, clusters, g.threads(), lstm_fwd_smem_bytes(g), s,
                          a);
  });
}

}  // namespace
