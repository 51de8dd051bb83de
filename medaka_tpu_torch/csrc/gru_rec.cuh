// The GRU forward recurrence over pre-projected inputs, shared by
// gru_train.cu (gru_fwd: one direction a launch) and gru_fullfused.cu
// (bigru_fullfused in each of its modes and bigru_fused: both directions
// in one launch): gru_cluster_fwd_kernel, started by launch_gru_cluster
// below over the caller's projections. A thread-block cluster of C blocks
// owns one direction and one tile of BT batch columns; every direction's
// clusters run in one grid (the cluster index gives the direction and the
// tile). Block r owns U = Hp / C hidden units and keeps their 3U gate rows
// of W_hh in its shared memory for the whole walk (ClusterGeo of
// rnn_train.cuh): bf16 rows of Hp + 8 values, int8 rows of Hp + 16 bytes
// with per-row scales, or, in the bf16-gates mode, bf16 rows of Hp + 16
// values, widened to f64 as they load. Rows of a slice: unit group q (16
// units) holds rows q*48 + g*16 + u (gate g of r, z, n, unit u), three
// m16 tiles, so in the mma accumulator fragments a thread holds r, z and n
// of units u and u + 8 for two batch columns of each n8 tile: the gates
// and the carry stay in registers. A step:
// - h (BT x Hp: bf16(h), or round(127 h) in int8) . W_slice^T on the
//   tensor cores: mma.sync m16n8k16 bf16 with f32 accumulation chained
//   over the Hp / 16 k-chunks in order, or m16n8k32 s8 with exact int32
//   sums in two chains, each warp keeping the A fragments of its first
//   GRU_KREG k-chunks in registers for the whole walk (a step then loads
//   only h and, in bf16 past Hp = 128, the rest of its W rows); in the
//   bf16-gates mode m16n8k16 f64 on the FP64 tensor cores, the k-chunks
//   split over the S warps of a (unit group, column tile) and their
//   partial sums added through shared memory in warp order;
// - the gates: the S warps (gru_gate_split: 4, 2 or 1) of a tile each run
//   the gates of 1 / S of its cells, so that a thread's serial gate
//   arithmetic is short;
// - each warp's h (bf16, or int8 round(127 h)) through a staging buffer
//   into every cluster block's next h buffer by st.async, completing its
//   bytes on that block's mbarrier (rnn_train.cuh StepExchange), and its
//   bf16 h to the outputs; a block waits on its own mbarrier for the next
//   step: no cluster barrier in the step loop.
// ops/rnn_cluster.py chooses C and BT on the host (GRU, GRU_BF16G,
// GRU_INT8). The forward direction freezes h at t >= length; the reverse
// one walks time back to front and keeps h = 0 until t < length, so padded
// columns stay 0. Outputs stay in natural time order.
//
// Numerics (NUM), per step with gate order r, z, n:
// - NUM_F32: hp = f32(bf16(h) . W_hh_bf16^T) + b_hh; r = sigmoid(x_r +
//   hp_r), z = sigmoid(x_z + hp_z), n = tanh(x_n + r hp_n), h' = (1 - z) n
//   + z h, carried in f32 (gru_pallas, bigru_pallas, the fullfused
//   kernel's default).
// - NUM_BF16G: bf16(hp), every gate op rounded to bf16, the exp(-|v|) /
//   exp(-2|v|) forms of sigmoid and tanh, the blend on bf16 h
//   (pallas_gru.py:539-558). The recurrent product is summed in f64 and
//   rounded once to f32: with h carried in bf16, a one-step difference of
//   bf16(hp) from another f32 summation order feeds back and grows over
//   the steps, so this mode's product is made independent of the order.
//   bf16 values widen to f64 exactly and a product of two is exact in f64;
//   a sum of Hp <= 512 of them is exact but in the rarest cases (products
//   whose exponents lie some 28 binades apart), so the FP64 tensor cores'
//   sums, in whatever order the k-chunks and warps add them, round to the
//   f32 the plain version gives.
// - NUM_INT8: an int8 W_hh with per-column scales, h quantised as
//   round(127 h) (half to even); int32 dot products (exact in any order),
//   hp = f32(dot) * scale + b_hh, then the f32 gates.
// They follow the plain PyTorch versions operation by operation: bf16 x
// bf16 products are exact in f32 and the tensor cores' f32 accumulation
// rounds only the sums; int8 dot products are exact;
// __fadd_rn/__fmul_rn/__fsub_rn/__fdiv_rn keep nvcc from contracting into
// FMAs the plain versions do not do. What is left is the order of the f32
// sums of NUM_F32's recurrent product, which can move a bf16 rounding of
// an output (the carry stays f32). No atomics: a run repeats bit for bit.
//
// What bounds the bf16-gates step on an H100: a block's share of the f64
// product, 3U x Hp x BT multiply-adds (at H = 256 on clusters of 16 and
// 8-column tiles 98,304, some 770 clocks of an SM's FP64 tensor cores),
// and the widening of its bf16 W slice to f64 as the fragments load (an
// f64 copy of the slice in shared memory, read as it is, was no faster on
// an H100: PERF.md), beside the exchange that every mode pays; hence the
// smallest share of the product a block can take (rnn_cluster.GRU_BF16G)
// and the k-chunks split over the tile's warps.
#pragma once

#include "rnn_train.cuh"

namespace {

constexpr int NUM_F32 = 0;    // bf16 W_hh, f32 gates
constexpr int NUM_BF16G = 1;  // bf16 W_hh, bf16 gates
constexpr int NUM_INT8 = 2;   // int8 W_hh (per-column scales), f32 gates

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// pallas_gru.py:545-549: e = exp(-|v|) <= 1, reconstructed by sign; every
// op rounded to bf16
__device__ __forceinline__ float sigmoid_bf16(float v) {
  const float e = bf16r(expf(-fabsf(v)));
  const float pos = bf16r(__fdiv_rn(1.0f, bf16r(__fadd_rn(1.0f, e))));
  return v >= 0.0f ? pos : bf16r(__fsub_rn(1.0f, pos));
}

// pallas_gru.py:551-556: e = exp(-2|v|) <= 1, sign-symmetric
__device__ __forceinline__ float tanh_bf16(float v) {
  const float e = bf16r(expf(bf16r(-2.0f * fabsf(v))));
  const float mag =
      bf16r(__fdiv_rn(bf16r(__fsub_rn(1.0f, e)), bf16r(__fadd_rn(1.0f, e))));
  return v >= 0.0f ? mag : -mag;
}

// One GRU update of one unit of one column; x* are the bf16 projections
// widened, h* the recurrent pre-activations with b_hh (bf16-rounded in
// NUM_BF16G).
template <int NUM>
__device__ __forceinline__ float gru_cell(float h, float xr, float xz,
                                          float xn, float hr, float hz,
                                          float hn) {
  if (NUM == NUM_BF16G) {
    const float r = sigmoid_bf16(bf16r(__fadd_rn(xr, hr)));
    const float z = sigmoid_bf16(bf16r(__fadd_rn(xz, hz)));
    const float n = tanh_bf16(bf16r(__fadd_rn(xn, bf16r(__fmul_rn(r, hn)))));
    const float hb = bf16r(h);
    return bf16r(__fadd_rn(bf16r(__fmul_rn(bf16r(__fsub_rn(1.0f, z)), n)),
                           bf16r(__fmul_rn(z, hb))));
  }
  const float r = sigmoid_f(__fadd_rn(xr, hr));
  const float z = sigmoid_f(__fadd_rn(xz, hz));
  const float n = tanhf(__fadd_rn(xn, __fmul_rn(r, hn)));
  return __fadd_rn(__fmul_rn(__fsub_rn(1.0f, z), n), __fmul_rn(z, h));
}

// rows of a slice: unit group q (GRU_UG units) holds rows q*48 + g*16 + u
constexpr int GRU_UG = 16;
typedef ClusterGeo<3, GRU_UG> GruGeo;
// threads of a block at most (255 registers a thread)
constexpr int GRU_MAX_THREADS = 256;
// k-chunks of its W rows a warp keeps in registers for the whole walk
// (3 x 4 registers a chunk): all of an int8 slice row up to Hp = 256, the
// first 128 columns of a bf16 one; the rest is read from shared memory
// on every step (f32 gates, int8)
constexpr int GRU_KREG = 8;
// units of a block at most in the bf16-gates mode: its step waits on the
// block's share of the f64 product
constexpr int GRU_BF16G_MAX_U = 32;

// units of a block at most in mode num (int8 rows are half as wide)
__host__ __device__ inline int gru_max_units(int num) {
  return num == NUM_INT8    ? 2 * CLUSTER_MAX_U
         : num == NUM_BF16G ? GRU_BF16G_MAX_U
                            : CLUSTER_MAX_U;
}

// warps that share a (unit group, column tile) of the forward: each runs
// the tile's whole product (f32 gates, int8) or 1 / S of its k-chunks
// (bf16 gates), and the gates of 1 / S of its cells (S = 2: units u or
// u + 8; S = 4: and every other column), so that a step's serial gate
// arithmetic is shorter; the most of 4, 2, 1 whose block stays within
// GRU_MAX_THREADS
__host__ __device__ inline int gru_gate_split(const GruGeo& g) {
  for (int s = 4; s > 1; s /= 2)
    if (g.threads() * s <= GRU_MAX_THREADS) return s;
  return 1;
}

__host__ __device__ inline int gru_fwd_threads(const GruGeo& g) {
  return g.threads() * gru_gate_split(g);
}

__host__ __device__ inline bool gru_cluster_bad(int num, int H, int C,
                                                int BT) {
  return (num != NUM_F32 && num != NUM_BF16G && num != NUM_INT8) ||
         GruGeo::bad(H, C, BT, gru_max_units(num), GRU_MAX_THREADS);
}

// bytes between two rows of the h buffers: bf16 Hp + 8 values, int8 Hp +
// 16 bytes (odd multiples of 16 bytes: ldmatrix without bank conflicts);
// bf16 Hp + 16 values in the bf16-gates mode, whose lanes read 8 bytes of
// each of 4 rows at once (32 bytes apart in the banks)
__host__ __device__ inline int gru_row_bytes(int num, const GruGeo& g) {
  return num == NUM_INT8    ? g.Hp + 16
         : num == NUM_BF16G ? 2 * g.Hp + 32
                            : 2 * g.ldw;
}

// the bf16-gates mode's partial sums: the f64 accumulators of each of the
// S warps of each (unit group, column tile), [S][NG NP][12 NT][32 lanes]
__host__ __device__ inline size_t gru_part_bytes(const GruGeo& g) {
  const int S = gru_gate_split(g);
  return S > 1 ? align16(static_cast<size_t>(S) * g.NG * g.NP * 12 * g.NT *
                         32 * sizeof(double))
               : 0;
}

// forward: W slice [3U][row], h [2][BT][row], (int8) the block's staged
// round(127 h) [BT][U], (bf16 gates) the partial sums, its staged bf16 h
// [BT][U], two mbarriers
__host__ __device__ inline size_t gru_cluster_fwd_smem(int num,
                                                       const GruGeo& g) {
  const size_t row = gru_row_bytes(num, g);
  return align16(g.rows() * row) + align16(2 * g.BT * row) +
         (num == NUM_INT8 ? align16(static_cast<size_t>(g.BT) * g.U) : 0) +
         (num == NUM_BF16G ? gru_part_bytes(g) : 0) + g.st_bytes() + 16;
}

// per direction d < dirs: projections xp[d] (T, B, 3H) bf16, W_hh slices
// w_sl[d] (C, 3U, Hp) (ops/rnn_cluster.py w_slices: bf16, or int8 in mode
// NUM_INT8), the int8 rows' scales hh_scale[d] (C, 3U) f32
// (rnn_cluster.row_slices; NUM_INT8 only), b_hh[d] (3H) f32, h of row
// (t, b) written at out[d] + (t * B + b) * ld_out
struct ClusterArgs {
  const bf16* xp[2];
  const void* w_sl[2];
  const float* hh_scale[2];
  const float* b_hh[2];
  bf16* out[2];
  int reverse[2];
  const int* lengths;  // (B,)
  int ld_out, T, B, H, C, BT, dirs;
};

// gate gt of cell (hh, c) of a thread: unit gid + 8 hh, column c of its
// 2 NT (n8 tile c / 2, element c % 2)
template <int NT, typename Acc>
__device__ __forceinline__ Acc gru_gate_acc(const Acc (&acc)[3][NT][4],
                                            int gt, int hh, int c) {
  return acc[gt][c / 2][hh * 2 + c % 2];
}

// the accumulator of mode NUM
template <int NUM>
struct GruAcc {
  typedef float type;
};
template <>
struct GruAcc<NUM_INT8> {
  typedef int type;
};
template <>
struct GruAcc<NUM_BF16G> {
  typedef double type;
};

template <int V>
struct IntC {
  static constexpr int value = V;
};

// f(IntC<s>()) for the warp's share s < S of its tile's cells
template <int S, typename F>
__device__ __forceinline__ void with_share(int s, F f) {
  if (s == 0) f(IntC<0>());
  if constexpr (S > 1) {
    if (s == 1) f(IntC<1>());
  }
  if constexpr (S > 2) {
    if (s == 2) f(IntC<2>());
    if (s == 3) f(IntC<3>());
  }
}

// The bf16-gates step's product, share s of S: acc[mt][nt] = W_s rows
// (row0 + mt * 16 ..) . h^T columns (n0 + nt * 8 ..) over the k-groups
// [s G / S, (s + 1) G / S) of the G = Hp / 16 (rnn_train.cuh F64Product:
// the bf16 W slice and bf16(h) widened exactly, f64 sums whose order does
// not matter).
template <int NT, int S>
__device__ __forceinline__ void f64_product(double (&acc)[3][NT][4],
                                            const unsigned char* w_s,
                                            int ldw, int row0,
                                            const unsigned char* h_s,
                                            int ldh, int n0, int Hp, int s,
                                            int lane) {
  const F64Product<3, NT> prod(w_s, ldw, row0, h_s, ldh, n0, 0, lane);
  const int groups = Hp / 16;
  const int j1 = (s + 1) * groups / S;
#pragma unroll 2
  for (int j = s * groups / S; j < j1; ++j) prod.step(acc, j);
}

template <int NUM, int NT, int S>
__global__ void __launch_bounds__(GRU_MAX_THREADS)
    gru_cluster_fwd_kernel(ClusterArgs a) {
  constexpr bool Q = NUM == NUM_INT8;
  // bf16 gates: the f64 product on the FP64 tensor cores
  constexpr bool F64 = NUM == NUM_BF16G;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int T = a.T, B = a.B, H = a.H, C = a.C, BT = a.BT;
  const GruGeo g(H, C, BT);
  const int r = static_cast<int>(cluster.block_rank());
  const int tiles = (B + BT - 1) / BT;
  const int cid = static_cast<int>(blockIdx.x) / C;
  const int d = cid / tiles;
  const int b0 = (cid - d * tiles) * BT;
  const bool reverse = pick(a.reverse, d) != 0;
  const bf16* xp = pick(a.xp, d);
  const float* b_hh = pick(a.b_hh, d);
  bf16* out = pick(a.out, d);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q = warp % g.NG;
  const int p = (warp / g.NG) % g.NP;
  const int share = warp / (g.NG * g.NP);
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int U = g.U;
  const int R = g.rows();
  const int H3 = 3 * H;
  constexpr int NC = 2 * NT;   // batch columns of a tile's thread
  constexpr int ESZ = Q ? 1 : 2;  // bytes of an h value
  const int ldb = gru_row_bytes(NUM, g);

  unsigned char* sp = smem;
  unsigned char* w_s = sp;  // [3U][ldb]
  sp += align16(static_cast<size_t>(R) * ldb);
  unsigned char* h_s = sp;  // [2][BT][ldb]
  sp += align16(static_cast<size_t>(2) * BT * ldb);
  int8_t* st8 = reinterpret_cast<int8_t*>(sp);  // [BT][U] (int8)
  if (Q) sp += align16(static_cast<size_t>(BT) * U);
  double* part = reinterpret_cast<double*>(sp);  // (bf16 gates)
  if (F64) sp += gru_part_bytes(g);
  bf16* st_h = reinterpret_cast<bf16*>(sp);  // [BT][U]
  sp += g.st_bytes();
  const StepExchange xc{reinterpret_cast<uint64_t*>(sp),
                        static_cast<uint32_t>(BT * g.Hp * ESZ), T};

  load_rows(w_s, ldb,
            static_cast<const unsigned char*>(pick(a.w_sl, d)) +
                static_cast<size_t>(r) * R * g.Hp * ESZ,
            g.Hp * ESZ, R);
  for (int e = threadIdx.x; e < 2 * BT * ldb / 16; e += blockDim.x)
    reinterpret_cast<uint4*>(h_s)[e] = make_uint4(0, 0, 0, 0);
  xc.init();

  // the tile's cells: units ul[hh] (block-local) for columns ncol[c]; a
  // warp computes those of its share (cell_of)
  int ul[2], j[2];
  bool unit_in[2];
  float bh[2][3], sc[2][3];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    ul[hh] = q * GRU_UG + gid + 8 * hh;
    j[hh] = r * U + ul[hh];
    unit_in[hh] = j[hh] < H;
#pragma unroll
    for (int gt = 0; gt < 3; ++gt) {
      bh[hh][gt] = unit_in[hh] ? b_hh[gt * H + j[hh]] : 0.0f;
      sc[hh][gt] = Q ? pick(a.hh_scale, d)[r * R + q * 3 * GRU_UG +
                                           gt * GRU_UG + gid + 8 * hh]
                     : 1.0f;
    }
  }
  int ncol[NC], len[NC];
  float h[2][NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    ncol[c] = (p * NT + c / 2) * 8 + tig * 2 + c % 2;
    const int b = b0 + ncol[c];
    len[c] = b < B ? a.lengths[b] : 0;
    h[0][c] = 0.0f;
    h[1][c] = 0.0f;
  }
  // share s of S: units hh in [H0, H0 + NH), columns c = C0, C0 + DC, ..
  auto cells = [&](auto sh, auto f) {
    constexpr int s = decltype(sh)::value;
    constexpr int NH = S == 1 ? 2 : 1;
    constexpr int H0 = S == 1 ? 0 : (S == 2 ? s : s >> 1);
    constexpr int C0 = S == 4 ? (s & 1) : 0;
    constexpr int DC = S == 4 ? 2 : 1;
#pragma unroll
    for (int hh = H0; hh < H0 + NH; ++hh)
#pragma unroll
      for (int c = C0; c < NC; c += DC) f(hh, c);
  };
  bf16 xr[2][NC][3];
  auto load_x = [&](auto sh, int tt) {
    cells(sh, [&](int hh, int c) {
      const int b = b0 + ncol[c];
      const bool in = unit_in[hh] && b < B;
      const size_t row = (static_cast<size_t>(tt) * B + b) * H3 + j[hh];
#pragma unroll
      for (int gt = 0; gt < 3; ++gt)
        xr[hh][c][gt] = in ? xp[row + gt * H] : __float2bfloat16_rn(0.0f);
    });
  };
  with_share<S>(share, [&](auto sh) { load_x(sh, reverse ? T - 1 : 0); });
  cluster.sync();  // every block running, its W slice loaded, h zero

  // the warp's A fragments of its first k-chunks, for the whole walk (f32
  // gates, int8)
  const int nk = Q ? g.Hp / 32 : g.Hp / 16;
  uint32_t areg[GRU_KREG][3][4];
  const int n0 = p * NT * 8;  // the tile's first column
  if constexpr (!F64) {
    const TileProduct<3, NT, Q> p0(w_s, ldb, q * 3 * GRU_UG, h_s, ldb, n0,
                                   0, lane);
#pragma unroll
    for (int ks = 0; ks < GRU_KREG; ++ks)
      if (ks < nk) p0.load_a(areg[ks], ks);
  }
  const uint32_t h_addr = smem_addr(h_s);
  // (bf16 gates) this warp's partial sums and the tile's
  const int tile = q * g.NP + p;
  double* part_tile = part + static_cast<size_t>(tile) * 12 * NT * 32 + lane;
  const int part_share = g.NG * g.NP * 12 * NT * 32;

  for (int i = 0; i < T; ++i) {
    const int cur = i & 1;
    const int t = reverse ? T - 1 - i : i;
    if (i > 0) xc.wait(i);  // h[cur] complete in this block

    // the step's product h . W_slice^T: int8 in two independent chains of
    // exact int32 sums; bf16 in one f32 chain over the k-chunks in order;
    // f64 (bf16 gates) over this warp's share of the k-chunks, then the
    // tile's S partial sums added in warp order, so that every warp of
    // the tile holds the same sums
    typedef typename GruAcc<NUM>::type Acc;
    Acc acc[3][NT][4] = {};
    if constexpr (F64) {
      f64_product<NT, S>(acc, w_s, ldb, q * 3 * GRU_UG,
                         h_s + cur * BT * ldb, ldb, n0, g.Hp, share, lane);
      if constexpr (S > 1) {
        double* mine = part_tile + share * part_share;
#pragma unroll
        for (int gt = 0; gt < 3; ++gt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              mine[((gt * NT + nt) * 4 + e) * 32] = acc[gt][nt][e];
        named_barrier(1 + tile, 32 * S);
#pragma unroll
        for (int gt = 0; gt < 3; ++gt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              double v = 0.0;
#pragma unroll
              for (int s2 = 0; s2 < S; ++s2)
                v += part_tile[s2 * part_share +
                               ((gt * NT + nt) * 4 + e) * 32];
              acc[gt][nt][e] = v;
            }
      }
    } else if constexpr (Q) {
      const TileProduct<3, NT, Q> prod(w_s, ldb, q * 3 * GRU_UG,
                                       h_s + cur * BT * ldb, ldb, n0, 0,
                                       lane);
      int acc2[3][NT][4] = {};
#pragma unroll
      for (int ks = 0; ks < GRU_KREG; ks += 2) {
        if (ks < nk) prod.mma(acc, areg[ks], ks);
        if (ks + 1 < nk) prod.mma(acc2, areg[ks + 1], ks + 1);
      }
      for (int ks = GRU_KREG; ks < nk; ks += 2) {
        prod.step(acc, ks);
        if (ks + 1 < nk) prod.step(acc2, ks + 1);
      }
#pragma unroll
      for (int gt = 0; gt < 3; ++gt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[gt][nt][e] += acc2[gt][nt][e];
    } else {
      const TileProduct<3, NT, Q> prod(w_s, ldb, q * 3 * GRU_UG,
                                       h_s + cur * BT * ldb, ldb, n0, 0,
                                       lane);
#pragma unroll
      for (int ks = 0; ks < GRU_KREG; ++ks)
        if (ks < nk) prod.mma(acc, areg[ks], ks);
#pragma unroll 4
      for (int ks = GRU_KREG; ks < nk; ++ks) prod.step(acc, ks);
    }

    with_share<S>(share, [&](auto sh) {
      constexpr int s = decltype(sh)::value;
      __syncwarp();  // the warp's lanes have sent the last step's staging
      cells(sh, [&](int hh, int c) {
        float hp[3];
#pragma unroll
        for (int gt = 0; gt < 3; ++gt) {
          const Acc v = gru_gate_acc<NT>(acc, gt, hh, c);
          if constexpr (F64)
            hp[gt] = bf16r(__fadd_rn(__double2float_rn(v), bh[hh][gt]));
          else if constexpr (Q)
            hp[gt] = __fadd_rn(__fmul_rn(static_cast<float>(v),
                                         sc[hh][gt]),
                               bh[hh][gt]);
          else
            hp[gt] = __fadd_rn(v, bh[hh][gt]);
        }
        const float h_new = gru_cell<NUM>(
            h[hh][c], __bfloat162float(xr[hh][c][0]),
            __bfloat162float(xr[hh][c][1]), __bfloat162float(xr[hh][c][2]),
            hp[0], hp[1], hp[2]);
        if (t < len[c]) h[hh][c] = h_new;
        st_h[ncol[c] * U + ul[hh]] = __float2bfloat16_rn(h[hh][c]);
        if constexpr (Q) {
          const int v = __float2int_rn(__fmul_rn(h[hh][c], 127.0f));
          st8[ncol[c] * U + ul[hh]] =
              static_cast<int8_t>(max(-128, min(127, v)));
        }
      });
      __syncwarp();  // the warp's h staged
      // the warp's units (16, or 8 where S > 1) of its columns into every
      // cluster block's next h buffer (not after the last step) and to
      // the outputs
      constexpr int UW = S == 1 ? 16 : 8;       // units a column
      constexpr int COLS = S == 4 ? NT * 4 : NT * 8;  // columns
      constexpr int U0 = S == 1 ? 0 : (S == 2 ? s : s >> 1) * 8;
      constexpr int CPC = UW * ESZ > 16 ? 2 : 1;  // stores a column
      auto col = [&](int m) {
        return n0 + (S == 4 ? 2 * m + (s & 1) : m);
      };
      const int u0 = q * GRU_UG + U0;
      if (i + 1 < T) {
        const uint32_t dst0 =
            h_addr + (cur ^ 1) * BT * ldb + (r * U + u0) * ESZ;
        for (int e = lane; e < C * COLS * CPC; e += 32) {
          const int rank = e / (COLS * CPC);
          const int rem = e - rank * COLS * CPC;
          const int n = col(rem / CPC);
          const int ch = rem % CPC;
          const uint32_t dst = map_rank(dst0 + n * ldb + ch * 16, rank);
          const uint32_t bar = xc.remote_bar(cur ^ 1, rank);
          if constexpr (Q && UW == 8)
            st_async8(dst, bar,
                      *reinterpret_cast<const uint2*>(st8 + n * U + u0));
          else if constexpr (Q)
            st_async16(dst, bar,
                       *reinterpret_cast<const uint4*>(st8 + n * U + u0));
          else
            st_async16(dst, bar,
                       *reinterpret_cast<const uint4*>(st_h + n * U + u0 +
                                                       ch * 8));
        }
      }
      constexpr int OPC = UW / 8;  // 16-byte output stores a column
      if (lane < COLS * OPC) {
        const int n = col(lane / OPC);
        const int ch = lane % OPC;
        const int b = b0 + n;
        const int j0 = r * U + u0 + ch * 8;
        if (b < B && j0 < H)
          *reinterpret_cast<uint4*>(
              out + (static_cast<size_t>(t) * B + b) * a.ld_out + j0) =
              *reinterpret_cast<const uint4*>(st_h + n * U + u0 + ch * 8);
      }
      if (i + 1 < T) load_x(sh, reverse ? T - 2 - i : i + 1);
    });
  }
  cluster.sync();  // no block leaves while another may still write to it
}

// f(kernel) for the kernel of geometry g in mode NUM
template <int NUM, typename F>
cudaError_t with_gru_fwd_kernel(const GruGeo& g, F f) {
  const int S = gru_gate_split(g);
  if (g.NT == 2)
    return S == 4   ? f(gru_cluster_fwd_kernel<NUM, 2, 4>)
           : S == 2 ? f(gru_cluster_fwd_kernel<NUM, 2, 2>)
                    : f(gru_cluster_fwd_kernel<NUM, 2, 1>);
  return S == 4   ? f(gru_cluster_fwd_kernel<NUM, 1, 4>)
         : S == 2 ? f(gru_cluster_fwd_kernel<NUM, 1, 2>)
                  : f(gru_cluster_fwd_kernel<NUM, 1, 1>);
}

// clusters of the cluster recurrence in mode NUM that can be resident at
// once at (C, BT, H); a negative value is minus a cudaError_t
template <int NUM>
int gru_cluster_fwd_max_clusters(int C, int BT, int H) {
  if (gru_cluster_bad(NUM, H, C, BT))
    return -static_cast<int>(cudaErrorInvalidValue);
  const GruGeo g(H, C, BT);
  int n = 0;
  const cudaError_t e = with_gru_fwd_kernel<NUM>(g, [&](auto kern) {
    n = max_clusters(kern, g.C, gru_fwd_threads(g),
                     gru_cluster_fwd_smem(NUM, g));
    return cudaSuccess;
  });
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

// Every cluster-recurrence launch (NUM_F32: gru_fwd, bigru_fused,
// bigru_fullfused's default; NUM_BF16G and NUM_INT8: bigru_fullfused's
// other modes): `dirs` directions on clusters of C blocks and tiles of BT
// columns. Direction d < dirs reads the projections xp[d] (T, B, 3H) bf16,
// the W_hh slices w_sl + d C 3U Hp ((dirs, C, 3U, Hp), bf16 or, in
// NUM_INT8, int8: ops/rnn_cluster.py w_slices), in NUM_INT8 their scales
// hh_scale + d C 3U ((dirs, C, 3U) f32, rnn_cluster.row_slices), and
// b_hh + d 3H ((dirs, 3H) f32) and writes h of row (t, b) at out[d] +
// (t B + b) ld_out. One direction walks time back to front if `reverse`;
// two are the forward and the backward direction (reverse must be 0).
template <int NUM>
cudaError_t launch_gru_cluster(const bf16* xp_f, const bf16* xp_b,
                               const void* w_sl, const float* hh_scale,
                               const float* b_hh, const int* lengths,
                               void* out_f, void* out_b, int ld_out, int T,
                               int B, int H, int C, int BT, int dirs,
                               int reverse, cudaStream_t s) {
  if (gru_cluster_bad(NUM, H, C, BT) || T < 1 || B < 1 || dirs < 1 ||
      dirs > 2 || (dirs == 2 && reverse != 0) ||
      (NUM == NUM_INT8 && hh_scale == nullptr))
    return cudaErrorInvalidValue;
  const GruGeo g(H, C, BT);
  const size_t per_dir = static_cast<size_t>(C) * g.rows();
  const unsigned char* w = static_cast<const unsigned char*>(w_sl);
  ClusterArgs a{};
  a.xp[0] = xp_f;
  a.xp[1] = xp_b;
  a.w_sl[0] = w;
  a.w_sl[1] = w + per_dir * g.Hp * (NUM == NUM_INT8 ? 1 : 2);
  a.hh_scale[0] = hh_scale;
  a.hh_scale[1] = hh_scale ? hh_scale + per_dir : nullptr;
  a.b_hh[0] = b_hh;
  a.b_hh[1] = b_hh + 3 * H;
  a.out[0] = static_cast<bf16*>(out_f);
  a.out[1] = static_cast<bf16*>(out_b);
  a.reverse[0] = reverse != 0;
  a.reverse[1] = 1;
  a.lengths = lengths;
  a.ld_out = ld_out;
  a.T = T;
  a.B = B;
  a.H = H;
  a.C = C;
  a.BT = BT;
  a.dirs = dirs;
  const int clusters = dirs * ((B + BT - 1) / BT);
  return with_gru_fwd_kernel<NUM>(g, [&](auto kern) {
    return launch_cluster(kern, C, clusters, gru_fwd_threads(g),
                          gru_cluster_fwd_smem(NUM, g), s, a);
  });
}

}  // namespace
