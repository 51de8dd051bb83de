// Split-path 2-layer bidirectional GRU + linear head, written for Hopper
// (sm_90a: thread-block clusters, distributed shared memory, mma.sync on
// the tensor cores) and bound to Python with ctypes through a plain C
// interface.
//
// gru_l1_split      replaces medaka_tpu/ops/pallas_gru.py
//                   _bigru_l1_split_t_kernel (mode "t") and
//                   _bigru_l1_split_kernel (mode "rows").
// gru_l2head_split  replaces medaka_tpu/ops/pallas_gru.py
//                   _bigru_l2head_t_kernel (mode "t") and
//                   _bigru_l2head_kernel (mode "rows").
//
// One design, the cluster recurrence, in both kinds of numerics: int8
// (quant, the default: gru_l1_split_s8_kernel, gru_l2head_split_s8_kernel)
// and bf16 (quant=False: gru_l1_split_bf16_kernel,
// gru_l2head_split_bf16_kernel), one template (split_cluster) whose S8
// flag sets the bytes of a weight and of an h value (WB = 1 or 2) and the
// step's product. A thread-block cluster of C blocks owns one direction
// and one tile of BT batch columns and walks all T steps; both
// directions' clusters run in one grid. Block r owns U = Hp / C hidden
// units (H padded to Hp with zero units) and keeps their 3U gate rows of
// every weight in its shared memory for the whole walk, in rows padded to
// an odd multiple of 16 bytes: W_hh (3U x Hp) and, in layer 2, W_ih (3U x
// 2H), int8 or bf16; layer 1's W_ih (3U x IN) is bf16 in both. No weight
// is read from L2 inside the step loop. Rows of a slice: unit group q (16
// units) holds rows q*48 + g*16 + u (gate g of r, z, n; unit u), so in
// the mma.sync m16n8k32 s8 accumulator fragments a thread holds r, z and
// n of units u and u + 8 for two batch columns of each n8 tile (two tiles
// a warp from 16 columns, one in bf16 layer 2); the f64 product gives a
// thread the same cells (rnn_train.cuh TileProduct, F64Product;
// ops/rnn_cluster.py SPLIT and SPLIT_BF16 choose C and BT on the host: C
// is the smallest cluster whose slices fit, 1 at H <= 256 in int8 layer 1
// at 10 inputs, so one __syncthreads a step and no cluster barrier there;
// 2 at 20 and 120 inputs, whose bf16 W_ih no longer fits beside W_hh in
// one block, and in bf16 layer 1 at H=256, 4 there up to 128 rows, whose
// blocks would leave SMs idle; 8 in bf16 layer 2 at H=256). The C entry
// points take the numerics as a flag (s8: int8, else bf16). A step: h
// (round(127 h) int8, or bf16; BT x Hp) . W_hh_slice^T on the tensor
// cores (int8: mma.sync m16n8k32 s8, exact int32 sums; bf16: m16n8k16 f64
// on the FP64 tensor cores over the bf16 slices and h widened as they
// load), the gates of the block's units in registers, h' into every
// cluster block's next h buffer (distributed shared memory, 16-byte
// stores; at C = 1 straight into the block's own), one split cluster
// barrier a step; a warp sends its units' h as soon as its gates are done.
// The input operand (layer 1: x; layer 2: [prev_f; prev_b]) comes by
// cp.async two steps ahead (bf16 layer 2: into its one buffer, a step
// ahead, which leaves room for twice the columns a block). Layer 1's input
// projection runs on the CUDA cores (int8: an f32 fmaf chain between the
// k-chunks of the step's recurrent product; bf16: a double fma chain
// before it); layer 2's (W_ih_slice . [prev_f; prev_b]: int8 one sum for
// each half, bf16 one f64 sum over both) runs for the next step between
// the barrier's arrive and its wait. Layer 2's head: W_head^T . bf16(h)
// over a block's units on the tensor cores (mma.sync m16n8k16, f32 sums;
// the m16 tiles of W_head^T are up to 64 classes: 5 haploid, 15 diploid,
// 49 run-length), then over the cluster's blocks in rank order, each block
// for its share of the columns: a run repeats bit for bit.
//
// bf16 layer 2 at H=384 and 512 does not fit a cluster: its W_hh and W_ih
// slices alone are 248,832 and 294,912 bytes a block at C=16. There
// gru_l2head_split_kernel, the per-block recurrence on the CUDA cores,
// runs it: one block owns one direction and a tile of BT = CPT * NQ
// columns and loops over all T steps itself; thread (j, q) owns hidden
// unit j for CPT columns; the bf16 W_hh and W_ih stream from L2,
// chunk-interleaved (chunk kc of row r at kc * 3H + r, 512 contiguous
// bytes for a warp), and its sums are double fma chains. ops/gru_split.py
// routes by shape.
//
// Numerics follow the TPU kernels operation by operation: int8 x int8 ->
// int32 products with per-row scales (exact in any order, so the tensor
// cores give the integers the CUDA cores' __dp4a gave), round-half-even
// (__float2int_rn) for round(127 h), bf16 roundings (__float2bfloat16_rn)
// where the TPU kernels cast, and __fmul_rn/__fadd_rn where a fused
// multiply-add would round differently from the plain PyTorch version in
// medaka_tpu_torch/ops/gru_split.py. Layer 1's f32 input projection in
// int8 keeps one fmaf chain over the features in order, so layer 1's
// outputs and layer 2's h do not depend on the design; only the order of
// the head's f32 sum over units does. In bf16 every product of the
// recurrence (W_hh h, layer 1's W_ih x, layer 2's W_ih [prev_f; prev_b]) is
// the TPU kernels' bf16 x bf16 dot (pallas_gru.py:1363-1364) summed
// exactly, in f64, and rounded once to f32, as the plain version sums it:
// the sum does not depend on the order, so the FP64 tensor cores, any
// split of k and the per-block kernel's chains all give the plain
// version's bits. (f32 sums in another order than the plain version's
// flip a bf16 rounding of h now and then, and through the recurrence that
// moved the random network's argmax in 0.1% of columns, past
// chip_smoke.py's bar of 0.01%: PERF.md.)
//
// What bounds it on an H100: a step is a (3H x K) x (K x BT) product with K
// = H (layer 1) or 3H (layer 2) and the serial chain of T dependent steps,
// not device memory (each byte of input and output crosses HBM once). In
// int8 the step's product reads the block's weight slices from shared
// memory through ldmatrix once (196,608 B at H = 256 in layer 1), which
// bounds layer 1's step at about 1 us; layer 2 adds the cluster barrier
// and the exchange. In bf16 the product runs at the FP64 tensor cores'
// rate (67 TFLOP/s, the CUDA cores' f32 rate), 3H K multiply-adds a column
// a step, and each bf16 value of the slices and of h is widened to f64 as
// it loads (a conversion the SM issues at 16 a clock): layer 1 at H = 256
// on clusters of 2 (196,608 B of W_hh a block), layer 2 on clusters of 8
// (147,456 B of W_hh and W_ih a block), in two waves at 480 rows: each
// block of a cluster holds the input of all its columns, so no geometry
// runs layer 2's 960 column-directions in one.
#include <type_traits>

#include "rnn_train.cuh"

namespace {

constexpr int MODE_T = 0;
constexpr int MODE_ROWS = 1;
// head widths of the l2 kernels: W_head^T is cut into m16 tiles of the
// mma.sync product, tile m holding classes 16 m .. 16 m + 15 (one tile for
// the haploid 5 and the diploid 15 classes, four for the run-length
// scheme's 49); the partial-logit slot holds the launch's class count
// rounded up to 8. The per-block bf16 layer 2 keeps W_head in registers
// up to 16 classes and reads it through L1 above that (head_regs)
constexpr int HEAD_MAX = 64;
__host__ __device__ constexpr int head_slot(int ncls) {
  return (ncls + 7) / 8 * 8;
}
__host__ __device__ constexpr int head_tiles(int ncls) {
  return (ncls + 15) / 16;
}
constexpr int head_regs(int ncls) {
  return ncls <= 8 ? 8 : ncls <= 16 ? 16 : HEAD_MAX;
}
constexpr size_t SMEM_LIMIT = 232448;  // dynamic shared memory of a block

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
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

// ---------------------------------------------------------------------------
// the cluster recurrence, int8 (S8) or bf16 weights and h (grid dirs *
// ceil(B / BT) * C, cluster C)
// ---------------------------------------------------------------------------

constexpr int SPLIT_UG = 16;      // units of a group: rows q*48 + g*16 + u
constexpr int SPLIT_MAX_U = 256;  // units of a block at most
constexpr int L1_THREADS = 512;   // threads of a block at most, layer 1
constexpr int L2_THREADS = 256;   // and layer 2 (its registers), and bf16
                                  // (a thread's f64 accumulators)
constexpr int L1_ROWC = 3;  // per-row constants: hh_scale, b_hh, b_ih
constexpr int L2_ROWC = 5;  // and the input scales of the two halves

typedef ClusterGeo<3, SPLIT_UG> SplitBase;

// The launch geometry of layer 1 (l2 false, IN features) or layer 2, with
// int8 (s8) or bf16 weights and h (WB = 1 or 2 bytes a value), and the
// carve-up of a block's shared memory, in this order: W_hh slice [3U][ldh],
// h [2][BT][ldh], the block's staged h [BT][U] (C > 1), W_ih (layer 1:
// [3U][INe] bf16; layer 2: [3U][ldi]), the input operand (layer 1: x
// [2][BT][INp] bf16; layer 2: [prev_f; prev_b] [NIN][BT][ldi]), and in layer
// 2 the head's operands, bf16(h) of the block's units [2][BT][U + 8] and
// the block's rows of W_head^T [16 HT][U + 8] bf16 (HT =
// head_tiles(ncls)), and (C > 1) the blocks' partial logits of the block's
// CR = ceil(BT / C) columns [2][C][CR][KS] f32, KS = head_slot(ncls).
// ops/rnn_cluster.py smem_bytes mirrors it.
struct SplitGeo : SplitBase {
  bool l2;
  int WB;   // bytes of a weight and of an h value: 1 (int8) or 2 (bf16)
  int NIN;  // layer 2's input buffers: 2 (int8), 1 (bf16: the bytes for
            // twice the columns; the copy then starts a step ahead)
  int IN;   // layer 1's features
  int INe;  // the same rounded up to even (W_ih rows of 32-bit pairs)
  int INp;  // the same padded to 8 (16 bytes of bf16)
  int ldh;  // padded row (bytes) of the W_hh slice and of h: WB Hp + 16
  int ldi;  // padded row (bytes) of the W_ih slice and the input: 2 WB H + 16
  int KS;   // layer 2: a column's partial logits in the slot
  int HT;   // layer 2: m16 tiles of W_head^T
  __host__ __device__ SplitGeo(bool l2_, bool s8, int H, int c, int bt,
                               int in, int ncls)
      : SplitBase(H, c, bt), l2(l2_), WB(s8 ? 1 : 2), NIN(s8 ? 2 : 1),
        IN(in),
        INe((in + 1) / 2 * 2), INp((in + 7) / 8 * 8), ldh(WB * Hp + 16),
        ldi(2 * WB * H + 16), KS(head_slot(ncls)), HT(head_tiles(ncls)) {
    if (!s8 && l2_) {
      // bf16 layer 2: one n8 tile of columns a warp, twice the warps of
      // two tiles (faster on an H100: PERF.md)
      NT = 1;
      NP = bt / 8;
    }
  }
  __host__ __device__ size_t whh_bytes() const {
    return align16(static_cast<size_t>(rows()) * ldh);
  }
  __host__ __device__ size_t hq_bytes() const {
    return align16(static_cast<size_t>(2) * BT * ldh);
  }
  __host__ __device__ size_t st_bytes() const {
    return C > 1 ? align16(static_cast<size_t>(BT) * U * WB) : 0;
  }
  __host__ __device__ size_t wih_bytes() const {
    return l2 ? align16(static_cast<size_t>(rows()) * ldi)
              : align16(static_cast<size_t>(rows()) * INe * sizeof(bf16));
  }
  __host__ __device__ size_t in_bytes() const {
    return l2 ? align16(static_cast<size_t>(NIN) * BT * ldi)
              : align16(static_cast<size_t>(2) * BT * INp * sizeof(bf16));
  }
  // layer 2: bf16(h) [2][BT][U + 8] and W_head^T [16 HT][U + 8]
  __host__ __device__ size_t head_bytes() const {
    return l2 ? align16(static_cast<size_t>(2 * BT + 16 * HT) * (U + 8) *
                        sizeof(bf16))
              : 0;
  }
  // columns of the logits a block of a cluster sums (C > 1)
  __host__ __device__ int CR() const { return (BT + C - 1) / C; }
  __host__ __device__ size_t slot_bytes() const {
    return l2 && C > 1 ? align16(static_cast<size_t>(2) * C * CR() * KS *
                                 sizeof(float))
                       : 0;
  }
  __host__ __device__ size_t smem() const {
    return whh_bytes() + hq_bytes() + st_bytes() + wih_bytes() +
           in_bytes() + head_bytes() + slot_bytes();
  }
  __host__ __device__ int max_threads() const {
    return l2 || WB == 2 ? L2_THREADS : L1_THREADS;
  }
  // a geometry the kernels cannot run
  __host__ __device__ static bool bad(bool l2, bool s8, int H, int c, int bt,
                                      int in, int ncls) {
    if (H % 32 != 0 || H <= 0 || H > 512) return true;
    if (c != 1 && c != 2 && c != 4 && c != 8 && c != 16) return true;
    if (bt != 8 && bt != 16 && bt != 32 && bt != 64) return true;
    if (!l2 && in < 1) return true;
    if (l2 && (ncls < 1 || ncls > HEAD_MAX)) return true;
    const SplitGeo g(l2, s8, H, c, bt, in, ncls);
    return g.U > SPLIT_MAX_U || g.threads() > g.max_threads() ||
           g.smem() > SMEM_LIMIT;
  }
};

// Both directions stacked along the first axis of every weight (fwd, bwd).
// Weights and h are int8 or bf16 as the kernel's S8 says.
struct SplitArgs {
  const void* w_hh;    // (2, C, 3U, Hp) slices (rnn_cluster w_slices)
  const float* rowc;   // (2, C, L*_ROWC, 3U) f32 per-row constants, same rows
  const int* lengths;  // (B,)
  const bf16* x;       // layer 1: (T, B, INp) bf16, features zero-padded
  const bf16* w_ih;    // layer 1: (2, C, 3U, INe) bf16, same rows
  void* out_f;         // layer 1: (T, B, H) round(127 h) int8 or bf16 h
  void* out_b;
  const void* prev_f;  // layer 2: (T, B, H), layer 1's outputs
  const void* prev_b;
  const void* w_in;    // layer 2: (2, C, 3U, 2H) slices
  const bf16* w_head;  // layer 2: (2, C, 16 HT, U) bf16 W_head^T rows
  float* lg_f;         // layer 2: (B, T, ncls) f32 logit partials
  float* lg_b;
  int T, B, H, IN, C, BT, ncls;
};

template <int NT, int MODE, bool L2, bool S8>
__device__ __forceinline__ void split_cluster(const SplitArgs& a) {
  extern __shared__ __align__(16) unsigned char smem[];
  // the step's sums: exact int32 (int8) or f64 (bf16) on the tensor cores
  typedef std::conditional_t<S8, int, double> Acc;
  typedef std::conditional_t<S8, S8Product<3, NT>, F64Product<3, NT>> Product;
  constexpr int WB = S8 ? 1 : 2;
  // the weight slices and h by the byte (int8: by the value)
  typedef std::conditional_t<S8, int8_t, unsigned char> B8;
  // layer 2's input buffers: two, filled two steps ahead, or (bf16) one,
  // filled a step ahead once every warp has read it
  constexpr int NIN = L2 && !S8 ? 1 : 2;
  cg::cluster_group cluster = cg::this_cluster();
  const int T = a.T, B = a.B, H = a.H, C = a.C, BT = a.BT;
  const SplitGeo g(L2, S8, H, C, BT, a.IN, a.ncls);
  const int r = static_cast<int>(cluster.block_rank());
  const int tiles = (B + BT - 1) / BT;
  const int cid = static_cast<int>(blockIdx.x) / C;
  const int d = cid / tiles;
  const int b0 = (cid - d * tiles) * BT;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q = warp % g.NG;
  const int p = warp / g.NG;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int U = g.U, R = g.rows(), ldh = g.ldh, ldi = g.ldi, INp = g.INp;
  const int nthr = blockDim.x;
  constexpr int NC = 2 * NT;  // batch columns of a thread
  constexpr int NROWC = L2 ? L2_ROWC : L1_ROWC;

  unsigned char* sp = smem;
  B8* whh_s = reinterpret_cast<B8*>(sp);
  sp += g.whh_bytes();
  B8* h_s = reinterpret_cast<B8*>(sp);
  sp += g.hq_bytes();
  B8* st_s = reinterpret_cast<B8*>(sp);
  sp += g.st_bytes();
  unsigned char* wih_s = sp;
  sp += g.wih_bytes();
  unsigned char* in_s = sp;
  sp += g.in_bytes();
  bf16* hb_s = reinterpret_cast<bf16*>(sp);  // [2][BT][U + 8]
  bf16* whd_s = hb_s + 2 * BT * (U + 8);      // [16 HT][U + 8]
  sp += g.head_bytes();
  float* slot_s = reinterpret_cast<float*>(sp);

  const size_t blk = static_cast<size_t>(d) * C + r;  // this block's slices
  load_rows(whh_s, ldh, static_cast<const B8*>(a.w_hh) + blk * R * g.Hp * WB,
            g.Hp * WB, R);
  if constexpr (L2) {
    load_rows(wih_s, ldi,
              static_cast<const unsigned char*>(a.w_in) +
                  blk * R * 2 * H * WB,
              2 * H * WB, R);
    load_rows(whd_s, (U + 8) * static_cast<int>(sizeof(bf16)),
              a.w_head + blk * 16 * g.HT * U,
              U * static_cast<int>(sizeof(bf16)), 16 * g.HT);
  }
  else
    load_rows(wih_s, 0, a.w_ih + blk * R * g.INe,
              R * g.INe * static_cast<int>(sizeof(bf16)), 1);
  for (int e = threadIdx.x; e < static_cast<int>(g.hq_bytes() / 16);
       e += nthr)
    reinterpret_cast<uint4*>(h_s)[e] = make_uint4(0, 0, 0, 0);

  // this thread's cells: units ul[hh] (block-local) for columns ncol[c]
  int ul[2], row[2][3];
  bool unit_in[2];
  float sc[2][3], bh[2][3], bi[2][3], sa[2][3], sb[2][3];
  const float* rc = a.rowc + blk * NROWC * R;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    ul[hh] = q * SPLIT_UG + gid + 8 * hh;
    unit_in[hh] = r * U + ul[hh] < H;
#pragma unroll
    for (int gt = 0; gt < 3; ++gt) {
      row[hh][gt] = q * 3 * SPLIT_UG + gt * SPLIT_UG + gid + 8 * hh;
      sc[hh][gt] = rc[row[hh][gt]];
      bh[hh][gt] = rc[R + row[hh][gt]];
      bi[hh][gt] = rc[2 * R + row[hh][gt]];
      sa[hh][gt] = L2 ? rc[3 * R + row[hh][gt]] : 0.0f;
      sb[hh][gt] = L2 ? rc[4 * R + row[hh][gt]] : 0.0f;
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

  // this thread's share of each per-step loop: (column, 16-byte chunk) of
  // the input copy and of the outputs, (column, class) of the logits
  const int in_cpc = L2 ? 2 * H * WB / 16 : INp / 8;  // chunks of a column
  const int u16 = U * WB / 16;  // 16-byte chunks of a column of the block's h
  const FlatWalk in_walk(threadIdx.x, nthr, in_cpc);
  const FlatWalk h_walk(threadIdx.x, nthr, u16);
  const FlatWalk head_walk(threadIdx.x, nthr, L2 ? a.ncls : 1);
  const int nwarps = nthr >> 5;

  // cp.async of step `step`'s input operand into buffer `buf`, zero for
  // columns past B
  auto issue = [&](int step, int buf) {
    const int tt = d == 0 ? step : T - 1 - step;
    FlatWalk w = in_walk;
    if constexpr (L2) {
      const int half = H * WB / 16;
      const unsigned char* pf = static_cast<const unsigned char*>(a.prev_f);
      const unsigned char* pb = static_cast<const unsigned char*>(a.prev_b);
      unsigned char* dst = in_s + buf * BT * ldi;
      const size_t t_off = static_cast<size_t>(tt) * B;
      for (; w.n < BT; w.next()) {
        const int b = b0 + w.n;
        const unsigned char* src = w.j < half ? pf : pb;
        cp_async16(dst + w.n * ldi + w.j * 16,
                   b < B ? src + (t_off + b) * H * WB +
                               (w.j < half ? w.j : w.j - half) * 16
                         : pf,
                   b < B);
      }
    } else {
      bf16* dst = reinterpret_cast<bf16*>(in_s) + buf * BT * INp;
      const size_t t_off = static_cast<size_t>(tt) * B;
      for (; w.n < BT; w.next()) {
        const int b = b0 + w.n;
        cp_async16(dst + w.n * INp + w.j * 8,
                   b < B ? a.x + (t_off + b) * INp + w.j * 8 : a.x, b < B);
      }
    }
    cp_async_commit();
  };

  // the input pre-activations xp of a step
  float xp[2][NC][3];
  // layer 2: xp of the step whose operand is in buffer `buf`, W_ih
  // [prev_f; prev_b]: in int8 one exact int32 sum for each half (k from 0
  // and from H), in bf16 one f64 sum over all 2H, rounded once
  auto project = [&](int buf) {
    const unsigned char* ib = in_s + buf * BT * ldi;
    if constexpr (!S8) {
      double acc_x[3][NT][4] = {};
      const Product prod(wih_s, ldi, q * 3 * SPLIT_UG, ib, ldi, p * NT * 8,
                         0, lane);
#pragma unroll 2
      for (int ks = 0; ks < 2 * H * WB / 32; ++ks) prod.step(acc_x, ks);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int gt = 0; gt < 3; ++gt) {
            const float v = __fadd_rn(
                __double2float_rn(acc_x[gt][c / 2][hh * 2 + c % 2]),
                bi[hh][gt]);
            xp[hh][c][gt] = MODE == MODE_ROWS ? bf16r(v) : v;
          }
    } else {
      Acc acc_a[3][NT][4] = {};
      Acc acc_b[3][NT][4] = {};
      const Product prod_a(wih_s, ldi, q * 3 * SPLIT_UG, ib, ldi, p * NT * 8,
                           0, lane);
      const Product prod_b(wih_s, ldi, q * 3 * SPLIT_UG, ib, ldi, p * NT * 8,
                           H * WB, lane);
#pragma unroll 2
      for (int ks = 0; ks < H * WB / 32; ++ks) {
        prod_a.step(acc_a, ks);
        prod_b.step(acc_b, ks);
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int gt = 0; gt < 3; ++gt) {
            const Acc va = acc_a[gt][c / 2][hh * 2 + c % 2];
            const Acc vb = acc_b[gt][c / 2][hh * 2 + c % 2];
            if (MODE == MODE_T) {
              // merged (3H, 2H) projection with one per-row scale
              xp[hh][c][gt] = __fadd_rn(
                  __fmul_rn(static_cast<float>(va + vb), sa[hh][gt]),
                  bi[hh][gt]);
            } else {
              const float pa =
                  __fmul_rn(static_cast<float>(va), sa[hh][gt]);
              const float pb =
                  __fmul_rn(static_cast<float>(vb), sb[hh][gt]);
              xp[hh][c][gt] =
                  bf16r(__fadd_rn(__fadd_rn(pa, pb), bi[hh][gt]));
            }
          }
    }
  };

  // layer 2 (C > 1): the logits of step `step` of this block's CR
  // columns from r CR on, the blocks' partials [buf][rank] summed in rank
  // order
  const int CR = g.CR();
  const int KS = g.KS;
  auto flush = [&](int step, int buf) {
    float* lg = d ? a.lg_b : a.lg_f;
    const int tt = d == 0 ? step : T - 1 - step;
    for (FlatWalk w = head_walk; w.n < CR; w.next()) {
      const int n = r * CR + w.n;
      float s = 0.0f;
      for (int rr = 0; rr < C; ++rr)
        s += slot_s[((buf * C + rr) * CR + w.n) * KS + w.j];
      if (n < BT && b0 + n < B)
        lg[(static_cast<size_t>(b0 + n) * T + tt) * a.ncls + w.j] = s;
    }
  };

  __syncthreads();  // h zeroed; no cp.async lands on a zeroing store
  issue(0, 0);
  if (NIN == 2 && T > 1) issue(1, 1);
  cp_async_wait_all();
  if (C > 1)
    cluster.sync();  // every block running, its h buffers zero
  else
    __syncthreads();
  if constexpr (L2) project(0);

  for (int i = 0; i < T; ++i) {
    const int cur = i & 1;
    const int nxt = cur ^ 1;
    const int t = d == 0 ? i : T - 1 - i;
    if (C > 1 && i > 0) cluster_wait();  // h[cur] complete in this block
    if constexpr (NIN == 1) {
      // one input buffer: every warp has run its product of this step's
      // operand (the last step's project); the next step's comes now
      __syncthreads();
      if (i + 1 < T) issue(i + 1, 0);
    }

    Acc acc[3][NT][4] = {};
    const Product rec(whh_s, ldh, q * 3 * SPLIT_UG, h_s + cur * BT * ldh, ldh,
                      p * NT * 8, 0, lane);
    if constexpr (L2) {
#pragma unroll 2
      for (int ks = 0; ks < g.Hp * WB / 32; ++ks) rec.step(acc, ks);
    } else if constexpr (!S8) {
      // bf16 layer 1: the input projection W_ih x of this step, one f64
      // sum over the features (a double fma chain on the CUDA cores: W_ih
      // rows of 10-120 values in m16n8k16 tiles of 16 would outgrow the
      // block's shared memory beside W_hh), rounded once, plus b_ih; then
      // the recurrent product (the chain between its k-chunks, as int8
      // runs it, was 9% slower at B=480 and 19-21% at 32-64 rows on an
      // H100: PERF.md)
      const bf16* xb = reinterpret_cast<const bf16*>(in_s) + cur * BT * INp;
      const bf16* w = reinterpret_cast<const bf16*>(wih_s);
      double pacc[2][NC][3] = {};
      for (int k = 0; k < a.IN; k += 2) {
        uint32_t wp[2][3], xq[NC];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int gt = 0; gt < 3; ++gt)
            wp[hh][gt] = *reinterpret_cast<const uint32_t*>(
                w + row[hh][gt] * g.INe + k);
#pragma unroll
        for (int c = 0; c < NC; ++c)
          xq[c] = *reinterpret_cast<const uint32_t*>(xb + ncol[c] * INp + k);
        // the pair's first feature, then its second where IN has it
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (e == 1 && k + 1 >= a.IN) break;
          double wv[2][3], xv[NC];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int gt = 0; gt < 3; ++gt)
              wv[hh][gt] = __uint_as_float(e ? wp[hh][gt] & 0xffff0000u
                                             : wp[hh][gt] << 16);
#pragma unroll
          for (int c = 0; c < NC; ++c)
            xv[c] = __uint_as_float(e ? xq[c] & 0xffff0000u : xq[c] << 16);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int c = 0; c < NC; ++c)
#pragma unroll
              for (int gt = 0; gt < 3; ++gt)
                pacc[hh][c][gt] = fma(wv[hh][gt], xv[c], pacc[hh][c][gt]);
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int gt = 0; gt < 3; ++gt) {
            const float v =
                __fadd_rn(__double2float_rn(pacc[hh][c][gt]), bi[hh][gt]);
            xp[hh][c][gt] = MODE == MODE_ROWS ? bf16r(v) : v;
          }
#pragma unroll 2
      for (int ks = 0; ks < g.Hp * WB / 32; ++ks) rec.step(acc, ks);
    } else {
      // int8 layer 1: the input projection W_ih x + b_ih of this step, one
      // f32 fmaf chain over the features in order, a pair of features
      // between each two k-chunks of the recurrent product (the CUDA
      // cores' work beside the tensor cores' shared-memory loads)
      const bf16* xb = reinterpret_cast<const bf16*>(in_s) + cur * BT * INp;
      const bf16* w = reinterpret_cast<const bf16*>(wih_s);
      float pacc[2][NC][3] = {};
      const int nk = g.Hp * WB / 32;  // 32-byte k-chunks of the product
      const int npair = (a.IN + 1) / 2;
      for (int ks = 0; ks < nk || ks < npair; ++ks) {
        if (ks < nk) rec.step(acc, ks);
        if (ks < npair) {
          const int k = 2 * ks;
          uint32_t wp[2][3], xq[NC];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int gt = 0; gt < 3; ++gt)
              wp[hh][gt] = *reinterpret_cast<const uint32_t*>(
                  w + row[hh][gt] * g.INe + k);
#pragma unroll
          for (int c = 0; c < NC; ++c)
            xq[c] = *reinterpret_cast<const uint32_t*>(xb + ncol[c] * INp + k);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int c = 0; c < NC; ++c)
#pragma unroll
              for (int gt = 0; gt < 3; ++gt)
                pacc[hh][c][gt] = fmaf(__uint_as_float(wp[hh][gt] << 16),
                                       __uint_as_float(xq[c] << 16),
                                       pacc[hh][c][gt]);
          if (k + 1 < a.IN) {
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
#pragma unroll
              for (int c = 0; c < NC; ++c)
#pragma unroll
                for (int gt = 0; gt < 3; ++gt)
                  pacc[hh][c][gt] =
                      fmaf(__uint_as_float(wp[hh][gt] & 0xffff0000u),
                           __uint_as_float(xq[c] & 0xffff0000u),
                           pacc[hh][c][gt]);
          }
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int gt = 0; gt < 3; ++gt) {
            const float v = __fadd_rn(pacc[hh][c][gt], bi[hh][gt]);
            xp[hh][c][gt] = MODE == MODE_ROWS ? bf16r(v) : v;
          }
    }

    // h' of the block's units (round(127 h') or bf16(h')): staged (C > 1)
    // or, at C = 1, straight into the next h buffer; layer 2 also stages
    // bf16(h') for the head
    B8* hq = C > 1 ? st_s : h_s + nxt * BT * ldh;
    const int ldq = C > 1 ? U * WB : ldh;  // bytes
    auto gate = [&](int hh, int c) {
      float hp[3];
#pragma unroll
      for (int gt = 0; gt < 3; ++gt) {
        const Acc v = acc[gt][c / 2][hh * 2 + c % 2];
        if constexpr (S8)
          hp[gt] = __fadd_rn(__fmul_rn(static_cast<float>(v), sc[hh][gt]),
                             bh[hh][gt]);
        else
          hp[gt] = __fadd_rn(__double2float_rn(v), bh[hh][gt]);
      }
      const float h_new = gru_update<S8, MODE>(
          h[hh][c], xp[hh][c][0], xp[hh][c][1], xp[hh][c][2], hp[0], hp[1],
          hp[2]);
      if (unit_in[hh] && t < len[c]) h[hh][c] = h_new;
      if constexpr (S8) {
        int v = __float2int_rn(__fmul_rn(h[hh][c], 127.0f));
        v = max(-128, min(127, v));
        hq[ncol[c] * ldq + ul[hh]] = static_cast<int8_t>(v);
      } else {
        *reinterpret_cast<bf16*>(hq + ncol[c] * ldq + ul[hh] * WB) =
            __float2bfloat16_rn(h[hh][c]);
      }
      if (L2)
        hb_s[(cur * BT + ncol[c]) * (U + 8) + ul[hh]] =
            __float2bfloat16_rn(h[hh][c]);
    };
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int c = 0; c < NC; ++c) gate(hh, c);
    if (C > 1 && i + 1 < T) {
      // the warp's 16 units of its NT * 8 columns (WB 16-byte chunks of
      // each staged column) into every cluster block's next h buffer
      __syncwarp();
      if constexpr (S8) {
        // one chunk a column; this form of the loop keeps the int8
        // kernels' code (with the bf16 loop's chunk index, int8 layer 1
        // ran 10% slower on an H100, layer 2 7% faster: PERF.md)
        B8* nb = h_s + nxt * BT * ldh + r * U + q * SPLIT_UG;
        for (int e = lane; e < C * NT * 8; e += 32) {
          const int dst_rank = e / (NT * 8);
          const int n = p * NT * 8 + e - dst_rank * NT * 8;
          *reinterpret_cast<uint4*>(cluster.map_shared_rank(nb, dst_rank) +
                                    n * ldh) =
              *reinterpret_cast<const uint4*>(st_s + n * U + q * SPLIT_UG);
        }
      } else {
        B8* nb = h_s + nxt * BT * ldh + (r * U + q * SPLIT_UG) * WB;
        for (int e = lane; e < C * NT * 8 * WB; e += 32) {
          const int dst_rank = e / (NT * 8 * WB);
          const int f = e - dst_rank * NT * 8 * WB;
          const int n = p * NT * 8 + f / WB;
          const int k = (f % WB) * 16;
          *reinterpret_cast<uint4*>(cluster.map_shared_rank(nb, dst_rank) +
                                    n * ldh + k) =
              *reinterpret_cast<const uint4*>(st_s + n * U * WB +
                                              q * SPLIT_UG * WB + k);
        }
      }
    }
    cp_async_wait_all();  // the operand of step i + 1 has landed
    __syncthreads();      // the block's h staged, the operand visible

    if constexpr (!L2) {
      // the block's units of h' to the outputs, 16 bytes a store
      B8* out = static_cast<B8*>(d ? a.out_b : a.out_f);
      for (FlatWalk w = h_walk; w.n < BT; w.next()) {
        const int j0 = r * U + w.j * 16 / WB;
        if (b0 + w.n < B && j0 < H)
          *reinterpret_cast<uint4*>(
              out + ((static_cast<size_t>(t) * B + b0 + w.n) * H + j0) * WB) =
              *reinterpret_cast<const uint4*>(hq + w.n * ldq + w.j * 16);
      }
    }
    if constexpr (L2) {
      // the block's head partial W_head^T (16 HT x U) . bf16(h)^T (U x BT)
      // on the tensor cores, f32 sums over the block's units in a fixed
      // order, a warp for each (m16 tile of classes, n8 tile of columns):
      // to the logits (C = 1) or to this block's slot at the rank that
      // sums the column
      float* lg = d ? a.lg_b : a.lg_f;
      const int ntiles = BT / 8;
      for (int job = warp; job < ntiles * g.HT; job += nwarps) {
        const int nt = job % ntiles;
        const int mt = job / ntiles;
        float hacc[4] = {};
        const int mat = lane >> 3;
        const int lrow = lane & 7;
        const uint32_t a_addr = smem_addr(
            whd_s + (mt * 16 + (mat & 1) * 8 + lrow) * (U + 8) +
            (mat >> 1) * 8);
        const uint32_t b_addr = smem_addr(
            hb_s + (cur * BT + nt * 8 + lrow) * (U + 8) + (mat & 1) * 8);
        for (int ks = 0; ks < U / 16; ++ks) {
          uint32_t am[4], bm[2];
          ldsm_x4(am, a_addr + ks * 32);
          ldsm_x2(bm, b_addr + ks * 32);
          mma_bf16(hacc, am, bm[0], bm[1]);
        }
        // classes 16 mt + gid (hacc[0..1]) and 16 mt + gid + 8
        // (hacc[2..3]) of columns nt * 8 + tig * 2 (+ 1)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int k = mt * 16 + gid + 8 * hi;
          if (k >= a.ncls) continue;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = nt * 8 + tig * 2 + e;
            if (C > 1)
              cluster.map_shared_rank(slot_s, n / CR)[
                  ((cur * C + r) * CR + n % CR) * KS + k] = hacc[2 * hi + e];
            else if (b0 + n < B)
              lg[(static_cast<size_t>(b0 + n) * T + t) * a.ncls + k] =
                  hacc[2 * hi + e];
          }
        }
      }
      if (C > 1 && i > 0) flush(i - 1, nxt);
    }
    if (C > 1) cluster_arrive();
    // the next steps' operands: cp.async two steps ahead (two buffers),
    // and (layer 2) the next step's input product while the cluster
    // barrier completes
    if (NIN == 2 && i + 2 < T) issue(i + 2, cur);
    if (L2 && i + 1 < T) project(NIN == 2 ? nxt : 0);
  }
  if (C > 1) {
    cluster_wait();  // no block leaves while another may still write to it
    if (L2) flush(T - 1, (T - 1) & 1);
  }
}

template <int NT, int MODE>
__global__ void __launch_bounds__(L1_THREADS)
    gru_l1_split_s8_kernel(SplitArgs a) {
  split_cluster<NT, MODE, false, true>(a);
}

template <int NT, int MODE>
__global__ void __launch_bounds__(L2_THREADS)
    gru_l2head_split_s8_kernel(SplitArgs a) {
  split_cluster<NT, MODE, true, true>(a);
}

template <int NT, int MODE>
__global__ void __launch_bounds__(L2_THREADS)
    gru_l1_split_bf16_kernel(SplitArgs a) {
  split_cluster<NT, MODE, false, false>(a);
}

template <int NT, int MODE>
__global__ void __launch_bounds__(L2_THREADS)
    gru_l2head_split_bf16_kernel(SplitArgs a) {
  split_cluster<NT, MODE, true, false>(a);
}

template <bool L2, bool S8, int MODE, int NT>
auto split_kernel() {
  if constexpr (L2 && S8)
    return gru_l2head_split_s8_kernel<NT, MODE>;
  else if constexpr (L2)
    return gru_l2head_split_bf16_kernel<NT, MODE>;
  else if constexpr (S8)
    return gru_l1_split_s8_kernel<NT, MODE>;
  else
    return gru_l1_split_bf16_kernel<NT, MODE>;
}

template <bool L2, bool S8, int MODE>
cudaError_t launch_split(const SplitArgs& a, cudaStream_t s) {
  if (a.T < 1 || a.B < 1 ||
      SplitGeo::bad(L2, S8, a.H, a.C, a.BT, a.IN, a.ncls))
    return cudaErrorInvalidValue;
  const SplitGeo g(L2, S8, a.H, a.C, a.BT, a.IN, a.ncls);
  const int clusters = 2 * ((a.B + a.BT - 1) / a.BT);
  constexpr int NT2 = S8 || !L2 ? 2 : 1;  // bf16 layer 2: one tile a warp
  return g.NT == 2
             ? launch_cluster(split_kernel<L2, S8, MODE, NT2>(), a.C, clusters,
                              g.threads(), g.smem(), s, a)
             : launch_cluster(split_kernel<L2, S8, MODE, 1>(), a.C, clusters,
                              g.threads(), g.smem(), s, a);
}

template <bool L2, bool S8, int MODE>
int split_max_clusters(int C, int BT, int H, int IN, int ncls) {
  if (SplitGeo::bad(L2, S8, H, C, BT, IN, ncls))
    return -static_cast<int>(cudaErrorInvalidValue);
  const SplitGeo g(L2, S8, H, C, BT, IN, ncls);
  constexpr int NT2 = S8 || !L2 ? 2 : 1;
  return g.NT == 2 ? max_clusters(split_kernel<L2, S8, MODE, NT2>(), C,
                                  g.threads(), g.smem())
                   : max_clusters(split_kernel<L2, S8, MODE, 1>(), C,
                                  g.threads(), g.smem());
}

template <bool S8>
int split_max(int layer2, int mode, int C, int BT, int H, int IN, int ncls) {
  if (layer2)
    return mode == MODE_T
               ? split_max_clusters<true, S8, MODE_T>(C, BT, H, IN, ncls)
               : split_max_clusters<true, S8, MODE_ROWS>(C, BT, H, IN, ncls);
  return mode == MODE_T
             ? split_max_clusters<false, S8, MODE_T>(C, BT, H, IN, ncls)
             : split_max_clusters<false, S8, MODE_ROWS>(C, BT, H, IN, ncls);
}

template <bool L2, bool S8>
int split_launch(const SplitArgs& a, int mode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(mode == MODE_T ? launch_split<L2, S8, MODE_T>(a, s)
                                         : launch_split<L2, S8, MODE_ROWS>(a, s));
}

SplitArgs l1_args(const void* x, const int* lengths, const void* w_ih,
                  const float* rowc, const void* w_hh, void* out_f,
                  void* out_b, int T, int B, int IN, int H, int C, int BT) {
  SplitArgs a{};
  a.w_hh = w_hh;
  a.rowc = rowc;
  a.lengths = lengths;
  a.x = static_cast<const bf16*>(x);
  a.w_ih = static_cast<const bf16*>(w_ih);
  a.out_f = out_f;
  a.out_b = out_b;
  a.T = T;
  a.B = B;
  a.H = H;
  a.IN = IN;
  a.C = C;
  a.BT = BT;
  return a;
}

SplitArgs l2_args(const void* prev_f, const void* prev_b, const int* lengths,
                  const void* w_in, const float* rowc, const void* w_hh,
                  const void* w_head, float* lg_f, float* lg_b, int T, int B,
                  int H, int ncls, int C, int BT) {
  SplitArgs a{};
  a.w_hh = w_hh;
  a.rowc = rowc;
  a.lengths = lengths;
  a.prev_f = prev_f;
  a.prev_b = prev_b;
  a.w_in = w_in;
  a.w_head = static_cast<const bf16*>(w_head);
  a.lg_f = lg_f;
  a.lg_b = lg_b;
  a.T = T;
  a.B = B;
  a.H = H;
  a.C = C;
  a.BT = BT;
  a.ncls = ncls;
  return a;
}

// ---------------------------------------------------------------------------
// bf16 layer 2 where no cluster holds its slices: the per-block recurrence
// on the CUDA cores
// ---------------------------------------------------------------------------

__device__ __forceinline__ double dot8_bf16(uint4 w, uint4 a, double acc) {
  const __nv_bfloat162* wp = reinterpret_cast<const __nv_bfloat162*>(&w);
  const __nv_bfloat162* ap = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const float2 wf = __bfloat1622float2(wp[p]);
    const float2 af = __bfloat1622float2(ap[p]);
    // bf16 x bf16 is exact in f64, and so is the sum but in the rarest
    // cases (F64Product), so its order does not matter
    acc = fma(static_cast<double>(wf.x), static_cast<double>(af.x), acc);
    acc = fma(static_cast<double>(wf.y), static_cast<double>(af.y), acc);
  }
  return acc;
}

// acc[g][cc] += W[g*H + j, k-range] . act[c0 + cc, k-range] for 16-byte
// chunks (8 values), in f64. W is chunk-interleaved: chunk kc of row r at
// w[kc * H3 + r], so a warp (32 consecutive j) reads 512 contiguous bytes.
// act rows are act_stride chunks apart; every lane of a warp reads the
// same act chunk.
template <int CPT>
__device__ __forceinline__ void dot_bf16(const uint4* __restrict__ w, int H3,
                                         int H, int j,
                                         const uint4* __restrict__ act,
                                         int act_stride, int c0, int nchunks,
                                         double (&acc)[3][CPT]) {
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

// Recurrent pre-activations hp = W_hh h + b_hh for one step.
template <int CPT>
__device__ __forceinline__ void recurrent(const uint4* wmat, int H, int j,
                                          const unsigned char* act, int c0,
                                          const float (&bh)[3],
                                          float (&hp)[3][CPT]) {
  double acc[3][CPT] = {};
  dot_bf16<CPT>(wmat, 3 * H, H, j, reinterpret_cast<const uint4*>(act), H / 8,
                c0, H / 8, acc);
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc)
      hp[g][cc] = __fadd_rn(__double2float_rn(acc[g][cc]), bh[g]);
}

size_t l2_smem_bytes(int BT, int H, int nthreads, int CPT, int KC) {
  return align16(2 * static_cast<size_t>(BT) * 2 * H * 2) +
         align16(2 * static_cast<size_t>(BT) * H * 2) +
         align16(2 * static_cast<size_t>(nthreads / 32) * CPT * KC *
                 sizeof(float));
}

// Layer 2 + head: prev_f, prev_b (T, B, H) bf16 -> lg_f, lg_b (B, T, C)
// f32 logit partials, C <= KC (head_regs(C)); up to 16 classes a thread
// keeps its unit's W_head column in registers, above that it reads it
// through L1 (56 registers of a 49-class head would spill). The layer-2 input
// projection runs here, per step, from the chunk-interleaved (2H/chunk,
// 3H) W_ih read through L2.
template <int CPT, int MODE, int KC>
__global__ void __launch_bounds__(512)
    gru_l2head_split_kernel(const void* __restrict__ prev_f,
                            const void* __restrict__ prev_b,
                            const int* __restrict__ lengths,
                            const void* __restrict__ w_in,
                            const float* __restrict__ b_ih,
                            const void* __restrict__ w_hh,
                            const float* __restrict__ b_hh,
                            const float* __restrict__ w_head, float* lg_f,
                            float* lg_b, int T, int B, int H, int C, int NQ) {
  extern __shared__ __align__(16) unsigned char smem[];
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
  const int kchunks = H / 8;  // 16-byte chunks per H values

  unsigned char* p = smem;
  unsigned char* in_s = p;  // [2][BT][2H] = [prev_f | prev_b] per column
  p += align16(2 * static_cast<size_t>(BT) * 2 * H * 2);
  unsigned char* act_s = p;  // [2][BT][H]
  p += align16(2 * static_cast<size_t>(BT) * H * 2);
  float* red_s = reinterpret_cast<float*>(p);  // [2][nwarps][CPT][KC]

  const uint4* wmat = static_cast<const uint4*>(w_hh) +
                      static_cast<size_t>(d) * kchunks * H3;
  const uint4* win_dir = static_cast<const uint4*>(w_in) +
                         static_cast<size_t>(d) * 2 * kchunks * H3;
  for (int i = tid; i < 2 * BT * H * 2; i += blockDim.x) act_s[i] = 0;

  float bh[3], bi[3];
#pragma unroll
  for (int g = 0; g < 3; ++g) {
    const int row = d * H3 + g * H + j;
    bh[g] = b_hh[row];
    bi[g] = b_ih[row];
  }
  constexpr bool WH_REGS = KC <= 16;
  float wh[WH_REGS ? KC : 1];
  if constexpr (WH_REGS) {
#pragma unroll
    for (int k = 0; k < KC; ++k)
      wh[k] = k < C ? w_head[(static_cast<size_t>(d) * C + k) * H + j] : 0.0f;
  }
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
  // thread tid sums the per-warp head partials of (column, class) pairs
  // e = tid, tid + blockDim.x, ..., column e / C, class e % C
  auto flush = [&](int step) {
    const int buf = step & 1;
    const int ts = d == 0 ? step : T - 1 - step;
    for (int e = tid; e < BT * C; e += blockDim.x) {
      const int fc = e / C;
      const int fk = e % C;
      const int q = fc / CPT;
      const int cc = fc % CPT;
      float s = 0.0f;
      for (int lw = 0; lw < wpq; ++lw)
        s += red_s[((buf * nwarps + q * wpq + lw) * CPT + cc) * KC + fk];
      if (b0 + fc < B) lg[(static_cast<size_t>(b0 + fc) * T + ts) * C + fk] = s;
    }
  };
  __syncthreads();

  for (int i = 0; i < T; ++i) {
    const int cur = i & 1;
    const int nxt = cur ^ 1;
    const int t = d == 0 ? i : T - 1 - i;
    if (i > 0) flush(i - 1);
    uint4 in_next = make_uint4(0, 0, 0, 0);
    if (il && i + 1 < T) in_next = load_in(d == 0 ? i + 1 : T - 2 - i);

    // input projection over [prev_f; prev_b], one f64 sum over all 2H
    float xp[3][CPT];
    const unsigned char* ins = in_s + cur * BT * 2 * H * 2;
    double acc_x[3][CPT] = {};
    dot_bf16<CPT>(win_dir, H3, H, j, reinterpret_cast<const uint4*>(ins),
                  col_chunks, c0, 2 * kchunks, acc_x);
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        xp[g][cc] = __fadd_rn(__double2float_rn(acc_x[g][cc]), bi[g]);
        if (MODE == MODE_ROWS) xp[g][cc] = bf16r(xp[g][cc]);
      }

    float hp[3][CPT];
    recurrent<CPT>(wmat, H, j, act_s + cur * BT * H * 2, c0, bh, hp);

    __nv_bfloat16* act_n =
        reinterpret_cast<__nv_bfloat16*>(act_s + nxt * BT * H * 2);
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) {
      const float hn = gru_update<false, MODE>(h[cc], xp[0][cc], xp[1][cc],
                                               xp[2][cc], hp[0][cc], hp[1][cc],
                                               hp[2][cc]);
      if (t < len[cc]) h[cc] = hn;
      act_n[(c0 + cc) * H + j] = __float2bfloat16_rn(h[cc]);
      // head partial: bf16(h) . W_head[:, j], reduced over the warp
      const float hb = bf16r(h[cc]);
      auto head = [&](int k, float wk) {
        float v = hb * wk;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane == 0) red_s[((cur * nwarps + warp) * CPT + cc) * KC + k] = v;
      };
      if constexpr (WH_REGS) {
#pragma unroll
        for (int k = 0; k < KC; ++k) {
          if (k >= C) break;
          head(k, wh[k]);
        }
      } else {
        // a loop, not unrolled: 64 unrolled classes spill at CPT = 4
        for (int k = 0; k < C; ++k)
          head(k, __ldg(&w_head[(static_cast<size_t>(d) * C + k) * H + j]));
      }
    }
    if (il) reinterpret_cast<uint4*>(in_s)[(nxt * BT + ic) * col_chunks + ik] =
        in_next;
    __syncthreads();
  }
  flush(T - 1);
}

template <int CPT, int MODE, int KC>
cudaError_t launch_l2(const void* prev_f, const void* prev_b,
                      const int* lengths, const void* w_in, const float* b_ih,
                      const void* w_hh, const float* b_hh,
                      const float* w_head, float* lg_f, float* lg_b, int T,
                      int B, int H, int C, int NQ, cudaStream_t stream) {
  const int BT = CPT * NQ;
  const size_t smem = l2_smem_bytes(BT, H, H * NQ, CPT, KC);
  auto kern = gru_l2head_split_kernel<CPT, MODE, KC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((B + BT - 1) / BT, 2);
  kern<<<grid, H * NQ, smem, stream>>>(prev_f, prev_b, lengths, w_in, b_ih,
                                       w_hh, b_hh, w_head, lg_f, lg_b, T, B,
                                       H, C, NQ);
  return cudaGetLastError();
}

template <int MODE, int KC, typename... Args>
cudaError_t dispatch_l2_cpt(int cpt, Args... args) {
  switch (cpt) {
    case 1: return launch_l2<1, MODE, KC>(args...);
    case 2: return launch_l2<2, MODE, KC>(args...);
    case 4: return launch_l2<4, MODE, KC>(args...);
    default: return cudaErrorInvalidValue;
  }
}

template <int MODE, typename... Args>
cudaError_t dispatch_l2(int cpt, int ncls, Args... args) {
  switch (head_regs(ncls)) {
    case 8: return dispatch_l2_cpt<MODE, 8>(cpt, args...);
    case 16: return dispatch_l2_cpt<MODE, 16>(cpt, args...);
    default: return dispatch_l2_cpt<MODE, HEAD_MAX>(cpt, args...);
  }
}

}  // namespace

extern "C" {

// --- the cluster recurrence: int8 (s8 != 0) or bf16 (quant=False) ---------

// dynamic shared memory of one block of layer 1 (layer2 = 0, IN features)
// or layer 2 (ncls classes) at (C, BT, H)
size_t gru_split_smem(int s8, int layer2, int C, int BT, int H, int IN,
                      int ncls) {
  return SplitGeo(layer2 != 0, s8 != 0, H, C, BT, IN, ncls).smem();
}

// clusters of C blocks that can be resident at once; a negative value is
// minus a cudaError_t (cudaErrorInvalidValue for a geometry the kernels
// cannot run)
int gru_split_max_clusters(int s8, int layer2, int mode, int C, int BT,
                           int H, int IN, int ncls) {
  return s8 ? split_max<true>(layer2, mode, C, BT, H, IN, ncls)
            : split_max<false>(layer2, mode, C, BT, H, IN, ncls);
}

// Layer 1: x (T, B, INp) bf16 (features zero-padded to a multiple of 8),
// w_ih (2, C, 3U, INe) bf16 (IN rounded up to even, zero-padded), rowc
// (2, C, 3, 3U) f32 (hh_scale, b_hh, b_ih), w_hh (2, C, 3U, Hp), in the
// slices' row order; out_f, out_b (T, B, H). w_hh and the outputs are
// int8 (s8: round(127 h)) or bf16 (h; hh_scale is not read).
int gru_l1_split_cluster_launch(int s8, const void* x, const int* lengths,
                                const void* w_ih, const float* rowc,
                                const void* w_hh, void* out_f, void* out_b,
                                int T, int B, int IN, int H, int C, int BT,
                                int mode, void* stream) {
  const SplitArgs a =
      l1_args(x, lengths, w_ih, rowc, w_hh, out_f, out_b, T, B, IN, H, C, BT);
  return s8 ? split_launch<false, true>(a, mode, stream)
            : split_launch<false, false>(a, mode, stream);
}

// Layer 2 + head: prev_f, prev_b (T, B, H), w_in (2, C, 3U, 2H), rowc (2,
// C, 5, 3U) f32 (hh_scale, b_hh, b_ih, the two halves' input scales), w_hh
// (2, C, 3U, Hp), w_head (2, C, 16 HT, U) bf16 (W_head^T of the block's
// units, classes past ncls zero); lg_f, lg_b (B, T, ncls) f32. The layer's
// input and weights are int8 (s8) or bf16 (the scales are not read).
int gru_l2head_split_cluster_launch(int s8, const void* prev_f,
                                    const void* prev_b, const int* lengths,
                                    const void* w_in, const float* rowc,
                                    const void* w_hh, const void* w_head,
                                    float* lg_f, float* lg_b, int T, int B,
                                    int H, int ncls, int C, int BT, int mode,
                                    void* stream) {
  const SplitArgs a = l2_args(prev_f, prev_b, lengths, w_in, rowc, w_hh,
                              w_head, lg_f, lg_b, T, B, H, ncls, C, BT);
  return s8 ? split_launch<true, true>(a, mode, stream)
            : split_launch<true, false>(a, mode, stream);
}

// --- bf16 layer 2 where no cluster holds its slices: the per-block kernel --

size_t gru_l2head_split_smem(int cpt, int nq, int hidden, int ncls) {
  return l2_smem_bytes(cpt * nq, hidden, hidden * nq, cpt, head_regs(ncls));
}

int gru_l2head_split_launch(const void* prev_f, const void* prev_b,
                            const int* lengths, const void* w_in,
                            const float* b_ih, const void* w_hh,
                            const float* b_hh, const float* w_head,
                            float* lg_f, float* lg_b, int T, int B, int H,
                            int C, int cpt, int nq, int mode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C < 1 || C > HEAD_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e =
      mode == MODE_T
          ? dispatch_l2<MODE_T>(cpt, C, prev_f, prev_b, lengths, w_in, b_ih,
                                w_hh, b_hh, w_head, lg_f, lg_b, T, B, H, C,
                                nq, s)
          : dispatch_l2<MODE_ROWS>(cpt, C, prev_f, prev_b, lengths, w_in,
                                   b_ih, w_hh, b_hh, w_head, lg_f, lg_b, T, B,
                                   H, C, nq, s);
  return static_cast<int>(e);
}

const char* gru_split_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
