// The GRU forward recurrences over pre-projected inputs, shared by
// gru_train.cu (gru_fwd: one direction a launch) and gru_fullfused.cu
// (bigru_fullfused, bigru_fused: both directions in one launch). Two
// designs, one for each kind of numerics:
//
// gru_cluster_fwd_kernel, the cluster recurrence: every f32-gates launch
// (gru_fwd, bigru_fused, bigru_fullfused's default mode), one or two
// directions (ClusterArgs.dirs) over the caller's projections, started by
// launch_gru_f32 below. A thread-block cluster of C blocks owns one
// direction and one tile of BT batch columns; every direction's clusters
// run in one grid (the cluster index gives the direction and the tile).
// Block r owns U = Hp / C hidden units and keeps their 3U gate rows of
// W_hh, bf16, in its shared memory for the whole walk (ClusterGeo of
// rnn_train.cuh; 192 x 264 x 2 = 101,376 B at H=256, C=4): all of W_hh is
// 393,216 B at H=256, more than one SM's shared memory. Rows of a slice:
// unit group q (16 units) holds rows q*48 + g*16 + u (gate g of r, z, n,
// unit u), three m16 tiles, so in the m16n8k16 accumulator fragments a
// thread holds r, z and n of units u and u + 8 for two batch columns of
// each n8 tile: the gates and the f32 carry stay in registers. A step:
// bf16(h) (BT x Hp) . W_slice^T on the tensor cores (mma.sync, f32
// accumulation chained over the Hp / 16 k-chunks in order), the f32 gates
// of the block's units, the block's bf16 h slice through a staging buffer
// into every cluster block's next h buffer (distributed shared memory,
// 16-byte stores) and to the outputs; one cluster barrier a step, split
// into arrive.release / wait.acquire so that the next step's projection
// loads overlap it. ops/rnn_cluster.py chooses C and BT on the host.
//
// gru_rec_kernel, the per-block recurrence (bigru_fullfused's bf16-gates
// and int8 modes only): the TPU kernels walk time blocks on a sequential
// grid with the carry in VMEM; here one block owns one direction
// (blockIdx.y) and a tile of BT = CPT * NQ batch columns and loops over
// all T steps itself; blocks never exchange state. Thread (j, q) owns
// hidden unit j (gate rows j, H+j, 2H+j) for columns q*CPT ..
// q*CPT+CPT-1, so a unit's three gates meet in one thread, h stays in
// registers, and a step needs one __syncthreads (the next step's matmul
// operand, bf16(h) or round(127 h), is double-buffered in shared memory).
// W_hh is read in 16-byte chunks (8 bf16 or 16 int8) laid out so that a
// warp of 32 consecutive units reads 512 contiguous bytes: chunk kc of row
// r at kc * 3H + r. It sits in dynamic shared memory where it fits (bf16
// up to H = 192, int8 up to H = 256: 196,608 B) and is read through the
// read-only cache from L2 on every step otherwise. Its sums are exact (f64
// for bf16 gates, int32 for int8), which the tensor cores do not give.
//
// Both designs: the forward direction freezes h at t >= length; the
// reverse one walks time back to front and keeps h = 0 until t < length,
// so padded columns stay 0. Outputs stay in natural time order.
//
// Numerics (NUM), per step with gate order r, z, n:
// - NUM_F32 (the cluster recurrence): hp = f32(bf16(h) . W_hh_bf16^T) +
//   b_hh; r = sigmoid(x_r + hp_r), z = sigmoid(x_z + hp_z),
//   n = tanh(x_n + r hp_n), h' = (1 - z) n + z h, carried in f32
//   (gru_pallas, bigru_pallas, the fullfused kernel's default).
// - NUM_BF16G: bf16(hp), every gate op rounded to bf16, the exp(-|v|) /
//   exp(-2|v|) forms of sigmoid and tanh, the blend on bf16 h
//   (pallas_gru.py:539-558). The recurrent product is summed in f64 and
//   rounded once to f32: with h carried in bf16, a one-step difference of
//   bf16(hp) from another f32 summation order feeds back and grows over
//   the steps, so this mode's product is made independent of the order.
// - NUM_INT8: an int8 W_hh with per-column scales, h quantised as
//   round(127 h) (half to even); int32 dot products by __dp4a,
//   hp = f32(dot) * scale + b_hh, then the f32 gates.
// They follow the plain PyTorch versions operation by operation: bf16 x
// bf16 products are exact in f32 and the tensor cores' f32 accumulation
// rounds only the sums; int8 dot products are exact;
// __fadd_rn/__fmul_rn/__fsub_rn/__fdiv_rn keep nvcc from contracting into
// FMAs the plain versions do not do. What is left is the order of the f32
// sums of NUM_F32's recurrent product, which can move a bf16 rounding of
// an output (the carry stays f32). Neither design uses atomics: a run
// repeats bit for bit.
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

// the 8 bf16 products of a pair of 16-byte chunks, summed in f64: the
// products are exact in f64 and a sum of H <= 512 of them is exact but in
// the rarest cases, so its one rounding to f32 does not depend on the
// order of the sum
__device__ __forceinline__ double dot8_bf16_f64(uint4 w, uint4 a,
                                                double acc) {
  const __nv_bfloat162* wp = reinterpret_cast<const __nv_bfloat162*>(&w);
  const __nv_bfloat162* ap = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const float2 wf = __bfloat1622float2(wp[p]);
    const float2 af = __bfloat1622float2(ap[p]);
    acc = fma(static_cast<double>(wf.x), static_cast<double>(af.x), acc);
    acc = fma(static_cast<double>(wf.y), static_cast<double>(af.y), acc);
  }
  return acc;
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

// bytes of one direction's W_hh (3H x H) in mode num
__host__ __device__ __forceinline__ size_t rec_w_bytes(int num, int H) {
  return static_cast<size_t>(3) * H * H * (num == NUM_INT8 ? 1 : 2);
}

inline size_t rec_smem_bytes(int num, bool w_smem, int BT, int H) {
  return (w_smem ? align16(rec_w_bytes(num, H)) : 0) +
         align16(2 * static_cast<size_t>(BT) * H * (num == NUM_INT8 ? 1 : 2));
}

// per direction d (blockIdx.y < dirs): projections xp[d] (T, B, 3H) bf16,
// W_hh chunks w_hh[d], scales hh_scale[d] (3H, NUM_INT8 only), b_hh[d]
// (3H) f32, h of row (t, b) written at out[d] + (t * B + b) * ld_out
struct RecArgs {
  const bf16* xp[2];
  const uint4* w_hh[2];
  const float* hh_scale[2];
  const float* b_hh[2];
  bf16* out[2];
  int reverse[2];
  const int* lengths;  // (B,)
  int ld_out, T, B, H, NQ, dirs;
};

// v[d] with d in {0, 1} without indexing the kernel's parameter array at
// run time (which would copy it to local memory)
template <typename V>
__device__ __forceinline__ V pick(const V (&v)[2], int d) {
  return d ? v[1] : v[0];
}

// grid (ceil(B / BT), dirs), block H * NQ threads; NUM_BF16G or NUM_INT8
template <int CPT, bool W_SMEM, int NUM>
__global__ void __launch_bounds__(512) gru_rec_kernel(RecArgs a) {
  static_assert(NUM == NUM_BF16G || NUM == NUM_INT8,
                "f32 gates run the cluster recurrence");
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool QUANT = NUM == NUM_INT8;
  constexpr int ESZ = QUANT ? 1 : 2;  // bytes of one matmul operand of h
  const int d = blockIdx.y;
  const bool reverse = pick(a.reverse, d) != 0;
  const int T = a.T, B = a.B, H = a.H;
  const int BT = CPT * a.NQ;
  const int b0 = blockIdx.x * BT;
  const int tid = threadIdx.x;
  const int j = tid % H;
  const int c0 = (tid / H) * CPT;
  const int H3 = 3 * H;
  const int kchunks = H * ESZ / 16;
  const size_t wchunks = static_cast<size_t>(kchunks) * H3;

  unsigned char* p = smem;
  uint4* w_s = reinterpret_cast<uint4*>(p);
  if (W_SMEM) p += align16(wchunks * 16);
  unsigned char* act_s = p;  // [2][BT][H] bf16(h) or int8 round(127 h)

  const uint4* w_dir = pick(a.w_hh, d);
  if (W_SMEM) {
    for (size_t i = tid; i < wchunks; i += blockDim.x) w_s[i] = w_dir[i];
  }
  const uint4* wmat = W_SMEM ? w_s : w_dir;
  for (int i = tid; i < 2 * BT * H * ESZ; i += blockDim.x) act_s[i] = 0;

  float bh[3], sc[3];
#pragma unroll
  for (int g = 0; g < 3; ++g) {
    bh[g] = pick(a.b_hh, d)[g * H + j];
    sc[g] = QUANT ? pick(a.hh_scale, d)[g * H + j] : 1.0f;
  }
  int len[CPT];
  float h[CPT];
#pragma unroll
  for (int cc = 0; cc < CPT; ++cc) {
    const int b = b0 + c0 + cc;
    len[cc] = b < B ? a.lengths[b] : 0;
    h[cc] = 0.0f;
  }
  const bf16* xp = pick(a.xp, d);
  bf16* out = pick(a.out, d);

  // this thread's projections of step tt: xp[tt, b, g*H + j]
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

    // recurrent pre-activations hp = W_hh h (+ scale) + b_hh
    float hp[3][CPT];
    const uint4* av =
        reinterpret_cast<const uint4*>(act_s + cur * BT * H * ESZ);
    if (QUANT) {
      int acc[3][CPT] = {};
      for (int kc = 0; kc < kchunks; ++kc) {
        uint4 w[3];
#pragma unroll
        for (int g = 0; g < 3; ++g)
          w[g] = load_w(wmat, static_cast<size_t>(kc) * H3 + g * H + j, W_SMEM);
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc) {
          const uint4 q = av[(c0 + cc) * kchunks + kc];
#pragma unroll
          for (int g = 0; g < 3; ++g) {
            acc[g][cc] = __dp4a(static_cast<int>(w[g].x), static_cast<int>(q.x), acc[g][cc]);
            acc[g][cc] = __dp4a(static_cast<int>(w[g].y), static_cast<int>(q.y), acc[g][cc]);
            acc[g][cc] = __dp4a(static_cast<int>(w[g].z), static_cast<int>(q.z), acc[g][cc]);
            acc[g][cc] = __dp4a(static_cast<int>(w[g].w), static_cast<int>(q.w), acc[g][cc]);
          }
        }
      }
#pragma unroll
      for (int g = 0; g < 3; ++g)
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc)
          hp[g][cc] = __fadd_rn(
              __fmul_rn(static_cast<float>(acc[g][cc]), sc[g]), bh[g]);
    } else {
      double acc[3][CPT] = {};
      for (int kc = 0; kc < kchunks; ++kc) {
        uint4 w[3];
#pragma unroll
        for (int g = 0; g < 3; ++g)
          w[g] = load_w(wmat, static_cast<size_t>(kc) * H3 + g * H + j, W_SMEM);
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc) {
          const uint4 hv = av[(c0 + cc) * kchunks + kc];
#pragma unroll
          for (int g = 0; g < 3; ++g) acc[g][cc] = dot8_bf16_f64(w[g], hv, acc[g][cc]);
        }
      }
#pragma unroll
      for (int g = 0; g < 3; ++g)
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc)
          hp[g][cc] = bf16r(__fadd_rn(__double2float_rn(acc[g][cc]), bh[g]));
    }

    unsigned char* act_n = act_s + (cur ^ 1) * BT * H * ESZ;
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) {
      const float h_new = gru_cell<NUM>(
          h[cc], __bfloat162float(x_cur[0][cc]),
          __bfloat162float(x_cur[1][cc]), __bfloat162float(x_cur[2][cc]),
          hp[0][cc], hp[1][cc], hp[2][cc]);
      if (t < len[cc]) h[cc] = h_new;
      const bf16 hb = __float2bfloat16_rn(h[cc]);
      const int c = c0 + cc;
      if (QUANT) {
        int q = __float2int_rn(__fmul_rn(h[cc], 127.0f));
        q = max(-128, min(127, q));
        act_n[c * H + j] = static_cast<unsigned char>(static_cast<int8_t>(q));
      } else {
        reinterpret_cast<bf16*>(act_n)[c * H + j] = hb;
      }
      const int b = b0 + c;
      if (b < B) out[(static_cast<size_t>(t) * B + b) * a.ld_out + j] = hb;
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

template <int CPT, bool W_SMEM, int NUM>
cudaError_t launch_rec(const RecArgs& a, cudaStream_t stream) {
  const int BT = CPT * a.NQ;
  const size_t smem = rec_smem_bytes(NUM, W_SMEM, BT, a.H);
  auto kern = gru_rec_kernel<CPT, W_SMEM, NUM>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.B + BT - 1) / BT, a.dirs);
  kern<<<grid, a.H * a.NQ, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool W_SMEM, int NUM>
cudaError_t dispatch_rec_cpt(int cpt, const RecArgs& a, cudaStream_t s) {
  switch (cpt) {
    case 1: return launch_rec<1, W_SMEM, NUM>(a, s);
    case 2: return launch_rec<2, W_SMEM, NUM>(a, s);
    case 4: return launch_rec<4, W_SMEM, NUM>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

// the per-block recurrence in mode NUM (NUM_BF16G or NUM_INT8) over a
// tile of cpt * a.NQ columns, W_hh in shared memory (w_smem) or read from
// L2
template <int NUM>
cudaError_t dispatch_rec(int cpt, int w_smem, const RecArgs& a,
                         cudaStream_t s) {
  if (a.T < 1 || a.B < 1 || a.dirs < 1 || a.dirs > 2 || bad_shape(a.H, a.NQ))
    return cudaErrorInvalidValue;
  return w_smem ? dispatch_rec_cpt<true, NUM>(cpt, a, s)
                : dispatch_rec_cpt<false, NUM>(cpt, a, s);
}

// ---------------------------------------------------------------------------
// the cluster recurrence (f32 gates): grid (dirs * ceil(B / BT) * C),
// cluster (C), block 32 * NG * NP threads
// ---------------------------------------------------------------------------

// rows of a slice: unit group q (GRU_UG units) holds rows q*48 + g*16 + u
constexpr int GRU_UG = 16;
typedef ClusterGeo<3, GRU_UG> GruGeo;
// threads of a block at most: a warp for each of at most 4 unit groups
// and 8 or 16 columns, twice for 32 columns (255 registers a thread)
constexpr int GRU_MAX_THREADS = 32 * (CLUSTER_MAX_U / GRU_UG) * 2;

// forward: W slice, h[2], staging of the block's bf16 h [BT][U]
__host__ __device__ inline size_t gru_cluster_fwd_smem(const GruGeo& g) {
  return g.w_bytes() + g.h_bytes() + g.st_bytes();
}

// per direction d < dirs: projections xp[d] (T, B, 3H) bf16, W_hh slices
// w_sl[d] (C, 3U, Hp) bf16 (ops/rnn_cluster.py w_slices), b_hh[d] (3H)
// f32, h of row (t, b) written at out[d] + (t * B + b) * ld_out
struct ClusterArgs {
  const bf16* xp[2];
  const bf16* w_sl[2];
  const float* b_hh[2];
  bf16* out[2];
  int reverse[2];
  const int* lengths;  // (B,)
  int ld_out, T, B, H, C, BT, dirs;
};

// gate gt of cell (hh, c) of a thread: unit gid + 8 hh, column c of its
// 2 NT (n8 tile c / 2, element c % 2)
template <int NT>
__device__ __forceinline__ float gru_gate_acc(const float (&acc)[3][NT][4],
                                              int gt, int hh, int c) {
  return acc[gt][c / 2][hh * 2 + c % 2];
}

template <int NT>
__global__ void __launch_bounds__(GRU_MAX_THREADS)
    gru_cluster_fwd_kernel(ClusterArgs a) {
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
  const int p = warp / g.NG;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int U = g.U;
  const int H3 = 3 * H;
  constexpr int NC = 2 * NT;  // batch columns of a thread

  bf16* w_s = reinterpret_cast<bf16*>(smem);  // [3U][ldw]
  bf16* h_s = reinterpret_cast<bf16*>(smem + g.w_bytes());  // [2][BT][ldw]
  // the block's h slice of a step, staged [BT][U]
  bf16* st_h = reinterpret_cast<bf16*>(smem + g.w_bytes() + g.h_bytes());

  load_slice(w_s, pick(a.w_sl, d), g, r);
  for (int e = threadIdx.x; e < 2 * BT * g.ldw; e += blockDim.x)
    h_s[e] = __float2bfloat16_rn(0.0f);

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
  float h[2][NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    ncol[c] = (p * NT + c / 2) * 8 + tig * 2 + c % 2;
    const int b = b0 + ncol[c];
    len[c] = b < B ? a.lengths[b] : 0;
    h[0][c] = 0.0f;
    h[1][c] = 0.0f;
  }
  bf16 xr[2][NC][3];
  auto load_x = [&](int tt) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int b = b0 + ncol[c];
        const bool in = unit_in[hh] && b < B;
        const size_t row = (static_cast<size_t>(tt) * B + b) * H3 + j[hh];
#pragma unroll
        for (int gt = 0; gt < 3; ++gt)
          xr[hh][c][gt] = in ? xp[row + gt * H] : __float2bfloat16_rn(0.0f);
      }
  };
  load_x(reverse ? T - 1 : 0);
  cluster.sync();  // every block running, its h buffers zero

  const int u8 = U / 8;
  for (int i = 0; i < T; ++i) {
    const int cur = i & 1;
    const int t = reverse ? T - 1 - i : i;
    if (i > 0) cluster_wait();  // h[cur] complete in this block

    float acc[3][NT][4] = {};
    gate_product(acc, w_s, h_s + cur * BT * g.ldw, g, q, p, lane);

#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float h_new = gru_cell<NUM_F32>(
            h[hh][c], __bfloat162float(xr[hh][c][0]),
            __bfloat162float(xr[hh][c][1]), __bfloat162float(xr[hh][c][2]),
            __fadd_rn(gru_gate_acc<NT>(acc, 0, hh, c), bh[hh][0]),
            __fadd_rn(gru_gate_acc<NT>(acc, 1, hh, c), bh[hh][1]),
            __fadd_rn(gru_gate_acc<NT>(acc, 2, hh, c), bh[hh][2]));
        if (t < len[c]) h[hh][c] = h_new;
        st_h[ncol[c] * U + ul[hh]] = __float2bfloat16_rn(h[hh][c]);
      }
    __syncthreads();  // the block's h slice staged

    // bf16 h slice into every cluster block's next h buffer (not after
    // the last step) and to the outputs, 16 bytes a store
    if (i + 1 < T) {
      bf16* nxt = h_s + (cur ^ 1) * BT * g.ldw + r * U;
      for (int e = threadIdx.x; e < C * BT * u8; e += blockDim.x) {
        const int dst_rank = e / (BT * u8);
        const int rem = e - dst_rank * BT * u8;
        const int n = rem / u8;
        const int k8 = rem - n * u8;
        bf16* dst =
            cluster.map_shared_rank(nxt, dst_rank) + n * g.ldw + k8 * 8;
        *reinterpret_cast<uint4*>(dst) =
            *reinterpret_cast<const uint4*>(st_h + n * U + k8 * 8);
      }
    }
    for (int e = threadIdx.x; e < BT * u8; e += blockDim.x) {
      const int n = e / u8;
      const int k8 = e - n * u8;
      const int b = b0 + n;
      const int j0 = r * U + k8 * 8;
      if (b < B && j0 < H)
        *reinterpret_cast<uint4*>(
            out + (static_cast<size_t>(t) * B + b) * a.ld_out + j0) =
            *reinterpret_cast<const uint4*>(st_h + n * U + k8 * 8);
    }
    cluster_arrive();
    if (i + 1 < T) load_x(reverse ? T - 2 - i : i + 1);
  }
  cluster_wait();  // no block leaves while another may still write to it
}

// the cluster recurrence over a.dirs directions
inline cudaError_t launch_gru_cluster_fwd(const ClusterArgs& a,
                                          cudaStream_t s) {
  if (a.T < 1 || a.B < 1 || a.dirs < 1 || a.dirs > 2 ||
      GruGeo::bad(a.H, a.C, a.BT))
    return cudaErrorInvalidValue;
  const GruGeo g(a.H, a.C, a.BT);
  const int clusters = a.dirs * ((a.B + a.BT - 1) / a.BT);
  const size_t smem = gru_cluster_fwd_smem(g);
  return g.NT == 2 ? launch_cluster(gru_cluster_fwd_kernel<2>, a.C, clusters,
                                    g.threads(), smem, s, a)
                   : launch_cluster(gru_cluster_fwd_kernel<1>, a.C, clusters,
                                    g.threads(), smem, s, a);
}

// clusters of the cluster recurrence that can be resident at once at
// (C, BT, H); a negative value is minus a cudaError_t
inline int gru_cluster_fwd_max_clusters(int C, int BT, int H) {
  if (GruGeo::bad(H, C, BT)) return -static_cast<int>(cudaErrorInvalidValue);
  const GruGeo g(H, C, BT);
  const size_t smem = gru_cluster_fwd_smem(g);
  return g.NT == 2
             ? max_clusters(gru_cluster_fwd_kernel<2>, C, g.threads(), smem)
             : max_clusters(gru_cluster_fwd_kernel<1>, C, g.threads(), smem);
}

// Every f32-gates launch: `dirs` directions of the cluster recurrence on
// clusters of C blocks and tiles of BT columns. Direction d < dirs reads
// the projections xp[d] (T, B, 3H) bf16, the W_hh slices w_sl + d C 3U Hp
// ((dirs, C, 3U, Hp) bf16, ops/rnn_cluster.py w_slices) and b_hh + d 3H
// ((dirs, 3H) f32) and writes h of row (t, b) at out[d] + (t B + b)
// ld_out. One direction walks time back to front if `reverse`; two are
// the forward and the backward direction (reverse must be 0).
inline cudaError_t launch_gru_f32(const bf16* xp_f, const bf16* xp_b,
                                  const void* w_sl, const float* b_hh,
                                  const int* lengths, void* out_f,
                                  void* out_b, int ld_out, int T, int B,
                                  int H, int C, int BT, int dirs, int reverse,
                                  cudaStream_t s) {
  if (GruGeo::bad(H, C, BT) || (dirs == 2 && reverse != 0))
    return cudaErrorInvalidValue;
  const GruGeo g(H, C, BT);
  const bf16* w = static_cast<const bf16*>(w_sl);
  ClusterArgs a{};
  a.xp[0] = xp_f;
  a.xp[1] = xp_b;
  a.w_sl[0] = w;
  a.w_sl[1] = w + static_cast<size_t>(C) * g.rows() * g.Hp;
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
  return launch_gru_cluster_fwd(a, s);
}

}  // namespace
