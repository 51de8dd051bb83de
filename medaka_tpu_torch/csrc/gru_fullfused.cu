// Bidirectional GRU layers off the split path (inference), written for
// Hopper (sm_90a) and bound to Python with ctypes through a plain C
// interface.
//
// bigru_fullfused_launch  replaces medaka_tpu/ops/pallas_gru.py
//                         _bigru_fullfused_kernel (bigru_pallas_fullfused,
//                         f32 gates and gates_bf16),
//                         _bigru_fullfused_kernel_staggered (a TPU
//                         instruction schedule with the f32 gates' numerics,
//                         pinned bit for bit to the sequential kernel by
//                         tests/test_pallas_gru.py, so it runs the f32-gates
//                         mode here) and _bigru_fullfused_int8_kernel
//                         (bigru_pallas_fullfused_int8).
// bigru_fused_launch      replaces _bigru_kernel (bigru_pallas): the
//                         f32-gates recurrence alone, over projections
//                         computed outside.
//
// One source covers the three TPU kernels. bigru_fullfused_launch first
// projects all T * B rows of both directions, xp = bf16(f32(bf16 x .
// bf16 W_ih^T) + b_ih) (the bias is added in f32 before the one rounding,
// as the TPU kernel does), into a (2, T, B, 3H) bf16 scratch;
// bigru_fused_launch reads the caller's projections. Then every launch
// runs gru_rec.cuh's cluster recurrence (gru_cluster_fwd_kernel through
// launch_gru_cluster, shared with gru_train.cu's gru_fwd) with both
// directions in one grid, in the launch's numerics: f32 gates over a bf16
// W_hh, bf16 gates (with f64 recurrent sums on the FP64 tensor cores), or
// f32 gates over an int8 W_hh with per-column scales.
//
// Design. The TPU kernels walk time blocks on a sequential grid and
// compute a block's projections as one MXU product at the block's start.
// Here the projections do not depend on h, so they run ahead of the serial
// chain as a separate, fully parallel stage. The f32-gates and int8 modes
// project on the tensor cores (bigru_proj_mma_kernel: 128 x 128 tiles of
// xp, mma.sync m16n8k16 with f32 sums); its f32 sums run in the tensor
// cores' order, so an element of xp can differ from the plain version's
// sequential sum by one bf16 rounding. The bf16-gates mode projects on the
// CUDA cores (bigru_proj_kernel: the same tiles and staging, 8 x 8
// elements a thread in registers), each element's sum over the inputs in
// the plain version's order, bit for bit: its h is carried in bf16, and a
// one-ulp difference of xp would feed back through it.
//
// What bounds it on an H100: at B = 16, T = 10000, H = 256 a layer moves a
// few hundred MB (x in, xp out and back, bf16 h out) and does about 2 x
// 1.26e11 multiply-adds (layer 2: the projection and the recurrence), a
// few tenths of a ms at the tensor cores' rates. The tensor-core
// projection reaches that scale; the bf16-gates one, an in-order f32
// chain on the CUDA cores, is bound by their 33.5 T multiply-adds a
// second (3.75 ms at that shape). The serial chain of T dependent steps
// binds the recurrence, whatever the batch: a step is a product over the
// W_hh slice (bf16 or int8 on the tensor cores, the first k-chunks held in
// registers; f64 split over a tile's warps in the bf16-gates mode), the
// gates, and one h exchange through distributed shared memory that each
// block waits for on its own mbarrier.
#include "gru_rec.cuh"

namespace {

// the projection stages' tiles: 128 rows of x and 128 gate rows a block,
// staged 32 inputs at a time into padded shared-memory rows (80 bytes:
// ldmatrix, and the CUDA-core stage's 16-byte reads, without bank
// conflicts), 256 threads
constexpr int PM_BM = 128;  // rows of x a block
constexpr int PM_BN = 128;  // gate rows a block
constexpr int PM_BK = 32;   // inputs a stage
constexpr int PM_LD = PM_BK + 8;
constexpr int PM_THREADS = 256;

// inputs k0 .. k0 + 31 of rows m0 .. of x (M, IN) and n0 .. of W_ih (G, IN)
// into xs, ws, zero past IN, M and G: by cp.async (commit group) where a
// row is a whole number of 16-byte chunks (VEC: IN % 8 == 0), else element
// by element
template <bool VEC>
__device__ __forceinline__ void stage_proj(bf16 (&xs)[PM_BM][PM_LD],
                                           bf16 (&ws)[PM_BN][PM_LD],
                                           const bf16* x, const bf16* wd,
                                           long long m0, int n0, int k0,
                                           long long M, int IN, int G) {
  if constexpr (VEC) {
    // 128 rows x 4 chunks of each operand, 2 + 2 a thread
    for (int e = threadIdx.x; e < PM_BM * PM_BK / 8; e += PM_THREADS) {
      const int row = e >> 2;
      const int kc = (e & 3) * 8;
      const long long m = m0 + row;
      const int n = n0 + row;
      const bool kin = k0 + kc < IN;
      const bool xin = kin && m < M;
      const bool win = kin && n < G;
      cp_async16(&xs[row][kc],
                 xin ? x + static_cast<size_t>(m) * IN + k0 + kc : x, xin);
      cp_async16(&ws[row][kc],
                 win ? wd + static_cast<size_t>(n) * IN + k0 + kc : wd, win);
    }
    cp_async_commit();
  } else {
    const bf16 zero = __float2bfloat16_rn(0.0f);
    for (int e = threadIdx.x; e < PM_BM * PM_BK; e += PM_THREADS) {
      const int row = e / PM_BK;
      const int kk = e % PM_BK;
      const int k = k0 + kk;
      const long long m = m0 + row;
      const int n = n0 + row;
      xs[row][kk] =
          (k < IN && m < M) ? x[static_cast<size_t>(m) * IN + k] : zero;
      ws[row][kk] =
          (k < IN && n < G) ? wd[static_cast<size_t>(n) * IN + k] : zero;
    }
  }
}

// bf16 value k < 8 of 16 bytes, widened
__device__ __forceinline__ float bf16_at(const uint4& v, int k) {
  const uint32_t w = k < 2 ? v.x : k < 4 ? v.y : k < 6 ? v.z : v.w;
  return __uint_as_float((k & 1) ? (w & 0xffff0000u) : (w << 16));
}

// ---------------------------------------------------------------------------
// projection stage, bf16 gates: grid (ceil(M / 128), ceil(G / 128), 2
// directions), 256 threads, each 8 rows x 8 gate rows of the block's tile:
// rows m0 + ty + 16 i and gate rows n0 + tx + 16 j (tx, ty < 16; a
// quarter warp's 16-byte reads of 8 W rows 80 bytes apart fall in
// distinct banks, its x reads are broadcasts).
// xp[d][m][n] = bf16(f32(sum over k of x[m][k] w_ih[d][n][k]) + b_ih[d][n])
// over M = T * B rows: each element one fmaf chain over k in order (a bf16
// x bf16 product is exact in f32, so each fmaf rounds as project_plain's
// add does; zero-padded inputs add exact zeros), 64 chains a thread.
// ---------------------------------------------------------------------------

template <bool VEC>
__global__ void __launch_bounds__(PM_THREADS)
    bigru_proj_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w_ih,
                      const float* __restrict__ b_ih, bf16* __restrict__ xp,
                      long long M, int IN, int G) {
  __shared__ __align__(16) bf16 xs[2][PM_BM][PM_LD];
  __shared__ __align__(16) bf16 ws[2][PM_BN][PM_LD];
  const int d = blockIdx.z;
  const long long m0 = static_cast<long long>(blockIdx.x) * PM_BM;
  const int n0 = blockIdx.y * PM_BN;
  const bf16* wd = w_ih + static_cast<size_t>(d) * G * IN;
  const int tx = threadIdx.x & 15;  // gate rows n0 + tx + 16 j
  const int ty = threadIdx.x >> 4;  // rows m0 + ty + 16 i
  float acc[8][8] = {};

  int buf = 0;
  stage_proj<VEC>(xs[0], ws[0], x, wd, m0, n0, 0, M, IN, G);
  for (int k0 = 0; k0 < IN; k0 += PM_BK) {
    if constexpr (VEC) cp_async_wait_all();
    __syncthreads();  // stage buf complete; buf ^ 1 no longer read
    if (k0 + PM_BK < IN)
      stage_proj<VEC>(xs[buf ^ 1], ws[buf ^ 1], x, wd, m0, n0, k0 + PM_BK, M,
                      IN, G);
#pragma unroll
    for (int kc = 0; kc < PM_BK / 8; ++kc) {
      uint4 xv[8], wv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        xv[i] = *reinterpret_cast<const uint4*>(&xs[buf][ty + 16 * i][kc * 8]);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        wv[jj] =
            *reinterpret_cast<const uint4*>(&ws[buf][tx + 16 * jj][kc * 8]);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        float xf[8], wf[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) xf[i] = bf16_at(xv[i], kk);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) wf[jj] = bf16_at(wv[jj], kk);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
            acc[i][jj] = fmaf(xf[i], wf[jj], acc[i][jj]);
      }
    }
    buf ^= 1;
  }

  bf16* xpd = xp + static_cast<size_t>(d) * M * G;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int n = n0 + tx + 16 * jj;
    if (n >= G) continue;
    const float bias = b_ih[d * G + n];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const long long m = m0 + ty + 16 * i;
      if (m < M)
        xpd[static_cast<size_t>(m) * G + n] =
            __float2bfloat16_rn(__fadd_rn(acc[i][jj], bias));
    }
  }
}

// ---------------------------------------------------------------------------
// projection stage, f32 gates and int8: grid (ceil(M / 128), ceil(G /
// 128), 2 directions), 256 threads (8 warps of 64 rows x 32 gate rows).
// The same xp as bigru_proj_kernel, on the tensor cores: A is x (rows m, k
// contiguous), B^T is W_ih (rows n, k contiguous), both staged 32 inputs
// at a time into padded shared-memory rows (80 bytes: ldmatrix without
// bank conflicts), double-buffered; cp.async where a row is a whole
// number of 16-byte chunks (IN % 8 == 0), else element by element. Each
// accumulator sums its 32-input stages in order, each stage as the tensor
// cores sum it. Inputs past IN and rows past M or G are zeros.
// ---------------------------------------------------------------------------

template <bool VEC>
__global__ void __launch_bounds__(PM_THREADS)
    bigru_proj_mma_kernel(const bf16* __restrict__ x,
                          const bf16* __restrict__ w_ih,
                          const float* __restrict__ b_ih,
                          bf16* __restrict__ xp, long long M, int IN, int G) {
  __shared__ __align__(16) bf16 xs[2][PM_BM][PM_LD];
  __shared__ __align__(16) bf16 ws[2][PM_BN][PM_LD];
  const int d = blockIdx.z;
  const long long m0 = static_cast<long long>(blockIdx.x) * PM_BM;
  const int n0 = blockIdx.y * PM_BN;
  const bf16* wd = w_ih + static_cast<size_t>(d) * G * IN;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = warp & 1;   // rows wm * 64 ..
  const int wn = warp >> 1;  // gate rows wn * 32 ..
  float acc[4][4][4] = {};

  const int mat = lane >> 3;
  const int lrow = lane & 7;
  int buf = 0;
  stage_proj<VEC>(xs[0], ws[0], x, wd, m0, n0, 0, M, IN, G);
  for (int k0 = 0; k0 < IN; k0 += PM_BK) {
    if constexpr (VEC) cp_async_wait_all();
    __syncthreads();  // stage buf complete; buf ^ 1 no longer read
    if (k0 + PM_BK < IN)
      stage_proj<VEC>(xs[buf ^ 1], ws[buf ^ 1], x, wd, m0, n0, k0 + PM_BK, M,
                      IN, G);
#pragma unroll
    for (int ks = 0; ks < PM_BK / 16; ++ks) {
      uint32_t a[4][4], b[2][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldsm_x4(a[mt], smem_addr(&xs[buf][wm * 64 + mt * 16 + (mat & 1) * 8 +
                                          lrow][ks * 16 + (mat >> 1) * 8]));
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldsm_x4(b[np], smem_addr(&ws[buf][wn * 32 + np * 16 +
                                          (mat >> 1) * 8 + lrow]
                                         [ks * 16 + (mat & 1) * 8]));
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_bf16(acc[mt][nt], a[mt], b[nt / 2][(nt % 2) * 2],
                   b[nt / 2][(nt % 2) * 2 + 1]);
    }
    buf ^= 1;
  }

  bf16* xpd = xp + static_cast<size_t>(d) * M * G;
  const int gid = lane >> 2;
  const int tig = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int n = n0 + wn * 32 + nt * 8 + tig * 2;
    if (n >= G) continue;  // G is even: n + 1 < G too
    const float bias0 = b_ih[d * G + n];
    const float bias1 = b_ih[d * G + n + 1];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const long long m = m0 + wm * 64 + mt * 16 + gid + hh * 8;
        if (m < M)
          *reinterpret_cast<__nv_bfloat162*>(
              &xpd[static_cast<size_t>(m) * G + n]) =
              __floats2bfloat162_rn(
                  __fadd_rn(acc[mt][nt][2 * hh], bias0),
                  __fadd_rn(acc[mt][nt][2 * hh + 1], bias1));
      }
  }
}

// the projection stage of mode num into xp (2, M, G) bf16
cudaError_t launch_projection(int num, const bf16* x, const bf16* w_ih,
                              const float* b_ih, bf16* xp, long long M,
                              int IN, int G, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>((M + PM_BM - 1) / PM_BM),
                  (G + PM_BN - 1) / PM_BN, 2);
  if (num == NUM_BF16G) {
    if (IN % 8 == 0)
      bigru_proj_kernel<true><<<grid, PM_THREADS, 0, s>>>(x, w_ih, b_ih, xp,
                                                          M, IN, G);
    else
      bigru_proj_kernel<false><<<grid, PM_THREADS, 0, s>>>(x, w_ih, b_ih,
                                                           xp, M, IN, G);
    return cudaGetLastError();
  }
  if (G % 2 != 0) return cudaErrorInvalidValue;
  if (IN % 8 == 0)
    bigru_proj_mma_kernel<true><<<grid, PM_THREADS, 0, s>>>(x, w_ih, b_ih, xp,
                                                            M, IN, G);
  else
    bigru_proj_mma_kernel<false><<<grid, PM_THREADS, 0, s>>>(x, w_ih, b_ih,
                                                             xp, M, IN, G);
  return cudaGetLastError();
}

// the cluster recurrence in mode num (NUM_F32, NUM_BF16G or NUM_INT8)
cudaError_t launch_recurrence(int num, const bf16* xp_f, const bf16* xp_b,
                              const void* w_sl, const float* hh_scale,
                              const float* b_hh, const int* lengths,
                              void* out_f, void* out_b, int ld_out, int T,
                              int B, int H, int C, int BT, cudaStream_t s) {
  switch (num) {
    case NUM_F32:
      return launch_gru_cluster<NUM_F32>(xp_f, xp_b, w_sl, hh_scale, b_hh,
                                         lengths, out_f, out_b, ld_out, T, B,
                                         H, C, BT, 2, 0, s);
    case NUM_BF16G:
      return launch_gru_cluster<NUM_BF16G>(xp_f, xp_b, w_sl, hh_scale, b_hh,
                                           lengths, out_f, out_b, ld_out, T,
                                           B, H, C, BT, 2, 0, s);
    case NUM_INT8:
      return launch_gru_cluster<NUM_INT8>(xp_f, xp_b, w_sl, hh_scale, b_hh,
                                          lengths, out_f, out_b, ld_out, T,
                                          B, H, C, BT, 2, 0, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// shared memory of a cluster-recurrence block in mode num at (C, BT, H)
size_t bigru_cluster_smem(int num, int C, int BT, int H) {
  return gru_cluster_fwd_smem(num, GruGeo(H, C, BT));
}

// clusters of C blocks of the cluster recurrence in mode num that can be
// resident at once at (C, BT, H); a negative value is minus a cudaError_t
int bigru_max_clusters(int num, int C, int BT, int H) {
  switch (num) {
    case NUM_F32: return gru_cluster_fwd_max_clusters<NUM_F32>(C, BT, H);
    case NUM_BF16G: return gru_cluster_fwd_max_clusters<NUM_BF16G>(C, BT, H);
    case NUM_INT8: return gru_cluster_fwd_max_clusters<NUM_INT8>(C, BT, H);
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}

// The projection stage into xp (2, T, B, 3H) bf16 scratch, then the
// cluster recurrence on clusters of C blocks and tiles of BT columns, in
// order on `stream`. x is (T, B, IN) bf16, w_ih (2, 3H, IN) bf16, b_ih and
// b_hh (2, 3H) f32, w_hh the (2, C, 3U, Hp) slices of ops/rnn_cluster.py
// w_slices in mode num: bf16 (NUM_F32, NUM_BF16G), or int8 with hh_scale
// their (2, C, 3U) f32 scales (NUM_INT8).
int bigru_fullfused_launch(const void* x, const void* w_ih, const float* b_ih,
                           const void* w_hh, const float* hh_scale,
                           const float* b_hh, const int* lengths, void* xp,
                           void* out_f, void* out_b, int ld_out, int T, int B,
                           int IN, int H, int C, int BT, int num,
                           void* stream) {
  if (T < 1 || B < 1 || IN < 1 || gru_cluster_bad(num, H, C, BT))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long M = static_cast<long long>(T) * B;
  const int G = 3 * H;
  bf16* xpb = static_cast<bf16*>(xp);
  cudaError_t e = launch_projection(num, static_cast<const bf16*>(x),
                                    static_cast<const bf16*>(w_ih), b_ih, xpb,
                                    M, IN, G, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(launch_recurrence(num, xpb, xpb + M * G, w_hh,
                                            hh_scale, b_hh, lengths, out_f,
                                            out_b, ld_out, T, B, H, C, BT,
                                            s));
}

// The projection stage of the f32-gates and int8 modes alone
// (bigru_proj_mma_kernel): xp (2, M, G) bf16 from x (M, IN) bf16, w_ih (2,
// G, IN) bf16 and b_ih (2, G) f32.
int bigru_project_launch(const void* x, const void* w_ih, const float* b_ih,
                         void* xp, long long M, int IN, int G, void* stream) {
  if (M < 1 || IN < 1 || G < 2) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_projection(
      NUM_F32, static_cast<const bf16*>(x), static_cast<const bf16*>(w_ih),
      b_ih, static_cast<bf16*>(xp), M, IN, G,
      static_cast<cudaStream_t>(stream)));
}

// The recurrence alone (f32 gates, bf16 W_hh) over the caller's
// projections xp_f, xp_b (T, B, 3H) bf16: the cluster recurrence on
// clusters of C blocks and tiles of BT columns, with w_sl the (2, C, 3U,
// Hp) bf16 slices of ops/rnn_cluster.py w_slices.
int bigru_fused_launch(const void* xp_f, const void* xp_b, const void* w_sl,
                       const float* b_hh, const int* lengths, void* out_f,
                       void* out_b, int ld_out, int T, int B, int H, int C,
                       int BT, void* stream) {
  return static_cast<int>(launch_recurrence(
      NUM_F32, static_cast<const bf16*>(xp_f), static_cast<const bf16*>(xp_b),
      w_sl, nullptr, b_hh, lengths, out_f, out_b, ld_out, T, B, H, C, BT,
      static_cast<cudaStream_t>(stream)));
}

// The int8 recurrence alone over the caller's projections xp_f, xp_b (T,
// B, 3H) bf16 (the recurrence of bigru_fullfused_int8, for its checks and
// timings): w_sl (2, C, 3U, Hp) int8 slices, hh_scale (2, C, 3U) f32.
int bigru_int8_rec_launch(const void* xp_f, const void* xp_b,
                          const void* w_sl, const float* hh_scale,
                          const float* b_hh, const int* lengths, void* out_f,
                          void* out_b, int ld_out, int T, int B, int H, int C,
                          int BT, void* stream) {
  return static_cast<int>(launch_recurrence(
      NUM_INT8, static_cast<const bf16*>(xp_f),
      static_cast<const bf16*>(xp_b), w_sl, hh_scale, b_hh, lengths, out_f,
      out_b, ld_out, T, B, H, C, BT, static_cast<cudaStream_t>(stream)));
}

const char* gru_fullfused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
