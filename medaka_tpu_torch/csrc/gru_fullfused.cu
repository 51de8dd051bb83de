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
// One source covers the three TPU kernels, templated on
// - the projection stage, on or off: bigru_fullfused_launch first projects
//   all T * B rows of both directions, xp = bf16(f32(bf16 x . bf16
//   W_ih^T) + b_ih) (the bias is added in f32 before the one rounding, as
//   the TPU kernel does), into a (2, T, B, 3H) bf16 scratch;
//   bigru_fused_launch skips it and reads the caller's projections;
// - the recurrence numerics: f32 gates over a bf16 W_hh or an int8 W_hh
//   with per-column scales (the cluster recurrence, gru_rec.cuh
//   gru_cluster_fwd_kernel), or bf16 gates (the per-block recurrence,
//   gru_rec_kernel);
// - the direction: both in one launch (the cluster index in the cluster
//   recurrence, blockIdx.y in the per-block one), 0 forward, 1 backward.
//
// Design. The TPU kernels walk time blocks on a sequential grid and
// compute a block's projections as one MXU product at the block's start.
// Here the projections do not depend on h, so they run ahead of the serial
// chain as a separate, fully parallel stage. The f32-gates and int8 modes
// project on the tensor cores (bigru_proj_mma_kernel: 128 x 128 tiles of
// xp, mma.sync m16n8k16 with f32 sums, x and W_ih staged by cp.async,
// double-buffered); its f32 sums run in the tensor cores' order, so an
// element of xp can differ from the plain version's sequential sum by one
// bf16 rounding. The bf16-gates mode keeps bigru_proj_kernel, the CUDA
// cores' sum over the inputs in the plain version's order, bit for bit:
// its h is carried in bf16, and a one-ulp difference of xp would feed back
// through it. The recurrence is gru_rec.cuh's, with both directions in one
// grid: every f32-gates and int8 launch runs the cluster recurrence
// through launch_gru_cluster, shared with gru_train.cu's gru_fwd (W_hh
// split over a thread-block cluster's shared memory, the step's product
// on the tensor cores, int8 on mma.sync m16n8k32 with exact int32 sums);
// the bf16-gates mode runs the per-block recurrence (gru_rec_kernel),
// whose order-free f64 sums the tensor cores do not give.
//
// What bounds it on an H100: at B = 16, T = 10000, H = 256 a layer moves a
// few hundred MB (x in, xp out and back, bf16 h out) and does about 2 x
// 1.26e11 multiply-adds (layer 2: the projection and the recurrence), a
// few tenths of a ms at the card's rates. The projection stage reaches
// that scale on the tensor cores; the serial chain of T dependent steps
// binds the recurrence instead, whatever the batch: a step is an mma chain
// over the W_hh slice (its first k-chunks held in registers), the gates,
// and one h exchange through distributed shared memory that each block
// waits for on its own mbarrier.
#include "gru_rec.cuh"

namespace {

constexpr int PJ_TILE = 64;   // projection tile: 64 rows x 64 gate rows
constexpr int PJ_K = 16;      // inputs per shared-memory stage
constexpr int PJ_THREADS = 256;

// ---------------------------------------------------------------------------
// projection stage, bf16 gates: grid (ceil(M / 64), ceil(G / 64), 2
// directions), 256 threads, each 4 rows x 4 gate rows of the tile.
// xp[d][m][n] = bf16(f32(sum over k of x[m][k] w_ih[d][n][k]) + b_ih[d][n])
// over M = T * B rows; the sum runs over k in order (zero-padded stages add
// exact zeros).
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(PJ_THREADS)
    bigru_proj_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w_ih,
                      const float* __restrict__ b_ih, bf16* __restrict__ xp,
                      long long M, int IN, int G) {
  __shared__ float xs[PJ_K][PJ_TILE];
  __shared__ float ws[PJ_K][PJ_TILE];
  const int d = blockIdx.z;
  const long long m0 = static_cast<long long>(blockIdx.x) * PJ_TILE;
  const int n0 = blockIdx.y * PJ_TILE;
  const int tx = threadIdx.x % 16;  // gate rows n0 + 4 tx ..
  const int ty = threadIdx.x / 16;  // rows m0 + 4 ty ..
  const bf16* wd = w_ih + static_cast<size_t>(d) * G * IN;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < IN; k0 += PJ_K) {
    for (int e = threadIdx.x; e < PJ_K * PJ_TILE; e += PJ_THREADS) {
      const int r = e / PJ_K;
      const int kk = e % PJ_K;
      const int k = k0 + kk;
      const long long m = m0 + r;
      const int n = n0 + r;
      xs[kk][r] = (m < M && k < IN)
                      ? __bfloat162float(x[static_cast<size_t>(m) * IN + k])
                      : 0.0f;
      ws[kk][r] = (n < G && k < IN)
                      ? __bfloat162float(wd[static_cast<size_t>(n) * IN + k])
                      : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < PJ_K; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
      const float4 w = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(av[u], wv[v], acc[u][v]);
    }
    __syncthreads();
  }

  bf16* xpd = xp + static_cast<size_t>(d) * M * G;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const long long m = m0 + ty * 4 + u;
    if (m >= M) continue;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int n = n0 + tx * 4 + v;
      if (n < G)
        xpd[static_cast<size_t>(m) * G + n] =
            __float2bfloat16_rn(__fadd_rn(acc[u][v], b_ih[d * G + n]));
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

constexpr int PM_BM = 128;  // rows of x a block
constexpr int PM_BN = 128;  // gate rows a block
constexpr int PM_BK = 32;   // inputs a stage
constexpr int PM_LD = PM_BK + 8;
constexpr int PM_THREADS = 256;

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

  auto stage = [&](int k0, int buf) {
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
        cp_async16(&xs[buf][row][kc],
                   xin ? x + static_cast<size_t>(m) * IN + k0 + kc : x, xin);
        cp_async16(&ws[buf][row][kc],
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
        xs[buf][row][kk] =
            (k < IN && m < M) ? x[static_cast<size_t>(m) * IN + k] : zero;
        ws[buf][row][kk] =
            (k < IN && n < G) ? wd[static_cast<size_t>(n) * IN + k] : zero;
      }
    }
  };

  const int mat = lane >> 3;
  const int lrow = lane & 7;
  int buf = 0;
  stage(0, 0);
  for (int k0 = 0; k0 < IN; k0 += PM_BK) {
    if constexpr (VEC) cp_async_wait_all();
    __syncthreads();  // stage buf complete; buf ^ 1 no longer read
    if (k0 + PM_BK < IN) stage(k0 + PM_BK, buf ^ 1);
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
  if (num == NUM_BF16G) {
    const dim3 grid(static_cast<unsigned>((M + PJ_TILE - 1) / PJ_TILE),
                    (G + PJ_TILE - 1) / PJ_TILE, 2);
    bigru_proj_kernel<<<grid, PJ_THREADS, 0, s>>>(x, w_ih, b_ih, xp, M, IN,
                                                  G);
    return cudaGetLastError();
  }
  if (G % 2 != 0) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>((M + PM_BM - 1) / PM_BM),
                  (G + PM_BN - 1) / PM_BN, 2);
  if (IN % 8 == 0)
    bigru_proj_mma_kernel<true><<<grid, PM_THREADS, 0, s>>>(x, w_ih, b_ih, xp,
                                                            M, IN, G);
  else
    bigru_proj_mma_kernel<false><<<grid, PM_THREADS, 0, s>>>(x, w_ih, b_ih,
                                                             xp, M, IN, G);
  return cudaGetLastError();
}

// the per-block recurrence's arguments for both directions: projections
// xp_f, xp_b (T, B, 3H) bf16, w_hh (2, kchunks, 3H) chunks, b_hh (2, 3H)
RecArgs both_directions(const bf16* xp_f, const bf16* xp_b, const void* w_hh,
                        const float* b_hh, const int* lengths, void* out_f,
                        void* out_b, int ld_out, int T, int B, int H,
                        int nq) {
  const size_t wchunks = rec_w_bytes(H) / 16;
  const uint4* w = static_cast<const uint4*>(w_hh);
  RecArgs a{};
  a.xp[0] = xp_f;
  a.xp[1] = xp_b;
  a.w_hh[0] = w;
  a.w_hh[1] = w + wchunks;
  a.b_hh[0] = b_hh;
  a.b_hh[1] = b_hh + 3 * H;
  a.out[0] = static_cast<bf16*>(out_f);
  a.out[1] = static_cast<bf16*>(out_b);
  a.reverse[0] = 0;
  a.reverse[1] = 1;
  a.lengths = lengths;
  a.ld_out = ld_out;
  a.T = T;
  a.B = B;
  a.H = H;
  a.NQ = nq;
  a.dirs = 2;
  return a;
}

}  // namespace

extern "C" {

size_t bigru_rec_smem(int w_smem, int bt, int hidden) {
  return rec_smem_bytes(w_smem != 0, bt, hidden);
}

size_t bigru_cluster_smem(int num, int C, int BT, int H) {
  return gru_cluster_fwd_smem(num, GruGeo(H, C, BT));
}

// clusters of C blocks of the cluster recurrence in mode num that can be
// resident at once at (C, BT, H); a negative value is minus a cudaError_t
int bigru_max_clusters(int num, int C, int BT, int H) {
  return gru_cluster_fwd_max_clusters(num, C, BT, H);
}

// The projection stage into xp (2, T, B, 3H) bf16 scratch, then the
// recurrence, in order on `stream`. x is (T, B, IN) bf16, w_ih (2, 3H, IN)
// bf16, b_ih and b_hh (2, 3H) f32. num = NUM_F32 or NUM_INT8 runs the
// cluster recurrence on clusters of C blocks and tiles of BT columns, with
// w_hh the (2, C, 3U, Hp) slices of ops/rnn_cluster.py w_slices (bf16, or
// int8 in NUM_INT8 with hh_scale their (2, C, 3U) f32 scales); NUM_BF16G
// runs the per-block recurrence on tiles of cpt * nq columns, with w_hh
// (2, kchunks, 3H) 16-byte chunks, in shared memory if w_smem.
int bigru_fullfused_launch(const void* x, const void* w_ih, const float* b_ih,
                           const void* w_hh, const float* hh_scale,
                           const float* b_hh, const int* lengths, void* xp,
                           void* out_f, void* out_b, int ld_out, int T, int B,
                           int IN, int H, int C, int BT, int cpt, int nq,
                           int w_smem, int num, void* stream) {
  const bool cluster = num == NUM_F32 || num == NUM_INT8;
  if (T < 1 || B < 1 || IN < 1 || (num != NUM_BF16G && !cluster) ||
      (cluster ? gru_cluster_bad(num, H, C, BT) : bad_shape(H, nq)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long M = static_cast<long long>(T) * B;
  const int G = 3 * H;
  bf16* xpb = static_cast<bf16*>(xp);
  cudaError_t e = launch_projection(num, static_cast<const bf16*>(x),
                                    static_cast<const bf16*>(w_ih), b_ih, xpb,
                                    M, IN, G, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (cluster)
    return static_cast<int>(launch_gru_cluster(
        num, xpb, xpb + M * G, w_hh, hh_scale, b_hh, lengths, out_f, out_b,
        ld_out, T, B, H, C, BT, 2, 0, s));
  const RecArgs a = both_directions(xpb, xpb + M * G, w_hh, b_hh, lengths,
                                    out_f, out_b, ld_out, T, B, H, nq);
  return static_cast<int>(dispatch_rec(cpt, w_smem, a, s));
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
  return static_cast<int>(launch_gru_cluster(
      NUM_F32, static_cast<const bf16*>(xp_f), static_cast<const bf16*>(xp_b),
      w_sl, nullptr, b_hh, lengths, out_f, out_b, ld_out, T, B, H, C, BT, 2,
      0, static_cast<cudaStream_t>(stream)));
}

// The int8 recurrence alone over the caller's projections xp_f, xp_b (T,
// B, 3H) bf16 (the recurrence of bigru_fullfused_int8, for its checks and
// timings): w_sl (2, C, 3U, Hp) int8 slices, hh_scale (2, C, 3U) f32.
int bigru_int8_rec_launch(const void* xp_f, const void* xp_b,
                          const void* w_sl, const float* hh_scale,
                          const float* b_hh, const int* lengths, void* out_f,
                          void* out_b, int ld_out, int T, int B, int H, int C,
                          int BT, void* stream) {
  return static_cast<int>(launch_gru_cluster(
      NUM_INT8, static_cast<const bf16*>(xp_f),
      static_cast<const bf16*>(xp_b), w_sl, hh_scale, b_hh, lengths, out_f,
      out_b, ld_out, T, B, H, C, BT, 2, 0,
      static_cast<cudaStream_t>(stream)));
}

const char* gru_fullfused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
