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
// - the projection stage, on or off: bigru_fullfused_launch first runs
//   bigru_proj_kernel, a tiled product over all T * B rows of both
//   directions, xp = bf16(f32(bf16 x . bf16 W_ih^T) + b_ih) (the bias is
//   added in f32 before the rounding, as the TPU kernel does), into a
//   (2, T, B, 3H) bf16 scratch; bigru_fused_launch skips it and reads the
//   caller's projections;
// - the recurrence numerics: f32 gates over a bf16 W_hh (the cluster
//   recurrence, bigru_fused and the fullfused default), bf16 gates, or an
//   int8 W_hh with per-column scales (the per-block recurrence;
//   gru_rec.cuh, NUM_*);
// - the direction: both in one launch (the cluster index in the cluster
//   recurrence, blockIdx.y in the per-block one), 0 forward, 1 backward.
//
// Design. The TPU kernels walk time blocks on a sequential grid and
// compute a block's projections as one MXU product at the block's start.
// Here the projections do not depend on h, so they run ahead of the serial
// chain as a separate, fully parallel stage; the recurrence is
// gru_rec.cuh's, with both directions in one grid: every f32-gates launch
// (bigru_fused, and bigru_fullfused by default) runs the cluster
// recurrence through launch_gru_f32, shared with gru_train.cu's gru_fwd
// (gru_cluster_fwd_kernel: W_hh split over a thread-block cluster's
// shared memory, the step's product on the tensor cores); the bf16-gates
// and int8 modes run the per-block recurrence (gru_rec_kernel), whose
// order-free sums the tensor cores do not give. The projection stage sums
// over the inputs in the plain version's order, and bf16 x bf16 products
// are exact in f32, so it agrees with the plain version bit for bit.
//
// What bounds it on an H100: at B = 16, T = 10000, H = 256 a layer moves a
// few hundred MB (x in, bf16 h out) and does about 2 x 1.26e11
// multiply-adds (layer 2: the projection and the recurrence), a few tenths
// of a ms at the card's rates. The serial chain of T dependent steps binds
// it instead, whatever the batch: in the cluster recurrence a step is an
// mma chain over shared memory, one h exchange through distributed shared
// memory and one cluster barrier; in the per-block recurrence a W_hh
// stream from L2 (or shared memory) into CUDA-core dot products.
#include "gru_rec.cuh"

namespace {

constexpr int PJ_TILE = 64;   // projection tile: 64 rows x 64 gate rows
constexpr int PJ_K = 16;      // inputs per shared-memory stage
constexpr int PJ_THREADS = 256;

// ---------------------------------------------------------------------------
// projection stage: grid (ceil(M / 64), ceil(G / 64), 2 directions), 256
// threads, each 4 rows x 4 gate rows of the tile.
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

// the recurrence's arguments for both directions: projections xp_f, xp_b
// (T, B, 3H) bf16, w_hh (2, kchunks, 3H) chunks, hh_scale (2, 3H) or null,
// b_hh (2, 3H)
RecArgs both_directions(const bf16* xp_f, const bf16* xp_b, const void* w_hh,
                        const float* hh_scale, const float* b_hh,
                        const int* lengths, void* out_f, void* out_b,
                        int ld_out, int T, int B, int H, int nq, int num) {
  const size_t wchunks = rec_w_bytes(num, H) / 16;
  const uint4* w = static_cast<const uint4*>(w_hh);
  RecArgs a{};
  a.xp[0] = xp_f;
  a.xp[1] = xp_b;
  a.w_hh[0] = w;
  a.w_hh[1] = w + wchunks;
  a.hh_scale[0] = hh_scale;
  a.hh_scale[1] = hh_scale ? hh_scale + 3 * H : nullptr;
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

size_t bigru_rec_smem(int num, int w_smem, int bt, int hidden) {
  return rec_smem_bytes(num, w_smem != 0, bt, hidden);
}

size_t bigru_cluster_smem(int C, int BT, int H) {
  return gru_cluster_fwd_smem(GruGeo(H, C, BT));
}

// clusters of C blocks of the cluster recurrence that can be resident at
// once at (C, BT, H); a negative value is minus a cudaError_t
int bigru_max_clusters(int C, int BT, int H) {
  return gru_cluster_fwd_max_clusters(C, BT, H);
}

// The projection stage into xp (2, T, B, 3H) bf16 scratch, then the
// recurrence, in order on `stream`. x is (T, B, IN) bf16, w_ih (2, 3H, IN)
// bf16, b_ih and b_hh (2, 3H) f32, hh_scale (2, 3H) f32 (read by
// num = NUM_INT8 only). num = NUM_F32 runs the cluster recurrence on
// clusters of C blocks and tiles of BT columns, with w_hh the (2, C, 3U,
// Hp) bf16 slices of ops/rnn_cluster.py w_slices; the other modes run the
// per-block recurrence on tiles of cpt * nq columns, with w_hh (2,
// kchunks, 3H) 16-byte chunks, in shared memory if w_smem.
int bigru_fullfused_launch(const void* x, const void* w_ih, const float* b_ih,
                           const void* w_hh, const float* hh_scale,
                           const float* b_hh, const int* lengths, void* xp,
                           void* out_f, void* out_b, int ld_out, int T, int B,
                           int IN, int H, int C, int BT, int cpt, int nq,
                           int w_smem, int num, void* stream) {
  if (T < 1 || B < 1 || IN < 1 || num < NUM_F32 || num > NUM_INT8 ||
      (num == NUM_F32 ? GruGeo::bad(H, C, BT) : bad_shape(H, nq)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long M = static_cast<long long>(T) * B;
  const int G = 3 * H;
  const dim3 grid(static_cast<unsigned>((M + PJ_TILE - 1) / PJ_TILE),
                  (G + PJ_TILE - 1) / PJ_TILE, 2);
  bf16* xpb = static_cast<bf16*>(xp);
  bigru_proj_kernel<<<grid, PJ_THREADS, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w_ih), b_ih, xpb,
      M, IN, G);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (num == NUM_F32)
    return static_cast<int>(launch_gru_f32(xpb, xpb + M * G, w_hh, b_hh,
                                           lengths, out_f, out_b, ld_out, T,
                                           B, H, C, BT, 2, 0, s));
  const RecArgs a = both_directions(xpb, xpb + M * G, w_hh, hh_scale, b_hh,
                                    lengths, out_f, out_b, ld_out, T, B, H,
                                    nq, num);
  e = num == NUM_BF16G ? dispatch_rec<NUM_BF16G>(cpt, w_smem, a, s)
                       : dispatch_rec<NUM_INT8>(cpt, w_smem, a, s);
  return static_cast<int>(e);
}

// The recurrence alone (f32 gates, bf16 W_hh) over the caller's
// projections xp_f, xp_b (T, B, 3H) bf16: the cluster recurrence on
// clusters of C blocks and tiles of BT columns, with w_sl the (2, C, 3U,
// Hp) bf16 slices of ops/rnn_cluster.py w_slices.
int bigru_fused_launch(const void* xp_f, const void* xp_b, const void* w_sl,
                       const float* b_hh, const int* lengths, void* out_f,
                       void* out_b, int ld_out, int T, int B, int H, int C,
                       int BT, void* stream) {
  return static_cast<int>(launch_gru_f32(
      static_cast<const bf16*>(xp_f), static_cast<const bf16*>(xp_b), w_sl,
      b_hh, lengths, out_f, out_b, ld_out, T, B, H, C, BT, 2, 0,
      static_cast<cudaStream_t>(stream)));
}

const char* gru_fullfused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
