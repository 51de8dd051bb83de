// Pieces shared by the trainable recurrences' CUDA sources (gru_train.cu
// and lstm_train.cu): the bf16 dot product and gate helpers of the
// recurrence kernels, and the two kernels that finish a backward after its
// recurrence, rnn_dw_kernel (dW_hh as tiled partial sums) and
// rnn_bwd_reduce_kernel (the fixed-order sums of those partials and of the
// per-block db_hh partials), with their launcher.
//
// G is the number of gate rows: 3H for the GRU, 4H for the LSTM. The
// recurrence writes bf16(dgates) (T, B, G) to a scratch; dW_hh (G, H) is
// sum over (t, b) of bf16(dgates)[t, b]^T bf16(h_prev)[t, b], where
// h_prev is the forward's bf16 output shifted a step (zero at the
// recurrence start). dW_hh is more than a block's shared memory or
// registers can hold across the walk and sums over every batch column and
// step, which run in parallel blocks, so each block of rnn_dw_kernel owns
// a 32 x 32 tile of dW_hh and one of `splits` contiguous ranges of (t, b)
// and writes its partial tile; rnn_bwd_reduce_kernel adds the partials in
// index order. No atomics: a backward repeats bit for bit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int DW_TILE = 32;   // dW tile edge (rows of G and of H)
constexpr int DW_KC = 32;     // (t, b) rows per shared-memory stage
constexpr int DW_THREADS = 64;

__device__ __forceinline__ float sigmoid_f(float v) {
  return 1.0f / (1.0f + expf(-v));
}

__device__ __forceinline__ float dot8_bf16(uint4 w, uint4 a, float acc) {
  const __nv_bfloat162* wp = reinterpret_cast<const __nv_bfloat162*>(&w);
  const __nv_bfloat162* ap = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const float2 wf = __bfloat1622float2(wp[p]);
    const float2 af = __bfloat1622float2(ap[p]);
    // bf16 x bf16 is exact in f32, so the fma rounds only the sum
    acc = fmaf(wf.x, af.x, acc);
    acc = fmaf(wf.y, af.y, acc);
  }
  return acc;
}

__host__ __device__ __forceinline__ size_t align16(size_t v) {
  return (v + 15) & ~static_cast<size_t>(15);
}

__device__ __forceinline__ uint4 load_w(const uint4* w, size_t i,
                                        bool from_smem) {
  return from_smem ? w[i] : __ldg(&w[i]);
}

// ---------------------------------------------------------------------------
// dW_hh partial tiles: grid (G / 32, H / 32, splits), 64 threads.
// dw_part[s][r][k] = sum over the (t, b) rows of split s of
//                    bf16(dgates)[t, b, r] * bf16(h_prev)[t, b, k]
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(DW_THREADS)
    rnn_dw_kernel(const bf16* __restrict__ dgates,
                  const bf16* __restrict__ h_out,
                  float* __restrict__ dw_part, int T, int B, int H, int G,
                  int reverse, long long rows_per_split) {
  __shared__ __align__(16) float a_s[DW_KC][DW_TILE];  // dgates rows r0..
  __shared__ __align__(16) float b_s[DW_KC][DW_TILE];  // h_prev rows k0..
  const int r0 = blockIdx.x * DW_TILE;
  const int k0 = blockIdx.y * DW_TILE;
  const long long K = static_cast<long long>(T) * B;
  const long long kbeg = static_cast<long long>(blockIdx.z) * rows_per_split;
  const long long kend = min(K, kbeg + rows_per_split);
  const int tx = threadIdx.x % 8;  // 4 columns k0 + 4 tx ..
  const int ty = threadIdx.x / 8;  // 4 rows r0 + 4 ty ..
  float acc[4][4] = {};

  for (long long kb = kbeg; kb < kend; kb += DW_KC) {
    // DW_KC rows x 32 values of each operand, 8 bf16 (16 bytes) a load
    for (int e = threadIdx.x; e < DW_KC * 4; e += DW_THREADS) {
      const int kk = e / 4;
      const int part = e % 4;
      const long long row = kb + kk;
      uint4 va = make_uint4(0u, 0u, 0u, 0u);
      uint4 vb = make_uint4(0u, 0u, 0u, 0u);
      if (row < kend) {
        const int t = static_cast<int>(row / B);
        const int b = static_cast<int>(row - static_cast<long long>(t) * B);
        va = *reinterpret_cast<const uint4*>(
            dgates + static_cast<size_t>(row) * G + r0 + part * 8);
        const int tp = reverse ? t + 1 : t - 1;
        if (tp >= 0 && tp < T)
          vb = *reinterpret_cast<const uint4*>(
              h_out + (static_cast<size_t>(tp) * B + b) * H + k0 + part * 8);
      }
      const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&va);
      const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&vb);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float2 fa = __bfloat1622float2(pa[u]);
        const float2 fb = __bfloat1622float2(pb[u]);
        a_s[kk][part * 8 + 2 * u] = fa.x;
        a_s[kk][part * 8 + 2 * u + 1] = fa.y;
        b_s[kk][part * 8 + 2 * u] = fb.x;
        b_s[kk][part * 8 + 2 * u + 1] = fb.y;
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < DW_KC; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&a_s[kk][ty * 4]);
      const float4 bq = *reinterpret_cast<const float4*>(&b_s[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(av[u], bv[v], acc[u][v]);
    }
    __syncthreads();
  }

  float* outp = dw_part + static_cast<size_t>(blockIdx.z) * G * H;
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v)
      outp[static_cast<size_t>(r0 + ty * 4 + u) * H + k0 + tx * 4 + v] =
          acc[u][v];
}

// dW_hh = sum over splits, db_hh = sum over (block, q) partials, each in
// index order
__global__ void rnn_bwd_reduce_kernel(const float* __restrict__ dw_part,
                                      int splits,
                                      const float* __restrict__ db_part,
                                      int parts, float* __restrict__ dw,
                                      float* __restrict__ db, int G, int H) {
  const size_t n_w = static_cast<size_t>(G) * H;
  const size_t n_g = static_cast<size_t>(G);
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n_w + n_g; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float s = 0.0f;
    if (i < n_w) {
      for (int z = 0; z < splits; ++z) s = __fadd_rn(s, dw_part[z * n_w + i]);
      dw[i] = s;
    } else {
      const size_t r = i - n_w;
      for (int pp = 0; pp < parts; ++pp)
        s = __fadd_rn(s, db_part[pp * n_g + r]);
      db[r] = s;
    }
  }
}

// After the recurrence, on the same stream: the dW_hh partial tiles, then
// the fixed-order sums into dw (G, H) and db (G). dw_part is (splits, G, H)
// scratch; db_part holds `parts` rows of G per-block db_hh partials.
cudaError_t launch_dw_reduce(const void* dgates, const void* h_out,
                             float* dw_part, const float* db_part, float* dw,
                             float* db, int T, int B, int H, int G,
                             int reverse, int splits, int parts,
                             cudaStream_t s) {
  const long long K = static_cast<long long>(T) * B;
  long long per = (K + splits - 1) / splits;
  per = (per + DW_KC - 1) / DW_KC * DW_KC;
  const dim3 grid(G / DW_TILE, H / DW_TILE, splits);
  rnn_dw_kernel<<<grid, DW_THREADS, 0, s>>>(
      static_cast<const bf16*>(dgates), static_cast<const bf16*>(h_out),
      dw_part, T, B, H, G, reverse, per);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t n = static_cast<size_t>(G) * H + G;
  const int blocks = static_cast<int>((n + 255) / 256);
  rnn_bwd_reduce_kernel<<<blocks, 256, 0, s>>>(dw_part, splits, db_part,
                                               parts, dw, db, G, H);
  return cudaGetLastError();
}

// the recurrence kernels' block: H * nq threads (at most 512), H a multiple
// of 32
bool bad_shape(int H, int nq) {
  return H % 32 != 0 || H > 512 || H * nq > 512;
}

}  // namespace
