// Pieces shared by the trainable recurrences' CUDA sources (gru_train.cu
// and lstm_train.cu): the bf16 dot product and gate helpers of the
// recurrence kernels, the tensor-core and copy primitives (ldmatrix,
// mma.sync m16n8k16 bf16, cp.async), and the two kernels that finish a
// backward after its recurrence, rnn_dw_kernel (dW_hh as tiled partial
// sums) and rnn_bwd_reduce_kernel (the fixed-order sums of those partials
// and of the per-block db_hh partials), with their launcher.
//
// G is the number of gate rows: 3H for the GRU, 4H for the LSTM. The
// recurrence writes bf16(dgates) (T, B, G) to a scratch; dW_hh (G, H) is
// sum over (t, b) of bf16(dgates)[t, b]^T bf16(h_prev)[t, b], where
// h_prev is the forward's bf16 output shifted a step (zero at the
// recurrence start). dW_hh is more than a block's shared memory or
// registers can hold across the walk and sums over every batch column and
// step, which run in parallel blocks, so each block of rnn_dw_kernel (8
// warps) owns a 128 x 128 tile of dW_hh and one of `splits` contiguous
// ranges of (t, b) rows, which it walks 32 rows at a time (cp.async,
// double-buffered) through mma.sync with f32 accumulation, and writes its
// partial tile; rnn_bwd_reduce_kernel adds the partials in index order.
// No atomics: a backward repeats bit for bit. A block reads both operands'
// 128 columns of each row, so the rows are read ceil(G / 128) x
// ceil(H / 128) times in all (from L2): the larger the tile, the fewer.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int DW_TILE = 128;  // dW tile edge (rows of G and of H)
constexpr int DW_KC = 32;     // (t, b) rows per shared-memory stage
constexpr int DW_THREADS = 256;     // 4 x 2 warps of 32 x 64
constexpr int DW_LD = DW_TILE + 8;  // padded row: ldmatrix conflict-free

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
// tensor-core and copy primitives (sm_80 and later)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 bf16 matrices; lane l gives the row address of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr));
}

// c (16 x 8 f32) += a (16 x 16 bf16, row) . b (16 x 8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared, zero-filled when `valid` is false (src is
// then not read but must still be a mapped address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// dW_hh partial tiles: grid (ceil(G / 128), ceil(H / 128), splits), 8 warps.
// dw_part[s][r][k] = sum over the (t, b) rows of split s of
//                    bf16(dgates)[t, b, r] * bf16(h_prev)[t, b, k]
// The product is (dgates^T) (128 x rows) . h_prev (rows x 128): both
// operands are staged row by row ((t, b) rows, 128 values each, zero past
// G or H) and read transposed by ldmatrix.trans; warp (wm, wn) keeps a
// 32 x 64 f32 sub-tile as 2 x 8 m16n8 accumulators. Each 16-row chunk is
// one mma per accumulator, chained in row order.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(DW_THREADS)
    rnn_dw_kernel(const bf16* __restrict__ dgates,
                  const bf16* __restrict__ h_out,
                  float* __restrict__ dw_part, int T, int B, int H, int G,
                  int reverse, long long rows_per_split) {
  __shared__ __align__(16) bf16 a_s[2][DW_KC][DW_LD];  // dgates cols r0..
  __shared__ __align__(16) bf16 b_s[2][DW_KC][DW_LD];  // h_prev cols k0..
  const int r0 = blockIdx.x * DW_TILE;
  const int k0 = blockIdx.y * DW_TILE;
  const long long K = static_cast<long long>(T) * B;
  const long long kbeg = static_cast<long long>(blockIdx.z) * rows_per_split;
  const long long kend = min(K, kbeg + rows_per_split);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = warp & 3;   // rows wm * 32 ..
  const int wn = warp >> 2;  // columns wn * 64 ..
  float acc[2][8][4] = {};

  // DW_KC rows x 128 values of each operand, 16 bytes (8 bf16) a copy
  constexpr int PARTS = DW_TILE / 8;
  auto stage = [&](long long kb, int buf) {
    for (int e = threadIdx.x; e < DW_KC * PARTS; e += DW_THREADS) {
      const int kk = e / PARTS;
      const int part = e % PARTS;
      const long long row = kb + kk;
      const bool in = row < kend;
      int t = 0, b = 0;
      if (in) {
        t = static_cast<int>(row / B);
        b = static_cast<int>(row - static_cast<long long>(t) * B);
      }
      const int tp = reverse ? t + 1 : t - 1;
      const int ra = r0 + part * 8;
      const bool ain = in && ra < G;
      cp_async16(&a_s[buf][kk][part * 8],
                 ain ? dgates + static_cast<size_t>(row) * G + ra : dgates,
                 ain);
      const int kbq = k0 + part * 8;
      const bool hin = in && tp >= 0 && tp < T && kbq < H;
      cp_async16(&b_s[buf][kk][part * 8],
                 hin ? h_out + (static_cast<size_t>(tp) * B + b) * H + kbq
                     : h_out,
                 hin);
    }
    cp_async_commit();
  };

  const int mat = lane >> 3;
  const int lrow = lane & 7;
  int buf = 0;
  if (kbeg < kend) stage(kbeg, 0);
  for (long long kb = kbeg; kb < kend; kb += DW_KC) {
    cp_async_wait_all();
    __syncthreads();  // stage buf complete; buf ^ 1 no longer read
    if (kb + DW_KC < kend) stage(kb + DW_KC, buf ^ 1);
#pragma unroll
    for (int ks = 0; ks < DW_KC / 16; ++ks) {
      uint32_t a[2][4], bq[4][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        // A[m][kk] = dgates[kk][m]: stored rows kk, read transposed
        ldsm_x4_t(a[mt],
                  smem_addr(&a_s[buf][ks * 16 + (mat >> 1) * 8 + lrow]
                                [wm * 32 + mt * 16 + (mat & 1) * 8]));
#pragma unroll
      for (int np = 0; np < 4; ++np)
        // B[kk][n] = h_prev[kk][n]: matrices (kk 0-7 | 8-15) x (n tile)
        ldsm_x4_t(bq[np],
                  smem_addr(&b_s[buf][ks * 16 + (mat & 1) * 8 + lrow]
                                [wn * 64 + np * 16 + (mat >> 1) * 8]));
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
          mma_bf16(acc[mt][nt], a[mt], bq[nt / 2][(nt % 2) * 2],
                   bq[nt / 2][(nt % 2) * 2 + 1]);
    }
    buf ^= 1;
  }

  float* outp = dw_part + static_cast<size_t>(blockIdx.z) * G * H;
  const int gid = lane >> 2;
  const int tig = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + wm * 32 + mt * 16 + gid + h * 8;
        const int k = k0 + wn * 64 + nt * 8 + tig * 2;
        if (r < G && k < H)
          *reinterpret_cast<float2*>(&outp[static_cast<size_t>(r) * H + k]) =
              make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
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
  const dim3 grid((G + DW_TILE - 1) / DW_TILE, (H + DW_TILE - 1) / DW_TILE,
                  splits);
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
