// Pieces shared by the recurrences' CUDA sources (gru_train.cu and
// gru_fullfused.cu through gru_rec.cuh, lstm_train.cu and bilstm.cu
// through lstm_fwd.cuh, gru_split.cu): the gate and weight-load helpers
// of the recurrence kernels, the tensor-core and copy primitives
// (ldmatrix, mma.sync m16n8k16 bf16, m16n8k32 s8 and m16n8k16 f64,
// cp.async, named barriers), the
// machinery of the cluster recurrences (their geometry, the W_hh slice
// loader, the step's tile products on the tensor cores, bf16 and int8,
// the backward's dh partials, the split cluster barrier, the forwards'
// h exchange by st.async and mbarriers, and the cluster launch), and the
// two kernels that finish a
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

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

typedef __nv_bfloat16 bf16;

constexpr int DW_TILE = 128;  // dW tile edge (rows of G and of H)
constexpr int DW_KC = 32;     // (t, b) rows per shared-memory stage
constexpr int DW_THREADS = 256;     // 4 x 2 warps of 32 x 64
constexpr int DW_LD = DW_TILE + 8;  // padded row: ldmatrix conflict-free

__device__ __forceinline__ float sigmoid_f(float v) {
  return 1.0f / (1.0f + expf(-v));
}

__host__ __device__ __forceinline__ size_t align16(size_t v) {
  return (v + 15) & ~static_cast<size_t>(15);
}

// v[d] with d in {0, 1} without indexing the kernel's parameter array at
// run time (which would copy it to local memory)
template <typename V>
__device__ __forceinline__ V pick(const V (&v)[2], int d) {
  return d ? v[1] : v[0];
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

// c (16 x 8 s32) += a (16 x 32 s8, row) . b (32 x 8 s8, col): exact integer
// sums. In bytes the fragments are those of m16n8k16 bf16, so ldmatrix
// loads them from rows of int8 as from rows of bf16.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c (16 x 8 f64) += a (16 x 16 f64, row) . b (16 x 8 f64, col) on the FP64
// tensor cores (sm_90): IEEE products and sums. a[hh][i] is A[gid + 8
// hh][tig + 4 i], b[i] B[tig + 4 i][gid]; the accumulator fragments are
// those of m16n8k16 bf16 (rows gid and gid + 8, columns 2 tig and 2 tig +
// 1), so an f64 product lands where a bf16 one does
__device__ __forceinline__ void mma_f64(double (&c)[4],
                                        const double (&a)[2][4],
                                        const double (&b)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11}, "
      "{%12, %13, %14, %15}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0][0]), "d"(a[1][0]), "d"(a[0][1]), "d"(a[1][1]),
        "d"(a[0][2]), "d"(a[1][2]), "d"(a[0][3]), "d"(a[1][3]), "d"(b[0]),
        "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// the `threads` threads (whole warps) of a block that name barrier `id`
// (1-15; 0 is __syncthreads') wait for each other
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
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

// ---------------------------------------------------------------------------
// cluster recurrences (sm_90: thread-block clusters, distributed shared
// memory). A cluster of C blocks owns one tile of BT batch columns of one
// direction and walks all T steps. Block r owns U = Hp / C hidden units (H
// padded to Hp with zero units) and keeps their GATES * U gate rows of
// W_hh, bf16, in its shared memory for the whole walk. A warp (q, p) owns
// unit group q (UG units: rows q * GATES * UG + g * UG + u of the slice,
// gate g, unit u, so MT = GATES * UG / 16 m16 tiles) and NT n8 tiles of
// batch columns from (p * NT) * 8. ops/rnn_cluster.py mirrors the geometry
// and the byte counts on the host.
// ---------------------------------------------------------------------------

constexpr int CLUSTER_MAX_U = 64;  // units of a block at most
constexpr int CLUSTER_MAX_THREADS = 512;

template <int GATES, int UG>
struct ClusterGeo {
  int C, U, Hp, BT, NT, NG, NP;
  int ldw;  // padded row (bf16) of the W slice and the h buffers: Hp + 8
  int ldg;  // padded row (bf16) of the dgates tile: GATES U + 8
  __host__ __device__ static int units(int H, int c) {
    return (H + c * UG - 1) / (c * UG) * UG;
  }
  __host__ __device__ ClusterGeo(int H, int c, int bt)
      : C(c), U(units(H, c)), Hp(c * U), BT(bt), NT(bt >= 16 ? 2 : 1),
        NG(U / UG), NP(bt / (8 * NT)), ldw(Hp + 8), ldg(GATES * U + 8) {}
  __host__ __device__ int rows() const { return GATES * U; }
  __host__ __device__ int threads() const { return 32 * NG * NP; }
  __host__ __device__ size_t w_bytes() const {
    return align16(static_cast<size_t>(GATES) * U * ldw * sizeof(bf16));
  }
  // h (forward) or h_prev (backward), double-buffered: [2][BT][ldw]
  __host__ __device__ size_t h_bytes() const {
    return align16(static_cast<size_t>(2) * BT * ldw * sizeof(bf16));
  }
  // the forward's staged bf16 h slice [BT][U]
  __host__ __device__ size_t st_bytes() const {
    return align16(static_cast<size_t>(BT) * U * sizeof(bf16));
  }
  // the backward's bf16 dgates [BT][ldg]
  __host__ __device__ size_t dg_bytes() const {
    return align16(static_cast<size_t>(BT) * ldg * sizeof(bf16));
  }
  // backward: W slice, h_prev[2], bf16 dgates, dh partials [2][C][U][BT]
  // f32
  __host__ __device__ size_t bwd_smem() const {
    return w_bytes() + h_bytes() + dg_bytes() +
           align16(static_cast<size_t>(2) * C * U * BT * sizeof(float));
  }
  // a geometry the kernels cannot run with at most max_u units and
  // max_threads threads a block
  __host__ __device__ static bool bad(
      int H, int c, int bt, int max_u = CLUSTER_MAX_U,
      int max_threads = CLUSTER_MAX_THREADS) {
    if (H % 32 != 0 || H <= 0 || H > 512) return true;
    if (c != 1 && c != 2 && c != 4 && c != 8 && c != 16) return true;
    if (bt != 8 && bt != 16 && bt != 32) return true;
    const ClusterGeo g(H, c, bt);
    return g.U > max_u || g.threads() > max_threads;
  }
};

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The h exchange of the cluster forwards, without a cluster barrier a
// step. Every block receives, for each step i >= 1, the h slices of all C
// blocks (`fill` bytes: BT x Hp values) into buffer i & 1 of its double
// buffer: each 16-byte st.async into another block's (or its own) shared
// memory completes its bytes on that block's mbarrier of the buffer, and a
// block waits on its own barrier alone. Fill k (steps 2k + 1 and 2k + 2)
// of buffer b completes phase k of barrier b; a barrier is re-armed (one
// arrive with the fill's expected bytes) right after its wait, for the
// fill two steps on. No block can send into a buffer before every block
// has read it: a block sends its step-i h after it has received every
// block's step-(i - 1) h, which each block sent after its step-(i - 1)
// product had read the same buffer.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_arm(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// a shared-memory address of this block as the same address in cluster
// block `rank`
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

// 16 bytes to cluster shared memory at dst, completing 16 bytes of the
// transaction of the barrier at bar (both in the receiving block)
__device__ __forceinline__ void st_async16(uint32_t dst, uint32_t bar,
                                           uint4 v) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(dst),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar)
      : "memory");
}

// 8 bytes (two 32-bit words) likewise
__device__ __forceinline__ void st_async8(uint32_t dst, uint32_t bar,
                                          uint2 v) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], "
      "{%1, %2}, [%3];\n" ::"r"(dst),
      "r"(v.x), "r"(v.y), "r"(bar)
      : "memory");
}

struct StepExchange {
  uint64_t* bar;  // [2] in shared memory
  uint32_t fill;  // bytes a block receives for one step
  int T;
  // thread 0: the barriers, armed for the first fill of each buffer; then
  // the caller's cluster.sync() publishes them
  __device__ __forceinline__ void init() const {
    if (threadIdx.x != 0) return;
    mbar_init(bar, 1);
    mbar_init(bar + 1, 1);
    if (T > 1) mbar_arm(bar + 1, fill);
    if (T > 2) mbar_arm(bar, fill);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // step i >= 1: buffer i & 1 holds every block's h of step i - 1
  __device__ __forceinline__ void wait(int i) const {
    mbar_wait(bar + (i & 1), ((i - 1) >> 1) & 1);
    if (threadIdx.x == 0 && i + 2 < T) mbar_arm(bar + (i & 1), fill);
  }
  // the barrier of buffer b in cluster block `rank`
  __device__ __forceinline__ uint32_t remote_bar(int b, int rank) const {
    return map_rank(smem_addr(bar + b), rank);
  }
};

// block r's slice (GATES U rows of Hp bf16, rows in the kernels' order)
// into the padded rows of w_s
template <typename Geo>
__device__ __forceinline__ void load_slice(bf16* w_s, const bf16* w_sl,
                                           const Geo& g, int r) {
  const int cpr = g.Hp / 8;  // 16-byte chunks a row
  const uint4* src = reinterpret_cast<const uint4*>(
      w_sl + static_cast<size_t>(r) * g.rows() * g.Hp);
  for (int e = threadIdx.x; e < g.rows() * cpr; e += blockDim.x) {
    const int row = e / cpr;
    const int c = e - row * cpr;
    *reinterpret_cast<uint4*>(w_s + static_cast<size_t>(row) * g.ldw +
                              c * 8) = src[e];
  }
}

// `rows` rows of `row_bytes` bytes (a multiple of 16), contiguous at src,
// into rows `ld` bytes apart at dst, 16 bytes a copy
__device__ __forceinline__ void load_rows(void* dst, int ld, const void* src,
                                          int row_bytes, int rows) {
  const int cpr = row_bytes / 16;
  const uint4* s = static_cast<const uint4*>(src);
  unsigned char* d = static_cast<unsigned char*>(dst);
  for (int e = threadIdx.x; e < rows * cpr; e += blockDim.x) {
    const int row = e / cpr;
    *reinterpret_cast<uint4*>(d + static_cast<size_t>(row) * ld +
                              (e - row * cpr) * 16) = s[e];
  }
}

// The step products of the cluster forwards, a k-chunk at a time, so that
// a caller can put other work between the chunks or keep the A fragments
// of its first chunks in registers for the whole walk (load_a once, then
// mma with them on every step): step(acc, ks) adds, for k-chunk ks, A rows
// (row0 + mt * 16 ..) . B^T columns (n0 + nt * 8 ..) to acc[mt][nt] on the
// tensor cores. A and B are rows lda and ldb bytes apart in shared memory
// (an odd multiple of 16 bytes: ldmatrix without bank conflicts), both
// read with ldmatrix. S8Product: int8 rows, mma.sync m16n8k32 s8, exact
// int32 sums, a 32-byte chunk from byte k0; BF16Product: bf16 rows,
// m16n8k16 with f32 accumulation, a 16-element (32-byte) chunk, each
// accumulator chained over the chunks in the order the caller steps them.
template <int MT, int NT, bool S8>
struct TileProduct {
  uint32_t a_addr, a_tile, b_addr;
  __device__ __forceinline__ TileProduct(const void* a_s, int lda, int row0,
                                         const void* b_s, int ldb, int n0,
                                         int k0, int lane) {
    const int mat = lane >> 3;
    const int lrow = lane & 7;
    const unsigned char* a = static_cast<const unsigned char*>(a_s);
    const unsigned char* b = static_cast<const unsigned char*>(b_s);
    a_addr = smem_addr(a + (row0 + (mat & 1) * 8 + lrow) * lda + k0 +
                       (mat >> 1) * 16);
    a_tile = 16 * lda;
    const int n = n0 + (NT == 2 ? (mat >> 1) * 8 : 0) + lrow;
    b_addr = smem_addr(b + n * ldb + k0 + (mat & 1) * 16);
  }
  __device__ __forceinline__ void load_a(uint32_t (&a)[MT][4], int ks) const {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) ldsm_x4(a[mt], a_addr + mt * a_tile + ks * 32);
  }
  template <typename Acc>
  __device__ __forceinline__ void mma(Acc (&acc)[MT][NT][4],
                                      const uint32_t (&a)[MT][4],
                                      int ks) const {
    if constexpr (NT == 2) {
      uint32_t b[4];
      ldsm_x4(b, b_addr + ks * 32);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if constexpr (S8) {
          mma_s8(acc[mt][0], a[mt], b[0], b[1]);
          mma_s8(acc[mt][1], a[mt], b[2], b[3]);
        } else {
          mma_bf16(acc[mt][0], a[mt], b[0], b[1]);
          mma_bf16(acc[mt][1], a[mt], b[2], b[3]);
        }
      }
    } else {
      uint32_t b[2];
      ldsm_x2(b, b_addr + ks * 32);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if constexpr (S8)
          mma_s8(acc[mt][0], a[mt], b[0], b[1]);
        else
          mma_bf16(acc[mt][0], a[mt], b[0], b[1]);
      }
    }
  }
  template <typename Acc>
  __device__ __forceinline__ void step(Acc (&acc)[MT][NT][4], int ks) const {
    uint32_t a[MT][4];
    load_a(a, ks);
    mma(acc, a, ks);
  }
};

template <int MT, int NT>
using S8Product = TileProduct<MT, NT, true>;
template <int MT, int NT>
using BF16Product = TileProduct<MT, NT, false>;

// 4 bf16 values (8 bytes) widened exactly to f64
__device__ __forceinline__ void widen4(uint2 v, double (&out)[4]) {
  out[0] = __uint_as_float(v.x << 16);
  out[1] = __uint_as_float(v.x & 0xffff0000u);
  out[2] = __uint_as_float(v.y << 16);
  out[3] = __uint_as_float(v.y & 0xffff0000u);
}

// TileProduct's interface and accumulator layout over bf16 rows, summed in
// f64 on the FP64 tensor cores (mma.sync m16n8k16 f64, one chain a tile):
// step(acc, ks) adds k-group ks (16 values, 32 bytes from byte k0) of A
// rows (row0 + mt * 16 ..) . B^T columns (n0 + nt * 8 ..) to acc[mt][nt],
// both operands widened exactly as they load. Within a group lane (gid,
// tig) supplies k = 4 tig + i as the mma's k index tig + 4 i, in A and B
// alike, so that it reads 4 consecutive values of each row at once. bf16
// values widen to f64 exactly and a product of two is exact in f64; a sum
// of up to 1,024 of them is exact but in the rarest cases (products whose
// exponents lie some 28 binades apart), so any order of the groups, and
// any split of them over warps, gives the same sum, and its one rounding
// to f32 the same f32.
template <int MT, int NT>
struct F64Product {
  const unsigned char* a;  // row gid of the first tile, byte k0 + 8 tig
  const unsigned char* b;  // column gid of the first n8 tile, the same
  int lda, ldb;
  __device__ __forceinline__ F64Product(const void* a_s, int lda_, int row0,
                                        const void* b_s, int ldb_, int n0,
                                        int k0, int lane)
      : lda(lda_), ldb(ldb_) {
    const int gid = lane >> 2;
    const int tig = lane & 3;
    a = static_cast<const unsigned char*>(a_s) + (row0 + gid) * lda + k0 +
        8 * tig;
    b = static_cast<const unsigned char*>(b_s) + (n0 + gid) * ldb + k0 +
        8 * tig;
  }
  __device__ __forceinline__ void step(double (&acc)[MT][NT][4],
                                       int ks) const {
    double bv[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      widen4(*reinterpret_cast<const uint2*>(b + nt * 8 * ldb + ks * 32),
             bv[nt]);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      double av[2][4];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        widen4(*reinterpret_cast<const uint2*>(a + (mt * 16 + hh * 8) * lda +
                                               ks * 32),
               av[hh]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_f64(acc[mt][nt], av, bv[nt]);
    }
  }
};

// acc[mt][nt] = W_s rows (q * MT * 16 + mt * 16 ..) . h^T columns
// ((p * NT + nt) * 8 ..): the gates of warp (q, p), f32 accumulation
// chained over the Hp / 16 k-chunks in order; W_slice is the A operand and
// bf16(h) the B operand, both read with ldmatrix from padded rows (the
// backward recurrences' product)
template <int MT, int NT, typename Geo>
__device__ __forceinline__ void gate_product(float (&acc)[MT][NT][4],
                                             const bf16* w_s,
                                             const bf16* h_s, const Geo& g,
                                             int q, int p, int lane) {
  const int ld = g.ldw * static_cast<int>(sizeof(bf16));
  const BF16Product<MT, NT> prod(w_s, ld, q * MT * 16, h_s, ld, p * NT * 8,
                                 0, lane);
  for (int ks = 0; ks < g.Hp / 16; ++ks) prod.step(acc, ks);
}

// (n, j) of a flat index e = n * m + j that a thread steps by s (its
// block's threads) in a loop: no division inside the loop
struct FlatWalk {
  int n, j, dn, dj, m;
  __device__ __forceinline__ FlatWalk(int e0, int s, int m_) : m(m_) {
    n = e0 / m;
    j = e0 - n * m;
    dn = s / m;
    dj = s - dn * m;
  }
  __device__ __forceinline__ void next() {
    n += dn;
    j += dj;
    if (j >= m) {
      j -= m;
      ++n;
    }
  }
};

// The backward's partial dh_prev = bf16(dgates)[:, its rows] . W[its rows,
// :] for every unit (BT x Hp, f32) on the tensor cores: W_slice^T (A,
// ldmatrix.trans) times the block's bf16 dgates (B, dg_s [BT][ldg]),
// f32 accumulation chained over the GATES U / 16 row chunks in order.
// 16-unit tile mt goes to the blocks that own its units: slot r of their
// receive buffer recv_slot ([C][U][BT] f32; this block's address, mapped
// to the owner's through distributed shared memory).
template <int NT, typename Geo>
__device__ __forceinline__ void dh_partials(cg::cluster_group& cluster,
                                            float* recv_slot,
                                            const bf16* w_s, const bf16* dg_s,
                                            const Geo& g, int r, int q, int p,
                                            int lane) {
  const int mat = lane >> 3;
  const int lrow = lane & 7;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int nb = p * NT * 8 + (NT == 2 ? (mat >> 1) * 8 : 0) + lrow;
  const uint32_t dg_addr = smem_addr(dg_s + nb * g.ldg + (mat & 1) * 8);
  const uint32_t wt_addr =
      smem_addr(w_s + ((mat >> 1) * 8 + lrow) * g.ldw + (mat & 1) * 8);
  float* dst_base = recv_slot + r * g.U * g.BT;
  for (int mt = q; mt < g.Hp / 16; mt += g.NG) {
    float acc2[NT][4] = {};
    for (int ks = 0; ks < g.rows() / 16; ++ks) {
      uint32_t a[4];
      ldsm_x4_t(a, wt_addr + (ks * 16 * g.ldw + mt * 16) * sizeof(bf16));
      if constexpr (NT == 2) {
        uint32_t bq[4];
        ldsm_x4(bq, dg_addr + ks * 32);
        mma_bf16(acc2[0], a, bq[0], bq[1]);
        mma_bf16(acc2[1], a, bq[2], bq[3]);
      } else {
        uint32_t bq[2];
        ldsm_x2(bq, dg_addr + ks * 32);
        mma_bf16(acc2[0], a, bq[0], bq[1]);
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int m = mt * 16 + gid + hh * 8;
      const int dest = m / g.U;
      float* dst = cluster.map_shared_rank(dst_base, dest) + (m % g.U) * g.BT;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        *reinterpret_cast<float2*>(dst + (p * NT + nt) * 8 + tig * 2) =
            make_float2(acc2[nt][2 * hh], acc2[nt][2 * hh + 1]);
    }
  }
}

// dynamic shared memory and, above the portable 8, the cluster size
template <typename Kern>
cudaError_t set_cluster_attributes(Kern kern, int C, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess && C > 8)
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

struct ClusterConfig {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  ClusterConfig(int C, int blocks, int threads, size_t smem,
                cudaStream_t stream) {
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// `clusters` clusters of C blocks of `threads` threads each
template <typename Kern, typename... Args>
cudaError_t launch_cluster(Kern kern, int C, int clusters, int threads,
                           size_t smem, cudaStream_t stream, Args... args) {
  cudaError_t err = set_cluster_attributes(kern, C, smem);
  if (err != cudaSuccess) return err;
  ClusterConfig cc(C, clusters * C, threads, smem, stream);
  err = cudaLaunchKernelEx(&cc.cfg, kern, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// clusters of C blocks that can be resident at once
// (cudaOccupancyMaxActiveClusters); a negative value is minus a cudaError_t
template <typename Kern>
int max_clusters(Kern kern, int C, int threads, size_t smem) {
  cudaError_t err = set_cluster_attributes(kern, C, smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  ClusterConfig cc(C, C, threads, smem, nullptr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kern, &cc.cfg);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return n;
}

}  // namespace
