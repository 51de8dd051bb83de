#!/usr/bin/env python3
"""Split one step of the f32-gates cluster GRU forward of PR 9's design
into its phases on one GPU (clock64 marks).

    python3 chip_phases.py --tree DIR

DIR is a checkout of the tree at PR 9 (``git archive`` of that commit),
whose ``medaka_tpu_torch/csrc/gru_rec.cuh`` holds that design: the
script compiles a copy of its ``gru_cluster_fwd_kernel`` with a clock64
mark after each phase of a step (the cluster barrier's wait, the mma
chain, the gates, the block's __syncthreads, the h exchange and output
stores, the barrier's arrive and the next step's projection loads)
against that checkout's headers, runs both directions at H=256, T=2000
on clusters of 4, 8 and 16 blocks at B=16 (8- and 16-column tiles) and
over one column, and prints the mean and largest cycles of each phase a
step over the blocks' warps, the marked and the unmarked launch's time,
and whether the marked launch gives the unmarked one's bits. It is the
measurement behind PERF.md's step split of that design (the redesign of
PR 10 removed the barrier and the block-wide exchange it measures).

Needs a CUDA GPU and ``nvcc``; imports nothing of JAX or ``medaka_tpu``.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
PHASES = ("barrier_wait", "mma_chain", "gates", "syncthreads",
          "exchange_out", "arrive_loadx")
MARKED = r"""
#include "gru_rec.cuh"

namespace {
constexpr int NPH = 6;
template <int NT>
__global__ void __launch_bounds__(GRU_MAX_THREADS)
    marked_kernel(ClusterArgs a, long long* marks) {
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
  constexpr int NC = 2 * NT;
  bf16* w_s = reinterpret_cast<bf16*>(smem);
  bf16* h_s = reinterpret_cast<bf16*>(smem + g.w_bytes());
  bf16* st_h = reinterpret_cast<bf16*>(smem + g.w_bytes() + g.h_bytes());
  load_slice(w_s, pick(a.w_sl, d), g, r);
  for (int e = threadIdx.x; e < 2 * BT * g.ldw; e += blockDim.x)
    h_s[e] = __float2bfloat16_rn(0.0f);
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
  cluster.sync();
  long long acc_ph[NPH] = {};
  const int u8 = U / 8;
  for (int i = 0; i < T; ++i) {
    const int cur = i & 1;
    const int t = reverse ? T - 1 - i : i;
    long long m0 = clock64();
    if (i > 0) cluster_wait();
    long long m1 = clock64();
    float acc[3][NT][4] = {};
    gate_product(acc, w_s, h_s + cur * BT * g.ldw, g, q, p, lane);
    // force the product to finish before the mark
    float sink = acc[0][0][0] + acc[2][NT - 1][3];
    asm volatile("" ::"f"(sink));
    long long m2 = clock64();
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
    long long m3 = clock64();
    __syncthreads();
    long long m4 = clock64();
    if (i + 1 < T) {
      bf16* nxt = h_s + (cur ^ 1) * BT * g.ldw + r * U;
      for (int e = threadIdx.x; e < C * BT * u8; e += blockDim.x) {
        const int dst_rank = e / (BT * u8);
        const int rem = e - dst_rank * BT * u8;
        const int n = rem / u8;
        const int k8 = rem - n * u8;
        bf16* dst = cluster.map_shared_rank(nxt, dst_rank) + n * g.ldw + k8 * 8;
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
    long long m5 = clock64();
    cluster_arrive();
    if (i + 1 < T) load_x(reverse ? T - 2 - i : i + 1);
    long long m6 = clock64();
    acc_ph[0] += m1 - m0; acc_ph[1] += m2 - m1; acc_ph[2] += m3 - m2;
    acc_ph[3] += m4 - m3; acc_ph[4] += m5 - m4; acc_ph[5] += m6 - m5;
  }
  cluster_wait();
  if (lane == 0) {
    long long* dst = marks + (static_cast<size_t>(blockIdx.x) * 32 + warp) * NPH;
    for (int k = 0; k < NPH; ++k) dst[k] = acc_ph[k];
  }
}
}  // namespace

extern "C" int marked_launch(const void* xp_f, const void* xp_b, const void* w_sl,
                             const float* b_hh, const int* lengths, void* out_f,
                             void* out_b, int T, int B, int H, int C, int BT,
                             long long* marks, void* stream) {
  const GruGeo g(H, C, BT);
  const bf16* w = static_cast<const bf16*>(w_sl);
  ClusterArgs a{};
  a.xp[0] = static_cast<const bf16*>(xp_f);
  a.xp[1] = static_cast<const bf16*>(xp_b);
  a.w_sl[0] = w;
  a.w_sl[1] = w + static_cast<size_t>(C) * g.rows() * g.Hp;
  a.b_hh[0] = b_hh;
  a.b_hh[1] = b_hh + 3 * H;
  a.out[0] = static_cast<bf16*>(out_f);
  a.out[1] = static_cast<bf16*>(out_b);
  a.reverse[0] = 0;
  a.reverse[1] = 1;
  a.lengths = lengths;
  a.ld_out = 2 * H;
  a.T = T; a.B = B; a.H = H; a.C = C; a.BT = BT; a.dirs = 2;
  const int clusters = 2 * ((B + BT - 1) / BT);
  const size_t smem = gru_cluster_fwd_smem(g);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = g.NT == 2
      ? launch_cluster(marked_kernel<2>, C, clusters, g.threads(), smem, s, a, marks)
      : launch_cluster(marked_kernel<1>, C, clusters, g.threads(), smem, s, a, marks);
  return static_cast<int>(e);
}
"""


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", required=True,
                        help="checkout of the tree at PR 9")
    parser.add_argument("--steps", type=int, default=2000)
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_phases: no CUDA GPU is available", file=sys.stderr)
        return 1
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    sys.path.insert(1, HERE)
    import chip_smoke as cs
    from medaka_tpu_torch.ops import cuda_build, gru_fullfused, rnn_cluster
    work = tempfile.mkdtemp(prefix="chip_phases_")
    src, so = os.path.join(work, "phase.cu"), os.path.join(work, "phase.so")
    with open(src, "w") as fh:
        fh.write(MARKED)
    subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-I",
                    os.path.join(tree, "medaka_tpu_torch", "csrc"), "-o", so,
                    src], check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    V, I = ctypes.c_void_p, ctypes.c_int
    lib.marked_launch.argtypes = [V] * 7 + [I] * 5 + [V, V]
    lib.marked_launch.restype = I
    dev = torch.device("cuda")
    torch.manual_seed(0)
    H, T = 256, args.steps
    k = 1 / H ** 0.5
    res = {}
    for B, BT in ((16, 8), (16, 16), (1, 8)):
        for C in (4, 8, 16):
            w_hh = (torch.rand(2, 3 * H, H, device=dev) * 2 - 1) * k
            b_hh = ((torch.rand(2, 3 * H, device=dev) * 2 - 1) * k
                    ).contiguous()
            xp = (torch.rand(2, T, B, 3 * H, device=dev) * 4 - 2).to(
                torch.bfloat16)
            ln = torch.full((B,), T, dtype=torch.int32, device=dev)
            w_op = torch.stack([rnn_cluster.w_slices(rnn_cluster.GRU, w, C)
                                for w in w_hh]).contiguous()
            out = torch.empty(T, B, 2 * H, dtype=torch.bfloat16, device=dev)
            marks = torch.zeros(2 * -(-B // BT) * C * 32 * len(PHASES),
                                dtype=torch.int64, device=dev)
            stream = torch.cuda.current_stream().cuda_stream

            def marked():
                err = lib.marked_launch(
                    xp[0].data_ptr(), xp[1].data_ptr(), w_op.data_ptr(),
                    b_hh.data_ptr(), ln.data_ptr(), out.data_ptr(),
                    out[..., H:].data_ptr(), T, B, H, C, BT,
                    marks.data_ptr(), stream)
                if err:
                    raise RuntimeError("marked launch failed: {}".format(err))

            ms = cs.cuda_ms(marked)
            ref = gru_fullfused.fused_layer(xp[0], xp[1], w_hh, b_hh, ln)
            plain_ms = cs.cuda_ms(lambda: gru_fullfused.fused_layer(
                xp[0], xp[1], w_hh, b_hh, ln))
            warps = rnn_cluster.threads(rnn_cluster.GRU, H, C, BT) // 32
            m = marks.view(-1, 32, len(PHASES))[:, :warps].cpu().double()
            key = "B{}_C{}_BT{}".format(B, C, BT)
            res[key] = {
                "marked_ms": ms, "unmarked_ms": plain_ms,
                "same_bits": torch.equal(ref, out),
                "cycles_mean": dict(zip(PHASES, (m.mean(dim=(0, 1)) / T)
                                        .tolist())),
                "cycles_max": dict(zip(PHASES, (m.amax(dim=(0, 1)) / T)
                                       .tolist()))}
            print(key, json.dumps(res[key]), flush=True)
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"card": cs.card_line(), "sm_clocks": clocks.strip(),
                      "phases": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
