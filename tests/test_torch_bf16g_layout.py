"""Host side of the bf16-gates cluster recurrence, on the CPU.

``bigru_fullfused``'s bf16-gates mode runs the GRU forward of
``csrc/gru_rec.cuh`` in mode NUM_BF16G (``rnn_cluster.GRU_BF16G``): the
GRU's bf16 slices of W_hh, widened to f64 as they load, the step's
product on the FP64 tensor cores with its k-groups
split over the S warps of a tile and the partial sums added in warp order.
These tests need no GPU and no JAX: the geometry against a stand-in
``max_clusters``, the slices read back as the kernel indexes them, and the
claim the design rests on, that f64 sums of bf16 products taken in the
kernel's order round to the f32 the plain version's f64 ``bmm`` gives.
"""
import numpy as np
import pytest
import torch

from medaka_tpu_torch.ops import cuda_build, gru_fullfused, rnn_cluster
from tests.torch_threads import one_thread  # noqa: F401

BF16G = rnn_cluster.GRU_BF16G
HIDDEN = (32, 64, 96, 128, 160, 192, 256, 288, 384, 448, 512)
BATCH = (1, 5, 16, 31, 64, 128, 512)


def _resident(cluster, columns, smem):
    """An H100's resident clusters, roughly: 132 SMs over the cluster."""
    return 132 // cluster


def _a16(v):
    return -(-v // 16) * 16


def _geo(H, C, BT):
    """(U, Hp, NT, tiles, S) as the kernel derives them (ClusterGeo,
    gru_gate_split)."""
    U = -(-H // (16 * C)) * 16
    NT = 2 if BT >= 16 else 1
    tiles = (U // 16) * (BT // (8 * NT))
    S = 4 if 4 * 32 * tiles <= 256 else (2 if 2 * 32 * tiles <= 256 else 1)
    return U, C * U, NT, tiles, S


def _smem(H, C, BT):
    """The bf16-gates forward's shared memory as ``gru_cluster_fwd_smem``
    carves it: W slice [3U] and h [2][BT] in bf16 rows of Hp + 16, the S
    warps' f64 partial sums of each tile's 12 NT accumulators a lane, the
    staged bf16 h [BT][U], two mbarriers."""
    U, Hp, NT, tiles, S = _geo(H, C, BT)
    row = 2 * Hp + 32
    part = S * tiles * 12 * NT * 32 * 8 if S > 1 else 0
    return (_a16(3 * U * row) + _a16(2 * BT * row) + _a16(part)
            + _a16(BT * U * 2) + 16)


@pytest.mark.parametrize("H", HIDDEN)
@pytest.mark.parametrize("B", BATCH)
def test_geometry(H, B):
    """At most 32 units a block (a multiple of 16, Hp = C U covering H), at
    most 256 threads; the cluster size whose block takes the least of the
    step's product (C U^2) among those that run in one wave, or the least
    of all where none does; the bytes the kernel carves, within the
    limit."""
    C, BT, smem = rnn_cluster.choose_geometry(
        BF16G, "fwd", H, B, cuda_build.SMEM_LIMIT, _resident, directions=2)
    U, Hp, NT, tiles, S = _geo(H, C, BT)
    assert U == rnn_cluster.units_per_block(BF16G, H, C)
    assert U <= 32 and U % 16 == 0 and Hp >= H
    assert rnn_cluster.threads(BF16G, H, C, BT) * S <= 256
    assert rnn_cluster.gate_split(BF16G, H, C, BT) == S
    assert smem == _smem(H, C, BT) <= cuda_build.SMEM_LIMIT
    assert smem == rnn_cluster.smem_bytes(BF16G, "fwd", C, BT, H)

    def work(c):
        return c * rnn_cluster.units_per_block(BF16G, H, c) ** 2

    fitting = [c for c in rnn_cluster.CLUSTER_SIZES
               if rnn_cluster.units_per_block(BF16G, H, c) <= 32
               and _smem(H, c, 8) <= cuda_build.SMEM_LIMIT]
    one_wave = [c for c in fitting if any(
        2 * -(-B // bt) <= _resident(c, bt, 0) for bt in (8, 16, 32)
        if _smem(H, c, bt) <= cuda_build.SMEM_LIMIT)]
    assert work(C) == min(work(c) for c in (one_wave or fitting))
    if one_wave:
        assert 2 * -(-B // BT) <= _resident(C, BT, smem)
    if B == 1:
        # clusters of 16 units a block where H allows, 32 above H=256
        assert U == (16 if H <= 256 else 32)


def test_geometry_takes_a_larger_block_for_one_wave():
    """Where clusters of 16 would need a second wave at every tile, the
    chooser takes the next cluster size by work (clusters of 8, 32 units)
    if that runs in one."""
    def scarce(cluster, columns, smem):
        return 4 if cluster == 16 else 132 // cluster
    C, BT, smem = rnn_cluster.choose_geometry(
        BF16G, "fwd", 256, 128, cuda_build.SMEM_LIMIT, scarce, directions=2)
    assert (C, BT) == (8, 16)
    assert smem == _smem(256, 8, 16)


def test_no_cluster_fits_raises():
    with pytest.raises(ValueError, match="no cluster size fits"):
        rnn_cluster.choose_geometry(BF16G, "fwd", 512, 1, 60000, _resident)
    with pytest.raises(RuntimeError, match="bigru_fullfused/bf16_gates"):
        rnn_cluster.choose_geometry(
            BF16G, "fwd", 256, 16, cuda_build.SMEM_LIMIT,
            lambda cluster, columns, smem: 0, directions=2,
            name="bigru_fullfused/bf16_gates")


def _weights(rng, H):
    k = 1.0 / np.sqrt(H)
    return (torch.from_numpy(rng.uniform(-k, k, (2, 3 * H, H)).astype(
                np.float32)),
            torch.from_numpy(rng.uniform(-k, k, (2, 3 * H)).astype(
                np.float32)))


@pytest.mark.parametrize("H,C,BT", [(96, 8, 8), (256, 16, 8), (256, 8, 16),
                                    (160, 16, 16), (512, 16, 8),
                                    (100, 8, 8)])
def test_slices_reassemble_w_hh(H, C, BT):
    """Row q*48 + g*16 + u of slice r holds bf16(W_hh) of gate g of unit
    r U + q 16 + u over the first H columns, zero past H and for padded
    units, in bf16 at every tile width BT."""
    rng = np.random.default_rng(H + C + BT)
    w_hh, _ = _weights(rng, H)
    sl, scale = gru_fullfused._cluster_operand(w_hh, C, "bf16_gates")
    assert scale is None
    U = rnn_cluster.units_per_block(BF16G, H, C)
    Hp = C * U
    assert sl.shape == (2, C, 3 * U, Hp)
    assert sl.dtype == torch.bfloat16
    w16 = w_hh.to(torch.bfloat16)
    back = torch.zeros((2, 3, Hp, Hp), dtype=torch.float64)
    for r in range(C):
        for q in range(U // 16):
            for g in range(3):
                rows = sl[:, r, q * 48 + g * 16:q * 48 + g * 16 + 16]
                back[:, g, r * U + q * 16:r * U + q * 16 + 16] = \
                    rows.double()
    want = torch.zeros((2, 3, Hp, Hp), dtype=torch.float64)
    want[:, :, :H, :H] = w16.double().reshape(2, 3, H, H)
    assert torch.equal(back, want)


def _h_wide_exponents(rng, B, H):
    """bf16 values of h over some 40 binades (and some zeros), both signs:
    the products of W_hh and h then span more binades than an f64
    significand holds, the hardest case for the order-free claim."""
    mag = 2.0 ** rng.uniform(-40, 0, (2, B, H))
    h = np.where(rng.random((2, B, H)) < 0.05, 0.0,
                 mag * rng.choice([-1.0, 1.0], (2, B, H)))
    return torch.from_numpy(h.astype(np.float32)).to(torch.bfloat16).float()


def _kernel_order_sums(h, w_hh, C, BT, dtype):
    """The recurrent product (2, B, 3H) of both directions as the
    bf16-gates kernel adds it: for each block's slice, each of the S warps
    of a tile sums its k-groups [s G / S, (s + 1) G / S) (16 k each, one
    m16n8k16 f64 mma a group) into its accumulator, then the S partial
    sums are added in warp order starting from 0. ``dtype`` float64 is the
    kernel; float32 the same order in f32."""
    H = w_hh.shape[-1]
    sl, _ = gru_fullfused._cluster_operand(w_hh, C, "bf16_gates")
    U = sl.shape[2] // 3
    Hp = C * U
    S = rnn_cluster.gate_split(BF16G, H, C, BT)
    hb = torch.zeros(h.shape[:2] + (Hp,), dtype=torch.float64)
    hb[..., :H] = h.double()
    groups = Hp // 16
    total = 0.0
    for s in range(S):
        acc = torch.zeros(h.shape[:2] + (C, 3 * U), dtype=dtype)
        for j in range(s * groups // S, (s + 1) * groups // S):
            k = slice(16 * j, 16 * j + 16)
            acc = acc + torch.einsum("dbk,dcrk->dbcr", hb[..., k].to(dtype),
                                     sl[..., k].double().to(dtype))
        total = total + acc
    # slice rows q*48 + g*16 + u -> gate-major (3, Hp) columns
    B = h.shape[1]
    out = total.reshape(2, B, C, U // 16, 3, 16).permute(0, 1, 4, 2, 3, 5)
    return out.reshape(2, B, 3, Hp)[..., :H].reshape(2, B, 3 * H)


@pytest.mark.parametrize("H,B", [(32, 16), (96, 31), (256, 16), (256, 128),
                                 (384, 16), (512, 8), (100, 5)])
def test_f64_sums_in_kernel_order_equal_the_plain_product(H, B):
    """The claim the bf16-gates kernel rests on: its f64 sums of bf16
    products, taken over the slices, k-groups and warps in its order and
    rounded once to f32, are bit for bit the f64 ``bmm`` of ``_cell``
    rounded to f32, with h spread over 40 binades. The same order summed
    in f32 (the mutation the design excludes) is not."""
    rng = np.random.default_rng(H * 7 + B)
    w_hh, _ = _weights(rng, H)
    h = _h_wide_exponents(rng, B, H)
    C, BT, _ = rnn_cluster.choose_geometry(
        BF16G, "fwd", -(-H // 32) * 32, B, cuda_build.SMEM_LIMIT, _resident,
        directions=2)
    w_t, _ = gru_fullfused._recurrent_weights(w_hh, "bf16_gates", "cpu")
    want = torch.bmm(gru_fullfused._bf16(h).double(), w_t.double()).float()
    # the kernel's zero units past H (the wrapper's padding)
    Hp = -(-H // 32) * 32
    w_pad, _ = gru_fullfused._pad_recurrent(w_hh, torch.zeros(2, 3 * H), H,
                                            Hp)
    h_pad = torch.nn.functional.pad(h, [0, Hp - H])

    def unpad(v):
        return v.reshape(2, B, 3, Hp)[..., :H].reshape(2, B, 3 * H)
    got = unpad(_kernel_order_sums(h_pad, w_pad, C, BT, torch.float64))
    assert torch.equal(got.float(), want)
    in_f32 = unpad(_kernel_order_sums(h_pad, w_pad, C, BT, torch.float32))
    assert not torch.equal(in_f32, want)


@pytest.mark.parametrize("H,C,BT", [(96, 8, 8), (256, 16, 8), (384, 16, 16)])
def test_step_from_the_slices_equals_the_plain_recurrence(H, C, BT):
    """The bf16-gates recurrence emulated from the kernel's slices (f64
    sums in its order, rounded once to f32, + b_hh, then the bf16 gates)
    equals ``recurrence_plain(mode="bf16_gates")`` bit for bit, ragged
    lengths with a padded row."""
    rng = np.random.default_rng(H + C + BT)
    T, B = 6, 4
    w_hh, b_hh = _weights(rng, H)
    xp_f, xp_b = (torch.from_numpy(rng.uniform(-2, 2, (T, B, 3 * H)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(2))
    lengths = torch.tensor([T, 0, 3, 1], dtype=torch.int32)
    want = gru_fullfused.recurrence_plain(xp_f, xp_b, w_hh, b_hh, lengths,
                                          "bf16_gates")
    h = torch.zeros((2, B, H))
    out = torch.empty((T, B, 2 * H), dtype=torch.bfloat16)
    for i in range(T):
        hp = _kernel_order_sums(gru_fullfused._bf16(h), w_hh, C, BT,
                                torch.float64).float() + b_hh[:, None]
        for d, t, xp in ((0, i, xp_f), (1, T - 1 - i, xp_b)):
            hn = gru_fullfused._gates_bf16(hp[d], xp[t], h[d])
            h[d] = torch.where((lengths > t)[:, None], hn, h[d])
            out[t, :, d * H:(d + 1) * H] = h[d].to(torch.bfloat16)
    assert torch.equal(out, want)
