"""Host side of the inference cluster recurrences, on the CPU.

``bigru_fullfused_int8`` runs the int8 GRU forward of ``csrc/gru_rec.cuh``
(``rnn_cluster.GRU_INT8``: int8 W_hh slices in the split kernels' row
order, per-row scales) and ``bilstm_fused`` the LSTM forward of
``csrc/lstm_fwd.cuh`` with both directions in one grid. These tests need
no GPU: the geometry against a stand-in ``max_clusters``, the slices read
back as the kernels index them, and one recurrence emulated slice by
slice against the plain versions.
"""
import numpy as np
import pytest
import torch

from medaka_tpu_torch.ops import (bilstm, cuda_build, gru_fullfused,
                                  lstm_train, rnn_cluster)
from medaka_tpu_torch.ops.gru_train import _sigmoid
from tests.torch_threads import one_thread  # noqa: F401

INT8 = rnn_cluster.GRU_INT8
LSTM = rnn_cluster.LSTM


def _resident(cluster, columns, smem):
    """An H100's resident clusters, roughly: 132 SMs over the cluster."""
    return 132 // cluster


def _int8_smem(H, C, BT):
    """The int8 forward's shared memory as ``gru_cluster_fwd_smem`` carves
    it: W slice and h [2][BT] in rows of Hp + 16 bytes, the staged int8 and
    bf16 h [BT][U], two mbarriers."""
    U = rnn_cluster.units_per_block(INT8, H, C)
    row = C * U + 16

    def a16(v):
        return -(-v // 16) * 16
    return (a16(3 * U * row) + a16(2 * BT * row) + a16(BT * U)
            + a16(BT * U * 2) + 16)


@pytest.mark.parametrize("H", [96, 256, 384, 512])
@pytest.mark.parametrize("B", [1, 16, 31])
def test_int8_geometry_over_two_directions(H, B):
    """At most 32 units a block (clusters of 4 at H=96, 8 at H=256, 16 at
    H=384 and 512), the smallest tile whose 2 ceil(B / BT) clusters run in
    one wave, at most 256 threads, and the byte count the kernel carves."""
    C, BT, smem = rnn_cluster.choose_geometry(
        INT8, "fwd", H, B, cuda_build.SMEM_LIMIT, _resident, directions=2)
    assert C == {96: 4, 256: 8, 384: 16, 512: 16}[H]
    U = rnn_cluster.units_per_block(INT8, H, C)
    assert U <= INT8.max_units and U % 16 == 0 and C * U >= H
    assert BT == 8 and 2 * -(-B // BT) <= _resident(C, BT, smem)
    assert rnn_cluster.threads(INT8, H, C, BT) <= 256
    assert smem == rnn_cluster.smem_bytes(INT8, "fwd", C, BT, H)
    assert smem == _int8_smem(H, C, BT) <= cuda_build.SMEM_LIMIT


def test_int8_geometry_widens_the_tile_when_clusters_are_scarce():
    """Where 8-column tiles would need a second wave, a larger tile of the
    same cluster size is taken (the chooser's rule for every layout)."""
    got = rnn_cluster.choose_geometry(
        INT8, "fwd", 256, 31, cuda_build.SMEM_LIMIT,
        lambda C, BT, smem: 4, directions=2)
    assert got == (8, 16, _int8_smem(256, 8, 16))


def _int8_weights(rng, H):
    k = 1.0 / np.sqrt(H)
    w_hh = torch.from_numpy(rng.uniform(-k, k, (2, 3 * H, H)).astype(
        np.float32))
    b_hh = torch.from_numpy(rng.uniform(-k, k, (2, 3 * H)).astype(
        np.float32))
    return w_hh, b_hh


@pytest.mark.parametrize("H,C", [(96, 4), (256, 8), (100, 4), (512, 16)])
def test_int8_slices_and_scales_read_back(H, C):
    """Row q*48 + g*16 + u of slice r holds gate g of unit r U + q 16 + u:
    its int8 weights over the first H columns (zero past H and for padded
    units) and its scale are ``_quantize_cols``'s for that gate row."""
    rng = np.random.default_rng(H)
    w_hh, _ = _int8_weights(rng, H)
    w_sl, scale = gru_fullfused._cluster_operand(w_hh, C, "int8")
    w_q, sc = gru_fullfused._quantize_cols(w_hh.transpose(1, 2))
    U = rnn_cluster.units_per_block(INT8, H, C)
    Hp = C * U
    assert w_sl.shape == (2, C, 3 * U, Hp) and w_sl.dtype == torch.int8
    assert scale.shape == (2, C, 3 * U) and scale.dtype == torch.float32
    for d in range(2):
        for j in range(Hp):
            r, ju = divmod(j, U)
            q, u = divmod(ju, 16)
            for g in range(3):
                row = q * 48 + g * 16 + u
                if j < H:
                    assert torch.equal(w_sl[d, r, row, :H],
                                       w_q[d, :, g * H + j])
                    assert scale[d, r, row] == sc[d, 0, g * H + j]
                else:
                    assert not w_sl[d, r, row].any()
                    assert scale[d, r, row] == 0
                assert not w_sl[d, r, row, H:].any()


def _emulate_int8(xp_f, xp_b, w_hh, b_hh, lengths, C):
    """Both directions of the int8 recurrence as the cluster kernel computes
    them: round(127 h) gathered over every block's units, each block's
    int32 products with its own int8 slice and per-row scales, hp =
    f32(dot) * scale + b_hh, then the f32 gates; h of unit j from the row
    of its block. Returns (T, B, 2H) bf16."""
    T, B, G = xp_f.shape
    H = G // 3
    w_sl, scale = gru_fullfused._cluster_operand(w_hh, C, "int8")
    U = w_sl.shape[2] // 3
    Hp = C * U
    h = torch.zeros((2, B, Hp))
    out = torch.empty((T, B, 2 * H), dtype=torch.bfloat16)
    for i in range(T):
        hq = torch.clamp(torch.round(h * 127.0), -128, 127).to(torch.int64)
        hp = torch.zeros((2, B, 3, Hp))
        for d in range(2):
            for r in range(C):
                dot = hq[d] @ w_sl[d, r].to(torch.int64).t()   # (B, 3U)
                v = dot.float() * scale[d, r] + 0.0
                rows = v.reshape(B, U // 16, 3, 16)           # q, g, u
                hp[d, :, :, r * U:(r + 1) * U] = rows.permute(
                    0, 2, 1, 3).reshape(B, 3, U)
        hp = hp[..., :H] + b_hh.reshape(2, 1, 3, H)
        for d, t, xp in ((0, i, xp_f), (1, T - 1 - i, xp_b)):
            xf = xp[t].float().reshape(B, 3, H)
            r_ = _sigmoid(xf[:, 0] + hp[d, :, 0])
            z = _sigmoid(xf[:, 1] + hp[d, :, 1])
            n = torch.tanh(xf[:, 2] + r_ * hp[d, :, 2])
            hn = (1.0 - z) * n + z * h[d, :, :H]
            keep = (lengths > t)[:, None]
            h[d, :, :H] = torch.where(keep, hn, h[d, :, :H])
            out[t, :, d * H:(d + 1) * H] = h[d, :, :H].to(torch.bfloat16)
    return out


@pytest.mark.parametrize("H,C", [(96, 4), (256, 8), (100, 4)])
def test_int8_step_from_the_slices_equals_the_plain_recurrence(H, C):
    """The int8 recurrence emulated slice by slice (exact int32 products)
    equals ``recurrence_plain(mode="int8")`` bit for bit, ragged lengths
    with a padded row: the slices and scales carry the plain version's
    numbers, and no sum depends on its order."""
    rng = np.random.default_rng(H + C)
    T, B = 5, 4
    w_hh, b_hh = _int8_weights(rng, H)
    xp_f, xp_b = (torch.from_numpy(rng.uniform(-2, 2, (T, B, 3 * H)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(2))
    lengths = torch.tensor([T, 0, 3, 1], dtype=torch.int32)
    want = gru_fullfused.recurrence_plain(xp_f, xp_b, w_hh, b_hh, lengths,
                                          "int8")
    got = _emulate_int8(xp_f, xp_b, w_hh, b_hh, lengths, C)
    assert torch.equal(got, want)
    # the wrapper's CPU route is that plain version
    assert torch.equal(gru_fullfused.int8_recurrence(
        xp_f, xp_b, w_hh, b_hh, lengths), want)


@pytest.mark.parametrize("H", [128, 384])
@pytest.mark.parametrize("B", [1, 128])
def test_bilstm_geometry_over_two_directions(H, B):
    """``bilstm_fused``'s launch: the LSTM layout with both directions'
    clusters in one grid, clusters of 2 at H=128 (64 units a block) and 8
    at H=384, the smallest tile whose clusters run in one wave, and the
    forward's byte count (W slice, h [2], staged h and c, two mbarriers)."""
    C, BT, smem = rnn_cluster.choose_geometry(
        LSTM, "fwd", H, B, cuda_build.SMEM_LIMIT, _resident, directions=2)
    assert C == {128: 2, 384: 8}[H]
    U = rnn_cluster.units_per_block(LSTM, H, C)
    ldw = C * U + 8
    assert smem == (4 * U * ldw * 2 + 2 * BT * ldw * 2 + BT * U * 2
                    + BT * U * 4 + 16)
    assert smem == lstm_train.smem_bytes("fwd", C, BT, H)
    assert 2 * -(-B // BT) <= _resident(C, BT, smem) or BT == 32
    if B == 1:
        assert BT == 8


@pytest.mark.parametrize("H,C", [(128, 2), (384, 8), (128, 1)])
def test_bilstm_slices_reassemble_w_hh(H, C):
    """``bilstm.w_slices``: each direction's ``lstm_train.w_slices``, rows
    q*32 + g*8 + u of slice r holding gate g of unit r U + q 8 + u."""
    rng = np.random.default_rng(H + C)
    w_hh = torch.from_numpy(rng.uniform(-1, 1, (2, 4 * H, H)).astype(
        np.float32))
    sl = bilstm.w_slices(w_hh, C)
    U = rnn_cluster.units_per_block(LSTM, H, C)
    assert sl.shape == (2, C, 4 * U, C * U) and sl.dtype == torch.bfloat16
    w16 = w_hh.to(torch.bfloat16)
    for d in range(2):
        for j in range(H):
            r, ju = divmod(j, U)
            q, u = divmod(ju, 8)
            for g in range(4):
                assert torch.equal(sl[d, r, q * 32 + g * 8 + u, :H],
                                   w16[d, g * H + j])


@pytest.mark.parametrize("H,C", [(128, 2), (384, 8)])
def test_lstm_step_from_the_slices_matches_the_plain_version(H, C):
    """Both LSTM directions emulated from the slices (each block's bf16(h)
    . W_slice^T summed in f64, the gates and c in f32) within one bf16
    step (2^-8) of ``bilstm_fused_plain``: only the order of the f32 sums
    of the recurrent product differs."""
    rng = np.random.default_rng(H)
    T, B = 4, 3
    k = 1.0 / np.sqrt(H)
    xp_f, xp_b = (torch.from_numpy(rng.uniform(-2, 2, (T, B, 4 * H)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(2))
    w_hh = torch.from_numpy(rng.uniform(-k, k, (2, 4 * H, H)).astype(
        np.float32))
    b_hh = torch.from_numpy(rng.uniform(-k, k, (2, 4 * H)).astype(
        np.float32))
    lengths = torch.tensor([T, 2, 0], dtype=torch.int32)
    want_f, want_b = bilstm.bilstm_fused_plain(xp_f, xp_b, w_hh, b_hh,
                                               lengths)
    sl = bilstm.w_slices(w_hh, C).double()
    U = sl.shape[2] // 4
    h = torch.zeros((2, B, C * U))
    c = torch.zeros((2, B, H))
    got = torch.empty((2, T, B, H), dtype=torch.bfloat16)
    for i in range(T):
        hb = h.to(torch.bfloat16).double()
        gates = torch.zeros((2, B, 4, C * U))
        for d in range(2):
            for r in range(C):
                v = (hb[d] @ sl[d, r].t()).float()            # (B, 4U)
                gates[d, :, :, r * U:(r + 1) * U] = v.reshape(
                    B, U // 8, 4, 8).permute(0, 2, 1, 3).reshape(B, 4, U)
        for d, t, xp in ((0, i, xp_f), (1, T - 1 - i, xp_b)):
            g = (gates[d, :, :, :H] + b_hh[d].reshape(4, H)
                 + xp[t].float().reshape(B, 4, H))
            gi, gf = _sigmoid(g[:, 0]), _sigmoid(g[:, 1])
            gg, go = torch.tanh(g[:, 2]), _sigmoid(g[:, 3])
            cn = gf * c[d] + gi * gg
            hn = go * torch.tanh(cn)
            keep = (lengths > t)[:, None]
            h[d, :, :H] = torch.where(keep, hn, h[d, :, :H])
            c[d] = torch.where(keep, cn, c[d])
            got[d, t] = h[d, :, :H].to(torch.bfloat16)
    for g, w in ((got[0], want_f), (got[1], want_b)):
        assert (g.float() - w.float()).abs().max().item() <= 2.0 ** -8
