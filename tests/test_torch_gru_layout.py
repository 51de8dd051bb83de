"""The GRU cluster kernels' host side on the CPU: the launch geometry and
the per-block W_hh slices of ``medaka_tpu_torch.ops.rnn_cluster`` with the
GRU's row order, as ``gru_train.gru_fwd``/``gru_bwd`` and the f32-gates
launches of ``gru_fullfused`` (``bigru_fullfused``, ``bigru_fused``) use
them.

The kernels themselves run only on the card (tests/test_torch_cuda.py);
what they are given is decided here, in pure Python.
"""
import contextlib
import types

import numpy as np
import pytest
import torch

from medaka_tpu_torch.ops import cuda_build, gru_fullfused, gru_train, \
    rnn_cluster
from medaka_tpu_torch.ops.rnn_cluster import GRU
from tests.torch_threads import one_thread  # noqa: F401

N_SM = 132
BATCHES = [1, 5, 16, 31, 128, 512]


def _resident(cluster, columns, smem):
    # a card with N_SM SMs, one block an SM
    return N_SM // cluster


def _check_fit(kind, H, B, directions):
    C, BT, smem = rnn_cluster.choose_geometry(
        GRU, kind, H, B, cuda_build.SMEM_LIMIT, _resident, directions)
    U = rnn_cluster.units_per_block(GRU, H, C)
    assert C in rnn_cluster.CLUSTER_SIZES
    assert BT in rnn_cluster.TILE_COLUMNS
    assert smem == rnn_cluster.smem_bytes(GRU, kind, C, BT, H)
    assert smem <= cuda_build.SMEM_LIMIT
    assert U <= rnn_cluster.MAX_UNITS and U % 16 == 0
    assert C * U >= H
    assert rnn_cluster.threads(GRU, H, C, BT) <= rnn_cluster.MAX_THREADS
    # no smaller cluster fits
    for smaller in rnn_cluster.CLUSTER_SIZES[
            :rnn_cluster.CLUSTER_SIZES.index(C)]:
        assert (rnn_cluster.units_per_block(GRU, H, smaller) > 64
                or rnn_cluster.smem_bytes(GRU, kind, smaller, 8, H)
                > cuda_build.SMEM_LIMIT)
    # the smallest tile that runs in one wave, else the largest fit
    one_wave = directions * -(-B // BT) <= _resident(C, BT, smem)
    larger = [t for t in rnn_cluster.TILE_COLUMNS if t > BT
              and rnn_cluster.smem_bytes(GRU, kind, C, t, H)
              <= cuda_build.SMEM_LIMIT]
    assert one_wave or not larger
    for t in rnn_cluster.TILE_COLUMNS:
        if t < BT:
            assert directions * -(-B // t) > _resident(C, t, None)
    return C, BT


@pytest.mark.parametrize("B", BATCHES)
def test_bwd_geometry_fits_every_hidden_size(B):
    """gru_bwd takes every H in 32..512 (step 32): a fit for each, the
    bytes within the limit, at most 64 units and 512 threads a block, one
    wave where a tile allows it."""
    clusters = {_check_fit("bwd", H, B, 1)[0] for H in range(32, 513, 32)}
    assert clusters == {1, 2, 4, 8, 16}


@pytest.mark.parametrize("B", BATCHES)
def test_fwd_geometry_fits_every_hidden_size(B):
    """gru_fwd, one direction a launch, takes every H in 32..512 (step
    32): clusters of 1 to 8 blocks, the bytes within the limit, one wave
    where a tile allows it."""
    clusters = {_check_fit("fwd", H, B, 1)[0] for H in range(32, 513, 32)}
    assert clusters == {1, 2, 4, 8}


@pytest.mark.parametrize("B", BATCHES)
def test_fullfused_geometry_fits_every_hidden_size(B):
    """The f32-gates fullfused recurrence takes every H in 1..512, padded
    to a multiple of 32 (``_padded``), both directions' clusters in one
    grid."""
    clusters = set()
    for H in range(1, 513):
        Hp = gru_fullfused._padded(H)
        assert Hp % 32 == 0 and H <= Hp < H + 32
        clusters.add(_check_fit("fwd", Hp, B, 2)[0])
    assert clusters == {1, 2, 4, 8}


@pytest.mark.parametrize("kind,H,B,directions,resident,want", [
    ("bwd", 256, 128, 1, 32, (4, 8, 129408)),
    ("bwd", 256, 128, 1, 8, (4, 16, 157440)),
    ("fwd", 256, 16, 2, 32, (4, 8, 110864)),
    ("fwd", 256, 1, 2, 32, (4, 8, 110864)),
    ("bwd", 512, 128, 1, 8, (16, 16, 201984)),
    ("fwd", 512, 16, 2, 15, (8, 8, 217360)),
    ("bwd", 96, 5, 1, 66, (2, 8, 41856)),
    ("fwd", 256, 128, 1, 62, (4, 8, 110864)),
    ("fwd", 256, 128, 1, 8, (4, 16, 120336)),
    ("fwd", 256, 16, 2, 62, (4, 8, 110864)),
    ("fwd", 96, 31, 1, 66, (2, 8, 34064)),
    ("fwd", 512, 128, 1, 15, (8, 8, 217360))])
def test_geometry_at_the_main_shapes(kind, H, B, directions, resident, want):
    """The counts model's width, H=256, takes clusters of 4 (64 units a
    block, a W slice of 192 x 264 x 2 = 101,376 B) for the backward and
    the forward, one direction (``gru_fwd``: 16 clusters at B=128) or two
    (``bigru_fused``, ``bigru_fullfused``): 8 columns a cluster where the
    clusters run in one wave, else the largest tile that fits; H=512
    takes 16 blocks in the backward, whose receive buffers do not fit
    beside a 64-unit slice, and 8 in the forward."""
    assert rnn_cluster.choose_geometry(
        GRU, kind, H, B, cuda_build.SMEM_LIMIT,
        lambda C, BT, smem: resident, directions) == want


def test_geometry_raises_without_resident_clusters():
    with pytest.raises(RuntimeError, match="cudaOccupancyMaxActiveClusters"):
        rnn_cluster.choose_geometry(GRU, "bwd", 256, 128,
                                    cuda_build.SMEM_LIMIT,
                                    lambda C, BT, smem: 0)
    with pytest.raises(RuntimeError, match=(
            "gru_fwd: no cluster of 4 blocks of 8 columns with 110864 bytes "
            "of shared memory can be resident")):
        rnn_cluster.choose_geometry(GRU, "fwd", 256, 128,
                                    cuda_build.SMEM_LIMIT,
                                    lambda C, BT, smem: 0, 1, "gru_fwd")
    with pytest.raises(ValueError, match="multiple of 32"):
        rnn_cluster.choose_geometry(GRU, "fwd", 100, 16,
                                    cuda_build.SMEM_LIMIT, _resident, 2)


def _slices(H, C, seed):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.standard_normal((3 * H, H)).astype(np.float32))
    return w, rnn_cluster.w_slices(GRU, w, C)


@pytest.mark.parametrize("H", [32, 64, 96, 160, 256, 384, 416, 512])
@pytest.mark.parametrize("C", [1, 2, 4, 8, 16])
def test_slices_reassemble_w_hh(H, C):
    """The (C, 3U, Hp) slices hold each W_hh value once, at row
    q*48 + g*16 + u of slice r for unit j = r*U + q*16 + u, and zeros
    elsewhere (padded units and columns)."""
    w, sl = _slices(H, C, H + C)
    U = rnn_cluster.units_per_block(GRU, H, C)
    Hp = C * U
    assert sl.shape == (C, 3 * U, Hp) and sl.dtype == torch.bfloat16
    assert sl.is_contiguous()
    # back to (3, Hp, Hp): gate, unit, k
    back = sl.reshape(C, U // 16, 3, 16, Hp).permute(2, 0, 1, 3, 4).reshape(
        3, Hp, Hp)
    assert torch.equal(back[:, :H, :H].reshape(3 * H, H),
                       w.to(torch.bfloat16))
    assert not back[:, H:].any() and not back[:, :, H:].any()
    # one value by the formula
    j, g, k = H - 1, 2, H // 2
    r, q, u = j // U, (j % U) // 16, j % 16
    assert sl[r, q * 48 + g * 16 + u, k] == w[g * H + j, k].to(
        torch.bfloat16)


@pytest.mark.parametrize("H,C", [(256, 4), (96, 2), (160, 4), (512, 16)])
def test_slices_give_the_kernels_products(H, C):
    """The two products the kernels run on the slices, in the kernels'
    row order: the gates hp = W h of block r's rows (row q*48 + g*16 + u
    is gate g of unit r*U + q*16 + u), and dh = sum over the blocks, in
    rank order, of bf16(dhp)[:, rows of r] . W[rows of r, :], which the
    owner of each unit sums from its C receive slots."""
    w, sl = _slices(H, C, 7)
    U = rnn_cluster.units_per_block(GRU, H, C)
    Hp = C * U
    rng = np.random.default_rng(H)
    BT = 8
    h = torch.zeros((BT, Hp), dtype=torch.float64)
    h[:, :H] = torch.from_numpy(rng.standard_normal((BT, H)))
    wd = w.to(torch.bfloat16).double()
    want_hp = h[:, :H] @ wd.t()                               # (BT, 3H)
    dhp = torch.from_numpy(rng.standard_normal((BT, 3 * H)))
    dh = torch.zeros((BT, Hp), dtype=torch.float64)
    for r in range(C):
        s = sl[r].double()                                    # (3U, Hp)
        rows = torch.arange(3 * U)
        gate, unit = (rows % 48) // 16, r * U + (rows // 48) * 16 + rows % 16
        hp = h @ s.t()                                        # (BT, 3U)
        inside = unit < H
        col = gate[inside] * H + unit[inside]
        assert torch.allclose(hp[:, inside], want_hp[:, col])
        assert not hp[:, ~inside].any()
        # the block's dgates tile [BT][3U] in row order, zero past H
        tile = torch.zeros((BT, 3 * U), dtype=torch.float64)
        tile[:, inside] = dhp[:, col]
        dh = dh + tile @ s
    assert torch.allclose(dh[:, :H], dhp @ wd)
    assert not dh[:, H:].any()


def test_wrappers_run_plain_versions_on_the_cpu():
    """CPU tensors take the plain versions (no library is built)."""
    rng = np.random.default_rng(0)
    H, B, T = 32, 3, 5
    xp = torch.from_numpy(rng.uniform(-2, 2, (T, B, 3 * H)).astype(
        np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.uniform(-0.2, 0.2, (3 * H, H)).astype(
        np.float32))
    b = torch.zeros(3 * H)
    lens = torch.tensor([5, 0, 3], dtype=torch.int32)
    dh_out = torch.from_numpy(rng.standard_normal((T, B, H)).astype(
        np.float32))
    gru_train.reset_launches()
    gru_fullfused.reset_launches()
    out = gru_train.gru_fwd_plain(xp, w, b, lens)
    got = gru_train.gru_bwd(xp, out, dh_out, w, b, lens)
    want = gru_train.gru_bwd_plain(xp, out, dh_out, w, b, lens)
    assert all(torch.equal(g, v) for g, v in zip(got, want))
    assert not got[0][:, 1].any()
    x = xp[..., :10].contiguous()
    layer = (torch.stack([w[:, :10]] * 2), torch.zeros(2, 3 * H),
             torch.stack([w] * 2), torch.zeros(2, 3 * H))
    got = gru_fullfused.fullfused_layer(x, *layer, lens, "f32_gates")
    want = gru_fullfused.bigru_fullfused_plain(x, *layer, lens, "f32_gates")
    assert torch.equal(got, want)
    assert gru_train.LAUNCHES == {"gru_fwd": 0, "gru_bwd": 0}
    assert sum(gru_fullfused.LAUNCHES.values()) == 0


@pytest.fixture
def fake_card(monkeypatch):
    """The wrappers' geometry queries against a stand-in kernel library
    whose ``*_max_clusters`` gives ``resident["n"]``: no card, no build."""
    resident = {"n": 62}

    def max_clusters(C, BT, H):
        return resident["n"]

    lib = types.SimpleNamespace(
        gru_fwd_max_clusters=max_clusters,
        bigru_max_clusters=lambda num, C, BT, H: max_clusters(C, BT, H),
        gru_train_error_string=lambda err: b"invalid argument",
        gru_fullfused_error_string=lambda err: b"invalid argument")
    monkeypatch.setattr(gru_train, "build", lambda: lib)
    monkeypatch.setattr(gru_fullfused, "build", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(rnn_cluster, "_RESIDENT", {})
    return resident


def test_fwd_geometry_through_the_wrappers(fake_card):
    """``gru_train.fwd_geometry`` chooses one direction's clusters and
    ``gru_fullfused.cluster_geometry`` both directions', from the card's
    resident clusters: at H=256 clusters of 4 and 8 columns, 16 clusters
    at B=128 (64 of 132 SMs), 4 at B=16 for both directions."""
    dev = torch.device("cuda", 0)
    assert gru_train.fwd_geometry(256, 128, dev) == (4, 8, 110864, 62)
    assert gru_train.fwd_geometry(256, 1, dev) == (4, 8, 110864, 62)
    assert gru_fullfused.cluster_geometry(256, 16, dev, "bigru_fused") == (
        4, 8, 110864, 62)
    assert gru_train.fwd_geometry(96, 31, dev) == (2, 8, 34064, 62)


@pytest.mark.parametrize("kernel", ["gru_fwd", "bigru_fused"])
def test_fwd_geometry_raises_without_resident_clusters(fake_card, kernel):
    """No resident cluster raises, naming the kernel and the geometry; a
    CUDA error of the query raises as a failed launch of the kernel."""
    dev = torch.device("cuda", 1)
    if kernel == "gru_fwd":
        def geometry():
            return gru_train.fwd_geometry(256, 128, dev)
    else:
        def geometry():
            return gru_fullfused.cluster_geometry(256, 16, dev, kernel)
    fake_card["n"] = 0
    with pytest.raises(RuntimeError, match=(
            kernel + ": no cluster of 4 blocks of 8 columns with 110864 "
            "bytes of shared memory can be resident")):
        geometry()
    rnn_cluster._RESIDENT.clear()
    fake_card["n"] = -1
    with pytest.raises(RuntimeError, match=kernel + " launch failed"):
        geometry()


def test_forward_wrappers_run_plain_versions_on_the_cpu():
    """``gru_fwd``, ``bigru_pallas`` and ``bigru_stack_fused``
    (bidirectional=False) take their plain versions on CPU tensors (no
    library is built, nothing launches)."""
    rng = np.random.default_rng(1)
    H, B, T = 32, 3, 6
    xp = torch.from_numpy(rng.uniform(-2, 2, (T, B, 3 * H)).astype(
        np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.uniform(-0.2, 0.2, (3 * H, H)).astype(
        np.float32))
    b = torch.from_numpy(rng.uniform(-0.2, 0.2, 3 * H).astype(np.float32))
    lens = torch.tensor([6, 0, 4], dtype=torch.int32)
    gru_train.reset_launches()
    gru_fullfused.reset_launches()
    for reverse in (False, True):
        assert torch.equal(gru_train.gru_fwd(xp, w, b, lens, reverse),
                           gru_train.gru_fwd_plain(xp, w, b, lens, reverse))
    w2, b2 = torch.stack([w, w.flip(0)]), torch.stack([b, b.flip(0)])
    got_f, got_b = gru_fullfused.bigru_pallas(xp, xp.flip(-1), w2, b2, lens)
    want = gru_fullfused.recurrence_plain(xp, xp.flip(-1), w2, b2, lens)
    assert torch.equal(torch.cat([got_f, got_b], -1), want)
    layers = [{"fwd": {"w_ih": w[:, :10], "w_hh": w, "b_ih": b,
                       "b_hh": b}},
              {"fwd": {"w_ih": w, "w_hh": w.flip(1), "b_ih": b.flip(0),
                       "b_hh": b}}]
    x = torch.from_numpy(rng.random((B, T, 10)).astype(np.float32))
    got = gru_fullfused.bigru_stack_fused(layers, x, bidirectional=False,
                                          lengths=lens, device="cpu")
    h = x.transpose(0, 1).to(torch.bfloat16)
    for layer in layers:
        p = layer["fwd"]
        h = gru_train.gru_fwd_plain(
            gru_fullfused.project_fused(h, p["w_ih"], p["b_ih"]), p["w_hh"],
            p["b_hh"], lens)
    assert got.shape == (B, T, H)
    assert torch.equal(got, h.transpose(0, 1))
    assert gru_train.LAUNCHES == {"gru_fwd": 0, "gru_bwd": 0}
    assert sum(gru_fullfused.LAUNCHES.values()) == 0
