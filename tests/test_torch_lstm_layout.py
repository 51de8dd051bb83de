"""The LSTM training kernels' host side on the CPU: the launch geometry
and the per-block W_hh slices of ``medaka_tpu_torch.ops.lstm_train``.

The kernels themselves run only on the card (tests/test_torch_cuda.py);
what they are given is decided here, in pure Python.
"""
import numpy as np
import pytest
import torch

from medaka_tpu_torch.ops import cuda_build, lstm_train
from tests.torch_threads import one_thread  # noqa: F401

H_ALL = list(range(32, 513, 32))
N_SM = 132


def _resident(cluster, columns, smem):
    # a card with N_SM SMs, one block an SM
    return N_SM // cluster


@pytest.mark.parametrize("kind", ["fwd", "bwd"])
@pytest.mark.parametrize("B", [1, 5, 128, 512])
def test_geometry_fits_every_hidden_size(kind, B):
    """A fit for every H in 32..512 (step 32): the bytes within the limit,
    at most 64 units and 512 threads a block, one wave where a tile
    allows it."""
    for H in H_ALL:
        C, BT, smem = lstm_train.choose_geometry(
            kind, H, B, cuda_build.SMEM_LIMIT, _resident)
        U = lstm_train.units_per_block(H, C)
        assert C in lstm_train.CLUSTER_SIZES
        assert BT in lstm_train.TILE_COLUMNS
        assert smem == lstm_train.smem_bytes(kind, C, BT, H)
        assert smem <= cuda_build.SMEM_LIMIT
        assert U <= lstm_train.MAX_UNITS and U % 8 == 0
        assert C * U >= H and (C * U) % 16 == 0
        # one warp per 8-unit group and 8 (BT=8) or 16 columns
        assert 32 * (U // 8) * (BT // min(BT, 16)) <= 512
        # no smaller cluster fits
        for smaller in lstm_train.CLUSTER_SIZES[
                :lstm_train.CLUSTER_SIZES.index(C)]:
            assert (lstm_train.units_per_block(H, smaller) > 64
                    or lstm_train.smem_bytes(kind, smaller, 8, H)
                    > cuda_build.SMEM_LIMIT)
        # the smallest tile that runs in one wave, else the largest fit
        one_wave = -(-B // BT) <= _resident(C, BT, smem)
        larger = [t for t in lstm_train.TILE_COLUMNS if t > BT
                  and lstm_train.smem_bytes(kind, C, t, H)
                  <= cuda_build.SMEM_LIMIT]
        assert one_wave or not larger
        for t in lstm_train.TILE_COLUMNS:
            if t < BT:
                assert -(-B // t) > _resident(C, t, None)


@pytest.mark.parametrize("kind,H,resident,want", [
    ("fwd", 384, 16, (8, 8, 165392)), ("bwd", 384, 16, (8, 8, 190848)),
    ("fwd", 384, 8, (8, 16, 180240)), ("bwd", 384, 8, (8, 16, 231168)),
    ("fwd", 128, 66, (2, 8, 77072)), ("bwd", 512, 8, (16, 8, 184704)),
    ("fwd", 512, 4, (16, 32, 205840))])
def test_geometry_at_the_training_shapes(kind, H, resident, want):
    """B=128: H=384 takes clusters of 8 (48 units a block, W slice
    150,528 B) and the smallest tile whose 128 / BT clusters are all
    resident; where none is, the largest tile that fits."""
    assert lstm_train.choose_geometry(
        kind, H, 128, cuda_build.SMEM_LIMIT,
        lambda C, BT, smem: resident) == want


def test_geometry_raises_without_resident_clusters():
    with pytest.raises(RuntimeError, match="cudaOccupancyMaxActiveClusters"):
        lstm_train.choose_geometry("fwd", 384, 128, cuda_build.SMEM_LIMIT,
                                   lambda C, BT, smem: 0)
    with pytest.raises(ValueError, match="multiple of 32"):
        lstm_train.choose_geometry("fwd", 100, 128, cuda_build.SMEM_LIMIT,
                                   _resident)


@pytest.mark.parametrize("H", [32, 96, 128, 160, 384, 416, 512])
@pytest.mark.parametrize("C", [1, 2, 4, 8, 16])
def test_slices_reassemble_w_hh(H, C):
    """The (C, 4U, Hp) slices hold each W_hh value once, at row
    q*32 + g*8 + u of slice r for unit j = r*U + q*8 + u, and zeros
    elsewhere (padded units and columns)."""
    rng = np.random.default_rng(H + C)
    w = torch.from_numpy(rng.standard_normal((4 * H, H)).astype(np.float32))
    sl = lstm_train.w_slices(w, C)
    U = lstm_train.units_per_block(H, C)
    Hp = C * U
    assert sl.shape == (C, 4 * U, Hp) and sl.dtype == torch.bfloat16
    assert sl.is_contiguous()
    # back to (4, Hp, Hp): gate, unit, k
    back = sl.reshape(C, U // 8, 4, 8, Hp).permute(2, 0, 1, 3, 4).reshape(
        4, Hp, Hp)
    assert torch.equal(back[:, :H, :H].reshape(4 * H, H),
                       w.to(torch.bfloat16))
    assert not back[:, H:].any() and not back[:, :, H:].any()
    # one value by the formula
    j, g, k = H - 1, 2, H // 2
    r, q, u = j // U, (j % U) // 8, j % 8
    assert sl[r, q * 32 + g * 8 + u, k] == w[g * H + j, k].to(
        torch.bfloat16)


def test_wrappers_run_plain_versions_on_the_cpu():
    """CPU tensors take the plain versions (no library is built)."""
    rng = np.random.default_rng(0)
    H, B, T = 32, 3, 5
    xp = torch.from_numpy(rng.uniform(-2, 2, (T, B, 4 * H)).astype(
        np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.uniform(-0.2, 0.2, (4 * H, H)).astype(
        np.float32))
    b = torch.zeros(4 * H)
    lens = torch.tensor([5, 0, 3], dtype=torch.int32)
    lstm_train.reset_launches()
    out, c = lstm_train.lstm_fwd(xp, w, b, lens)
    want, c_want = lstm_train.lstm_fwd_plain(xp, w, b, lens)
    assert torch.equal(out, want) and torch.equal(c, c_want)
    assert not out[:, 1].float().any()
    assert lstm_train.LAUNCHES == {"lstm_fwd": 0, "lstm_bwd": 0}
