"""The split kernels' int8 host side on the CPU: the launch geometry and
the int8 slices of ``medaka_tpu_torch.ops.rnn_cluster`` with the ``SPLIT``
layout, as ``gru_split.gru_l1_split`` (kind "l1") and
``gru_split.gru_l2head_split`` (kind "l2") use them in int8 mode.

The kernels themselves run only on the card (tests/test_torch_cuda.py);
what they are given is decided here, in pure Python.
"""
import contextlib
import types

import numpy as np
import pytest
import torch

from medaka_tpu_torch.ops import cuda_build, gru_split, rnn_cluster
from medaka_tpu_torch.ops.rnn_cluster import SPLIT
from tests.torch_threads import one_thread  # noqa: F401

N_SM = 132
LIMIT = cuda_build.SMEM_LIMIT
HIDDEN = [128, 256, 384, 512]
BATCHES = [1, 32, 64, 191, 192, 512]
FEATURES = 10


def _resident(cluster, columns, smem):
    # a card with N_SM SMs of 228 KB: two blocks an SM where they fit
    per_sm = 2 if 2 * (smem + 1024) <= 233472 else 1
    return N_SM * per_sm // cluster


def _choose(kind, H, B, resident=_resident, classes=5):
    return rnn_cluster.choose_geometry(
        SPLIT, kind, H, B, LIMIT, resident, 2, "gru_split",
        FEATURES if kind == "l1" else 0, classes)


def _fits(kind, H, C, BT, classes=5):
    inputs = FEATURES if kind == "l1" else 0
    return (rnn_cluster.units_per_block(SPLIT, H, C) <= SPLIT.max_units
            and rnn_cluster.threads(SPLIT, H, C, BT)
            <= rnn_cluster.max_threads(kind)
            and rnn_cluster.smem_bytes(SPLIT, kind, C, BT, H, inputs,
                                       classes) <= LIMIT)


@pytest.mark.parametrize("kind,classes", [("l1", 5), ("l2", 5), ("l2", 9),
                                          ("l2", 16), ("l2", 49)])
@pytest.mark.parametrize("H", HIDDEN)
@pytest.mark.parametrize("B", BATCHES)
def test_split_geometry(kind, H, B, classes):
    """(C, BT, bytes) at each width and batch, and for layer 2 with 5
    classes (the haploid head) and 9 and 16 (the edges of the 16-wide
    slot): the geometry fits (units, threads, bytes), C is the smallest
    cluster that fits unless a larger one buys one wave, and BT the
    smallest tile that runs in one wave or, failing that at every cluster
    size, the largest that fits at the smallest one."""
    C, BT, smem = _choose(kind, H, B, classes=classes)
    inputs = FEATURES if kind == "l1" else 0
    assert C in rnn_cluster.CLUSTER_SIZES and BT in SPLIT.tiles
    assert smem == rnn_cluster.smem_bytes(SPLIT, kind, C, BT, H, inputs,
                                          classes)
    assert _fits(kind, H, C, BT, classes)
    U = rnn_cluster.units_per_block(SPLIT, H, C)
    assert C * U >= H and U % 16 == 0
    smallest = min(c for c in rnn_cluster.CLUSTER_SIZES
                   if _fits(kind, H, c, 8, classes))
    assert C >= smallest

    def one_wave(c, t):
        return 2 * -(-B // t) <= _resident(
            c, t, rnn_cluster.smem_bytes(SPLIT, kind, c, t, H, inputs,
                                         classes))

    if one_wave(C, BT):
        # no smaller tile at C, and no smaller cluster, runs in one wave
        assert not any(one_wave(C, t) for t in SPLIT.tiles
                       if t < BT and _fits(kind, H, C, t, classes))
        assert not any(one_wave(c, t) for c in rnn_cluster.CLUSTER_SIZES
                       if smallest <= c < C for t in SPLIT.tiles
                       if _fits(kind, H, c, t, classes))
    else:
        assert C == smallest
        assert not any(_fits(kind, H, C, t, classes) for t in SPLIT.tiles
                       if t > BT)


@pytest.mark.parametrize("kind,resident,classes,want", [
    # layer 1 keeps all of W_hh (768 x 272 B) in one block: no cluster
    ("l1", 132, 5, (1, 8, 229120)),
    # layer 2: clusters of 4 and 32 columns where 32 clusters are resident
    ("l2", 33, 5, (4, 32, 220416)),
    # else clusters of 8 and 64 columns, where 16 are
    ("l2", 31, 5, (8, 64, 196864)),
    # up to 8 classes the slot keeps 8 a column: the same bytes
    ("l2", 33, 8, (4, 32, 220416)),
    # 9 to 16 classes (the diploid head's 15): 16 a column, 2 x 4 x 8 x 8
    # and 2 x 8 x 8 x 8 f32 more
    ("l2", 33, 9, (4, 32, 222464)),
    ("l2", 33, 15, (4, 32, 222464)),
    ("l2", 31, 15, (8, 64, 200960)),
    ("l2", 33, 16, (4, 32, 222464)),
    # the run-length head's 49 classes: four tiles of W_head^T and a slot
    # of 56 put clusters of 4 at 32 columns over the limit (239,616 B), so
    # 4 at 16 columns where 64 clusters are resident, else 8 at 64
    ("l2", 64, 49, (4, 16, 201216)),
    ("l2", 31, 49, (8, 64, 225280))])
def test_split_geometry_at_the_main_shape(kind, resident, classes, want):
    """H=256, B=512 (the counts model at the automatic batch): the bytes
    of both layers pinned, in one wave of 128 blocks (256 where 16 columns
    a cluster of 4 is the widest that fits)."""
    def stand_in(C, BT, smem):
        return resident if C == want[0] else resident // 2
    assert _choose(kind, 256, 512, stand_in, classes) == want
    C, BT, _ = want
    assert 2 * -(-512 // BT) * C == (256 if BT * C == 64 else 128)


@pytest.mark.parametrize("classes,slot", [(1, 8), (5, 8), (8, 8), (9, 16),
                                          (15, 16), (16, 16), (17, 24),
                                          (49, 56), (64, 64)])
def test_split_bytes_by_part(classes, slot):
    """The carve-up at H=256, layer 2, C=4, BT=32: W_hh 192 x 272, h 2 x 32
    x 272, the staged h 32 x 64, W_ih 192 x 528, the input 2 x 32 x 528,
    the head's bf16 operands (2 x 32 + 16 x tiles) x 72, a tile of
    W_head^T for each 16 classes, and the blocks' partial logits of the
    block's 32 / 4 columns 2 x 4 x 8 x slot f32, the slot the class count
    rounded up to 8."""
    assert rnn_cluster.head_slot(classes) == slot
    tiles = rnn_cluster.head_tiles(classes)
    assert tiles == -(-classes // 16)
    parts = (192 * 272 + 2 * 32 * 272 + 32 * 64 + 192 * 528 + 2 * 32 * 528
             + (2 * 32 + 16 * tiles) * 72 * 2 + 2 * 4 * 8 * slot * 4)
    assert rnn_cluster.smem_bytes(SPLIT, "l2", 4, 32, 256,
                                  classes=classes) == parts
    # layer 1 at C=1: no staging; bf16 W_ih 768 x 10, x 2 x 8 x 16
    assert rnn_cluster.smem_bytes(SPLIT, "l1", 1, 8, 256, 10) == (
        768 * 272 + 2 * 8 * 272 + 768 * 10 * 2 + 2 * 8 * 16 * 2)
    # an odd feature count rounds W_ih's rows up to even
    assert rnn_cluster.smem_bytes(SPLIT, "l1", 1, 8, 256, 9) == (
        768 * 272 + 2 * 8 * 272 + 768 * 10 * 2 + 2 * 8 * 16 * 2)


def test_split_geometry_raises_without_resident_clusters():
    with pytest.raises(RuntimeError, match=(
            "gru_l2head_split/t: no cluster of 4 blocks of 8 columns with "
            "172032 bytes of shared memory can be resident")):
        rnn_cluster.choose_geometry(SPLIT, "l2", 256, 512, LIMIT,
                                    lambda C, BT, smem: 0, 2,
                                    "gru_l2head_split/t")
    with pytest.raises(ValueError, match="multiple of 32"):
        _choose("l1", 100, 16)


@pytest.mark.parametrize("classes", [0, 65, 100])
def test_split_head_refuses_past_16_classes(classes):
    """The head's four m16 tiles of W_head^T hold 64 classes (the RLE
    scheme's 49 among them): none, or more than 64, raise a clear error
    before any launch."""
    with pytest.raises(ValueError, match="1 to 64 classes, got {}".format(
            classes)):
        rnn_cluster.smem_bytes(SPLIT, "l2", 4, 32, 256, classes=classes)
    with pytest.raises(ValueError, match="1 to 64 classes"):
        _choose("l2", 256, 512, classes=classes)


@pytest.fixture
def fake_card(monkeypatch):
    """``gru_split.geometry`` against a stand-in kernel library whose
    ``gru_split_max_clusters`` gives ``resident["n"]`` for the int8
    kernels: no card, no build."""
    resident = {"n": 33, "calls": []}

    def max_clusters(s8, layer2, mode, C, BT, H, IN, classes):
        assert s8 == 1
        resident["calls"].append((layer2, mode, C, BT, H, IN, classes))
        return resident["n"]

    lib = types.SimpleNamespace(
        gru_split_max_clusters=max_clusters,
        gru_split_error_string=lambda err: b"invalid argument")
    monkeypatch.setattr(gru_split, "build", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(rnn_cluster, "_RESIDENT", {})
    return resident


def test_split_geometry_through_the_wrapper(fake_card):
    """``gru_split.geometry`` asks the library for the kernel of the kind
    and mode, and chooses from its answer."""
    dev = torch.device("cuda", 0)
    fake_card["n"] = 132
    assert gru_split.geometry("l1", 256, 512, dev, "t", 10) == (
        1, 8, 229120, 132)
    assert fake_card["calls"][-1] == (0, 0, 1, 8, 256, 10, 5)
    fake_card["n"] = 33
    assert gru_split.geometry("l2", 256, 512, dev, "rows") == (
        4, 32, 220416, 33)
    assert fake_card["calls"][-1] == (1, 1, 4, 32, 256, 0, 5)
    # the diploid head's 15 classes: the slot of 16, asked for and cached
    # apart from the 5-class launch's
    assert gru_split.geometry("l2", 256, 512, dev, "rows", classes=15) == (
        4, 32, 222464, 33)
    assert fake_card["calls"][-1] == (1, 1, 4, 32, 256, 0, 15)


@pytest.mark.parametrize("kind", ["l1", "l2"])
def test_split_geometry_wrapper_raises(fake_card, kind):
    """No resident cluster raises, naming the kernel, its mode and the
    geometry; a CUDA error of the query raises as a failed launch of the
    kernel."""
    dev = torch.device("cuda", 1)
    name = {"l1": "gru_l1_split", "l2": "gru_l2head_split"}[kind]
    fake_card["n"] = 0
    with pytest.raises(RuntimeError, match=name + "/t: no cluster of "):
        gru_split.geometry(kind, 256, 64, dev, "t", 10 * (kind == "l1"))
    rnn_cluster._RESIDENT.clear()
    fake_card["n"] = -1
    with pytest.raises(RuntimeError, match=name + " launch failed"):
        gru_split.geometry(kind, 256, 64, dev, "t", 10 * (kind == "l1"))


def _int8(rng, shape):
    return torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))


def _unslice(sl, H, C):
    """(C, 3U, K) slices -> (3 Hp, K) rows in natural order (gate, unit)."""
    U = sl.shape[1] // 3
    K = sl.shape[2]
    back = sl.reshape(C, U // 16, 3, 16, K).permute(2, 0, 1, 3, 4)
    return back.reshape(3, C * U, K)


@pytest.mark.parametrize("H", HIDDEN + [96, 160])
@pytest.mark.parametrize("C", [1, 2, 4, 8, 16])
def test_int8_slices_reassemble(H, C):
    """The int8 slices of W_hh (C, 3U, Hp) and W_ih (C, 3U, 2H) and the
    per-row scales (C, 3U) hold each value once, at row q*48 + g*16 + u of
    slice r for unit j = r*U + q*16 + u, and zeros elsewhere."""
    rng = np.random.default_rng(H * 31 + C)
    w_hh, w_ih = _int8(rng, (3 * H, H)), _int8(rng, (3 * H, 2 * H))
    sc = torch.from_numpy(rng.random(3 * H).astype(np.float32))
    U = rnn_cluster.units_per_block(SPLIT, H, C)
    Hp = C * U
    sl = rnn_cluster.w_slices(SPLIT, w_hh, C)
    assert sl.shape == (C, 3 * U, Hp) and sl.dtype == torch.int8
    back = _unslice(sl, H, C)
    assert torch.equal(back[:, :H, :H].reshape(3 * H, H), w_hh)
    assert not back[:, H:].any() and not back[:, :, H:].any()
    si = rnn_cluster.row_slices(SPLIT, w_ih, C)
    assert si.shape == (C, 3 * U, 2 * H) and si.dtype == torch.int8
    back = _unslice(si, H, C)
    assert torch.equal(back[:, :H].reshape(3 * H, 2 * H), w_ih)
    assert not back[:, H:].any()
    ss = rnn_cluster.row_slices(SPLIT, sc, C)
    assert ss.shape == (C, 3 * U) and ss.is_contiguous()
    back = _unslice(ss[..., None], H, C)[..., 0]
    assert torch.equal(back[:, :H].reshape(3 * H), sc)
    assert not back[:, H:].any()
    # one value by the formula
    j, g = H - 1, 1
    r, q, u = j // U, (j % U) // 16, j % 16
    assert sl[r, q * 48 + g * 16 + u, 5] == w_hh[g * H + j, 5]
    assert si[r, q * 48 + g * 16 + u, 2 * H - 1] == w_ih[g * H + j, 2 * H - 1]


@pytest.mark.parametrize("H,C", [(256, 1), (256, 4), (384, 4), (384, 8),
                                 (512, 16), (160, 2)])
def test_int8_products_through_the_slices(H, C):
    """The kernels' int32 products on the slices, in their row order,
    equal the plain int32 products exactly: W_hh round(127 h) of block r's
    rows over the padded Hp, and W_ih [prev_f; prev_b] summed over each
    half (layer 2's two accumulators) and over both (mode "t")."""
    rng = np.random.default_rng(H + C)
    BT = 8
    w_hh, w_ih = _int8(rng, (3 * H, H)), _int8(rng, (3 * H, 2 * H))
    h = _int8(rng, (BT, H)).long()
    inp = _int8(rng, (BT, 2 * H)).long()
    U = rnn_cluster.units_per_block(SPLIT, H, C)
    Hp = C * U
    sl = rnn_cluster.w_slices(SPLIT, w_hh, C).long()
    si = rnn_cluster.row_slices(SPLIT, w_ih, C).long()
    hp = torch.zeros((BT, Hp), dtype=torch.long)
    hp[:, :H] = h                      # the h buffer, padded units zero
    want_hh = h @ w_hh.long().t()      # (BT, 3H)
    want_a = inp[:, :H] @ w_ih[:, :H].long().t()
    want_b = inp[:, H:] @ w_ih[:, H:].long().t()
    for r in range(C):
        rows = torch.arange(3 * U)
        gate = (rows % 48) // 16
        unit = r * U + (rows // 48) * 16 + rows % 16
        inside = unit < H
        col = gate[inside] * H + unit[inside]
        got = hp @ sl[r].t()                                # (BT, 3U)
        assert torch.equal(got[:, inside], want_hh[:, col])
        assert not got[:, ~inside].any()
        acc_a = inp[:, :H] @ si[r, :, :H].t()
        acc_b = inp[:, H:] @ si[r, :, H:].t()
        assert torch.equal(acc_a[:, inside], want_a[:, col])
        assert torch.equal(acc_b[:, inside], want_b[:, col])
        assert torch.equal((inp @ si[r].t())[:, inside],
                           (want_a + want_b)[:, col])
        # |sum| < 2^31 at the largest width: exact in int32
        assert (acc_a + acc_b).abs().max() < 2 ** 31


def test_tile_columns_of_the_other_kernels_unchanged():
    """The bf16 cluster kernels keep their tiles and unit limit; only the
    split layout takes 64 columns and 256 units."""
    assert rnn_cluster.GRU.tiles == rnn_cluster.LSTM.tiles == (8, 16, 32)
    assert rnn_cluster.GRU.max_units == rnn_cluster.LSTM.max_units == 64
    assert not rnn_cluster.GRU.widen and not rnn_cluster.LSTM.widen
    assert SPLIT.tiles == (8, 16, 32, 64) and SPLIT.max_units == 256
    assert rnn_cluster.max_threads("l2") == 256
    assert rnn_cluster.max_threads("l1") == rnn_cluster.max_threads(
        "fwd") == 512


def _bf16(v):
    return v.to(torch.bfloat16).float()


def _gates(h, xp, hp, mode):
    """One GRU update from (..., 3) input and recurrent pre-activations,
    in the numerics of ``gru_split._cell``."""
    if mode == "t":
        rz = _bf16(xp[..., :2] + hp[..., :2]).to(torch.bfloat16)
        rz = (0.5 * (1.0 + torch.tanh(rz * 0.5))).float()
        n = torch.tanh((xp[..., 2] + rz[..., 0] * hp[..., 2]).to(
            torch.bfloat16)).float()
        z = rz[..., 1]
    else:
        r = torch.sigmoid(xp[..., 0] + hp[..., 0])
        z = torch.sigmoid(xp[..., 1] + hp[..., 1])
        n = torch.tanh(xp[..., 2] + r * hp[..., 2])
    return (1.0 - z) * n + z * h


def _emulate(layer, ops, C, BT, mode, H, T, lengths, inputs, classes=5):
    """The int8 kernels' arithmetic, block by block of each cluster, with
    every operand read the way the kernels index it: W_hh (and W_ih) rows
    q*48 + g*16 + u of slice r, the per-row constants in the same rows,
    layer 1's features from the padded x, the head from W_head^T of the
    block's units, summed over the blocks in rank order."""
    B = lengths.shape[0]
    U = rnn_cluster.units_per_block(SPLIT, H, C)
    rows = torch.arange(3 * U)
    gate, unit = (rows % 48) // 16, (rows // 48) * 16 + rows % 16
    outs = []
    for d in range(2):
        out = (torch.zeros((T, B, H), dtype=torch.int8) if layer == 1
               else torch.zeros((B, T, classes)))
        for b0 in range(0, B, BT):
            cols = torch.arange(b0, min(B, b0 + BT))
            h = torch.zeros((C, len(cols), U))
            hq = torch.zeros((len(cols), C * U))
            for i in range(T):
                t = i if d == 0 else T - 1 - i
                new_hq, head = torch.zeros_like(hq), 0.0
                for r in range(C):
                    rc = ops["rowc"][d, r]
                    hp = (hq @ ops["w_hh"][d, r].float().t()) * rc[0] + rc[1]
                    if layer == 1:
                        x = ops["x"][t, cols].float()
                        w = ops["w_ih"][d, r].float()
                        xp = torch.zeros((len(cols), 3 * U))
                        for k in range(inputs):      # one fmaf chain
                            xp = xp + w[:, k] * x[:, k:k + 1]
                        xp = xp + rc[2]
                    else:
                        w = ops["w_in"][d, r].float()
                        a = inputs[0][t, cols].float() @ w[:, :H].t()
                        b = inputs[1][t, cols].float() @ w[:, H:].t()
                        xp = ((a + b) * rc[3] + rc[2] if mode == "t"
                              else (a * rc[3] + b * rc[4]) + rc[2])
                    if mode == "rows":
                        xp = _bf16(xp)
                    xg = torch.zeros((len(cols), U, 3))
                    hg = torch.zeros((len(cols), U, 3))
                    xg[:, unit, gate] = xp
                    hg[:, unit, gate] = hp
                    keep = ((r * U + torch.arange(U) < H)[None, :]
                            & (t < lengths[cols])[:, None])
                    h[r] = torch.where(keep, _gates(h[r], xg, hg, mode), h[r])
                    new_hq[:, r * U:(r + 1) * U] = torch.clamp(
                        torch.round(h[r] * 127.0), -128, 127)
                    if layer == 2:
                        head = head + _bf16(h[r]) @ ops["w_head"][
                            d, r, :classes].float().t()
                hq = new_hq
                if layer == 1:
                    out[t, cols] = hq[:, :H].to(torch.int8)
                else:
                    out[cols, t] = head
        outs.append(out)
    return outs


@pytest.mark.parametrize("mode", ["t", "rows"])
@pytest.mark.parametrize("H,C,BT,B,classes", [
    (128, 1, 8, 11, 5), (128, 2, 16, 20, 5), (256, 4, 8, 9, 5),
    (384, 8, 8, 9, 5), (128, 2, 16, 20, 15), (256, 4, 8, 9, 16)])
def test_int8_operands_reproduce_the_plain_versions(H, C, BT, B, classes,
                                                    mode):
    """``gru_split.l1_operands`` and ``l2_operands`` (x padded, the int8
    and bf16 slices, the per-row constants, W_head^T by block, classes 8
    to 15 in rows 8 to 15 of the head's tile), read the way the int8
    kernels index them, give the plain versions' results: layer 1 within
    one int8 step (the same bar as on the card), the logits within
    1e-3."""
    _check_operands(H, C, BT, B, classes, mode, 10)


@pytest.mark.parametrize("mode", ["t", "rows"])
@pytest.mark.parametrize("H,C,BT,B", [(128, 2, 16, 20), (256, 4, 8, 9)])
def test_int8_operands_at_the_run_length_shapes(H, C, BT, B, mode):
    """The same at the run-length bundle's shapes: 120 input features (W_ih
    rows of 120 bf16, x padded to 120) and 49 classes (four tiles of
    W_head^T, classes 16 to 48 in tiles 1 to 3)."""
    _check_operands(H, C, BT, B, 49, mode, 120)


def _check_operands(H, C, BT, B, classes, mode, IN):
    rng = np.random.default_rng(H + C + B)
    T = 6
    k = 1.0 / np.sqrt(H)

    def direction(width):
        return {name: torch.from_numpy(rng.uniform(-k, k, shape).astype(
            np.float32)) for name, shape in (
                ("w_ih", (3 * H, width)), ("w_hh", (3 * H, H)),
                ("b_ih", (3 * H,)), ("b_hh", (3 * H,)))}
    layers = [{"fwd": direction(IN), "bwd": direction(IN)},
              {"fwd": direction(2 * H), "bwd": direction(2 * H)}]
    head = {"w": torch.from_numpy(rng.uniform(
        -k, k, (classes, 2 * H)).astype(np.float32)),
        "b": torch.zeros(classes)}
    lengths = torch.from_numpy(rng.integers(1, T + 1, B).astype(np.int32))
    lengths[-1] = 0
    w = gru_split.prepare_split_weights(layers, head, mode, True, "cpu")
    xt = torch.from_numpy(rng.random((T, B, IN)).astype(np.float32)).to(
        torch.bfloat16)
    a1 = (xt, lengths, w["w_ih1"], w["b_ih1"], w["w_hh1"], w["sc1"],
          w["b_hh1"])
    want1 = gru_split.gru_l1_split_plain(*a1, mode=mode, quant=True)
    got1 = _emulate(1, gru_split.l1_operands(xt, *a1[2:], C), C, BT, mode,
                    H, T, lengths, IN)
    for got, want in zip(got1, want1):
        assert got.shape == want.shape
        assert (got.float() - want.float()).abs().max() <= 1
    a2 = (want1[0], want1[1], lengths, w["w_in2"], w["in_scale2"],
          w["b_ih2"], w["w_hh2"], w["sc2"], w["b_hh2"], w["w_head"])
    want2 = gru_split.gru_l2head_split_plain(*a2, mode=mode, quant=True)
    got2 = _emulate(2, gru_split.l2_operands(*a2[3:], C), C, BT, mode, H, T,
                    lengths, want1, classes)
    valid = torch.arange(T)[None, :] < lengths[:, None]
    for got, want in zip(got2, want2):
        assert (got - want).abs()[valid].max() <= 1e-3
