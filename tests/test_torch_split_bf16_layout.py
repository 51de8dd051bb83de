"""The split kernels' bf16 host side on the CPU: the launch geometry and
the bf16 slices of ``medaka_tpu_torch.ops.rnn_cluster`` with the
``SPLIT_BF16`` layout, as ``gru_split.gru_l1_split`` (kind "l1") and
``gru_split.gru_l2head_split`` (kind "l2") use them where
``quant=False``, and the route of bf16 layer 2 by shape.

The kernels themselves run only on the card (tests/test_torch_cuda.py);
what they are given is decided here, in pure Python. Every product of
their recurrence is an f64 sum of bf16 products rounded once to f32
(``F64Product`` in ``csrc/rnn_train.cuh``: k-groups of 16 on the FP64
tensor cores; layer 1's features in a double fma chain), as the plain
versions sum it: their arithmetic is emulated from the slices in the
kernels' order and held to the plain versions bit for bit in layer 1, the
plain versions to a numpy f64 reference, and the sums to themselves in
other orders of k.
"""
import contextlib
import types

import numpy as np
import pytest
import torch

from medaka_tpu_torch.ops import cuda_build, gru_split, rnn_cluster
from medaka_tpu_torch.ops.rnn_cluster import SPLIT, SPLIT_BF16
from tests.torch_threads import one_thread  # noqa: F401

N_SM = 132
LIMIT = cuda_build.SMEM_LIMIT
HIDDEN = [128, 256, 384, 512]
BATCHES = [32, 64, 191, 192, 480, 512]
#: the card's bars (tests/test_torch_cuda.py, chip_smoke.py): one bf16
#: step of layer 1's h, its mean, the logits
TOL_L1, TOL_L1_MEAN, TOL_LOGIT = 2.0 ** -7, 1e-3, 1e-3


def _resident(cluster, columns, smem):
    # a card with N_SM SMs of 228 KB: two blocks an SM where they fit
    per_sm = 2 if 2 * (smem + 1024) <= 233472 else 1
    return N_SM * per_sm // cluster


def _fits(kind, H, C, BT, inputs, classes):
    return (rnn_cluster.units_per_block(SPLIT_BF16, H, C)
            <= SPLIT_BF16.max_units
            and rnn_cluster.threads(SPLIT_BF16, H, C, BT, kind)
            <= rnn_cluster.max_threads(kind, SPLIT_BF16)
            and rnn_cluster.smem_bytes(SPLIT_BF16, kind, C, BT, H, inputs,
                                       classes) <= LIMIT)


@pytest.fixture
def fake_card(monkeypatch):
    """``gru_split.geometry`` against a stand-in kernel library whose
    ``gru_split_max_clusters`` gives :func:`_resident` for the bf16
    kernels (or ``resident["n"]`` where set): no card, no build."""
    resident = {"n": None, "calls": []}

    def max_clusters(s8, layer2, mode, C, BT, H, IN, classes):
        assert s8 == 0, "the int8 query answered a bf16 launch"
        resident["calls"].append((layer2, mode, C, BT, H, IN, classes))
        if resident["n"] is not None:
            return resident["n"]
        return _resident(C, BT, rnn_cluster.smem_bytes(
            SPLIT_BF16, "l2" if layer2 else "l1", C, BT, H, IN, classes))

    lib = types.SimpleNamespace(
        gru_split_max_clusters=max_clusters,
        gru_split_error_string=lambda err: b"invalid argument")
    monkeypatch.setattr(gru_split, "build", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(rnn_cluster, "_RESIDENT", {})
    return resident


@pytest.mark.parametrize("kind,inputs,classes", [
    ("l1", 10, 5), ("l1", 20, 5), ("l1", 120, 5),
    ("l2", 0, 5), ("l2", 0, 15), ("l2", 0, 49)])
@pytest.mark.parametrize("H", HIDDEN)
@pytest.mark.parametrize("B", BATCHES)
def test_bf16_split_geometry(fake_card, kind, H, B, inputs, classes):
    """(C, BT, bytes, resident) of the bf16 cluster kernels through the
    wrapper at each width, batch, feature count and head: the geometry
    fits (units, threads, bytes), C is the smallest cluster that fits
    unless a larger one buys one wave, BT the smallest tile that runs in
    one wave or, failing that at every cluster size, the largest that
    fits at the smallest one; a batch that runs in one wave at the
    smallest tile on clusters of 2 or more spreads to twice the blocks
    where a block keeps 64 units, the wider blocks fit what the card held
    at the narrower geometry and still run in one wave (and only then).
    Layer 2 at H=384 and 512 fits no cluster
    (its W_hh and W_ih slices outgrow a block): it routes to the
    per-block kernel, and the cluster geometry raises naming the kernel."""
    dev = torch.device("cuda", 0)
    if kind == "l2" and H >= 384:
        assert gru_split.l2_route(H, classes, False) == "per-block"
        with pytest.raises(ValueError, match=(
                r"gru_l2head_split/t/bf16: no cluster size fits H={}"
                .format(H))):
            gru_split.geometry(kind, H, B, dev, "t", inputs, classes,
                               quant=False)
        return
    if kind == "l2":
        assert gru_split.l2_route(H, classes, False) == "cluster"
    mode = gru_split.split_mode(B)
    C, BT, smem, resident = gru_split.geometry(kind, H, B, dev, mode, inputs,
                                               classes, quant=False)
    assert (int(kind == "l2"), gru_split.MODES[mode], C, BT, H, inputs,
            classes) in fake_card["calls"]
    assert C in rnn_cluster.CLUSTER_SIZES and BT in SPLIT_BF16.tiles
    assert smem == rnn_cluster.smem_bytes(SPLIT_BF16, kind, C, BT, H, inputs,
                                          classes)
    assert resident == _resident(C, BT, smem)
    assert _fits(kind, H, C, BT, inputs, classes)
    U = rnn_cluster.units_per_block(SPLIT_BF16, H, C)
    assert C * U >= H and U % 16 == 0
    smallest = min(c for c in rnn_cluster.CLUSTER_SIZES
                   if _fits(kind, H, c, 8, inputs, classes))
    assert C >= smallest

    def resident_at(c, t):
        return _resident(c, t, rnn_cluster.smem_bytes(
            SPLIT_BF16, kind, c, t, H, inputs, classes))

    def spreads(c, t):
        # (c, t) runs in one wave and would double to 2c
        tiles = 2 * -(-B // t)
        return (c > 1 and t == 8 and tiles <= resident_at(c, t)
                and rnn_cluster.units_per_block(SPLIT_BF16, H, 2 * c) >= 64
                and tiles * 2 * c <= resident_at(c, t) * c
                and 2 * c in rnn_cluster.CLUSTER_SIZES
                and _fits(kind, H, 2 * c, t, inputs, classes)
                and tiles <= resident_at(2 * c, t))

    assert not spreads(C, BT)
    while C // 2 >= smallest and spreads(C // 2, BT):
        C //= 2          # the geometry it spread from obeys the rest

    def one_wave(c, t):
        return 2 * -(-B // t) <= _resident(c, t, rnn_cluster.smem_bytes(
            SPLIT_BF16, kind, c, t, H, inputs, classes))

    if one_wave(C, BT):
        assert not any(one_wave(C, t) for t in SPLIT_BF16.tiles
                       if t < BT and _fits(kind, H, C, t, inputs, classes))
        assert not any(one_wave(c, t) for c in rnn_cluster.CLUSTER_SIZES
                       if smallest <= c < C for t in SPLIT_BF16.tiles
                       if _fits(kind, H, c, t, inputs, classes))
    else:
        assert C == smallest
        assert not any(_fits(kind, H, C, t, inputs, classes)
                       for t in SPLIT_BF16.tiles if t > BT)


@pytest.mark.parametrize("B,want", [
    (1, (4, 8)), (32, (4, 8)), (64, (4, 8)), (128, (4, 8)), (129, (2, 8)),
    (191, (2, 8)), (480, (2, 16))])
@pytest.mark.parametrize("inputs", [10, 20])
def test_bf16_layer1_spreads_small_batches(B, want, inputs):
    """Layer 1 at H=256 (10 and 20 features) on clusters of 4 blocks of 64
    units up to 128 rows, whose 2 ceil(B / 8) clusters of 4 fit the 132
    SMs that the clusters of 2 would half fill; above, clusters of 2 as
    without the spread. At 480 rows the 20-feature layer runs on clusters
    of 4, 32 columns, in both layouts."""
    got = rnn_cluster.choose_geometry(SPLIT_BF16, "l1", 256, B, LIMIT,
                                      _resident, 2, "gru_split", inputs)
    plain = rnn_cluster.choose_geometry(
        SPLIT_BF16._replace(spread_units=0), "l1", 256, B, LIMIT, _resident,
        2, "gru_split", inputs)
    if B == 480 and inputs == 20:
        want = (4, 32)
    assert got[:2] == want
    assert plain[:2] == (want if want[0] == 2 or B == 480 else (2, 8))
    assert got[2] == rnn_cluster.smem_bytes(SPLIT_BF16, "l1", *got[:2], 256,
                                            inputs)
    # the reference's 2x128 GRU keeps its one block (no cluster exchange)
    assert rnn_cluster.choose_geometry(
        SPLIT_BF16, "l1", 128, B, LIMIT, _resident, 2, "gru_split",
        inputs)[:2] == (1, 8)


@pytest.mark.parametrize("kind,H,inputs,classes,want", [
    # layer 1: W_hh (768 x 528 B) needs two blocks; 16 columns fill the
    # 232,448 B to the byte, 60 clusters of 2 in one wave
    ("l1", 256, 10, 5, (2, 16, 232448)),
    # the run-length bundle's 120 features: clusters of 4, 32 columns
    ("l1", 256, 120, 5, (4, 32, 200704)),
    # the reference's 2x128 GRU: all of W_hh in one block
    ("l1", 128, 10, 5, (1, 8, 116992)),
    # layer 2: W_hh and W_ih (768 x 1,568 B) need 8 blocks; no geometry
    # runs 480 rows in one wave, so the largest tile at C=8: 32 columns
    # with one input buffer, 30 clusters in two waves
    ("l2", 256, 0, 5, (8, 32, 228096)),
    ("l2", 256, 0, 15, (8, 32, 230144)),
    # the run-length head's four tiles and slot of 56 put 32 columns over
    # the limit (244,224 B): 16 columns, four waves
    ("l2", 256, 0, 49, (8, 16, 199936)),
    # H=128: clusters of 2, 16 columns, 60 clusters in one wave
    ("l2", 128, 0, 5, (2, 16, 180736))])
def test_bf16_split_geometry_at_the_main_shape(kind, H, inputs, classes,
                                                want):
    """B=480 (the counts model's automatic batch): the geometry pinned."""
    assert rnn_cluster.choose_geometry(
        SPLIT_BF16, kind, H, 480, LIMIT, _resident, 2, "gru_split",
        inputs, classes) == want


@pytest.mark.parametrize("classes,slot", [(5, 8), (15, 16), (49, 56)])
def test_bf16_split_bytes_by_part(classes, slot):
    """The carve-up in bf16: rows of W_hh and of h 2 Hp + 16 bytes, of
    W_ih and the layer-2 input 4 H + 16, the staged h U x 2 bytes a
    column, one layer-2 input buffer (int8: two); layer 1's W_ih and x,
    and layer 2's head operands and slot, as in int8."""
    tiles = rnn_cluster.head_tiles(classes)
    # layer 2, H=256, C=8 (U=32), BT=16: W_hh 96 x 528, h 2 x 16 x 528,
    # the staged h 16 x 32 x 2, W_ih 96 x 1040, the input 16 x 1040,
    # bf16(h) x 2 and W_head^T (2 x 16 + 16 x tiles) x 40 x 2, the
    # partial logits of 16 / 8 columns 2 x 8 x 2 x slot x 4
    parts = (96 * 528 + 2 * 16 * 528 + 16 * 32 * 2 + 96 * 1040
             + 16 * 1040 + (2 * 16 + 16 * tiles) * 40 * 2
             + 2 * 8 * 2 * slot * 4)
    assert rnn_cluster.smem_bytes(SPLIT_BF16, "l2", 8, 16, 256,
                                  classes=classes) == parts
    # layer 1, H=256, C=2 (U=128), BT=16, 10 features: W_hh 384 x 528, h
    # 2 x 16 x 528, staged 16 x 128 x 2, W_ih 384 x 10 x 2, x 2 x 16 x 16
    assert rnn_cluster.smem_bytes(SPLIT_BF16, "l1", 2, 16, 256, 10) == (
        384 * 528 + 2 * 16 * 528 + 16 * 128 * 2 + 384 * 10 * 2
        + 2 * 16 * 16 * 2) == LIMIT
    # C=1: no staged h (H=128: W_hh 384 x 272, h 2 x 8 x 272)
    assert rnn_cluster.smem_bytes(SPLIT_BF16, "l1", 1, 8, 128, 10) == (
        384 * 272 + 2 * 8 * 272 + 384 * 10 * 2 + 2 * 8 * 16 * 2)
    # the int8 layout's rows are half as wide at the same geometry
    assert rnn_cluster.smem_bytes(SPLIT, "l1", 2, 16, 256, 10) == (
        384 * 272 + 2 * 16 * 272 + 16 * 128 + 384 * 10 * 2
        + 2 * 16 * 16 * 2)


def test_bf16_layout_is_the_int8_rows_in_bf16():
    """SPLIT_BF16 differs from SPLIT in the bytes of a weight, 256 threads
    a block at most in both layers, small batches' spread to 64 units a
    block, and layer 2's warps, one n8 tile of columns each (int8 and
    bf16 layer 1: two from 16 columns)."""
    assert SPLIT_BF16.wbytes == 2 and SPLIT.wbytes == 1
    assert SPLIT_BF16.spread_units == 64 and SPLIT.spread_units == 0
    assert SPLIT_BF16._replace(wbytes=1, max_threads=512,
                               spread_units=0) == SPLIT
    assert rnn_cluster.max_threads("l1", SPLIT_BF16) == 256
    assert rnn_cluster.max_threads("l1", SPLIT) == 512
    # layer 2 at H=256 on clusters of 8 (2 unit groups), 32 columns
    assert rnn_cluster.threads(SPLIT_BF16, 256, 8, 32, "l2") == 32 * 2 * 4
    assert rnn_cluster.threads(SPLIT, 256, 8, 32, "l2") == \
        rnn_cluster.threads(SPLIT_BF16, 256, 8, 32, "l1") == 32 * 2 * 2
    # layer 1 at H=256 on clusters of 2 (8 unit groups), 16 columns: 256
    assert rnn_cluster.threads(SPLIT_BF16, 256, 2, 16, "l1") == 256
    # 64 columns at clusters of 8 need 512 threads in layer 2
    assert not _fits("l2", 256, 8, 64, 0, 5)


@pytest.mark.parametrize("H,classes", [(128, 5), (256, 5), (256, 15),
                                       (256, 49), (384, 5), (512, 5),
                                       (384, 64), (160, 5)])
def test_bf16_l2_route_by_shape(H, classes):
    """bf16 layer 2 runs on clusters wherever a cluster size holds a
    block's slices, and on the per-block kernel where none does (H=384 and
    512: 248,832 and 294,912 bytes of W_hh and W_ih a block at C=16);
    int8 always on clusters. The route is the shape's alone."""
    fits = rnn_cluster.fitting_clusters(SPLIT_BF16, "l2", H, LIMIT,
                                        classes=classes)
    assert gru_split.l2_route(H, classes, False) == (
        "cluster" if fits else "per-block")
    assert (H >= 384) == (not fits)
    assert gru_split.l2_route(H, classes, True) == "cluster"
    U = rnn_cluster.units_per_block(SPLIT_BF16, H, 16)
    wbytes = 3 * U * (2 * 16 * U + 16) + 3 * U * (4 * H + 16)
    assert (wbytes > LIMIT) == (H >= 384)


def test_bf16_geometry_raises_where_nothing_fits(fake_card):
    """Layer 1 with more features than a block's W_ih slice holds at any
    cluster size raises, naming the kernel and its mode; no resident
    cluster raises likewise, and a CUDA error of the query raises as a
    failed launch of the kernel."""
    dev = torch.device("cuda", 0)
    with pytest.raises(ValueError, match=(
            r"gru_l1_split/rows/bf16: no cluster size fits H=512")):
        gru_split.geometry("l1", 512, 64, dev, "rows", 2000, quant=False)
    fake_card["n"] = 0
    with pytest.raises(RuntimeError, match=(
            r"gru_l2head_split/t/bf16: no cluster of 8 blocks")):
        gru_split.geometry("l2", 256, 480, dev, "t", quant=False)
    rnn_cluster._RESIDENT.clear()
    fake_card["n"] = -1
    with pytest.raises(RuntimeError, match="gru_l1_split launch failed"):
        gru_split.geometry("l1", 256, 480, dev, "t", 10, quant=False)


def _net(rng, H, IN, classes):
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
    return layers, head


def _unslice(sl, C):
    """(C, 3U, K) slices -> (3, C U, K) rows in natural order (gate,
    unit)."""
    U = sl.shape[1] // 3
    K = sl.shape[2]
    back = sl.reshape(C, U // 16, 3, 16, K).permute(2, 0, 1, 3, 4)
    return back.reshape(3, C * U, K)


@pytest.mark.parametrize("H,C", [(128, 1), (128, 2), (256, 2), (256, 8),
                                 (384, 8), (512, 16), (160, 4)])
def test_bf16_slices_reassemble(H, C):
    """``l1_operands``/``l2_operands(quant=False)``: the bf16 slices of
    W_hh (2, C, 3U, Hp) and W_ih (2, C, 3U, 2H) and W_head^T (2, C, 16
    tiles, U) hold each weight once, at row q*48 + g*16 + u of slice r for
    unit j = r*U + q*16 + u (W_head^T: row k is class k), and zeros for the
    padded units and classes."""
    rng = np.random.default_rng(H + C)
    layers, head = _net(rng, H, 10, 15)
    w = gru_split.prepare_split_weights(layers, head, "t", False, "cpu")
    x = torch.zeros((2, 3, 10), dtype=torch.bfloat16)
    op1 = gru_split.l1_operands(x, w["w_ih1"], w["b_ih1"], w["w_hh1"],
                                w["sc1"], w["b_hh1"], C, quant=False)
    op2 = gru_split.l2_operands(w["w_in2"], w["in_scale2"], w["b_ih2"],
                                w["w_hh2"], w["sc2"], w["b_hh2"],
                                w["w_head"], C, quant=False)
    U = rnn_cluster.units_per_block(SPLIT_BF16, H, C)
    for d in range(2):
        for sl, full, K in ((op1["w_hh"][d], w["w_hh1"][d], H),
                            (op2["w_hh"][d], w["w_hh2"][d], H),
                            (op2["w_in"][d], w["w_in2"][d], 2 * H)):
            assert sl.dtype == torch.bfloat16 and sl.is_contiguous()
            assert sl.shape == (C, 3 * U, C * U if K == H else K)
            back = _unslice(sl, C)
            assert torch.equal(back[:, :H, :K].reshape(3 * H, K), full)
            assert not back[:, H:].any() and not back[:, :, K:].any()
        wh = op2["w_head"][d]
        assert wh.shape == (C, 16, U) and wh.dtype == torch.bfloat16
        back = wh.permute(1, 0, 2).reshape(16, C * U)
        assert torch.equal(back[:15, :H], w["w_head"][d])
        assert not back[15:].any() and not back[:, H:].any()
    # one value by the formula
    j, g = H - 1, 2
    r, q, u = j // U, (j % U) // 16, j % 16
    assert op2["w_in"][1, r, q * 48 + g * 16 + u, 2 * H - 1] == \
        w["w_in2"][1, g * H + j, 2 * H - 1]


def _groups(a, w, groups, dtype=torch.float64):
    """a (n, K) . w (m, K)^T as the bf16 kernels sum it: the products of
    16-value k-groups (one m16n8k16 f64 mma a group) added in ``dtype`` in
    the order of ``groups``."""
    a = torch.as_tensor(a).to(dtype)
    w = torch.as_tensor(w).to(dtype)
    acc = torch.zeros(a.shape[:-1] + (w.shape[0],), dtype=dtype)
    for j in groups:
        k = slice(16 * j, 16 * j + 16)
        acc = acc + a[..., k] @ w[:, k].t()
    return acc


def _f64(a, w):
    """a (n, K) . w (m, K)^T summed in f64, rounded once to f32: the f32
    that the kernels' sums give in any order of k
    (:func:`test_bf16_sums_do_not_depend_on_the_order_of_k`)."""
    return (torch.as_tensor(a).double()
            @ torch.as_tensor(w).double().t()).float()


def _gates(h, xp, hp):
    """gru_update<false, MODE> on (..., 3) pre-activations, f32."""
    r = torch.sigmoid(xp[..., 0] + hp[..., 0])
    z = torch.sigmoid(xp[..., 1] + hp[..., 1])
    n = torch.tanh(xp[..., 2] + r * hp[..., 2])
    return (1.0 - z) * n + z * h


def _bf16(v):
    return v.to(torch.bfloat16).float()


def _emulate(layer, ops, C, BT, mode, H, T, lengths, inputs, classes=5):
    """The bf16 cluster kernels' arithmetic, block by block of each
    cluster, every operand read the way the kernels index it: the bf16 h
    buffer (C U units, padded units zero) times the block's W_hh rows
    q*48 + g*16 + u summed in f64, the per-row constants in the same
    rows, layer 1's features in one f64 fma chain, layer 2's W_ih over
    both halves in one f64 sum, each rounded once to f32; the head from
    W_head^T of the block's units, summed over the blocks in rank order."""
    B = lengths.shape[0]
    U = rnn_cluster.units_per_block(SPLIT_BF16, H, C)
    rows = torch.arange(3 * U)
    gate, unit = (rows % 48) // 16, (rows // 48) * 16 + rows % 16
    outs = []
    for d in range(2):
        out = (torch.zeros((T, B, H), dtype=torch.bfloat16) if layer == 1
               else torch.zeros((B, T, classes)))
        for b0 in range(0, B, BT):
            cols = torch.arange(b0, min(B, b0 + BT))
            n = len(cols)
            h = torch.zeros((C, n, U))
            hbuf = np.zeros((n, C * U), dtype=np.float32)
            for i in range(T):
                t = i if d == 0 else T - 1 - i
                new_buf, head = np.zeros_like(hbuf), 0.0
                for r in range(C):
                    rc = ops["rowc"][d, r]
                    whh = ops["w_hh"][d, r].float().numpy()
                    hp = _f64(hbuf, whh) + rc[1]
                    if layer == 1:
                        x = ops["x"][t, cols].double()
                        w = ops["w_ih"][d, r].double()
                        xp = torch.zeros((n, 3 * U), dtype=torch.float64)
                        for k in range(inputs):      # one f64 fma chain
                            xp = xp + w[:, k] * x[:, k:k + 1]
                        xp = xp.float() + rc[2]
                    else:
                        prev = torch.cat([inputs[0][t, cols],
                                          inputs[1][t, cols]], dim=-1)
                        xp = _f64(prev, ops["w_in"][d, r]) + rc[2]
                    if mode == "rows":
                        xp = _bf16(xp)
                    xg = torch.zeros((n, U, 3))
                    hg = torch.zeros((n, U, 3))
                    xg[:, unit, gate] = xp
                    hg[:, unit, gate] = hp
                    keep = ((r * U + torch.arange(U) < H)[None, :]
                            & (t < lengths[cols])[:, None])
                    h[r] = torch.where(keep, _gates(h[r], xg, hg), h[r])
                    new_buf[:, r * U:(r + 1) * U] = _bf16(h[r]).numpy()
                    if layer == 2:
                        head = head + _bf16(h[r]) @ ops["w_head"][
                            d, r, :classes].float().t()
                hbuf = new_buf
                if layer == 1:
                    out[t, cols] = torch.from_numpy(
                        hbuf[:, :H]).to(torch.bfloat16)
                else:
                    out[cols, t] = head
        outs.append(out)
    return outs


@pytest.mark.parametrize("mode", ["t", "rows"])
@pytest.mark.parametrize("H,C,BT,B,IN,classes", [
    (64, 1, 8, 11, 10, 5), (64, 2, 16, 20, 10, 5), (96, 2, 8, 9, 10, 15),
    (128, 4, 8, 9, 120, 49), (128, 8, 16, 17, 20, 5)])
def test_bf16_steps_from_the_slices_match_the_plain_versions(
        H, C, BT, B, IN, classes, mode):
    """The bf16 kernels' arithmetic emulated from ``l1_operands`` and
    ``l2_operands(quant=False)`` over ragged lengths (a column of length
    0) against ``gru_l1_split_plain`` and ``gru_l2head_split_plain``
    (quant=False): layer 1 bit for bit (f64 sums of the slices in the
    kernels' order against the plain versions' f64 ``torch.bmm``) and the
    logits within 1e-3, the card's bar (the head's f32 sum over the
    blocks)."""
    rng = np.random.default_rng(H + C + B + IN)
    T = 6
    layers, head = _net(rng, H, IN, classes)
    lengths = torch.from_numpy(rng.integers(1, T + 1, B).astype(np.int32))
    lengths[-1] = 0
    w = gru_split.prepare_split_weights(layers, head, mode, False, "cpu")
    xt = torch.from_numpy(rng.random((T, B, IN)).astype(np.float32)).to(
        torch.bfloat16)
    a1 = (xt, lengths, w["w_ih1"], w["b_ih1"], w["w_hh1"], w["sc1"],
          w["b_hh1"])
    want1 = gru_split.gru_l1_split_plain(*a1, mode=mode, quant=False)
    got1 = _emulate(1, gru_split.l1_operands(xt, *a1[2:], C, quant=False),
                    C, BT, mode, H, T, lengths, IN)
    for got, want in zip(got1, want1):
        assert got.shape == want.shape and got.dtype == torch.bfloat16
        assert torch.equal(got, want)
    a2 = (want1[0], want1[1], lengths, w["w_in2"], w["in_scale2"],
          w["b_ih2"], w["w_hh2"], w["sc2"], w["b_hh2"], w["w_head"])
    want2 = gru_split.gru_l2head_split_plain(*a2, mode=mode, quant=False)
    got2 = _emulate(2, gru_split.l2_operands(*a2[3:], C, quant=False), C,
                    BT, mode, H, T, lengths, want1, classes)
    valid = torch.arange(T)[None, :] < lengths[:, None]
    for got, want in zip(got2, want2):
        assert got.shape == want.shape
        assert (got - want).abs()[valid].max() <= TOL_LOGIT


def _reference(w, xt, lengths, mode):
    """The quant=False split path written out with numpy's f64 products:
    every product of the recurrence is ``a @ w.T`` of the bf16 values in
    f64, rounded once to f32, then the f32 biases, the f32 gates and the
    masks; returns layer 1's bf16 outputs and layer 2's bf16 h of both
    directions, each (2, T, B, H)."""
    T, B, _ = xt.shape
    H = w["w_hh1"].shape[-1]
    lens = lengths.numpy()

    def f64(a, m):
        return torch.from_numpy((np.asarray(a, np.float64)
                                 @ np.asarray(m, np.float64).T)
                                .astype(np.float32))

    def walk(inputs, w_in, b_in, w_hh, b_hh):
        outs = torch.zeros((2, T, B, H), dtype=torch.bfloat16)
        for d in range(2):
            wi = w_in[d].float().numpy()
            wh = w_hh[d].float().numpy()
            h = torch.zeros((B, H))
            for i in range(T):
                t = i if d == 0 else T - 1 - i
                xp = f64(inputs[t].float().numpy(), wi) + b_in[d]
                if mode == "rows":
                    xp = _bf16(xp)
                hp = f64(_bf16(h).numpy(), wh) + b_hh[d]
                r = torch.sigmoid(xp[:, :H] + hp[:, :H])
                z = torch.sigmoid(xp[:, H:2 * H] + hp[:, H:2 * H])
                n = torch.tanh(xp[:, 2 * H:] + r * hp[:, 2 * H:])
                nh = (1.0 - z) * n + z * h
                h = torch.where(torch.from_numpy(t < lens)[:, None], nh, h)
                outs[d, t] = h.to(torch.bfloat16)
        return outs

    l1 = walk(xt, w["w_ih1"], w["b_ih1"], w["w_hh1"], w["b_hh1"])
    l2 = walk(torch.cat([l1[0], l1[1]], dim=-1), w["w_in2"], w["b_ih2"],
              w["w_hh2"], w["b_hh2"])
    return l1, l2


@pytest.mark.parametrize("mode", ["t", "rows"])
@pytest.mark.parametrize("H,IN,B,T", [(16, 10, 7, 9), (256, 10, 5, 4),
                                      (256, 120, 3, 3)])
def test_bf16_plain_versions_equal_a_numpy_f64_reference(H, IN, B, T, mode):
    """``gru_l1_split_plain`` and ``gru_l2head_split_plain`` with
    quant=False over ragged lengths (a column of length 0) are bit for bit
    :func:`_reference`, whose products numpy sums in f64 and rounds once
    to f32. Layer 2's h is read through a one-hot head (class k picks unit
    u_k of each direction's half), whose logit of a column is bf16(h) of
    that unit exactly."""
    rng = np.random.default_rng(H + IN + B)
    layers, _ = _net(rng, H, IN, 5)
    units = rng.permutation(H)[:min(H, rnn_cluster.HEAD_CLASSES)]
    w_head = np.zeros((len(units), 2 * H), dtype=np.float32)
    w_head[np.arange(len(units)), units] = 1.0
    w_head[np.arange(len(units)), H + units] = 1.0
    head = {"w": torch.from_numpy(w_head), "b": torch.zeros(len(units))}
    lengths = torch.from_numpy(rng.integers(1, T + 1, B).astype(np.int32))
    lengths[0], lengths[-1] = T, 0
    w = gru_split.prepare_split_weights(layers, head, mode, False, "cpu")
    xt = torch.from_numpy(rng.random((T, B, IN)).astype(np.float32)).to(
        torch.bfloat16)
    l1, l2 = _reference(w, xt, lengths, mode)
    out = gru_split.gru_l1_split_plain(
        xt, lengths, w["w_ih1"], w["b_ih1"], w["w_hh1"], w["sc1"],
        w["b_hh1"], mode=mode, quant=False)
    assert torch.equal(out[0], l1[0]) and torch.equal(out[1], l1[1])
    lg = gru_split.gru_l2head_split_plain(
        out[0], out[1], lengths, w["w_in2"], w["in_scale2"], w["b_ih2"],
        w["w_hh2"], w["sc2"], w["b_hh2"], w["w_head"], mode=mode,
        quant=False)
    for d in range(2):
        want = l2[d][:, :, units].float().transpose(0, 1)   # (B, T, C)
        assert torch.equal(lg[d], want)


def _h_wide(rng, n, K):
    """bf16 values over some 40 binades (and some zeros), both signs: the
    products then span more binades than an f64 significand holds."""
    mag = 2.0 ** rng.uniform(-40, 0, (n, K))
    v = np.where(rng.random((n, K)) < 0.05, 0.0,
                 mag * rng.choice([-1.0, 1.0], (n, K)))
    return torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("H,C", [(16, 1), (256, 2), (256, 8), (512, 16)])
def test_bf16_sums_do_not_depend_on_the_order_of_k(H, C):
    """The claim the f64 kernels rest on: over the bf16 slices of W_hh
    (K = Hp) and of layer 2's W_ih (K = 2H), the f64 sums of each block's
    rows taken by k-groups in ascending order, in descending order, and
    split over S = 2 and 4 warps (each warp's groups in order, the partial
    sums added in warp order) all round to the same f32, the plain
    version's ``_sum64`` of the unsliced weights; the same orders summed
    in f32 (by k-group) do not agree."""
    rng = np.random.default_rng(H + C)
    layers, head = _net(rng, H, 10, 5)
    w = gru_split.prepare_split_weights(layers, head, "t", False, "cpu")
    op = gru_split.l2_operands(w["w_in2"], w["in_scale2"], w["b_ih2"],
                               w["w_hh2"], w["sc2"], w["b_hh2"],
                               w["w_head"], C, quant=False)
    U = rnn_cluster.units_per_block(SPLIT_BF16, H, C)
    f32_orders_agree = True
    for sl, full in ((op["w_hh"][0], w["w_hh2"][0]),
                     (op["w_in"][0], w["w_in2"][0])):
        K = sl.shape[-1]
        a = _h_wide(rng, 9, K)
        a[:, full.shape[-1]:] = 0     # the padded units' zero h
        want = gru_split._sum64(a[:, :full.shape[-1]].float()[None],
                                full.float().t()[None])[0]
        flat = torch.cat(list(sl), 0)
        G = K // 16

        def unslice(rows):
            back = _unslice(rows.t().reshape(C, 3 * U, -1), C)
            return back[:, :H].reshape(3 * H, -1).t()

        sums = []
        for order in (range(G), range(G - 1, -1, -1)):
            assert torch.equal(unslice(_groups(a, flat, order).float()),
                               want)
            sums.append(_groups(a, flat, order, torch.float32))
        for S in (2, 4):
            # each warp's share in order, the shares added in warp order
            for dtype in (torch.float64, torch.float32):
                total = 0
                for s in range(S):
                    total = total + _groups(
                        a, flat, range(s * G // S, (s + 1) * G // S), dtype)
                if dtype == torch.float64:
                    assert torch.equal(unslice(total.float()), want)
                else:
                    sums.append(total)
        f32_orders_agree &= all(torch.equal(v, sums[0]) for v in sums[1:])
    # (at H=16, one and two k-groups, every order adds the same f32s)
    assert H == 16 or not f32_orders_agree
