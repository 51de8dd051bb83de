"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: skips without a GPU. The test imports no JAX, so it
runs on a machine that has PyTorch for CUDA but no JAX, past the JAX
setup of ``conftest.py``:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import json
import os

import numpy as np
import pytest
import torch

from medaka_tpu_torch import features, models, prediction, testing
from medaka_tpu_torch.common import Region
from medaka_tpu_torch.models.gru import GRUModel
from medaka_tpu_torch.ops import bilstm, cuda_build, gru_fullfused, \
    gru_split, gru_train, lstm_train, rnn_cluster

pytestmark = pytest.mark.cuda

RL_MODEL = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "medaka_tpu", "data",
    "rl_lstm128_lambda_demo.tar.gz")
MODEL = os.path.join(os.path.dirname(RL_MODEL),
                     "gru256_lambda_demo_model_pt.tar.gz")


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gru_split.build()
    bilstm.build()
    gru_train.build()
    lstm_train.build()
    gru_fullfused.build()
    for log in cuda_build.BUILD_LOGS.values():
        print(log)
    return torch.device("cuda")


def _net(rng, H, IN=10, C=5):
    def direction(in_size):
        k = 1.0 / np.sqrt(H)
        return {name: torch.from_numpy(
            rng.uniform(-k, k, shape).astype(np.float32))
            for name, shape in (("w_ih", (3 * H, in_size)),
                                ("w_hh", (3 * H, H)),
                                ("b_ih", (3 * H,)), ("b_hh", (3 * H,)))}
    layers = [{"fwd": direction(IN), "bwd": direction(IN)},
              {"fwd": direction(2 * H), "bwd": direction(2 * H)}]
    k = 1.0 / np.sqrt(2 * H)
    head = {"w": torch.from_numpy(rng.uniform(-k, k, (C, 2 * H)).astype(
                np.float32)),
            "b": torch.from_numpy(rng.uniform(-k, k, (C,)).astype(
                np.float32))}
    return layers, head


def _split_inputs(rng, H, T, batch, mode, quant, device, classes=5,
                  inputs=10):
    layers, head = _net(rng, H, IN=inputs, C=classes)
    x = torch.from_numpy(rng.random((batch, T, inputs)).astype(np.float32))
    lengths = torch.from_numpy(
        rng.integers(1, T + 1, batch).astype(np.int32))
    lengths[0] = T
    lengths[-1] = 0        # a column of length 0
    w = gru_split.prepare_split_weights(layers, head, mode, quant, device)
    xt = x.transpose(0, 1).to(torch.bfloat16).contiguous().to(device)
    return w, xt, lengths.to(device)


def _one_hot_head(w, H, classes):
    """``w`` with a head whose class k picks unit k H // classes of each
    direction's h: its logits are bf16(h) of those units exactly, in any
    order of the head's sum."""
    units = torch.arange(classes, device=w["w_head"].device) * H // classes
    head = torch.zeros_like(w["w_head"])
    head[:, torch.arange(classes), units] = 1.0
    return dict(w, w_head=head)


def _check_split_kernels(device, H, T, batch, mode, quant, seed,
                         classes=5, inputs=10, exact_l1=False):
    """Layer 1 against its plain version on its own inputs, layer 2 on
    layer 1's kernel outputs, and both kernels against themselves run
    again (bit for bit); ``exact_l1``: the int8 layer 1 bit for bit. In
    bf16 (every sum exact in f64) layer 1 is the plain version's bits, and
    so is layer 2's h, read through a one-hot head."""
    w, xt, lens = _split_inputs(np.random.default_rng(seed), H, T, batch,
                                mode, quant, device, classes, inputs)
    args1 = (xt, lens, w["w_ih1"], w["b_ih1"], w["w_hh1"], w["sc1"],
             w["b_hh1"])
    out_f, out_b = gru_split.gru_l1_split(*args1, mode=mode, quant=quant)
    ref_f, ref_b = gru_split.gru_l1_split_plain(*args1, mode=mode,
                                                quant=quant)
    again = gru_split.gru_l1_split(*args1, mode=mode, quant=quant)
    torch.cuda.synchronize()
    assert torch.equal(again[0], out_f) and torch.equal(again[1], out_b)
    for got, ref in ((out_f, ref_f), (out_b, ref_b)):
        diff = (got.float() - ref.float()).abs()
        print("layer 1", H, batch, mode, quant, "max", diff.max().item(),
              "mean", diff.mean().item())
        assert diff.max().item() <= (1 if quant else 2.0 ** -7)
        assert diff.mean().item() <= 1e-3
        if exact_l1 or not quant:
            assert torch.equal(got, ref)
    args2 = (out_f, out_b, lens, w["w_in2"], w["in_scale2"], w["b_ih2"],
             w["w_hh2"], w["sc2"], w["b_hh2"], w["w_head"])
    lg_f, lg_b = gru_split.gru_l2head_split(*args2, mode=mode, quant=quant)
    pf, pb = gru_split.gru_l2head_split_plain(*args2, mode=mode, quant=quant)
    again = gru_split.gru_l2head_split(*args2, mode=mode, quant=quant)
    torch.cuda.synchronize()
    assert torch.equal(again[0], lg_f) and torch.equal(again[1], lg_b)
    valid = (torch.arange(T, device=device)[None, :]
             < lens[:, None].long())
    for got, ref in ((lg_f, pf), (lg_b, pb)):
        assert got.shape == (batch, T, classes)
        diff = (got - ref).abs()[valid]
        print("layer 2", H, batch, mode, quant, "max", diff.max().item(),
              "mean", diff.mean().item())
        assert diff.max().item() <= 1e-3
    if not quant:
        wh = _one_hot_head(w, H, classes)
        args2 = args2[:-1] + (wh["w_head"],)
        got = gru_split.gru_l2head_split(*args2, mode=mode, quant=False)
        ref = gru_split.gru_l2head_split_plain(*args2, mode=mode,
                                               quant=False)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.parametrize("classes", [5, 9, 15, 16])
@pytest.mark.parametrize("quant", [True, False])
@pytest.mark.parametrize("mode,batch", [("t", 512), ("t", 200),
                                        ("rows", 37)])
def test_kernels_match_plain(device, mode, batch, quant, classes):
    """Both kernels against their plain versions at H=256, ragged lengths
    with a column of length 0, and against themselves run again; with the
    haploid head's 5 classes, the diploid head's 15 and the edges of the
    16-wide head (9 and 16).

    Layer 1 is compared on its own inputs, layer 2 on layer 1's kernel
    outputs, so each kernel is held to the same inputs as its plain
    version. They do the same operations and differ only in the order of
    f32 sums, which could move round(127 h) or a bf16 cast across a
    rounding boundary: layer 1 within one int8 step or one bf16 ulp,
    logits within 1e-3. Measured on an H100: layer 1 identical, logits
    within 4e-8. The batch sizes cover the tile shapes; a second launch
    gives the same bits (no atomics, fixed-order sums).
    """
    _check_split_kernels(device, 256, 300, batch, mode, quant, 7, classes)


@pytest.mark.parametrize("quant", [True, False])
@pytest.mark.parametrize("mode,batch", [("t", 480), ("t", 200),
                                        ("rows", 64), ("rows", 37)])
def test_rle_split_kernels_match_plain(device, mode, batch, quant):
    """Both kernels at the run-length bundle's shapes (``gru256_rle_demo``:
    120 input features, 49 classes) against their plain versions, the
    same bars: layer 1's W_ih no longer fits one block beside W_hh, so
    the int8 layer 1 runs on clusters of 2 or more (bf16: 4); the head is
    four m16 tiles of W_head^T in both layer-2 kernels."""
    _check_split_kernels(device, 256, 200, batch, mode, quant, 11, 49, 120)


@pytest.mark.parametrize("quant", [True, False])
@pytest.mark.parametrize("mode,batch", [("t", 512), ("t", 200),
                                        ("rows", 64), ("rows", 37)])
def test_reference_width_split_kernels_match_plain(device, mode, batch,
                                                   quant):
    """Both kernels at the reference's ``GRUModel`` width (H=128, 10
    inputs, 5 classes) against their plain versions, the bars of H=256,
    the int8 layer 1 bit for bit: fewer units a block (m16 tiles of 128/C
    units) and more resident clusters than at H=256."""
    _check_split_kernels(device, 128, 300, batch, mode, quant, 128 + batch,
                         exact_l1=True)


def test_reference_width_wave_batch(device):
    """The automatic batch of a 2x128 GRUModel on the card: both int8
    split kernels in one wave, at most the cap of 512 rows."""
    batch = prediction.auto_batch_size(GRUModel(gru_size=128), device)
    wave = gru_split.wave_batch(128, 10, device, prediction.AUTO_BATCH_CAP)
    print("H=128 automatic batch", batch, "wave batch", wave)
    assert batch <= prediction.AUTO_BATCH_CAP and batch <= wave
    assert gru_split.split_mode(batch) == "t"


@pytest.mark.parametrize("mode", ["t", "rows"])
@pytest.mark.parametrize("batch", [32, 200])
@pytest.mark.parametrize("H", [384, 512])
def test_wide_split_kernels_match_plain(device, H, batch, mode):
    """The int8 split kernels at H=384 and 512, where the whole int8 W_hh
    is more than one block's shared memory (468,800 and 821,568 B with
    the old per-block kernel's buffers): clusters hold it in slices. The
    same bars as at H=256, and bit for bit on repeat."""
    _check_split_kernels(device, H, 64, batch, mode, True, H + batch)


@pytest.mark.parametrize("mode", ["t", "rows"])
@pytest.mark.parametrize("batch", [32, 200])
@pytest.mark.parametrize("H", [384, 512])
def test_wide_bf16_split_kernels_match_plain(device, H, batch, mode):
    """The bf16 (``quant=False``) split kernels at H=384 and 512: layer 1
    on clusters (of 8 or 16), layer 2 on the per-block kernel, whose bf16
    W_hh and W_ih slices fit no cluster and whose sums are double fma
    chains. Layer 1 and layer 2's h the plain versions' bits, the logits
    within 1e-3, bit for bit on repeat."""
    _check_split_kernels(device, H, 64, batch, mode, False, H + batch + 1)


def test_bf16_split_kernels_at_the_automatic_batch(device):
    """The bf16 cluster kernels at the automatic batch (480 rows, mode
    "t", H=256, ragged lengths): layer 1 and layer 2's h the plain
    versions' bits, the logits within 1e-3, and a second launch of each
    repeats the first bit for bit."""
    _check_split_kernels(device, 256, 200, 480, "t", False, 480)


def _split_kernels_run(fn):
    """The split kernels' names in a profile of ``fn``."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key.replace("(anonymous namespace)::", "")
                   for e in prof.key_averages() if "split" in e.key})


@pytest.mark.parametrize("H,per_block", [(256, False), (512, True)])
def test_bf16_split_launches_run_the_cluster_kernels(device, H, per_block):
    """A ``quant=False`` launch runs the bf16 cluster kernels
    (``gru_l1_split_bf16_kernel``, ``gru_l2head_split_bf16_kernel``) and
    no retired per-block kernel: the per-block layer 1 is gone, and the
    per-block layer 2 (``gru_l2head_split_kernel``) runs only where no
    cluster holds the slices (H=512). Their outputs are the plain
    versions' bits in layer 1, and in layer 2's h (a one-hot head)."""
    w, xt, lens = _split_inputs(np.random.default_rng(H), H, 40, 64, "rows",
                                False, device)
    args1 = (xt, lens, w["w_ih1"], w["b_ih1"], w["w_hh1"], w["sc1"],
             w["b_hh1"])
    out = {}
    l1 = _split_kernels_run(lambda: out.update(
        l1=gru_split.gru_l1_split(*args1, mode="rows", quant=False)))
    args2 = out["l1"] + (lens, w["w_in2"], w["in_scale2"], w["b_ih2"],
                         w["w_hh2"], w["sc2"], w["b_hh2"], w["w_head"])
    l2 = _split_kernels_run(lambda: gru_split.gru_l2head_split(
        *args2, mode="rows", quant=False))
    print(H, l1, l2)
    plain = gru_split.gru_l1_split_plain(*args1, mode="rows", quant=False)
    assert all(torch.equal(a, b) for a, b in zip(out["l1"], plain))
    wh = _one_hot_head(w, H, 5)["w_head"]
    got = gru_split.gru_l2head_split(*args2[:-1], wh, mode="rows",
                                     quant=False)
    want = gru_split.gru_l2head_split_plain(*args2[:-1], wh, mode="rows",
                                            quant=False)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert any(k.startswith(("gru_l1_split_bf16_kernel",
                             "void gru_l1_split_bf16_kernel")) for k in l1)
    assert not any("gru_l1_split_kernel" in k for k in l1 + l2)
    assert not any("_s8_kernel" in k for k in l1 + l2)
    assert any("gru_l2head_split_bf16_kernel" in k for k in l2) != per_block
    assert any("gru_l2head_split_kernel" in k for k in l2) == per_block


@pytest.mark.parametrize("quant", [True, False])
@pytest.mark.parametrize("kind", ["l1", "l2"])
def test_split_geometry_matches_the_kernels(device, kind, quant):
    """The host's byte count equals the kernel's for every H and batch of
    the split path, int8 and bf16, every geometry it picks is resident
    and runs, the int8 layer 1 at H=256 keeps all of W_hh in one block
    (C=1) at 512 and 480 rows, the bf16 layer 1 at H=256 runs 480 rows on
    clusters of 2 and the bf16 layer 2 on clusters of 8, 32 columns; bf16
    layer 2 at H=384 and 512 routes to the per-block kernel."""
    lib = gru_split.build()
    for H in (128, 256, 384, 512):
        for B in (32, 64, 191, 192, 480, 512):
            for mode in ("t", "rows"):
                for inputs, classes in (((0, 5), (0, 15), (0, 49))
                                        if kind == "l2"
                                        else ((10, 5), (120, 5))):
                    if kind == "l2" and gru_split.l2_route(
                            H, classes, quant) == "per-block":
                        assert not quant and H >= 384
                        continue
                    C, BT, smem, resident = gru_split.geometry(
                        kind, H, B, device, mode, inputs, classes,
                        quant=quant)
                    assert lib.gru_split_smem(
                        int(quant), int(kind == "l2"), C, BT, H, inputs,
                        classes) == smem
                    assert smem <= cuda_build.SMEM_LIMIT and resident >= 1
                    print(kind, quant, H, B, mode, inputs, classes,
                          (C, BT, smem, resident))
    if kind == "l1" and quant:
        assert gru_split.geometry("l1", 256, 512, device, "t", 10)[:2] == (
            1, 8)
    want = {("l1", True): (1, 8), ("l1", False): (2, 16),
            ("l2", False): (8, 32)}.get((kind, quant))
    if want:
        assert gru_split.geometry(kind, 256, 480, device, "t",
                                  10 * (kind == "l1"),
                                  quant=quant)[:2] == want


def test_wrapper_raises_on_bad_input(device):
    x = torch.zeros((4, 2, 10), dtype=torch.bfloat16, device=device)
    with pytest.raises(ValueError, match="multiple of 32"):
        gru_split.gru_l1_split(
            x, torch.full((2,), 4, dtype=torch.int32, device=device),
            torch.zeros((2, 48, 10), device=device),
            torch.zeros((2, 48), device=device),
            torch.zeros((2, 48, 16), dtype=torch.int8, device=device),
            torch.ones((2, 48), device=device),
            torch.zeros((2, 48), device=device))


@pytest.mark.parametrize("H,B,T", [(128, 128, 1000), (384, 32, 500),
                                   (128, 5, 64), (128, 1, 200),
                                   (128, 16, 300), (384, 1, 100),
                                   (384, 16, 200), (384, 128, 200)])
def test_bilstm_matches_plain(device, H, B, T):
    """bilstm_fused (the LSTM cluster forward, both directions in one grid:
    clusters of 2 at H=128, 8 at H=384) against bilstm_fused_plain on
    random weights, ragged lengths, both directions. They do the same
    operations and differ only in the order of the f32 sums of the
    recurrent product, which can move the bf16 rounding of h by one step:
    outputs within one bf16 step (2^-8 for |h| < 1), mean difference
    within 1e-3; a second launch repeats the first bit for bit."""
    rng = np.random.default_rng(H + B)
    k = 1.0 / np.sqrt(H)
    xp_f, xp_b = (torch.from_numpy(rng.uniform(-2, 2, (T, B, 4 * H)).astype(
        np.float32)).to(device, torch.bfloat16) for _ in range(2))
    w_hh = torch.from_numpy(rng.uniform(-k, k, (2, 4 * H, H)).astype(
        np.float32)).to(device)
    b_hh = torch.from_numpy(rng.uniform(-k, k, (2, 4 * H)).astype(
        np.float32)).to(device)
    lengths = torch.from_numpy(rng.integers(1, T + 1, B).astype(np.int32))
    lengths[0] = T
    lengths = lengths.to(device)
    got = bilstm.bilstm_fused(xp_f, xp_b, w_hh, b_hh, lengths)
    again = bilstm.bilstm_fused(xp_f, xp_b, w_hh, b_hh, lengths)
    want = bilstm.bilstm_fused_plain(xp_f, xp_b, w_hh, b_hh, lengths)
    torch.cuda.synchronize()
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    for g, w in zip(got, want):
        assert g.shape == (T, B, H) and g.dtype == torch.bfloat16
        diff = (g.float() - w.float()).abs()
        print("H", H, "B", B, "max", diff.max().item(), "mean",
              diff.mean().item())
        assert diff.max().item() <= 2.0 ** -8
        assert diff.mean().item() <= 1e-3
    # padded steps of the backward direction hold the zero state
    t_pad = torch.arange(T, device=device)[:, None] >= lengths[None, :]
    assert (got[1].float().abs().sum(-1)[t_pad] == 0).all()


def test_read_level_forward_matches_cpu_plain_route(device, tmp_path):
    """The read-level model on the card (bf16, bilstm_fused kernel)
    against the CPU's plain route (fused=True: the kernel's plain
    version) on 2 chunks: probabilities within 2e-2, as the bf16 CPU
    routes of the two packages (cuDNN and the CPU round the convolutions
    differently), argmax agreement >= 0.99."""
    bam, _ = testing.create_synth_bam(str(tmp_path / "r.bam"), ref_mb=0.01,
                                      depth=10, read_len=2000)
    bundle = models.load_model(RL_MODEL)
    samples = features.SampleGenerator(
        bam, Region("synth", 0, 10000), bundle.feature_encoder,
        chunk_len=1000, chunk_overlap=100).samples[:2]
    batch = prediction.Batch.collate(samples, 2, 1000, 100)
    x = torch.from_numpy(batch.features)
    lengths = torch.from_numpy(batch.lengths)
    model = bundle.model
    with torch.inference_mode():
        want = model(x, lengths=lengths, compute_dtype=torch.bfloat16,
                     fused=True)
        bilstm.reset_launches()
        model.to(device)
        got = model(x.to(device), lengths=lengths.to(device),
                    compute_dtype=torch.bfloat16).cpu()
        model.to("cpu")
    assert bilstm.LAUNCHES["bilstm_fused"] == 2
    diff = (got - want).abs()
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    print("read-level card vs CPU: max", diff.max().item(), "mean",
          diff.mean().item(), "argmax agreement", agree)
    assert diff.max().item() <= 2e-2
    assert agree >= 0.99


def _train_inputs(rng, H, B, T, device):
    k = 1.0 / np.sqrt(H)
    xp = torch.from_numpy(rng.uniform(-2, 2, (T, B, 3 * H)).astype(
        np.float32)).to(device, torch.bfloat16)
    w_hh = torch.from_numpy(rng.uniform(-k, k, (3 * H, H)).astype(
        np.float32)).to(device)
    b_hh = torch.from_numpy(rng.uniform(-k, k, (3 * H,)).astype(
        np.float32)).to(device)
    lengths = torch.from_numpy(rng.integers(1, T + 1, B).astype(np.int32))
    lengths[0] = T
    dh_out = torch.from_numpy(rng.standard_normal((T, B, H)).astype(
        np.float32)).to(device, torch.bfloat16).float()
    return xp, w_hh, b_hh, lengths.to(device), dh_out


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("H,B,T", [
    (256, 128, 200), (128, 37, 100), (64, 5, 64), (64, 1, 50),
    (96, 16, 60), (256, 16, 80), (256, 37, 60), (384, 37, 40),
    (384, 128, 30), (512, 128, 40), (512, 1, 30), (128, 128, 1000)])
def test_gru_train_kernels_match_plain(device, H, B, T, reverse):
    """gru_fwd and gru_bwd against their plain versions, ragged lengths
    with a length-0 column.

    They do the same operations and differ only in the order of f32 sums
    (the recurrent products, dW_hh and db_hh), which can move a bf16
    rounding: forward outputs within one bf16 step (2^-8 for |h| < 1),
    mean within 1e-3; dxp, dW_hh and db_hh within 1e-3 of each tensor's
    largest magnitude. Both run the cluster recurrence; the shapes take
    every cluster size the geometry chooser picks, the backward's (H=64:
    1, 96: 2, 256: 4, 384: 8, 512: 16) and the forward's (H=64: 1, 96 and
    128: 2, 256: 4, 384 and 512: 8), and 1, 2 or 4 column tiles. A second
    forward and backward repeat the first bit for bit.
    """
    rng = np.random.default_rng(H + B + int(reverse))
    xp, w_hh, b_hh, lengths, dh_out = _train_inputs(rng, H, B, T, device)
    if B > 1:
        lengths[-1] = 0
    out = gru_train.gru_fwd(xp, w_hh, b_hh, lengths, reverse)
    ref = gru_train.gru_fwd_plain(xp, w_hh, b_hh, lengths, reverse)
    out_again = gru_train.gru_fwd(xp, w_hh, b_hh, lengths, reverse)
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    print("gru_fwd H", H, "B", B, "reverse", reverse, "geometry",
          gru_train.fwd_geometry(H, B, device), "max", diff.max().item(),
          "mean", diff.mean().item())
    assert out.shape == (T, B, H) and out.dtype == torch.bfloat16
    assert torch.equal(out, out_again)
    assert diff.max().item() <= 2.0 ** -8
    assert diff.mean().item() <= 1e-3
    got = gru_train.gru_bwd(xp, out, dh_out, w_hh, b_hh, lengths, reverse)
    want = gru_train.gru_bwd_plain(xp, out, dh_out, w_hh, b_hh, lengths,
                                   reverse)
    again = gru_train.gru_bwd(xp, out, dh_out, w_hh, b_hh, lengths, reverse)
    torch.cuda.synchronize()
    print("gru_bwd geometry", gru_train.bwd_geometry(H, B, device))
    for name, g, w in zip(("dxp", "dW_hh", "db_hh"), got, want):
        rel = ((g - w).abs().max() / w.abs().max()).item()
        print("gru_bwd", name, "relative max", rel)
        assert g.shape == w.shape and g.dtype == torch.float32
        assert rel <= 1e-3
    for g, a in zip(got, again):
        assert torch.equal(g, a)


def test_train_step_kernels_match_cpu_plain_route(device):
    """One bf16 training step of GRUModel (2 layers, bidirectional,
    H=64) through the kernels on the card against the same step through
    their plain versions on the CPU: loss within 1e-5 relative, every
    gradient within 1e-2 of its largest magnitude."""
    from medaka_tpu_torch import parallel
    rng = np.random.default_rng(3)
    B, T = 8, 120
    torch.manual_seed(0)
    model = GRUModel(gru_size=64)
    lengths = rng.integers(T // 2, T + 1, B).astype(np.int32)
    lengths[0] = T
    mask = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)
    batch = {"features": torch.from_numpy(rng.random((B, T, 10)).astype(
                 np.float32)),
             "labels": torch.from_numpy(rng.integers(0, 5, (B, T)).astype(
                 np.int32)),
             "mask": torch.from_numpy(mask),
             "lengths": torch.from_numpy(lengths)}

    def step(dev, fused):
        model.to(dev)
        model.zero_grad()
        loss, _ = parallel.cross_entropy_loss(
            lambda *a, **kw: model(*a, fused=fused, **kw),
            {k: v.to(dev) for k, v in batch.items()},
            compute_dtype=torch.bfloat16, training=True)
        loss.backward()
        return loss.item(), {n: p.grad.cpu().clone()
                             for n, p in model.named_parameters()}

    gru_train.reset_launches()
    loss_k, grads_k = step(device, None)
    assert gru_train.LAUNCHES == {"gru_fwd": 4, "gru_bwd": 4}
    loss_p, grads_p = step("cpu", True)
    model.to("cpu")
    print("loss kernels", loss_k, "plain", loss_p)
    assert abs(loss_k - loss_p) <= 1e-5 * abs(loss_p)
    for name, gp in grads_p.items():
        rel = ((grads_k[name] - gp).abs().max() / gp.abs().max()).item()
        print(name, "relative max", rel)
        assert rel <= 1e-2


def _lstm_train_inputs(rng, H, B, T, device):
    k = 1.0 / np.sqrt(H)
    xp = torch.from_numpy(rng.uniform(-2, 2, (T, B, 4 * H)).astype(
        np.float32)).to(device, torch.bfloat16)
    w_hh = torch.from_numpy(rng.uniform(-k, k, (4 * H, H)).astype(
        np.float32)).to(device)
    b_hh = torch.from_numpy(rng.uniform(-k, k, (4 * H,)).astype(
        np.float32)).to(device)
    lengths = torch.from_numpy(rng.integers(1, T + 1, B).astype(np.int32))
    lengths[0] = T
    dh_out = torch.from_numpy(rng.standard_normal((T, B, H)).astype(
        np.float32)).to(device, torch.bfloat16).float()
    return xp, w_hh, b_hh, lengths.to(device), dh_out


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("H,B,T", [
    (384, 128, 100), (128, 128, 200), (128, 37, 100), (64, 5, 64),
    (64, 1, 50), (256, 37, 60), (384, 5, 50), (416, 37, 40),
    (512, 128, 40), (512, 1, 30)])
def test_lstm_train_kernels_match_plain(device, H, B, T, reverse):
    """lstm_fwd and lstm_bwd against their plain versions, ragged lengths
    with a length-0 column.

    They do the same operations and differ only in the order of f32 sums
    (the recurrent products on the tensor cores, dW_hh and db_hh), which
    can move a bf16 rounding: h within one bf16 step (2^-8 for |h| < 1),
    mean within 1e-3, c within 1e-3 of its largest magnitude; dxp, dW_hh
    and db_hh within 1e-3 of each tensor's largest magnitude. The shapes
    take every cluster size the geometry chooser picks (H=64: 1, 128: 2,
    256: 4, 384: 8, 512: 16; the backward at H=416: 16) and 1, 2 or 4
    column tiles. A second forward and backward repeat the first bit for
    bit.
    """
    rng = np.random.default_rng(H + B + int(reverse))
    xp, w_hh, b_hh, lengths, dh_out = _lstm_train_inputs(rng, H, B, T,
                                                         device)
    if B > 1:
        lengths[-1] = 0
    out, c_out = lstm_train.lstm_fwd(xp, w_hh, b_hh, lengths, reverse)
    geometry = {kind: lstm_train.geometry(kind, H, B, device)
                for kind in ("fwd", "bwd")}
    ref, c_ref = lstm_train.lstm_fwd_plain(xp, w_hh, b_hh, lengths, reverse)
    out2, c_out2 = lstm_train.lstm_fwd(xp, w_hh, b_hh, lengths, reverse)
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    c_rel = ((c_out - c_ref).abs().max() / c_ref.abs().max()).item()
    print("lstm_fwd H", H, "B", B, "reverse", reverse, "geometry",
          geometry, "max", diff.max().item(), "mean", diff.mean().item(),
          "c", c_rel)
    assert out.shape == (T, B, H) and out.dtype == torch.bfloat16
    assert c_out.shape == (T, B, H) and c_out.dtype == torch.float32
    assert diff.max().item() <= 2.0 ** -8
    assert diff.mean().item() <= 1e-3
    assert c_rel <= 1e-3
    assert torch.equal(out, out2) and torch.equal(c_out, c_out2)
    got = lstm_train.lstm_bwd(xp, out, c_out, dh_out, w_hh, b_hh, lengths,
                              reverse)
    want = lstm_train.lstm_bwd_plain(xp, out, c_out, dh_out, w_hh, b_hh,
                                     lengths, reverse)
    again = lstm_train.lstm_bwd(xp, out, c_out, dh_out, w_hh, b_hh,
                                lengths, reverse)
    torch.cuda.synchronize()
    for name, g, w in zip(("dxp", "dW_hh", "db_hh"), got, want):
        rel = ((g - w).abs().max() / w.abs().max()).item()
        print("lstm_bwd", name, "relative max", rel)
        assert g.shape == w.shape and g.dtype == torch.float32
        assert rel <= 1e-3
    for g, a in zip(got, again):
        assert torch.equal(g, a)


@pytest.mark.parametrize("kind", ["fwd", "bwd"])
def test_lstm_geometry_matches_the_kernels(device, kind):
    """The host's byte count equals the kernel's for every H and tile the
    chooser can pick, and every cluster size it picks is resident."""
    smem_fn = getattr(lstm_train.build(), "lstm_{}_smem".format(kind))
    clusters = set()
    for H in range(32, 513, 32):
        for B in (1, 5, 128, 512):
            C, BT, smem, resident = lstm_train.geometry(kind, H, B, device)
            assert smem_fn(C, BT, H) == smem
            assert smem <= cuda_build.SMEM_LIMIT and resident >= 1
            clusters.add(C)
    print(kind, "cluster sizes", sorted(clusters))
    assert clusters == {1, 2, 4, 8, 16}


def _launch_at(kernel, H, B, device):
    """Two steps of ``gru_fwd`` (one direction) or ``bigru_fused`` (both)
    at (H, B) against the plain version, within one bf16 step."""
    rng = np.random.default_rng(H * 1000 + B)
    T = 2
    xp, w_hh, b_hh, lengths, _ = _train_inputs(rng, H, B, T, device)
    if kernel == "gru_fwd":
        got = gru_train.gru_fwd(xp, w_hh, b_hh, lengths)
        want = gru_train.gru_fwd_plain(xp, w_hh, b_hh, lengths)
    else:
        w2, b2 = torch.stack([w_hh, w_hh.flip(0)]), torch.stack([b_hh] * 2)
        got = gru_fullfused.fused_layer(xp, xp.flip(-1), w2, b2, lengths)
        want = gru_fullfused.recurrence_plain(xp, xp.flip(-1), w2, b2,
                                              lengths)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= 2.0 ** -8


@pytest.mark.parametrize("kernel", ["gru_bwd", "bigru_fullfused", "gru_fwd",
                                    "bigru_fused", "bigru_fullfused_int8",
                                    "bigru_fullfused/bf16_gates"])
def test_gru_geometry_matches_the_kernels(device, kernel):
    """The host's byte count equals the kernel's for every H and tile the
    GRU cluster chooser can pick (the backward and ``gru_fwd`` at every H
    they take, the f32-gates bi-GRU recurrence of ``bigru_fullfused`` and
    ``bigru_fused``, the int8 one of ``bigru_fullfused_int8`` and the
    bf16-gates one at every H up to 512, padded to a multiple of 32), and
    every cluster size it picks is resident; ``gru_fwd`` and
    ``bigru_fused`` launch at each geometry and agree with their plain
    versions."""
    if kernel == "gru_bwd":
        smem_fn = gru_train.build().gru_bwd_smem
        geometry = gru_train.bwd_geometry
        want = {1, 2, 4, 8, 16}
    elif kernel == "gru_fwd":
        smem_fn = gru_train.build().gru_fwd_cluster_smem
        geometry = gru_train.fwd_geometry
        want = {1, 2, 4, 8}
    else:
        name, _, mode = kernel.partition("/")
        mode = mode or ("int8" if kernel == "bigru_fullfused_int8"
                        else "f32_gates")
        num = gru_fullfused.NUMERICS[mode]

        def smem_fn(C, BT, H):
            return gru_fullfused.build().bigru_cluster_smem(num, C, BT, H)

        def geometry(H, B, dev):
            return gru_fullfused.cluster_geometry(H, B, dev, name, mode)
        want = {"int8": {1, 2, 4, 8, 16}, "bf16_gates": {2, 4, 8, 16},
                "f32_gates": {1, 2, 4, 8}}[mode]
    gru_train.reset_launches()
    gru_fullfused.reset_launches()
    clusters = set()
    for H in range(32, 513, 32):
        for B in (1, 5, 16, 31, 128, 512):
            C, BT, smem, resident = geometry(H, B, device)
            assert smem_fn(C, BT, H) == smem
            assert smem <= cuda_build.SMEM_LIMIT and resident >= 1
            clusters.add(C)
            if kernel in ("gru_fwd", "bigru_fused"):
                _launch_at(kernel, H, B, device)
    print(kernel, "cluster sizes", sorted(clusters))
    assert clusters == want
    if kernel == "gru_fwd":
        assert gru_train.LAUNCHES["gru_fwd"] == 16 * 6
    elif kernel == "bigru_fused":
        assert gru_fullfused.LAUNCHES["bigru_fused"] == 16 * 6


def _rl_train_batch(rng, B, T, R):
    x = np.zeros((B, T, R, 5), np.int8)
    x[..., 0] = rng.integers(0, 6, (B, T, R))
    x[..., 1] = rng.integers(-1, 40, (B, T, R))
    x[..., 2] = rng.choice([-1, 1], (B, T, R))
    x[..., 4] = rng.integers(0, 12, (B, T, R))
    x[0, :, R // 2:] = 0                          # empty read rows
    lengths = rng.integers(T // 2, T + 1, B).astype(np.int32)
    lengths[0] = T
    mask = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)
    return {"features": torch.from_numpy(x),
            "labels": torch.from_numpy(rng.integers(0, 5, (B, T)).astype(
                np.int32)),
            "mask": torch.from_numpy(mask),
            "lengths": torch.from_numpy(lengths)}


def _cosine(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return (a @ b / (a.norm() * b.norm()).clamp(min=1e-300)).item()


def test_read_level_train_step_kernels_match_plain(device):
    """One bf16 training step of LatentSpaceLSTM (lstm_size 128, dwells,
    2 bidirectional layers) through the kernels on the card: 4 launches of
    each LSTM kernel. Against the same step through their plain versions
    on the card: loss within 1e-5 relative, the LSTM stack's and the
    head's gradients within 1e-2 of each leaf's largest magnitude. Below
    the stack the gradient flows in bf16 (dxp is cast to the projections'
    bf16): the kernels' f32 sums in another order move some of those
    roundings by one step, and the sums over every read and position that
    make the conv, batch-norm and embedding gradients cancel, so a small
    leaf can differ by a few percent of its largest element (2% measured
    on an H100): each of those leaves must point the same way (cosine
    >= 0.999). Against the CPU's plain route (fused=True), whose
    convolutions round in bf16 at other points: loss within 1e-3
    relative, the stack's and the head's gradients within 5e-2."""
    from medaka_tpu_torch import parallel
    from medaka_tpu_torch.models.latent_space_lstm import LatentSpaceLSTM
    rng = np.random.default_rng(5)
    torch.manual_seed(0)
    model = LatentSpaceLSTM(lstm_size=128, use_dwells=True)
    batch = _rl_train_batch(rng, 8, 200, 12)

    def step(dev, **kw):
        model.to(dev)
        model.zero_grad()
        stats = []
        with parallel.deterministic_convolutions():
            loss, _ = parallel.cross_entropy_loss(
                lambda *a, **k: model(*a, **kw, **k),
                {k: v.to(dev) for k, v in batch.items()},
                compute_dtype=torch.bfloat16, training=True, bn_stats=stats)
            loss.backward()
        assert len(stats) == 2
        return loss.item(), {n: p.grad.cpu().clone()
                             for n, p in model.named_parameters()}

    lstm_train.reset_launches()
    loss_k, grads_k = step(device)
    assert lstm_train.LAUNCHES == {"lstm_fwd": 4, "lstm_bwd": 4}
    lstm_train.reset_launches()
    from unittest import mock
    with mock.patch.object(lstm_train, "lstm_fwd", lstm_train.lstm_fwd_plain), \
            mock.patch.object(lstm_train, "lstm_bwd",
                              lstm_train.lstm_bwd_plain):
        loss_p, grads_p = step(device)
    assert lstm_train.LAUNCHES == {"lstm_fwd": 0, "lstm_bwd": 0}
    loss_c, grads_c = step("cpu", fused=True)
    model.to("cpu")
    print("loss kernels", loss_k, "plain", loss_p, "cpu", loss_c)
    assert abs(loss_k - loss_p) <= 1e-5 * abs(loss_p)
    assert abs(loss_k - loss_c) <= 1e-3 * abs(loss_c)
    for name, gp in grads_p.items():
        gk = grads_k[name]
        rel = ((gk - gp).abs().max() / gp.abs().max()).item()
        cos = _cosine(gk, gp)
        print(name, "vs plain on the card: relative max", rel, "cosine", cos)
        if name.startswith(("lstm.", "linear.")):
            assert rel <= 1e-2
            gc = grads_c[name]
            rel_c = ((gk - gc).abs().max() / gc.abs().max()).item()
            print(name, "relative max vs the CPU", rel_c)
            assert rel_c <= 5e-2
        else:
            assert cos >= 0.999


def _fullfused_inputs(rng, H, B, T, IN, device):
    """Layer input, stacked weights as torch initialises them and ragged
    lengths (the first full, one 0: a padded row)."""
    k = 1.0 / np.sqrt(H)

    def uniform(lo, hi, shape):
        return torch.from_numpy(rng.uniform(lo, hi, shape).astype(
            np.float32)).to(device)

    lengths = torch.from_numpy(rng.integers(1, T + 1, B).astype(np.int32))
    lengths[0] = T
    if B > 2:
        lengths[1] = 0
    return (uniform(-1, 1, (T, B, IN)).to(torch.bfloat16),
            uniform(-k, k, (2, 3 * H, IN)), uniform(-k, k, (2, 3 * H)),
            uniform(-k, k, (2, 3 * H, H)), uniform(-k, k, (2, 3 * H)),
            lengths.to(device))


def _bf16_ulp(v):
    """One bf16 step at the magnitude of v's largest element."""
    return 2.0 ** (np.floor(np.log2(v.abs().max().item())) - 7)


@pytest.mark.parametrize("layer_in", ["features", "layer"])
@pytest.mark.parametrize("mode", ["f32_gates", "bf16_gates", "int8", "fused"])
@pytest.mark.parametrize("H,B,T", [(256, 16, 300), (96, 31, 200),
                                   (256, 1, 100), (64, 37, 60),
                                   (384, 16, 40), (512, 1, 30),
                                   (512, 128, 20), (160, 5, 50)])
def test_fullfused_kernels_match_plain(device, H, B, T, mode, layer_in):
    """Each fullfused mode and ``bigru_fused`` against its plain version,
    ragged lengths, layer 1 (10 features) and layer 2 (2H) inputs.

    The bf16-gates mode's projection stage sums in the plain version's
    order, so it agrees bit for bit, and its plain version is
    ``bigru_fullfused_plain``; the f32-gates and int8 modes project on the
    tensor cores (within one bf16 step of ``project_plain``, checked in
    ``test_fullfused_projection_stage_matches_plain``), so their
    recurrence is held against ``recurrence_plain`` over the stage's own
    projections. The recurrent product's f32 sums run in another order
    (cuBLAS), which can move one bf16 rounding of h: f32-gates outputs
    within 2^-8 (mean 1e-3); int8 sums are exact, so int8 outputs too;
    bf16 gates within one bf16 step of the output's largest magnitude. A
    second launch repeats the first bit for bit. Every launch runs the
    cluster recurrence, whose chooser takes clusters of 1 (H=64), 2 (96),
    4 (160 with 32 zero units, 256) and 8 (384, 512) blocks in f32, of
    2-16 blocks in int8 and of 4-16 blocks in bf16 gates (the f64 product
    on the FP64 tensor cores, its W slice in f64 up to H=256 and in bf16
    above), with B=1-128 on 8-, 16- and 32-column tiles.
    """
    rng = np.random.default_rng(H + B + T)
    IN = 10 if layer_in == "features" else 2 * H
    x, w_ih, b_ih, w_hh, b_hh, lengths = _fullfused_inputs(
        rng, H, B, T, IN, device)
    gru_fullfused.reset_launches()
    if mode == "fused":
        xp = gru_fullfused.project_plain(x, w_ih, b_ih)

        def kernel():
            return torch.cat(gru_fullfused.bigru_pallas(
                xp[0], xp[1], w_hh, b_hh, lengths), -1)
        want = gru_fullfused.recurrence_plain(xp[0], xp[1], w_hh, b_hh,
                                              lengths)
        key = "bigru_fused"
    else:
        def kernel():
            return gru_fullfused.fullfused_layer(x, w_ih, b_ih, w_hh, b_hh,
                                                 lengths, mode)
        if mode == "bf16_gates":
            want = gru_fullfused.bigru_fullfused_plain(
                x, w_ih, b_ih, w_hh, b_hh, lengths, mode)
        else:
            xp = gru_fullfused.project(x, w_ih, b_ih)
            want = gru_fullfused.recurrence_plain(xp[0], xp[1], w_hh, b_hh,
                                                  lengths, mode)
        key = "bigru_fullfused_int8" if mode == "int8" else "bigru_fullfused"
    got, again = kernel(), kernel()
    torch.cuda.synchronize()
    assert gru_fullfused.LAUNCHES[key] == 2
    assert got.shape == (T, B, 2 * H) and got.dtype == torch.bfloat16
    assert torch.equal(got, again)
    diff = (got.float() - want.float()).abs()
    print(mode, layer_in, "H", H, "B", B, "max", diff.max().item(), "mean",
          diff.mean().item())
    bar = _bf16_ulp(want.float()) if mode == "bf16_gates" else 2.0 ** -8
    assert diff.max().item() <= bar
    assert diff.mean().item() <= 1e-3
    # padded steps of the backward direction and padded rows hold 0
    t_pad = torch.arange(T, device=device)[:, None] >= lengths[None, :]
    assert (got[..., H:].float().abs().sum(-1)[t_pad] == 0).all()


def _within_one_bf16_step(got, want):
    """(largest difference, share of elements that differ, the bar): the
    bar is one bf16 step at the magnitude of ``want``'s largest element,
    as ``_bf16_ulp`` sets it for the bf16-gates outputs."""
    diff = (got.float() - want.float()).abs()
    return (diff.max().item(), (diff > 0).float().mean().item(),
            _bf16_ulp(want.float()))


@pytest.mark.parametrize("H,B,T,IN", [(64, 8, 1, 512), (256, 16, 200, 512),
                                      (256, 31, 100, 10), (96, 1, 50, 192),
                                      (256, 16, 200, 120)])
def test_fullfused_projection_stage_matches_plain(device, H, B, T, IN):
    """The tensor-core projection stage of the f32-gates and int8 modes
    (``project``, the stage ``fullfused_layer`` runs) within one bf16 step
    of ``project_plain``: its f32 sums run in the tensor cores' order, so
    an element can round to the neighbouring bf16 value (a share of about
    1e-4 of them on an H100); fewer than 1% of the elements may differ at
    all. The bf16-gates mode's stage sums in the plain version's order: a
    one-step layer with zero recurrent weights (h = (1 - z) n with n, z
    from the projections only) is bit for bit the plain version's, and so
    is the f32-gates one over ``project``'s projections."""
    rng = np.random.default_rng(H + IN)
    x, w_ih, b_ih, _, _, lengths = _fullfused_inputs(rng, H, B, T, IN,
                                                     device)
    gru_fullfused.reset_launches()
    got = gru_fullfused.project(x, w_ih, b_ih)
    want = gru_fullfused.project_plain(x, w_ih, b_ih)
    torch.cuda.synchronize()
    assert gru_fullfused.LAUNCHES["bigru_project"] == 1
    assert got.shape == (2, T, B, 3 * H) and got.dtype == torch.bfloat16
    err, share, bar = _within_one_bf16_step(got, want)
    print("projection H", H, "IN", IN, "max", err, "bar", bar,
          "share differing", share)
    assert err <= bar and share < 1e-2
    zeros = torch.zeros((2, 3 * H, H), device=device)
    one = x[:1].contiguous()
    for mode in ("bf16_gates", "f32_gates"):
        kernel = gru_fullfused.fullfused_layer(one, w_ih, b_ih, zeros,
                                               zeros[..., 0], lengths, mode)
        if mode == "bf16_gates":
            plain = gru_fullfused.bigru_fullfused_plain(
                one, w_ih, b_ih, zeros, zeros[..., 0], lengths, mode)
        else:
            xp = gru_fullfused.project(one, w_ih, b_ih)
            plain = gru_fullfused.recurrence_plain(
                xp[0], xp[1], zeros, zeros[..., 0], lengths, mode)
        torch.cuda.synchronize()
        assert torch.equal(kernel, plain), mode


@pytest.mark.parametrize("H", [96, 256, 384, 512])
@pytest.mark.parametrize("B", [1, 16, 31])
def test_int8_fullfused_matches_plain(device, H, B):
    """``bigru_fullfused_int8`` (the int8 cluster recurrence: clusters of
    4, 8, 16 and 16 blocks at these H) at B=1, 16 and 31 with a padded row,
    layer 1 and layer 2 inputs: within 2^-8 of its plain version over the
    stage's projections, bit for bit on repeat; its recurrence launched
    alone over the same projections gives the same bits. (Its distance to
    ``bigru_fullfused_plain``, whose projection sums in another order, is
    printed: a projection one bf16 step away can move round(127 h).)"""
    rng = np.random.default_rng(H * 100 + B)
    T = 100
    for IN in (10, 2 * H):
        x, w_ih, b_ih, w_hh, b_hh, lengths = _fullfused_inputs(
            rng, H, B, T, IN, device)
        gru_fullfused.reset_launches()
        got = gru_fullfused.fullfused_layer(x, w_ih, b_ih, w_hh, b_hh,
                                            lengths, "int8")
        again = gru_fullfused.fullfused_layer(x, w_ih, b_ih, w_hh, b_hh,
                                              lengths, "int8")
        xp = gru_fullfused.project(x, w_ih, b_ih)
        alone = gru_fullfused.int8_recurrence(xp[0], xp[1], w_hh, b_hh,
                                              lengths)
        want = gru_fullfused.recurrence_plain(xp[0], xp[1], w_hh, b_hh,
                                              lengths, "int8")
        whole = gru_fullfused.bigru_fullfused_plain(
            x, w_ih, b_ih, w_hh, b_hh, lengths, "int8")
        torch.cuda.synchronize()
        assert gru_fullfused.MODE_LAUNCHES["bigru_fullfused_int8/int8"] == 2
        assert gru_fullfused.LAUNCHES["bigru_int8_recurrence"] == 1
        assert torch.equal(got, again) and torch.equal(got, alone)
        diff = (got.float() - want.float()).abs()
        print("int8 H", H, "B", B, "IN", IN, "max", diff.max().item(),
              "vs the whole plain layer",
              (got.float() - whole.float()).abs().max().item())
        assert diff.max().item() <= 2.0 ** -8
        assert diff.mean().item() <= 1e-3
        t_pad = torch.arange(T, device=device)[:, None] >= lengths[None, :]
        assert (got[..., H:].float().abs().sum(-1)[t_pad] == 0).all()


@pytest.mark.parametrize("H", [64, 96, 160, 256, 384, 512])
@pytest.mark.parametrize("B", [1, 16, 31, 128])
def test_bf16_gates_cluster_recurrence_matches_plain(device, H, B):
    """The bf16-gates mode on the cluster recurrence (f64 sums on the FP64
    tensor cores) at layer 1 (10 inputs) and layer 2 (2H) inputs, ragged
    lengths with a padded row: bit for bit on a second launch, within one
    bf16 step of ``bigru_fullfused_plain`` (mean 1e-3; its f64 sums do not
    depend on their order, so the share of elements that differ is
    printed, expected 0), padded steps and rows 0, one launch counted
    under its mode; the shared memory that ``rnn_cluster`` reckons for the
    chosen geometry is the kernel's."""
    rng = np.random.default_rng(H * 1000 + B)
    T = 30
    C, BT, smem, resident = gru_fullfused.cluster_geometry(
        H, B, device, "bigru_fullfused", "bf16_gates")
    lib = gru_fullfused.build()
    assert lib.bigru_cluster_smem(gru_fullfused.NUMERICS["bf16_gates"], C,
                                  BT, H) == smem
    assert smem == rnn_cluster.smem_bytes(rnn_cluster.GRU_BF16G, "fwd", C,
                                          BT, H) <= cuda_build.SMEM_LIMIT
    assert 1 <= resident
    for IN in (10, 2 * H):
        x, w_ih, b_ih, w_hh, b_hh, lengths = _fullfused_inputs(
            rng, H, B, T, IN, device)
        gru_fullfused.reset_launches()
        got = gru_fullfused.fullfused_layer(x, w_ih, b_ih, w_hh, b_hh,
                                            lengths, "bf16_gates")
        assert gru_fullfused.MODE_LAUNCHES["bigru_fullfused/bf16_gates"] == 1
        assert gru_fullfused.LAUNCHES["bigru_project"] == 0
        again = gru_fullfused.fullfused_layer(x, w_ih, b_ih, w_hh, b_hh,
                                              lengths, "bf16_gates")
        want = gru_fullfused.bigru_fullfused_plain(
            x, w_ih, b_ih, w_hh, b_hh, lengths, "bf16_gates")
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        err, share, bar = _within_one_bf16_step(got, want)
        print("bf16 gates H", H, "B", B, "IN", IN, "C", C, "BT", BT, "max",
              err, "share differing", share)
        assert err <= bar
        assert (got.float() - want.float()).abs().mean().item() <= 1e-3
        t_pad = torch.arange(T, device=device)[:, None] >= lengths[None, :]
        assert (got[..., H:].float().abs().sum(-1)[t_pad] == 0).all()


def test_bf16_gates_geometry_that_cannot_fit_raises(device):
    """A bf16-gates launch on a geometry the cluster recurrence cannot run
    (64 units a block, above its 32) raises, naming the kernel; so does a
    chooser that finds no cluster the card can hold."""
    rng = np.random.default_rng(5)
    args = _fullfused_inputs(rng, 512, 4, 8, 10, device)
    with pytest.raises(RuntimeError, match="bigru_fullfused launch failed"):
        gru_fullfused._launch_fullfused(*args, "bf16_gates", cluster=(8, 8))
    with pytest.raises(RuntimeError, match="bigru_fullfused/bf16_gates"):
        rnn_cluster.choose_geometry(
            rnn_cluster.GRU_BF16G, "fwd", 256, 16, cuda_build.SMEM_LIMIT,
            lambda cluster, columns, smem: 0, directions=2,
            name="bigru_fullfused/bf16_gates")


def test_fullfused_wrapper_raises_on_bad_input(device):
    rng = np.random.default_rng(1)
    x, w_ih, b_ih, w_hh, b_hh, lengths = _fullfused_inputs(rng, 32, 4, 8, 10,
                                                           device)
    with pytest.raises(ValueError, match="expected torch.bfloat16"):
        gru_fullfused.fullfused_layer(x.float(), w_ih, b_ih, w_hh, b_hh,
                                      lengths)
    with pytest.raises(ValueError, match="expected shape"):
        gru_fullfused.fullfused_layer(x, w_ih[:, :, :5], b_ih, w_hh, b_hh,
                                      lengths)
    H = 544
    with pytest.raises(ValueError, match="outside 1..512"):
        gru_fullfused.fullfused_layer(
            x, torch.zeros((2, 3 * H, 10), device=device),
            torch.zeros((2, 3 * H), device=device),
            torch.zeros((2, 3 * H, H), device=device),
            torch.zeros((2, 3 * H), device=device), lengths)
    with pytest.raises(ValueError, match="outside 1..512"):
        gru_fullfused.bigru_pallas(
            torch.zeros((8, 4, 3 * H), dtype=torch.bfloat16, device=device),
            torch.zeros((8, 4, 3 * H), dtype=torch.bfloat16, device=device),
            torch.zeros((2, 3 * H, H), device=device),
            torch.zeros((2, 3 * H), device=device), lengths)


def test_fullfused_odd_hidden_matches_plain(device):
    """H=100 (not a multiple of 32): the kernels run on zero-padded units
    and agree with the unpadded plain version as at H=96 (the recurrence
    over the tensor-core stage's projections)."""
    rng = np.random.default_rng(3)
    args = _fullfused_inputs(rng, 100, 5, 60, 10, device)
    xp = gru_fullfused.project(*args[:3])
    for mode in ("f32_gates", "int8"):
        got = gru_fullfused.fullfused_layer(*args, mode)
        want = gru_fullfused.recurrence_plain(xp[0], xp[1], *args[3:], mode)
        torch.cuda.synchronize()
        assert got.shape == (60, 5, 200)
        assert (got.float() - want.float()).abs().max().item() <= 2.0 ** -8


@pytest.mark.parametrize("n_layers,hidden,bidirectional,quant,key", [
    (2, 256, True, None, "bigru_fullfused"),
    (3, 96, True, "int8", "bigru_fullfused_int8"),
    (1, 128, True, "bf16_gates", "bigru_fullfused"),
    (2, 64, False, None, None), (3, 256, False, None, None)])
def test_gru_model_off_split_on_card_matches_cpu_plain(
        device, n_layers, hidden, bidirectional, quant, key):
    """GRUModel.forward on the card at B=16 (off the split path) against
    the same kernels' plain route on the CPU (``bigru_stack_fullfused`` /
    ``bigru_stack_fused`` with device="cpu" and the f32 head):
    probabilities within 1e-2 (the card's and the CPU's sums of the
    recurrent product run in other orders), argmax agreement >= 0.99; the
    card launches the fullfused kernel once a layer (``gru_fwd`` for the
    unidirectional stack) and no split kernel."""
    rng = np.random.default_rng(n_layers + hidden)
    torch.manual_seed(n_layers)
    model = GRUModel(gru_size=hidden, n_layers=n_layers,
                     bidirectional=bidirectional)
    B, T = 16, 200
    x = torch.from_numpy(rng.random((B, T, 10)).astype(np.float32))
    lengths = torch.from_numpy(rng.integers(1, T + 1, B).astype(np.int32))
    with torch.inference_mode():
        if bidirectional:
            feats = gru_fullfused.bigru_stack_fullfused(
                model.layer_params(), x, lengths, recurrent_quant=quant,
                device="cpu")
        else:
            feats = gru_fullfused.bigru_stack_fused(
                model.layer_params(), x, bidirectional=False,
                lengths=lengths, device="cpu")
        want = torch.softmax(feats.float() @ model.linear.weight.t()
                             + model.linear.bias, -1)
        gru_fullfused.reset_launches()
        gru_split.reset_launches()
        gru_train.reset_launches()
        model.to(device)
        got = model(x.to(device), lengths=lengths.to(device),
                    compute_dtype=torch.bfloat16,
                    recurrent_quant=quant).cpu()
        model.to("cpu")
    if key is None:
        assert gru_train.LAUNCHES["gru_fwd"] == n_layers
        assert sum(gru_fullfused.LAUNCHES.values()) == 0
    else:
        assert gru_fullfused.LAUNCHES[key] == n_layers
    assert sum(gru_split.LAUNCHES.values()) == 0
    valid = torch.arange(T)[None, :] < lengths[:, None]
    diff = (got - want).abs()[valid]
    agree = (got.argmax(-1) == want.argmax(-1))[valid].float().mean().item()
    print(n_layers, hidden, quant, "max", diff.max().item(), "agreement",
          agree)
    assert diff.max().item() <= 1e-2
    assert agree >= 0.99


@pytest.mark.parametrize("mode", ["rows", "t"])
def test_reference_gru_model_split_on_card_matches_cpu_plain(device, mode):
    """The reference's 2x128 GRUModel on the split path (B=64; mode
    "rows" as the batch picks it, "t" through ``bigru_head_fullfused``)
    on the card against the same kernels' plain route on the CPU, the
    bars of the H=384 case below, and no fullfused launch."""
    rng = np.random.default_rng(128)
    torch.manual_seed(128)
    model = GRUModel(gru_size=128)
    B, T = 64, 300
    x = torch.from_numpy(rng.random((B, T, 10)).astype(np.float32))
    lengths = torch.from_numpy(rng.integers(1, T + 1, B).astype(np.int32))
    layout = None if mode == "rows" else "t"
    with torch.inference_mode():
        want = torch.softmax(gru_split.bigru_head_fullfused(
            model.layer_params(), model.head_params(), x, lengths,
            layout=layout, device="cpu"), -1)
        gru_fullfused.reset_launches()
        gru_split.reset_launches()
        model.to(device)
        if layout is None:
            got = model(x.to(device), lengths=lengths.to(device),
                        compute_dtype=torch.bfloat16).cpu()
        else:
            got = torch.softmax(gru_split.bigru_head_fullfused(
                model.layer_params(), model.head_params(), x.to(device),
                lengths.to(device), layout=layout, device=device), -1).cpu()
        model.to("cpu")
    assert sum(gru_split.LAUNCHES.values()) == 2
    assert sum(gru_fullfused.LAUNCHES.values()) == 0
    valid = torch.arange(T)[None, :] < lengths[:, None]
    diff = (got - want).abs()[valid]
    agree = (got.argmax(-1) == want.argmax(-1))[valid].float().mean().item()
    print("H=128", mode, "max", diff.max().item(), "agreement", agree)
    assert diff.max().item() <= 1e-2
    assert agree >= 0.99


@pytest.mark.parametrize("mode", ["rows", "t"])
def test_gru_model_split_on_card_matches_cpu_plain(device, mode):
    """GRUModel.forward at H=384 on the split path (B=64, int8; mode
    "rows" as the batch picks it, and "t" through ``bigru_head_fullfused``
    with layout "t") on the card against the same kernels' plain route on
    the CPU: probabilities within 1e-2, argmax agreement >= 0.99; the card
    launches each split kernel once and no fullfused kernel. The parent
    of this design refused H=384 on the card (W_hh larger than a block's
    shared memory)."""
    rng = np.random.default_rng(384)
    torch.manual_seed(384)
    model = GRUModel(gru_size=384)
    B, T = 64, 200
    x = torch.from_numpy(rng.random((B, T, 10)).astype(np.float32))
    lengths = torch.from_numpy(rng.integers(1, T + 1, B).astype(np.int32))
    layout = None if mode == "rows" else "t"
    with torch.inference_mode():
        want = torch.softmax(gru_split.bigru_head_fullfused(
            model.layer_params(), model.head_params(), x, lengths,
            layout=layout, device="cpu"), -1)
        gru_fullfused.reset_launches()
        gru_split.reset_launches()
        model.to(device)
        if layout is None:
            got = model(x.to(device), lengths=lengths.to(device),
                        compute_dtype=torch.bfloat16).cpu()
        else:
            got = torch.softmax(gru_split.bigru_head_fullfused(
                model.layer_params(), model.head_params(), x.to(device),
                lengths.to(device), layout=layout, device=device), -1).cpu()
        model.to("cpu")
    assert gru_split.MODE_LAUNCHES == {
        "{}/{}".format(k, m): int(m == mode)
        for k in gru_split.LAUNCHES for m in gru_split.MODES}
    assert sum(gru_fullfused.LAUNCHES.values()) == 0
    valid = torch.arange(T)[None, :] < lengths[:, None]
    diff = (got - want).abs()[valid]
    agree = (got.argmax(-1) == want.argmax(-1))[valid].float().mean().item()
    print("H=384", mode, "max", diff.max().item(), "agreement", agree)
    assert diff.max().item() <= 1e-2
    assert agree >= 0.99


def test_predict_direct_on_card_matches_hdf5_route(device, tmp_path):
    """predict_direct on the card at batch 16 (the fullfused kernels, off
    the split path) writes the same FASTQ and gaps bed as inference +
    sequence on the card at batch 16, and both launch the fullfused
    kernel twice a batch and no split kernel."""
    from medaka_tpu_torch import cli, stitch
    bam, draft = testing.create_synth_bam(str(tmp_path / "r.bam"),
                                          ref_mb=0.05, depth=10,
                                          read_len=5000)
    hdf = str(tmp_path / "p.hdf")
    want = str(tmp_path / "hdf5.fastq")
    gru_fullfused.reset_launches()
    gru_split.reset_launches()
    assert cli.main(["inference", bam, hdf, "--model", MODEL, "--batch_size",
                     "16", "--chunk_len", "2000", "--chunk_ovlp", "200"]) == 0
    launches = gru_fullfused.LAUNCHES["bigru_fullfused"]
    assert launches >= 2 and launches % 2 == 0
    stitch.stitch_to_fasta(hdf, draft, want, qualities=True)
    got = str(tmp_path / "direct.fastq")
    prediction.predict_direct(bam, got, draft, model_path=MODEL,
                              batch_size=16, chunk_len=2000,
                              chunk_overlap=200, qualities=True)
    assert gru_fullfused.LAUNCHES["bigru_fullfused"] == 2 * launches
    assert sum(gru_split.LAUNCHES.values()) == 0
    for suffix in ("", ".gaps_in_draft_coords.bed"):
        with open(want + suffix, "rb") as a, open(got + suffix, "rb") as b:
            assert a.read() == b.read()


@pytest.mark.parametrize("batch", [64, 200])
def test_diploid_bundle_on_card_matches_plain(device, batch):
    """The diploid bundle (15 classes) through GRUModel on the split path
    (mode "rows" at B=64, "t" at B=200) against the split kernels' plain
    versions on the card, on the same inputs: probabilities within 1e-3
    and argmax agreement >= 0.9999 (chip_smoke.py's whole-network bars);
    each split kernel launches once."""
    bundle = models.load_model(models.resolve_model(
        "gru256_diploid_snp_demo"))
    model = bundle.model.to(device)
    assert model.num_classes == 15
    rng = np.random.default_rng(batch)
    T = 300
    x = torch.from_numpy(rng.random((batch, T, 10)).astype(np.float32)).to(
        device)
    lengths = torch.from_numpy(rng.integers(1, T + 1, batch).astype(
        np.int32)).to(device)
    mode = gru_split.split_mode(batch)
    with torch.inference_mode():
        gru_split.reset_launches()
        got = model(x, lengths=lengths, compute_dtype=torch.bfloat16)
        launches = dict(gru_split.LAUNCHES)
        w = gru_split.prepare_split_weights(
            model.layer_params(), model.head_params(), mode, True, device)
        xt = x.transpose(0, 1).to(torch.bfloat16).contiguous()
        out_f, out_b = gru_split.gru_l1_split_plain(
            xt, lengths, w["w_ih1"], w["b_ih1"], w["w_hh1"], w["sc1"],
            w["b_hh1"], mode=mode, quant=True)
        lg_f, lg_b = gru_split.gru_l2head_split_plain(
            out_f, out_b, lengths, w["w_in2"], w["in_scale2"], w["b_ih2"],
            w["w_hh2"], w["sc2"], w["b_hh2"], w["w_head"], mode=mode,
            quant=True)
        want = torch.softmax(lg_f + lg_b + w["b_head"], -1)
    model.to("cpu")
    assert launches == {"gru_l1_split": 1, "gru_l2head_split": 1}
    valid = (torch.arange(T, device=device)[None, :]
             < lengths[:, None].long())
    diff = (got - want).abs()[valid]
    agree = (got.argmax(-1) == want.argmax(-1))[valid].float().mean().item()
    print("diploid B={} mode {}".format(batch, mode), "max",
          diff.max().item(), "agreement", agree)
    assert got.shape == (batch, T, 15)
    assert diff.max().item() <= 1e-3
    assert agree >= 0.9999


def test_head_past_16_classes_raises(device):
    """More than 64 classes (four m16 tiles of W_head^T) raise before a
    launch."""
    H, T, B, C = 256, 4, 2, 65
    i8 = dict(dtype=torch.int8, device=device)
    with pytest.raises(ValueError, match="at most 64 classes, got 65"):
        gru_split.gru_l2head_split(
            torch.zeros((T, B, H), **i8), torch.zeros((T, B, H), **i8),
            torch.full((B,), T, dtype=torch.int32, device=device),
            torch.zeros((2, 3 * H, 2 * H), **i8),
            torch.ones((2, 2, 3 * H), device=device),
            torch.zeros((2, 3 * H), device=device),
            torch.zeros((2, 3 * H, H), **i8),
            torch.ones((2, 3 * H), device=device),
            torch.zeros((2, 3 * H), device=device),
            torch.zeros((2, C, H), dtype=torch.bfloat16, device=device))


def test_consensus_from_reads_on_card_matches_cpu(device, tmp_path):
    """``consensus`` from the FASTQ of a 20 kb ``create_synth_bam`` genome
    (depth 20, 2 kb reads) on the card, at the automatic batch (the int8
    split kernels), against ``consensus --cpu`` (the bf16 scan): the same
    mapped BAM; consensus sequences within 1 edit per 10,000 bases
    (``testing.greedy_edit_count``), the near-tie columns where the int8
    and bf16 routes round apart (ROADMAP.md queue 3 items 2-3); both split
    kernels launched."""
    from medaka_tpu_torch import cli
    from medaka_tpu_torch.io.fastx import FastaReader
    bam, draft = testing.create_synth_bam(str(tmp_path / "synth.bam"),
                                          ref_mb=0.02, depth=20, seed=3,
                                          read_len=2000)
    fastq = str(tmp_path / "reads.fastq")
    truth = testing.write_reads_fastq(bam, fastq)
    outputs = {}
    for name, extra in (("cuda", []), ("cpu", ["--cpu"])):
        outputs[name] = str(tmp_path / name)
        gru_split.reset_launches()
        assert cli.main(["consensus", fastq, draft, "-o", outputs[name],
                         "--model", "gru256_lambda_demo", "-t", "2"]
                        + extra) == 0
        launches = dict(gru_split.LAUNCHES)
        if name == "cuda":
            assert min(launches.values()) >= 1, launches
    with open(os.path.join(outputs["cuda"], "calls_to_draft.bam"),
              "rb") as a, open(os.path.join(outputs["cpu"],
                                            "calls_to_draft.bam"), "rb") as b:
        assert a.read() == b.read()
    mapped, wrong = testing.placement(
        os.path.join(outputs["cuda"], "calls_to_draft.bam"), truth)
    assert mapped == 1.0 and not wrong
    seqs = {}
    for name, out in outputs.items():
        with FastaReader(os.path.join(out, "consensus.fasta")) as fr:
            seqs[name] = fr.fetch("synth")
    edits = testing.greedy_edit_count(seqs["cuda"].encode(),
                                      seqs["cpu"].encode())
    print("card vs CPU consensus: {} edits over {} bases".format(
        edits, len(seqs["cpu"])))
    assert len(seqs["cuda"]) > 19000
    assert edits <= len(seqs["cpu"]) // 10000


# ---------------------------------------------------------------------------
# scale-out on one card: replicas and ranks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch", [480, 200, 40])
def test_two_replicas_match_one(device, batch):
    """Predictor over two replicas on cuda:0 (each on its own stream,
    half the rows each: mode "t", mode "rows" and the fullfused route at
    480, 200 and 40 rows) against one replica on the same card: bit for
    bit against the one replica fed each half (the same launches); at 480
    (mode "t" either way) within 1e-3 of the one replica over all 480
    rows with argmax agreement >= 0.9999 (the whole-network bars of
    chip_smoke.py); every replica launches its kernels (the split kernels
    once each, the fullfused kernel once a layer)."""
    rng = np.random.default_rng(batch)
    torch.manual_seed(batch)
    model = GRUModel(gru_size=256)
    T = 300
    feats = rng.random((batch, T, 10)).astype(np.float32)
    lengths = rng.integers(T // 2, T + 1, batch).astype(np.int32)
    half = batch // 2
    one = prediction.Predictor(model, device="cuda:0")
    halves = np.concatenate([one.fetch(one.dispatch(prediction.Batch(
        feats[rows], lengths[rows], [None] * half)), half)
        for rows in (slice(0, half), slice(half, batch))])
    two = prediction.Predictor(model, devices=["cuda:0", "cuda:0"])
    got = two.fetch(two.dispatch(prediction.Batch(
        feats, lengths, [None] * batch)), batch)
    np.testing.assert_array_equal(got, halves)
    # one launch of each split kernel, or one fullfused launch a layer
    kernels = {"gru_l1_split": 1, "gru_l2head_split": 1} if half >= 32 \
        else {"bigru_fullfused": 2}
    for launches in two.launches:
        assert all(launches[k] == n for k, n in kernels.items()), launches
    if batch == 480:
        want = one.fetch(one.dispatch(prediction.Batch(
            feats, lengths, [None] * batch)), batch)
        valid = np.arange(T)[None, :] < lengths[:, None]
        assert np.abs(got - want)[valid].max() <= 1e-3
        assert (got.argmax(-1) == want.argmax(-1))[valid].mean() >= 0.9999


def test_two_ranks_on_one_card_match_one_rank(device, tmp_path):
    """run_training over two gloo ranks on cuda:0 against one rank (nccl)
    on the same features: in f32 (the scan under autograd) every
    training.csv row within 1e-5 relative; in bf16 (gru_fwd/gru_bwd)
    each rank launches 4 of each kernel a step and the losses are finite
    and within 1e-2 relative of the one rank's."""
    from medaka_tpu_torch import training
    bam, ref = testing.create_synth_bam(
        str(tmp_path / "reads.bam"), ref_mb=0.006, depth=8, read_len=1500,
        seed=4)
    truth = testing.create_truth_bam(
        str(tmp_path / "truth.bam"), ref, substitutions={"synth": {}},
        draft_fasta=str(tmp_path / "draft.fasta"))
    hdf = str(tmp_path / "feats.hdf")
    features.create_samples(bam, hdf, truth_bam=truth, chunk_len=100,
                            chunk_ovlp=0)
    run = dict(model_dict={"type": "GRUModel", "kwargs": {
        "num_features": 10, "num_classes": 5, "gru_size": 128}},
        optimizer="nadam", optim_args={"learning_rate": 5e-3}, seed=3,
        epochs=1, use_lr_schedule=False)

    def batcher():
        return training.TrainBatcher([hdf], validation=0.25, seed=3,
                                     batch_size=8, max_samples=24)

    def losses(path):
        with open(os.path.join(path, "training.csv")) as fh:
            return [float(line.split(",")[3]) for line in fh.readlines()[1:]]

    for dtype, bar in ((None, 1e-5), (torch.bfloat16, 1e-2)):
        one, two = str(tmp_path / "one{}".format(dtype)), \
            str(tmp_path / "two{}".format(dtype))
        training.run_training(one, batcher(), compute_dtype=dtype,
                              devices=["cuda:0"], **run)
        training.run_training(two, batcher(), compute_dtype=dtype,
                              devices=["cuda:0", "cuda:0"], **run)
        a, b = losses(two), losses(one)
        assert len(a) == len(b) and all(np.isfinite(a))
        for x, y in zip(a, b):
            assert abs(x - y) <= bar * abs(y), (x, y)
        if dtype is not None:
            steps = batcher().n_batches("train")
            for rank in range(2):
                with open(os.path.join(two, "rank{}.json".format(
                        rank))) as fh:
                    report = json.load(fh)
                assert report["backend"] == "gloo"
                assert report["launches"]["gru_fwd"] == 4 * steps
                assert report["launches"]["gru_bwd"] == 4 * steps
