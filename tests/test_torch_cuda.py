"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: skips without a GPU. The test imports no JAX, so it
runs on a machine that has PyTorch for CUDA but no JAX, past the JAX
setup of ``conftest.py``:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

import os

from medaka_tpu_torch import features, models, prediction, testing
from medaka_tpu_torch.common import Region
from medaka_tpu_torch.models.gru import GRUModel
from medaka_tpu_torch.ops import bilstm, cuda_build, gru_split, gru_train

pytestmark = pytest.mark.cuda

RL_MODEL = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "medaka_tpu", "data",
    "rl_lstm128_lambda_demo.tar.gz")


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gru_split.build()
    bilstm.build()
    gru_train.build()
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


@pytest.mark.parametrize("quant", [True, False])
@pytest.mark.parametrize("mode,batch", [("t", 512), ("t", 200),
                                        ("rows", 37)])
def test_kernels_match_plain(device, mode, batch, quant):
    """Both kernels against their plain versions at H=256, ragged lengths.

    Layer 1 is compared on its own inputs, layer 2 on layer 1's kernel
    outputs, so each kernel is held to the same inputs as its plain
    version. They do the same operations and differ only in the order of
    f32 sums, which could move round(127 h) or a bf16 cast across a
    rounding boundary: layer 1 within one int8 step or one bf16 ulp,
    logits within 1e-3. Measured on an H100: layer 1 identical, logits
    within 4e-8. The batch sizes cover the three tile shapes.
    """
    rng = np.random.default_rng(7)
    H, T = 256, 300
    layers, head = _net(rng, H)
    x = torch.from_numpy(rng.random((batch, T, 10)).astype(np.float32))
    lengths = torch.from_numpy(
        rng.integers(1, T + 1, batch).astype(np.int32))
    lengths[0] = T
    w = gru_split.prepare_split_weights(layers, head, mode, quant, device)
    xt = x.transpose(0, 1).to(torch.bfloat16).contiguous().to(device)
    lens = lengths.to(device)
    args1 = (xt, lens, w["w_ih1"], w["b_ih1"], w["w_hh1"], w["sc1"],
             w["b_hh1"])
    out_f, out_b = gru_split.gru_l1_split(*args1, mode=mode, quant=quant)
    ref_f, ref_b = gru_split.gru_l1_split_plain(*args1, mode=mode,
                                                quant=quant)
    torch.cuda.synchronize()
    for got, ref in ((out_f, ref_f), (out_b, ref_b)):
        diff = (got.float() - ref.float()).abs()
        print("layer 1", mode, quant, "max", diff.max().item(),
              "mean", diff.mean().item())
        assert diff.max().item() <= (1 if quant else 2.0 ** -7)
        assert diff.mean().item() <= 1e-3
    args2 = (out_f, out_b, lens, w["w_in2"], w["in_scale2"], w["b_ih2"],
             w["w_hh2"], w["sc2"], w["b_hh2"], w["w_head"])
    lg_f, lg_b = gru_split.gru_l2head_split(*args2, mode=mode, quant=quant)
    pf, pb = gru_split.gru_l2head_split_plain(*args2, mode=mode, quant=quant)
    torch.cuda.synchronize()
    valid = (torch.arange(T, device=device)[None, :]
             < lens[:, None].long())
    for got, ref in ((lg_f, pf), (lg_b, pb)):
        assert got.shape == (batch, T, 5)
        diff = (got - ref).abs()[valid]
        print("layer 2", mode, quant, "max", diff.max().item(),
              "mean", diff.mean().item())
        assert diff.max().item() <= 1e-3


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
                                   (128, 5, 64)])
def test_bilstm_matches_plain(device, H, B, T):
    """bilstm_fused against bilstm_fused_plain on random weights, ragged
    lengths, both directions. They do the same operations and differ only
    in the order of the f32 sums of the recurrent product, which can move
    the bf16 rounding of h by one step: outputs within one bf16 step
    (2^-8 for |h| < 1), mean difference within 1e-3."""
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
    want = bilstm.bilstm_fused_plain(xp_f, xp_b, w_hh, b_hh, lengths)
    torch.cuda.synchronize()
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
@pytest.mark.parametrize("H,B,T", [(256, 128, 200), (128, 37, 100),
                                   (64, 5, 64)])
def test_gru_train_kernels_match_plain(device, H, B, T, reverse):
    """gru_fwd and gru_bwd against their plain versions, ragged lengths.

    They do the same operations and differ only in the order of f32 sums
    (the recurrent products, dW_hh and db_hh), which can move a bf16
    rounding: forward outputs within one bf16 step (2^-8 for |h| < 1),
    mean within 1e-3; dxp, dW_hh and db_hh within 1e-3 of each tensor's
    largest magnitude. W_hh is read from L2 at H=256 and sits in shared
    memory below. A second backward repeats the first bit for bit.
    """
    rng = np.random.default_rng(H + B + int(reverse))
    xp, w_hh, b_hh, lengths, dh_out = _train_inputs(rng, H, B, T, device)
    out = gru_train.gru_fwd(xp, w_hh, b_hh, lengths, reverse)
    ref = gru_train.gru_fwd_plain(xp, w_hh, b_hh, lengths, reverse)
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    print("gru_fwd H", H, "B", B, "reverse", reverse, "max",
          diff.max().item(), "mean", diff.mean().item())
    assert out.shape == (T, B, H) and out.dtype == torch.bfloat16
    assert diff.max().item() <= 2.0 ** -8
    assert diff.mean().item() <= 1e-3
    got = gru_train.gru_bwd(xp, out, dh_out, w_hh, b_hh, lengths, reverse)
    want = gru_train.gru_bwd_plain(xp, out, dh_out, w_hh, b_hh, lengths,
                                   reverse)
    again = gru_train.gru_bwd(xp, out, dh_out, w_hh, b_hh, lengths, reverse)
    torch.cuda.synchronize()
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
