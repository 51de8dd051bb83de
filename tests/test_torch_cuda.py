"""The split-path CUDA kernels against their plain versions, on the card.

Marked ``cuda``: skips without a GPU. The test imports no JAX, so it
runs on a machine that has PyTorch for CUDA but no JAX, past the JAX
setup of ``conftest.py``:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from medaka_tpu_torch.ops import cuda_build, gru_split

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    gru_split.build()
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
