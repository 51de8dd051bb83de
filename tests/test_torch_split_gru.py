"""The port's split-path GRU (plain versions) against the JAX kernels.

``medaka_tpu_torch.ops.gru_split`` runs the split-path kernels' plain
PyTorch versions on the CPU; they are held against
``medaka_tpu.ops.pallas_gru.bigru_head_fullfused`` in Pallas interpret
mode on the same inputs and weights, for both numerics modes and both
quantisation settings.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medaka_tpu.ops import pallas_gru
from medaka_tpu_torch.ops import cuda_build, gru_split
from tests.torch_threads import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, T, IN, H, C = 4, 32, 10, 16, 5
LENGTHS = np.array([32, 20, 7, 1], np.int32)


#: the run-length bundle's layer-1 inputs (10 x num_qstrat 12) and classes
RLE_IN, RLE_CLASSES = 120, 49


def _direction(rng, in_size, hidden=H):
    k = 1.0 / np.sqrt(hidden)
    return {name: rng.uniform(-k, k, shape).astype(np.float32)
            for name, shape in (("w_ih", (3 * hidden, in_size)),
                                ("w_hh", (3 * hidden, hidden)),
                                ("b_ih", (3 * hidden,)),
                                ("b_hh", (3 * hidden,)))}


def _make_net(classes, inputs=IN, hidden=H):
    rng = np.random.default_rng(0)
    layers = [{"fwd": _direction(rng, inputs, hidden),
               "bwd": _direction(rng, inputs, hidden)},
              {"fwd": _direction(rng, 2 * hidden, hidden),
               "bwd": _direction(rng, 2 * hidden, hidden)}]
    head = {"w": rng.uniform(-0.2, 0.2, (classes, 2 * hidden)).astype(
                np.float32),
            "b": rng.uniform(-0.2, 0.2, (classes,)).astype(np.float32)}
    x = rng.random((B, T, inputs)).astype(np.float32)
    return layers, head, x


@pytest.fixture(scope="module")
def net():
    return _make_net(C)


def _jax_logits(net, layout, quant):
    layers, head, x = net
    return np.asarray(pallas_gru.bigru_head_fullfused(
        jax.tree.map(jnp.asarray, layers), jax.tree.map(jnp.asarray, head),
        jnp.asarray(x), lengths=jnp.asarray(LENGTHS), quant=quant,
        interpret=True, layout=layout))


def _valid():
    return np.arange(T)[None, :] < LENGTHS[:, None]


@pytest.mark.parametrize("classes,hidden", [(C, H), (15, H), (C, 128)],
                         ids=["5", "15", "5-H128"])
@pytest.mark.parametrize("quant", [True, False])
@pytest.mark.parametrize("layout", ["transposed", "rows"])
def test_plain_matches_jax_interpret(layout, quant, classes, hidden):
    """Logits agree within 5e-3 on valid columns (test_layouts_agree's bar),
    with the haploid head's 5 classes and the diploid head's 15, and at
    the reference GRUModel's width (H=128, 5 classes).

    Measured max |logit diff| at 5 classes: 2.6e-3 for "transposed" +
    int8, where the bf16 tanh-form gates round XLA's and PyTorch's tanh to
    bf16 and a last-bit difference can flip a rounding; <= 6e-8 for the
    other three (f32 accumulation order only).
    """
    _check_against_jax(_make_net(classes, hidden=hidden), layout, quant,
                       classes)


@pytest.mark.parametrize("quant", [True, False])
@pytest.mark.parametrize("layout", ["transposed", "rows"])
def test_plain_matches_jax_interpret_at_rle_shapes(layout, quant):
    """The same bar at the run-length bundle's shapes: layer 1 over 120
    input features and a 49-class head (four m16 tiles of W_head^T in
    the int8 layer-2 kernel, W_head read through L1 in the bf16 one)."""
    _check_against_jax(_make_net(RLE_CLASSES, RLE_IN), layout, quant,
                       RLE_CLASSES)


def _check_against_jax(net, layout, quant, classes):
    layers, head, x = net
    ref = _jax_logits(net, layout, quant)
    before = dict(gru_split.LAUNCHES), dict(gru_split.MODE_LAUNCHES)
    got = gru_split.bigru_head_fullfused(
        layers, head, torch.from_numpy(x), lengths=torch.from_numpy(LENGTHS),
        quant=quant, layout=layout, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (B, T, classes)
    # CPU tensors never launch
    assert (gru_split.LAUNCHES, gru_split.MODE_LAUNCHES) == before
    assert np.abs(got.numpy() - ref)[_valid()].max() <= 5e-3


def test_layer1_rows_int8_outputs_match_exactly(net):
    """Row-major layer 1 emits the same int8 round(127 h) as JAX."""
    _check_layer1_rows(net)


def test_layer1_rows_int8_outputs_match_exactly_at_120_inputs():
    """The same over the run-length bundle's 120 input features."""
    _check_layer1_rows(_make_net(RLE_CLASSES, RLE_IN))


def _check_layer1_rows(net):
    layers, head, x = net
    xt = jnp.swapaxes(jnp.asarray(x), 0, 1).astype(jnp.bfloat16)
    st = lambda k: jnp.stack(  # noqa: E731
        [jnp.asarray(layers[0]["fwd"][k]), jnp.asarray(layers[0]["bwd"][k])])
    ref_f, ref_b = pallas_gru.bigru_l1_split(
        xt, st("w_ih"), st("b_ih"), st("w_hh"), st("b_hh"),
        lengths=jnp.asarray(LENGTHS), quant=True, interpret=True)
    w = gru_split.prepare_split_weights(layers, head, "rows", True, "cpu")
    out_f, out_b = gru_split.gru_l1_split(
        torch.from_numpy(x).transpose(0, 1).to(torch.bfloat16).contiguous(),
        torch.from_numpy(LENGTHS), w["w_ih1"], w["b_ih1"], w["w_hh1"],
        w["sc1"], w["b_hh1"], mode="rows", quant=True)
    assert out_f.dtype == torch.int8
    np.testing.assert_array_equal(out_f.numpy(), np.asarray(ref_f))
    np.testing.assert_array_equal(out_b.numpy(), np.asarray(ref_b))


def _half_even_weights():
    """Rows whose max is 127, so w/scale = w and .5 cases hit rounding."""
    w = np.random.default_rng(1).uniform(-100, 100, (2, 6, 8))
    w = w.astype(np.float32)
    w[:, :, 0] = 127.0
    w[0, 0, 1:8] = [0.5, 1.5, 2.5, -0.5, -2.5, 3.5, -3.5]
    w[1, 2, 1:4] = [126.5, -125.5, 4.5]
    return w


@pytest.mark.parametrize("name", ["_quantize_rows", "_quantize_cols"])
def test_quantize_helpers_bit_identical(name):
    w = _half_even_weights()
    if name == "_quantize_cols":
        w = np.swapaxes(w, -1, -2).copy()
    q_ref, s_ref = getattr(pallas_gru, name)(jnp.asarray(w))
    q, s = getattr(gru_split, name)(torch.from_numpy(w))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    # half-to-even, as jnp.round: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2, -2.5 -> -2
    flat = q.numpy().reshape(-1)
    assert 0 in flat and -2 in flat


@pytest.mark.parametrize("batch,expected", [
    (4, (1, 1)), (64, (1, 1)), (132, (2, 1)), (256, (2, 2)),
    (512, (4, 2)), (2048, (4, 2))])
def test_tile_shape_fills_one_wave(batch, expected):
    assert cuda_build.tile_shape(batch, 132) == expected


@pytest.mark.parametrize("batch,mode", [(191, "rows"), (192, "t")])
def test_mode_follows_jax_crossover(batch, mode):
    assert gru_split.split_mode(batch) == mode
    assert gru_split.split_mode(batch, "rows") == "rows"
    assert gru_split.split_mode(batch, "transposed") == "t"


def test_cuda_request_without_gpu_raises(net):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    layers, head, x = net
    with pytest.raises(RuntimeError, match="no GPU"):
        gru_split.bigru_head_fullfused(layers, head, torch.from_numpy(x))


def test_kernel_module_imports_without_nvcc_or_jax():
    """Importing the port never compiles a kernel and never needs JAX."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import medaka_tpu_torch.ops.gru_split as g\n"
        "import medaka_tpu_torch.cli, medaka_tpu_torch.prediction\n"
        "import medaka_tpu_torch.models, medaka_tpu_torch.stitch\n"
        "import medaka_tpu_torch.vcf, medaka_tpu_torch.variant\n"
        "import medaka_tpu_torch.options, medaka_tpu_torch.labels\n"
        "import medaka_tpu_torch.testing, medaka_tpu_torch.rle\n"
        "from medaka_tpu_torch.ops import cuda_build\n"
        "assert not cuda_build._LIBS\n"
        "bad = [m for m in sys.modules if m == 'medaka_tpu' or "
        "m.startswith('medaka_tpu.')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PATH="/usr/bin:/bin", NVCC="")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   env=env)
