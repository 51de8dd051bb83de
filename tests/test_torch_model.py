"""The port's masked scan, GRUModel and bundle IO against the JAX package."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medaka_tpu import models as jax_models
from medaka_tpu.ops import rnn as jax_rnn
from medaka_tpu_torch import models
from medaka_tpu_torch.models import latent_space_lstm
from medaka_tpu.ops import pallas_gru
from medaka_tpu_torch.models.gru import GRUModel, fused_route, \
    params_from_jax, params_to_jax, takes_split_path
from medaka_tpu_torch.models.latent_space_lstm import LatentSpaceLSTM
from medaka_tpu_torch.ops import rnn
from tests.torch_threads import one_thread  # noqa: F401

DATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "medaka_tpu", "data")
LAMBDA = os.path.join(DATA, "gru256_lambda_demo_model_pt.tar.gz")


def _layer(rng, in_size, hidden):
    k = 1.0 / np.sqrt(hidden)
    return {name: rng.uniform(-k, k, shape).astype(np.float32)
            for name, shape in (("w_ih", (3 * hidden, in_size)),
                                ("w_hh", (3 * hidden, hidden)),
                                ("b_ih", (3 * hidden,)),
                                ("b_hh", (3 * hidden,)))}


def _inputs(rng, batch=4, steps=40, feats=10):
    x = rng.random((batch, steps, feats)).astype(np.float32)
    lengths = np.array([steps, 25, 3, steps - 1][:batch], np.int32)
    return x, lengths


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype,atol", [(None, 1e-5), ("bf16", 3e-2)])
def test_gru_scan_matches_jax(reverse, dtype, atol):
    """f32 within 1e-5; bf16 within 3e-2 (test_pallas_gru.py:59's bar)."""
    rng = np.random.default_rng(3)
    params = _layer(rng, 10, 32)
    x, lengths = _inputs(rng)
    ref = jax_rnn.gru_scan(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x), reverse=reverse,
        compute_dtype=jnp.bfloat16 if dtype else None,
        lengths=jnp.asarray(lengths))
    got = rnn.gru_scan(
        {k: torch.from_numpy(v) for k, v in params.items()},
        torch.from_numpy(x), reverse=reverse,
        compute_dtype=torch.bfloat16 if dtype else None,
        lengths=torch.from_numpy(lengths))
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(ref, np.float32), atol=atol)


def test_bigru_stack_matches_jax():
    rng = np.random.default_rng(4)
    layers = [{"fwd": _layer(rng, 10, 16), "bwd": _layer(rng, 10, 16)},
              {"fwd": _layer(rng, 32, 16), "bwd": _layer(rng, 32, 16)}]
    x, lengths = _inputs(rng)
    ref = jax_rnn.bigru_stack(
        jax.tree.map(jnp.asarray, layers), jnp.asarray(x),
        lengths=jnp.asarray(lengths))
    got = rnn.bigru_stack(
        jax.tree.map(torch.from_numpy, layers), torch.from_numpy(x),
        lengths=torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("name", [
    "gru256_lambda_demo_model_pt", "gru256_gcrep_demo_model_pt",
    "gru256_variant_demo", "gru256_diploid_snp_demo",
    "gru256_diploid_snp_w10_demo", "gru256_rle_demo"])
def test_counts_bundles_load(name):
    bundle = models.load_model(os.path.join(DATA, name + ".tar.gz"))
    ref = jax_models.load_model(os.path.join(DATA, name + ".tar.gz"))
    assert isinstance(bundle.model, GRUModel)
    assert bundle.model.to_dict() == ref.model.to_dict()
    assert bundle.feature_encoder.to_dict() == \
        ref.feature_encoder.to_dict()
    assert bundle.label_scheme.to_dict() == ref.label_scheme.to_dict()
    state = params_from_jax(ref.params)
    for key, value in bundle.model.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), state[key].numpy())


@pytest.mark.parametrize("name", [
    "rl_lstm128_lambda_demo", "rl_lstm128_dwells_demo"])
def test_read_level_bundles_load(name):
    bundle = models.load_model(os.path.join(DATA, name + ".tar.gz"))
    ref = jax_models.load_model(os.path.join(DATA, name + ".tar.gz"))
    assert isinstance(bundle.model, LatentSpaceLSTM)
    assert bundle.model.to_dict() == ref.model.to_dict()
    assert bundle.feature_encoder.to_dict() == \
        ref.feature_encoder.to_dict()
    assert bundle.label_scheme.to_dict() == ref.label_scheme.to_dict()
    state = latent_space_lstm.params_from_jax(ref.params)
    assert sorted(state) == sorted(bundle.model.state_dict())
    for key, value in bundle.model.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), state[key].numpy())


def test_saved_read_level_bundle_loads_in_jax_package(tmp_path):
    path = os.path.join(DATA, "rl_lstm128_dwells_demo.tar.gz")
    bundle, ref = models.load_model(path), jax_models.load_model(path)
    saved = str(tmp_path / "port_saved_rl.tar.gz")
    models.save_model(saved, bundle.model, bundle.feature_encoder,
                      bundle.label_scheme)
    back = jax_models.load_model(saved)
    assert back.model.to_dict() == ref.model.to_dict()
    assert back.feature_encoder.to_dict() == ref.feature_encoder.to_dict()
    assert jax.tree.structure(back.params) == jax.tree.structure(ref.params)
    for got, want in zip(jax.tree.leaves(back.params),
                         jax.tree.leaves(ref.params)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.fixture(scope="module")
def lambda_bundles():
    return models.load_model(LAMBDA), jax_models.load_model(LAMBDA)


def test_gru_model_matches_jax_apply_f32(lambda_bundles):
    """Probabilities of the lambda bundle (f32, CPU) within 1e-4."""
    bundle, ref = lambda_bundles
    rng = np.random.default_rng(5)
    x, lengths = _inputs(rng, batch=2, steps=64)
    want = np.asarray(ref.model.apply(
        ref.params, jnp.asarray(x), lengths=jnp.asarray(lengths)))
    with torch.inference_mode():
        got = bundle.model(torch.from_numpy(x),
                           lengths=torch.from_numpy(lengths)).numpy()
    valid = np.arange(64)[None, :] < lengths[:, None]
    assert np.abs(got - want)[valid].max() <= 1e-4


@pytest.mark.parametrize("quant,atol", [(None, 2e-2), ("none", 5e-3)])
def test_gru_model_fused_cpu_matches_jax_interpret(lambda_bundles, quant,
                                                   atol):
    """fused=True on the CPU runs the split kernels' plain versions.

    Held against JAX ``apply(fused=True, interpret=True)`` in the rows
    layout (B < 192) at the bundle's full width (H=256), within the
    repo's split-path bars (test_pallas_gru.py: 2e-2 int8, 5e-3 bf16).
    Measured 4.1e-3 (int8) and 2.4e-3 (bf16): where XLA's and PyTorch's
    sigmoid differ in the last bit, round(127 h) or the bf16 cast of h
    can land on the other side of a rounding boundary, after which the
    two recurrences drift by single int8 or bf16 steps.
    """
    bundle, ref = lambda_bundles
    rng = np.random.default_rng(6)
    x, lengths = _inputs(rng, batch=2, steps=48)
    want = np.asarray(ref.model.apply(
        ref.params, jnp.asarray(x), lengths=jnp.asarray(lengths),
        compute_dtype=jnp.bfloat16, fused=True, recurrent_quant=quant,
        interpret=True))
    with torch.inference_mode():
        got = bundle.model(
            torch.from_numpy(x), lengths=torch.from_numpy(lengths),
            compute_dtype=torch.bfloat16, fused=True,
            recurrent_quant=quant).numpy()
    valid = np.arange(48)[None, :] < lengths[:, None]
    assert np.abs(got - want)[valid].max() <= atol


def test_saved_bundle_loads_in_jax_package(lambda_bundles, tmp_path):
    bundle, ref = lambda_bundles
    path = str(tmp_path / "port_saved.tar.gz")
    models.save_model(path, bundle.model, bundle.feature_encoder,
                      bundle.label_scheme)
    back = jax_models.load_model(path)
    assert back.model.to_dict() == ref.model.to_dict()
    assert back.label_scheme.to_dict() == ref.label_scheme.to_dict()
    for got, want in zip(jax.tree.leaves(back.params),
                         jax.tree.leaves(ref.params)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    again = models.load_model(path)
    for key, value in again.model.state_dict().items():
        np.testing.assert_array_equal(
            value.numpy(), bundle.model.state_dict()[key].numpy())


def test_params_from_jax_round_trips(lambda_bundles):
    _, ref = lambda_bundles
    back = params_to_jax(params_from_jax(ref.params))
    assert jax.tree.structure(back) == jax.tree.structure(
        jax.tree.map(np.asarray, ref.params))
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(ref.params)):
        np.testing.assert_array_equal(got, np.asarray(want))


#: (n_layers, hidden, bidirectional, recurrent_quant, bar): configurations
#: off the split path; bars as tests/test_torch_fullfused.py
OFF_SPLIT = [(1, 32, True, None, 5e-3), (3, 32, True, "int8", 2e-2),
             (2, 96, True, "bf16_gates", 2e-2),
             (2, 32, True, "staggered", 5e-3), (2, 32, False, None, 5e-3)]


@pytest.mark.parametrize("n_layers,hidden,bidirectional,quant,atol",
                         OFF_SPLIT)
def test_fused_off_split_configurations_refused(n_layers, hidden,
                                                bidirectional, quant, atol):
    """Fused configurations off the split path, which the port refused
    until the fullfused kernels were ported, now run: on the CPU
    ``GRUModel.forward(fused=True)`` takes the fullfused (bidirectional) or
    fused (unidirectional) kernels' plain versions and the f32 head, held
    against JAX's ``bigru_stack_fullfused`` / ``bigru_stack_fused``
    (interpret=True) + the f32 einsum head + softmax on the same weights.
    Measured max |diff| of the probabilities: 4.2e-5 (int8), at most
    4.5e-8 for the others."""
    torch.manual_seed(n_layers + hidden)
    model = GRUModel(gru_size=hidden, n_layers=n_layers,
                     bidirectional=bidirectional)
    rng = np.random.default_rng(hidden)
    x, lengths = _inputs(rng, batch=3)
    params = jax.tree.map(jnp.asarray, params_to_jax(model.state_dict()))
    if bidirectional:
        feats = pallas_gru.bigru_stack_fullfused(
            params["gru"], jnp.asarray(x), lengths=jnp.asarray(lengths),
            interpret=True, recurrent_quant=quant)
    else:
        feats = pallas_gru.bigru_stack_fused(
            params["gru"], jnp.asarray(x), bidirectional=False,
            lengths=jnp.asarray(lengths), interpret=True)
    logits = jnp.einsum("bth,ch->btc", feats.astype(jnp.float32),
                        params["linear"]["w"]) + params["linear"]["b"]
    want = np.asarray(jax.nn.softmax(logits, -1))
    with torch.inference_mode():
        got = model(torch.from_numpy(x), lengths=torch.from_numpy(lengths),
                    compute_dtype=torch.bfloat16, fused=True,
                    recurrent_quant=quant).numpy()
    valid = np.arange(x.shape[1])[None, :] < lengths[:, None]
    assert np.abs(got - want)[valid].max() <= atol


@pytest.mark.parametrize("batch,hidden,on_cpu,split", [
    (16, 256, False, False),     # B < 32: JAX runs the fullfused kernels
    (64, 96, False, False),      # H % 128 != 0: the same
    (32, 256, False, True),      # the split path
    (512, 128, False, True),
    (16, 256, True, True),       # the CPU route is JAX's interpret=True
    (64, 96, True, True)])
def test_split_routing_follows_jax(batch, hidden, on_cpu, split):
    """The split kernels run where ``GRUModel.apply`` runs them
    (medaka_tpu/models/gru.py:162-169)."""
    assert takes_split_path(batch, hidden, on_cpu) is split


@pytest.mark.parametrize("batch,hidden,n_layers,bidirectional,quant,device,"
                         "route", [
                             (512, 256, 2, True, None, "cuda", "split"),
                             (32, 128, 2, True, "none", "cuda", "split"),
                             (16, 256, 2, True, None, "cuda", "fullfused"),
                             (31, 256, 2, True, "int8", "cuda", "fullfused"),
                             (64, 96, 2, True, None, "cuda", "fullfused"),
                             (512, 256, 3, True, None, "cuda", "fullfused"),
                             (512, 256, 1, True, "int8", "cuda", "fullfused"),
                             (512, 256, 2, True, "bf16_gates", "cuda",
                              "fullfused"),
                             (512, 256, 2, True, "staggered", "cpu",
                              "fullfused"),
                             (16, 256, 2, True, None, "cpu", "split"),
                             (16, 96, 2, True, "int8", "cpu", "split"),
                             (16, 96, 3, True, None, "cpu", "fullfused"),
                             (512, 256, 2, False, None, "cuda", "fused"),
                             (8, 64, 1, False, "int8", "cpu", "fused")])
def test_fused_route_follows_jax(batch, hidden, n_layers, bidirectional,
                                 quant, device, route):
    """Fused inference takes the kernels ``GRUModel.apply`` takes
    (medaka_tpu/models/gru.py:162-196): the split path for 2-layer
    bidirectional bf16 stacks with recurrent_quant None/"int8"/"none"
    (batch >= 32 and H % 128 == 0 on the card, any batch on the CPU), the
    fullfused stack for every other bidirectional stack, the fused stack
    for unidirectional ones."""
    assert fused_route(batch, hidden, n_layers, bidirectional, quant,
                       device) == route


def test_fused_route_refuses_unknown_quant():
    with pytest.raises(ValueError, match="recurrent_quant"):
        fused_route(16, 256, 2, True, "fp8", "cuda")


@pytest.mark.parametrize("quant,kernel,mode", [
    (None, "bigru_fullfused", "f32_gates"),
    ("none", "bigru_fullfused", "f32_gates"),
    ("int8", "bigru_fullfused_int8", "int8"),
    ("bf16_gates", "bigru_fullfused", "bf16_gates"),
    ("staggered", "bigru_fullfused", "f32_gates")])
def test_fused_small_batch_on_card_names_fullfused_kernels(
        monkeypatch, quant, kernel, mode):
    """Where JAX takes the fullfused branch (here B=2 < 32), the card
    route launches the fullfused kernel of the mode ``recurrent_quant``
    selects, once a layer, and no split kernel; the CPU route runs the
    split kernels' plain versions at any batch. The card is stood in for
    by CUDA-looking CPU tensors and a launch that records its call and
    runs the plain version."""
    from medaka_tpu_torch.ops import gru_fullfused, gru_split
    model = GRUModel(gru_size=32)
    x = torch.from_numpy(np.random.default_rng(1).random(
        (2, 6, 10)).astype(np.float32))
    with torch.inference_mode():
        cpu_probs = model(x, compute_dtype=torch.bfloat16, fused=True,
                          recurrent_quant=quant)
    calls = []

    def launch(x, w_ih, b_ih, w_hh, b_hh, lengths, mode):
        calls.append(mode)
        return gru_fullfused.bigru_fullfused_plain(x, w_ih, b_ih, w_hh,
                                                   b_hh, lengths, mode)

    def no_split(*args, **kwargs):
        raise AssertionError("the split kernels must not run")

    monkeypatch.setattr(gru_fullfused, "_launch_fullfused", launch)
    monkeypatch.setattr(gru_split, "_launch_l1", no_split)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    with torch.inference_mode():
        probs = model(x, compute_dtype=torch.bfloat16, fused=True,
                      recurrent_quant=quant)
    assert calls == [mode, mode]
    assert probs.shape == cpu_probs.shape == (2, 6, 5)
    assert kernel in gru_fullfused.LAUNCHES
