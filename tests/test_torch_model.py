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
from medaka_tpu_torch.models.gru import GRUModel, params_from_jax, \
    params_to_jax
from medaka_tpu_torch.ops import rnn

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
    "gru256_variant_demo"])
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


@pytest.mark.parametrize("name,missing", [
    ("gru256_diploid_snp_demo", "DiploidLabelScheme"),
    ("gru256_diploid_snp_w10_demo", "DiploidLabelScheme"),
    ("gru256_rle_demo", "HardRLEFeatureEncoder"),
    ("rl_lstm128_lambda_demo", "LatentSpaceLSTM"),
    ("rl_lstm128_dwells_demo", "LatentSpaceLSTM")])
def test_unported_bundles_name_the_missing_class(name, missing):
    with pytest.raises(NotImplementedError, match=missing):
        models.load_model(os.path.join(DATA, name + ".tar.gz"))


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


def test_fused_off_split_configurations_refused():
    model = GRUModel(gru_size=32, n_layers=3)
    with pytest.raises(NotImplementedError, match="not ported"):
        model(torch.zeros((1, 4, 10)), compute_dtype=torch.bfloat16,
              fused=True)
