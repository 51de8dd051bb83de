"""The port's fullfused and fused bi-GRU (plain versions) against JAX.

``medaka_tpu_torch.ops.gru_fullfused`` runs the kernels' plain PyTorch
versions on the CPU; they are held against the JAX kernels of
``medaka_tpu.ops.pallas_gru`` in Pallas interpret mode on the same inputs
and weights (numpy, from a seed): ``bigru_pallas_fullfused`` (sequential,
staggered, ``gates_bf16``), ``bigru_pallas_fullfused_int8``,
``bigru_pallas``, ``bigru_stack_fused`` (both branches) and
``bigru_stack_fullfused`` for each ``recurrent_quant``, plus the bundled
``gru256_lambda_demo`` weights through the fullfused stack and the f32
head. Bars: 5e-3 for the f32-gates modes, 2e-2 for int8 and bf16 gates
(the repo's split-path bars, tests/test_pallas_gru.py).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medaka_tpu import models as jax_models
from medaka_tpu.ops import pallas_gru
from medaka_tpu_torch import models
from medaka_tpu_torch.ops import gru_fullfused
from tests.torch_threads import one_thread  # noqa: F401

LAMBDA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "medaka_tpu", "data",
    "gru256_lambda_demo_model_pt.tar.gz")
T = 40


def _direction(rng, in_size, hidden):
    k = 1.0 / np.sqrt(hidden)
    return {name: rng.uniform(-k, k, shape).astype(np.float32)
            for name, shape in (("w_ih", (3 * hidden, in_size)),
                                ("w_hh", (3 * hidden, hidden)),
                                ("b_ih", (3 * hidden,)),
                                ("b_hh", (3 * hidden,)))}


def _layer_args(seed, B, IN, H):
    """x (T, B, IN) bf16-representable, stacked (fwd, bwd) weights, ragged
    lengths with a 0 (a padded row)."""
    rng = np.random.default_rng(seed)
    fwd, bwd = _direction(rng, IN, H), _direction(rng, IN, H)
    x = rng.uniform(-1, 1, (T, B, IN)).astype(np.float32)
    x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    lengths = np.array([T, 0, 17, 1, T - 3, 29, 5, T][:B], np.int32)
    stack = {k: np.stack([fwd[k], bwd[k]]) for k in fwd}
    return x, stack, lengths


def _jax_layer(x, w, lengths, kind, **kw):
    args = [jnp.asarray(x, jnp.bfloat16)] + [
        jnp.asarray(w[k]) for k in ("w_ih", "b_ih", "w_hh", "b_hh")]
    fn = (pallas_gru.bigru_pallas_fullfused_int8 if kind == "int8"
          else pallas_gru.bigru_pallas_fullfused)
    out = fn(*args, lengths=jnp.asarray(lengths), interpret=True, **kw)
    return np.concatenate([np.asarray(o, np.float32) for o in out], -1)


def _valid(lengths, width):
    v = np.arange(T)[:, None] < lengths[None, :]
    return np.repeat(v[..., None], width, -1)


@pytest.mark.parametrize("B,IN,H", [(1, 10, 16), (4, 32, 32), (8, 10, 32)])
@pytest.mark.parametrize("kind,kw,atol", [
    ("fullfused", {}, 5e-3),
    ("fullfused", {"schedule": "staggered"}, 5e-3),
    ("fullfused", {"gates_bf16": True}, 2e-2),
    ("int8", {}, 2e-2)])
def test_fullfused_layer_matches_jax_interpret(B, IN, H, kind, kw, atol):
    """One layer, both directions, against the JAX kernel in interpret
    mode. Measured max |diff| over the three shapes: 0 (f32 gates, bf16
    gates), 2.4e-4 (staggered: a last-bit difference of XLA's and
    PyTorch's sigmoid moves one bf16 rounding of a small h) and 9.8e-4
    (int8: round(127 h) lands on the other side of a boundary)."""
    x, w, lengths = _layer_args(B + IN + H, B, IN, H)
    want = _jax_layer(x, w, lengths, kind, **kw)
    t = {k: torch.from_numpy(v) for k, v in w.items()}
    before = dict(gru_fullfused.LAUNCHES)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    if kind == "int8":
        got = gru_fullfused.bigru_pallas_fullfused_int8(
            xt, t["w_ih"], t["b_ih"], t["w_hh"], t["b_hh"],
            torch.from_numpy(lengths))
    else:
        got = gru_fullfused.bigru_pallas_fullfused(
            xt, t["w_ih"], t["b_ih"], t["w_hh"], t["b_hh"],
            torch.from_numpy(lengths), **kw)
    assert gru_fullfused.LAUNCHES == before   # CPU tensors never launch
    got = torch.cat(got, -1)
    assert got.dtype == torch.bfloat16 and got.shape == (T, B, 2 * H)
    got = got.float().numpy()
    # padded steps: forward repeats its last h, backward stays 0
    assert np.all(got[:, lengths == 0] == 0)
    assert np.abs(got - want).max() <= atol


@pytest.mark.parametrize("B,H", [(4, 16), (8, 32)])
def test_bigru_pallas_matches_jax_interpret(B, H):
    """Both directions over the same bf16 projections. Measured max
    |diff| 4.5e-8 (one bf16 rounding of a small h)."""
    rng = np.random.default_rng(B * H)
    xp = rng.uniform(-2, 2, (2, T, B, 3 * H)).astype(np.float32)
    xp = np.array(jnp.asarray(xp, jnp.bfloat16).astype(jnp.float32))
    w = _direction(rng, 1, H)
    w_hh = np.stack([w["w_hh"], _direction(rng, 1, H)["w_hh"]])
    b_hh = rng.uniform(-0.2, 0.2, (2, 3 * H)).astype(np.float32)
    lengths = np.array([T, 0, 9, T - 1, 3, T, 22, 1][:B], np.int32)
    want = pallas_gru.bigru_pallas(
        jnp.asarray(xp[0], jnp.bfloat16), jnp.asarray(xp[1], jnp.bfloat16),
        jnp.asarray(w_hh), jnp.asarray(b_hh), lengths=jnp.asarray(lengths),
        interpret=True)
    want = np.concatenate([np.asarray(o, np.float32) for o in want], -1)
    got = gru_fullfused.bigru_pallas(
        torch.from_numpy(xp[0]).to(torch.bfloat16),
        torch.from_numpy(xp[1]).to(torch.bfloat16), torch.from_numpy(w_hh),
        torch.from_numpy(b_hh), torch.from_numpy(lengths))
    got = torch.cat(got, -1).float().numpy()
    assert np.abs(got - want).max() <= 5e-3


def _stack(rng, n_layers, IN, H, bidirectional=True):
    n_dirs = 2 if bidirectional else 1
    layers = []
    for k in range(n_layers):
        in_size = IN if k == 0 else n_dirs * H
        layer = {"fwd": _direction(rng, in_size, H)}
        if bidirectional:
            layer["bwd"] = _direction(rng, in_size, H)
        layers.append(layer)
    return layers


def _stack_inputs(seed, B=4, IN=10):
    rng = np.random.default_rng(seed)
    x = rng.random((B, T, IN)).astype(np.float32)
    lengths = np.array([T, 11, 0, T - 5][:B], np.int32)
    return rng, x, lengths


@pytest.mark.parametrize("quant,atol", [
    (None, 5e-3), ("none", 5e-3), ("int8", 2e-2), ("bf16_gates", 2e-2),
    ("staggered", 5e-3)])
def test_stack_fullfused_matches_jax_interpret(quant, atol):
    """A 3-layer H=32 stack, each ``recurrent_quant``. Measured max
    |diff|: 9.8e-4 (None, "none", "staggered"), 2.0e-3 (int8), 0 (bf16
    gates)."""
    rng, x, lengths = _stack_inputs(11)
    layers = _stack(rng, 3, 10, 32)
    want = np.asarray(pallas_gru.bigru_stack_fullfused(
        jax.tree.map(jnp.asarray, layers), jnp.asarray(x),
        lengths=jnp.asarray(lengths), interpret=True,
        recurrent_quant=quant), np.float32)
    got = gru_fullfused.bigru_stack_fullfused(
        jax.tree.map(torch.from_numpy, layers), torch.from_numpy(x),
        lengths=torch.from_numpy(lengths), recurrent_quant=quant,
        device="cpu")
    assert got.shape == (4, T, 64) and got.dtype == torch.bfloat16
    assert np.abs(got.float().numpy() - want).max() <= atol


@pytest.mark.parametrize("bidirectional", [True, False])
def test_stack_fused_matches_jax_interpret(bidirectional):
    """``bigru_stack_fused``: 2 layers, H=16; the bidirectional branch runs
    ``bigru_pallas``, the unidirectional one ``gru_fwd`` (``gru_pallas``).
    Measured max |diff| 0 in both."""
    rng, x, lengths = _stack_inputs(13)
    layers = _stack(rng, 2, 10, 16, bidirectional)
    want = np.asarray(pallas_gru.bigru_stack_fused(
        jax.tree.map(jnp.asarray, layers), jnp.asarray(x),
        bidirectional=bidirectional, lengths=jnp.asarray(lengths),
        interpret=True), np.float32)
    got = gru_fullfused.bigru_stack_fused(
        jax.tree.map(torch.from_numpy, layers), torch.from_numpy(x),
        bidirectional=bidirectional, lengths=torch.from_numpy(lengths),
        device="cpu")
    assert got.shape == want.shape
    assert np.abs(got.float().numpy() - want).max() <= 5e-3


@pytest.mark.parametrize("quant,atol", [(None, 5e-3), ("int8", 2e-2)])
def test_lambda_bundle_fullfused_matches_jax(quant, atol):
    """The bundled gru256_lambda_demo (H=256) through the port's fullfused
    stack and f32 head against JAX's ``bigru_stack_fullfused(interpret=
    True)`` + the f32 einsum head + softmax, B=4, T=48: probabilities on
    valid columns. Measured max |diff| 6.8e-4 (f32 gates), 3.0e-3
    (int8)."""
    bundle, ref = models.load_model(LAMBDA), jax_models.load_model(LAMBDA)
    rng = np.random.default_rng(17)
    x = rng.random((4, 48, 10)).astype(np.float32)
    lengths = np.array([48, 30, 0, 7], np.int32)
    feats = pallas_gru.bigru_stack_fullfused(
        ref.params["gru"], jnp.asarray(x), lengths=jnp.asarray(lengths),
        interpret=True, recurrent_quant=quant)
    logits = jnp.einsum("bth,ch->btc", feats.astype(jnp.float32),
                        ref.params["linear"]["w"].astype(jnp.float32))
    want = np.asarray(jax.nn.softmax(
        logits + ref.params["linear"]["b"].astype(jnp.float32), -1))
    with torch.inference_mode():
        feats_t = gru_fullfused.bigru_stack_fullfused(
            bundle.model.layer_params(), torch.from_numpy(x),
            lengths=torch.from_numpy(lengths), recurrent_quant=quant,
            device="cpu")
        got = torch.softmax(
            feats_t.float() @ bundle.model.linear.weight.t()
            + bundle.model.linear.bias, -1).numpy()
    valid = np.arange(48)[None, :] < lengths[:, None]
    assert np.abs(got - want)[valid].max() <= atol


def test_wrapper_checks_mode_and_schedule():
    x = torch.zeros((2, 1, 4), dtype=torch.bfloat16)
    w = torch.zeros((2, 12, 4))
    b = torch.zeros((2, 12))
    with pytest.raises(ValueError, match="schedule"):
        gru_fullfused.bigru_pallas_fullfused(
            x, w, b, torch.zeros((2, 12, 4)), b, schedule="other")
    with pytest.raises(ValueError, match="recurrent_quant"):
        gru_fullfused.bigru_stack_fullfused([], x, recurrent_quant="fp8",
                                            device="cpu")


def test_hidden_padding_is_exact():
    """An H that is not a multiple of 32 is padded with zero units for the
    kernels: the padded units stay 0, so the real units equal the unpadded
    plain version bit for bit (checked here through the plain version of
    the padded weights, as the kernel sees them)."""
    x, w, lengths = _layer_args(3, 4, 10, 20)
    t = {k: torch.from_numpy(v) for k, v in w.items()}
    xt = torch.from_numpy(x).to(torch.bfloat16)
    lens = torch.from_numpy(lengths)
    for mode in ("f32_gates", "bf16_gates", "int8"):
        want = gru_fullfused.bigru_fullfused_plain(
            xt, t["w_ih"], t["b_ih"], t["w_hh"], t["b_hh"], lens, mode)
        w_ih = gru_fullfused._pad_gates(t["w_ih"], 20, 32, 1)
        b_ih = gru_fullfused._pad_gates(t["b_ih"], 20, 32, 1)
        w_hh, b_hh = gru_fullfused._pad_recurrent(t["w_hh"], t["b_hh"], 20,
                                                  32)
        got = gru_fullfused.bigru_fullfused_plain(xt, w_ih, b_ih, w_hh, b_hh,
                                                  lens, mode)
        got = gru_fullfused._unpad(got, T, 4, 20, 32)
        assert torch.equal(got, want), mode
