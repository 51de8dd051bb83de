"""The read-level model of the port against medaka_tpu's, on the CPU.

``LatentSpaceLSTM`` (both bundled ``rl_lstm128_*`` models, the
unidirectional stack), its parameters, read buckets, the automatic batch
and the Predictor's transfer of int8 features, each held against the
matching ``medaka_tpu`` call on the same inputs and weights. (Apart from
``test_torch_read_level.py``, whose pipeline runs take a worker of their
own.)
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medaka_tpu import models as jax_models
from medaka_tpu import prediction as jax_prediction
from medaka_tpu.ops import pallas_gru
from medaka_tpu_torch import features, models, prediction
from medaka_tpu_torch.common import Region
from medaka_tpu_torch.models.latent_space_lstm import LatentSpaceLSTM, \
    params_from_jax, params_to_jax
from tests.torch_read_level_data import make_bams
from tests.torch_threads import one_thread  # noqa: F401

DATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "medaka_tpu", "data")
LAMBDA = os.path.join(DATA, "rl_lstm128_lambda_demo.tar.gz")
DWELLS = os.path.join(DATA, "rl_lstm128_dwells_demo.tar.gz")


@pytest.fixture(scope="module")
def bams(tmp_path_factory):
    """The synthetic BAMs of ``torch_read_level_data.make_bams``."""
    return make_bams(tmp_path_factory.mktemp("rl"))


@pytest.fixture(scope="module")
def lambda_bundles():
    return models.load_model(LAMBDA), jax_models.load_model(LAMBDA)


@pytest.fixture(scope="module")
def chunks(bams, lambda_bundles):
    """Three real 200-column chunks of the plain BAM and one empty row."""
    samples = features.SampleGenerator(
        bams["plain"], Region("synth", 0, 10000),
        lambda_bundles[0].feature_encoder, chunk_len=200,
        chunk_overlap=20).samples[:3]
    batch = prediction.Batch.collate(samples, 4, 200, 100)
    assert batch.features.shape == (4, 200, 25, 4)
    return batch.features, batch.lengths


@pytest.mark.parametrize("mode", ["f32", "bf16_fused"])
def test_model_matches_jax_apply(lambda_bundles, chunks, mode, monkeypatch):
    """f32 (the scan): probabilities within 1e-4 of ``apply`` (measured
    6.6e-7). bf16 with ``fused=True`` (the kernel's plain version)
    against ``apply(fused=True)`` with the Pallas stack in interpret
    mode: within 2e-2, argmax agreement >= 0.999 (measured 1.6e-4, 1.0)."""
    bundle, ref = lambda_bundles
    x, lengths = chunks
    kwargs = {}
    if mode == "bf16_fused":
        monkeypatch.setattr(pallas_gru, "bilstm_stack_fused", functools.partial(
            pallas_gru.bilstm_stack_fused, interpret=True))
        kwargs = {"fused": True}
    want = np.asarray(ref.model.apply(
        ref.params, jnp.asarray(x).astype(jnp.float32),
        lengths=jnp.asarray(lengths),
        compute_dtype=jnp.bfloat16 if kwargs else None, **kwargs))
    with torch.inference_mode():
        got = bundle.model(
            torch.from_numpy(x), lengths=torch.from_numpy(lengths),
            compute_dtype=torch.bfloat16 if kwargs else None,
            **kwargs).numpy()
    valid = np.arange(200)[None, :] < lengths[:, None]
    diff = np.abs(got - want)[valid]
    if mode == "f32":
        assert diff.max() <= 1e-4
    else:
        assert diff.max() <= 2e-2
        assert (got.argmax(-1) == want.argmax(-1))[valid].mean() >= 0.999


def test_dwells_bundle_forward_matches_jax(bams):
    """The dwells bundle loads as it is and its f32 forward on mv-tagged
    features matches ``apply`` within 1e-4."""
    bundle, ref = models.load_model(DWELLS), jax_models.load_model(DWELLS)
    assert bundle.model.use_dwells and bundle.feature_encoder.include_dwells
    assert bundle.model.to_dict() == ref.model.to_dict()
    samples = features.SampleGenerator(
        bams["moves"], Region("synth", 0, 10000), bundle.feature_encoder,
        chunk_len=200, chunk_overlap=20).samples[:2]
    batch = prediction.Batch.collate(samples, 2, 200, 100)
    assert batch.features.shape[-1] == 5
    want = np.asarray(ref.model.apply(
        ref.params, jnp.asarray(batch.features).astype(jnp.float32),
        lengths=jnp.asarray(batch.lengths)))
    with torch.inference_mode():
        got = bundle.model(torch.from_numpy(batch.features),
                           lengths=torch.from_numpy(batch.lengths)).numpy()
    assert np.abs(got - want).max() <= 1e-4


def test_unidirectional_stack_matches_jax():
    """The 4-layer reverse/forward interleave (no kernel) in f32."""
    model = LatentSpaceLSTM(lstm_size=16, cnn_size=8, kernel_sizes=(1, 3),
                            bidirectional=False)
    ref_model = jax_models.model_from_dict(model.to_dict())
    params = ref_model.init_params(jax.random.PRNGKey(2))
    model.load_jax_params(jax.tree.map(np.asarray, params))
    rng = np.random.default_rng(4)
    x = np.zeros((2, 30, 6, 4), np.int8)
    x[..., 0] = rng.integers(0, 6, (2, 30, 6))
    x[..., 1] = rng.integers(-1, 40, (2, 30, 6))
    x[..., 2] = rng.choice([-1, 1], (2, 30, 6))
    x[:, :, 4:] = 0                                   # two empty read rows
    lengths = np.array([30, 17], np.int32)
    want = np.asarray(ref_model.apply(params, jnp.asarray(x),
                                      lengths=jnp.asarray(lengths)))
    with torch.inference_mode():
        got = model(torch.from_numpy(x),
                    lengths=torch.from_numpy(lengths)).numpy()
    assert np.abs(got - want).max() <= 1e-4


def test_params_round_trip(lambda_bundles):
    _, ref = lambda_bundles
    back = params_to_jax(params_from_jax(ref.params))
    assert jax.tree.structure(back) == jax.tree.structure(
        jax.tree.map(np.asarray, ref.params))
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(ref.params)):
        np.testing.assert_array_equal(got, np.asarray(want))


def test_collate_read_buckets():
    """Reads pad to the smallest of {25, 50, 100} covering the batch's
    deepest sample, as medaka_tpu's Batch.collate."""
    def sample(reads, cols=5):
        from medaka_tpu_torch.common import Sample, make_positions
        return Sample("c", np.ones((cols, reads, 4), np.int8), None, None,
                      make_positions(np.arange(cols), np.zeros(cols)), None)
    for depth, bucket in ((3, 25), (25, 25), (26, 50), (80, 100),
                          (100, 100)):
        samples = [sample(depth), sample(2, cols=3)]
        got = prediction.Batch.collate(samples, 3, 6, max_reads=100)
        want = jax_prediction.Batch.collate(samples, 3, 6, max_reads=100)
        assert got.features.shape == (3, 6, bucket, 4)
        np.testing.assert_array_equal(got.features, want.features)
        np.testing.assert_array_equal(got.lengths, want.lengths)


def test_auto_batch_size_read_level():
    """chunk_len x max_reads x cnn_size x 2 bytes x 3 live activations
    per row (76.8 MB at 1000 x 100 x 128); half the free memory is
    budgeted, capped at 128; the CPU uses 128."""
    model = LatentSpaceLSTM()
    gib = 1 << 30
    assert prediction.auto_batch_size(model, "cpu", chunk_len=1000) == 128
    assert prediction.auto_batch_size(
        model, "cuda", chunk_len=1000, free_bytes=80 * gib) == 128
    assert prediction.auto_batch_size(
        model, "cuda", chunk_len=1000, free_bytes=8 * gib) == 55
    assert prediction.auto_batch_size(
        model, "cuda", chunk_len=1000, free_bytes=8 * gib,
        full_precision=True) == 27
    assert prediction.auto_batch_size(
        model, "cuda", chunk_len=10000, free_bytes=1 * gib) == 1


def test_dispatch_keeps_int8_features(lambda_bundles, chunks):
    """Under compact transfer, int8 read-level features reach the model
    as int8 (the model widens them); float features go as bf16."""
    seen = []

    class Spy(torch.nn.Module):
        def forward(self, x, **kwargs):
            seen.append(x.dtype)
            return torch.zeros(x.shape[:2] + (5,))

    x, lengths = chunks
    pred = prediction.Predictor(Spy(), device="cpu", compact_transfer=True)
    pred.dispatch(prediction.Batch(x, lengths, []))
    pred.dispatch(prediction.Batch(x[..., 0].astype(np.float32), lengths,
                                   []))
    assert seen == [torch.int8, torch.float32]
