"""The port's read-level path against medaka_tpu's, on the CPU.

Features, the bi-LSTM kernel's plain version and the whole ``inference``
+ ``sequence`` pipeline, each held against the matching ``medaka_tpu``
call on the same inputs and weights (made from numpy seeds or the bundled
``rl_lstm128_*`` models). The model's own tests are in
``test_torch_read_level_model.py``, and the pipeline's bf16 half and
command line in ``test_torch_bf16_read_level.py``, so that workers of
their own can run them beside the full-precision pipeline run here.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medaka_tpu import features as jax_features
from medaka_tpu import models as jax_models
from medaka_tpu.common import Region as JaxRegion
from medaka_tpu.ops import pallas_gru
from medaka_tpu.ops import rnn as jax_rnn
from medaka_tpu_torch import features, models, testing
from medaka_tpu_torch.common import Region
from medaka_tpu_torch.io.bam import BamRecord
from medaka_tpu_torch.ops import bilstm, rnn
from tests import mock_data
from tests.torch_precision_runs import check_pipeline, predict_both
from tests.torch_read_level_data import make_bams
from tests.torch_threads import one_thread  # noqa: F401

DATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "medaka_tpu", "data")
LAMBDA = os.path.join(DATA, "rl_lstm128_lambda_demo.tar.gz")
DWELLS = os.path.join(DATA, "rl_lstm128_dwells_demo.tar.gz")
RUN = dict(chunk_len=1000, chunk_overlap=100, batch_size=8)


@pytest.fixture(scope="module")
def bams(tmp_path_factory):
    """The synthetic BAMs of ``torch_read_level_data.make_bams``."""
    return make_bams(tmp_path_factory.mktemp("rl"))


@pytest.mark.parametrize("bam,dwells", [
    ("moves", True), ("plain", True), ("plain", False),
    ("long_cigar", True)])
def test_read_alignment_matrix_equals_jax(bams, bam, dwells):
    """Array-equal to medaka_tpu's: native path with and without mv
    tags, and the numpy path a CG long-cigar record takes."""
    got = features.read_alignment_matrix(
        Region("synth", 0, 10000), bams[bam], include_dwells=dwells)
    want = jax_features.read_alignment_matrix(
        JaxRegion("synth", 0, 10000), bams[bam], include_dwells=dwells)
    assert len(got) == len(want) >= 1
    for (m1, p1), (m2, p2) in zip(got, want):
        assert m1.dtype == np.int8 and m1.shape[-1] == 4 + int(dwells)
        np.testing.assert_array_equal(m1, m2)
        np.testing.assert_array_equal(p1, p2)
    if bam == "moves":
        assert (got[0][0][..., 4] > 0).any()


def test_encoder_samples_equal_jax(bams):
    """Sample generation with the bundle's encoder: same chunks, depth."""
    port = models.load_model(LAMBDA).feature_encoder
    ref = jax_models.load_model(LAMBDA).feature_encoder
    assert port.to_dict() == ref.to_dict()
    got = features.SampleGenerator(
        bams["plain"], Region("synth", 0, 10000), port, chunk_len=1000,
        chunk_overlap=100).samples
    want = jax_features.SampleGenerator(
        bams["plain"], JaxRegion("synth", 0, 10000), ref, chunk_len=1000,
        chunk_overlap=100).samples
    assert len(got) == len(want) > 5
    for a, b in zip(got, want):
        assert a.name == b.name
        np.testing.assert_array_equal(a.features, b.features)
        np.testing.assert_array_equal(a.depth, b.depth)


def test_dwell_reads_match_mock_data():
    """The port's simulator repeats tests/mock_data's draws; its cigar
    aligns the read exactly and the mv table has one move per base."""
    arr = np.frombuffer(b"ACGT", np.uint8)[
        np.random.default_rng(1).integers(0, 4, 5000)]
    want = mock_data.simulate_dwell_read(arr, 100, 1500,
                                         np.random.default_rng(3))
    seq, mv, cigar = testing.simulate_dwell_read(
        arr, 100, 1500, np.random.default_rng(3))
    assert seq == want[0]
    np.testing.assert_array_equal(mv, want[1])
    rec = BamRecord.build("r", 0, 100, seq=seq, cigar=cigar)
    assert rec.reference_length == 1500
    assert int(np.sum(mv[1:] == 1)) == len(seq)
    assert features.calculate_dwells(
        BamRecord.build("r", 0, 100, seq=seq, cigar=cigar,
                        tags={"mv": mv})) is not None


def _lstm_layer(rng, in_size, hidden):
    k = 1.0 / np.sqrt(hidden)
    return {name: rng.uniform(-k, k, shape).astype(np.float32)
            for name, shape in (("w_ih", (4 * hidden, in_size)),
                                ("w_hh", (4 * hidden, hidden)),
                                ("b_ih", (4 * hidden,)),
                                ("b_hh", (4 * hidden,)))}


def _stack(rng, hidden=16, in_size=16):
    return [{"fwd": _lstm_layer(rng, i, hidden),
             "bwd": _lstm_layer(rng, i, hidden)}
            for i in (in_size, 2 * hidden)]


def _torch_tree(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype,atol", [(None, 1e-5), ("bf16", 3e-2)])
def test_lstm_scan_matches_jax(reverse, dtype, atol):
    """f32 within 1e-5; bf16 within the 3e-2 bar of test_pallas_gru.py."""
    rng = np.random.default_rng(8)
    params = _lstm_layer(rng, 10, 32)
    x = rng.random((4, 40, 10)).astype(np.float32)
    lengths = np.array([40, 25, 3, 39], np.int32)
    ref = jax_rnn.lstm_scan(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x), reverse=reverse,
        compute_dtype=jnp.bfloat16 if dtype else None,
        lengths=jnp.asarray(lengths))
    got = rnn.lstm_scan(
        _torch_tree(params), torch.from_numpy(x), reverse=reverse,
        compute_dtype=torch.bfloat16 if dtype else None,
        lengths=torch.from_numpy(lengths))
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(ref, np.float32), atol=atol)


def test_bilstm_stack_matches_jax():
    rng = np.random.default_rng(9)
    layers = _stack(rng)
    x = rng.random((4, 48, 16)).astype(np.float32)
    lengths = np.array([48, 30, 7, 1], np.int32)
    ref = jax_rnn.bilstm_stack(jax.tree.map(jnp.asarray, layers),
                               jnp.asarray(x), lengths=jnp.asarray(lengths))
    got = rnn.bilstm_stack(_torch_tree(layers), torch.from_numpy(x),
                           lengths=torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("level", ["kernel", "stack"])
def test_bilstm_plain_matches_jax_interpret(level):
    """The kernel's plain version against ``bilstm_pallas`` and the stack
    against ``bilstm_stack_fused``, both with ``interpret=True``, at the
    shapes of test_pallas_gru.py's TestFusedLSTM (H=16, T=48, B=4) with
    lengths [48, 30, 7, 1]: within one bf16 step, 4e-3 (measured 9.8e-4
    for the stack)."""
    rng = np.random.default_rng(5)
    layers = _stack(rng)
    x = rng.random((4, 48, 16)).astype(np.float32)
    lengths = np.array([48, 30, 7, 1], np.int32)
    with torch.inference_mode():
        if level == "stack":
            want = pallas_gru.bilstm_stack_fused(
                layers, jnp.asarray(x), lengths=jnp.asarray(lengths),
                interpret=True)
            got = bilstm.bilstm_stack_fused(
                _torch_tree(layers), torch.from_numpy(x),
                lengths=torch.from_numpy(lengths))
        else:
            xp = [rng.uniform(-2, 2, (48, 4, 64)).astype(np.float32)
                  for _ in range(2)]
            w_hh = np.stack([layers[0]["fwd"]["w_hh"],
                             layers[0]["bwd"]["w_hh"]])
            b_hh = np.stack([layers[0]["fwd"]["b_hh"],
                             layers[0]["bwd"]["b_hh"]])
            want = jnp.stack(pallas_gru.bilstm_pallas(
                *(jnp.asarray(v, jnp.bfloat16) for v in xp),
                jnp.asarray(w_hh), jnp.asarray(b_hh),
                lengths=jnp.asarray(lengths), interpret=True))
            got = torch.stack(bilstm.bilstm_fused(
                *(torch.from_numpy(v).to(torch.bfloat16) for v in xp),
                torch.from_numpy(w_hh), torch.from_numpy(b_hh),
                torch.from_numpy(lengths)))
        assert got.dtype == torch.bfloat16
        diff = np.abs(got.float().numpy() - np.asarray(want, np.float32))
    assert diff.max() <= 4e-3


@pytest.fixture(scope="module")
def runs(bams, tmp_path_factory):
    """Both packages' probability files of a 20 kb BAM at depth 15 in
    full precision (the bf16 half is ``test_torch_bf16_read_level.py``'s);
    medaka_tpu on one device, as the port runs."""
    d = tmp_path_factory.mktemp("rl_runs")
    bam, draft = testing.create_synth_bam(str(d / "reads.bam"), ref_mb=0.02,
                                          depth=15, read_len=2000)
    return {"bam": bam, "draft": draft,
            "f32": predict_both(bam, d, LAMBDA, True, RUN)}


@pytest.mark.parametrize("tag", ["f32"])
def test_pipeline_matches_jax(runs, tag, tmp_path):
    """Probabilities within 1e-4; each package stitches the other's file
    to the same bytes; the consensus FASTAs are byte-identical (measured:
    20,005 bp, 34 edits from the draft by greedy walk, identity
    0.9983)."""
    check_pipeline(runs, tag, tmp_path)
