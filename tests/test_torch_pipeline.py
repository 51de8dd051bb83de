"""The port's inference + sequence against medaka_tpu's, end to end on CPU.

Both packages polish the same synthetic BAM with the same bundle; the
probabilities agree within the stated bars, the consensus FASTAs are
byte-identical, and each package stitches the other's probability file.
This file runs the full-precision half; ``test_torch_bf16_pipeline.py``
runs the bf16 half and the command line, on another xdist worker.
"""
import os

import numpy as np
import pytest
import torch

from medaka_tpu_torch import prediction, testing
from tests.mock_data import create_synth_bam
from tests.torch_precision_runs import cross_stitch, predict_both, probs
from tests.torch_threads import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = os.path.join(REPO, "medaka_tpu", "data",
                     "gru256_lambda_demo_model_pt.tar.gz")
RUN = dict(chunk_len=1000, chunk_overlap=100, batch_size=8)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    d = tmp_path_factory.mktemp("synth")
    return create_synth_bam(str(d / "reads.bam"), ref_mb=0.02, depth=10,
                            read_len=2000)


@pytest.fixture(scope="module")
def runs(synth, tmp_path_factory):
    """Both packages' probability files in full precision (the bf16 half
    is ``test_torch_bf16_pipeline.py``'s)."""
    bam, _ = synth
    return {"f32": predict_both(bam, tmp_path_factory.mktemp("runs"), MODEL,
                                True, RUN)}


@pytest.mark.parametrize("tag,atol", [("f32", 1e-4)])
def test_probabilities_match(runs, tag, atol):
    want, got = (probs(hdf) for hdf in runs[tag])
    assert sorted(want) == sorted(got) and len(got) > 8
    assert max(np.abs(got[k] - want[k]).max() for k in want) <= atol


@pytest.mark.parametrize("tag", ["f32"])
def test_consensus_and_cross_stitch(runs, synth, tag, tmp_path):
    """Each package stitches the other's HDF5 to the same bytes, and the
    two packages' consensus FASTAs are byte-identical."""
    fastas = cross_stitch(runs[tag], synth[1], tmp_path)
    assert len(fastas["jax"]) > 20000
    assert fastas["jax_stitches_port"] == fastas["port"]
    assert fastas["port_stitches_jax"] == fastas["jax"]
    assert fastas["port"] == fastas["jax"]


def test_testing_bam_matches_mock_data(tmp_path):
    """The port's synthetic BAM writer reproduces tests/mock_data's."""
    a = create_synth_bam(str(tmp_path / "a.bam"), ref_mb=0.005, depth=4,
                         read_len=1000)
    b = testing.create_synth_bam(str(tmp_path / "b.bam"), ref_mb=0.005,
                                 depth=4, read_len=1000)
    for x, y in zip(a, b):
        with open(x, "rb") as fa, open(y, "rb") as fb:
            assert fa.read() == fb.read()


def test_predict_on_cuda_without_gpu_raises(synth, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no GPU"):
        prediction.predict(synth[0], str(tmp_path / "x.hdf"),
                           model_path=MODEL, **RUN)


def test_auto_batch_size_memory_model():
    """Per row at T=10000: bf16 features, two int8 (T, 256) layer-1
    outputs and two f32 (T, 5) logit partials = 5.72 MB; half the free
    memory is budgeted, in multiples of 64, capped at 512. Off the split
    path (here H=96) the fullfused stack's buffers a row: bf16 features,
    two (T, 192) bf16 inter-layer buffers, the (2, T, 288) bf16
    projection scratch and f32 logits = 19.6 MB, never below 32."""
    from medaka_tpu_torch.models.gru import GRUModel
    model = GRUModel(gru_size=256)
    gib = 1 << 30
    assert prediction.auto_batch_size(model, "cpu") == 128
    assert prediction.auto_batch_size(
        model, "cuda", free_bytes=80 * gib) == prediction.AUTO_BATCH_CAP
    assert prediction.auto_batch_size(model, "cuda", free_bytes=2 * gib) \
        == 128
    assert prediction.auto_batch_size(
        model, "cuda", free_bytes=80 * gib, full_precision=True) == 512
    assert prediction.auto_batch_size(
        model, "cuda", free_bytes=8 * gib, full_precision=True) == 64
    off_split = GRUModel(gru_size=96)
    assert prediction.auto_batch_size(off_split, "cuda",
                                      free_bytes=8 * gib) == 192
    assert prediction.auto_batch_size(off_split, "cuda",
                                      free_bytes=gib) == 32
    assert prediction.auto_batch_size(off_split, "cpu") == 128


@pytest.mark.parametrize("kwargs,per_row", [
    ({"gru_size": 96}, 10000 * (20 + 2 * 2 * 192 + 2 * 288 * 2 + 20)),
    ({"gru_size": 256, "n_layers": 3},
     10000 * (20 + 2 * 2 * 512 + 2 * 768 * 2 + 20)),
    # unidirectional: one direction's buffers and scratch
    ({"gru_size": 256, "bidirectional": False},
     10000 * (20 + 2 * 256 * 2 + 768 * 2 + 20))])
def test_auto_batch_size_memory_model_off_split(kwargs, per_row):
    """Off the split path (medaka_tpu/prediction.py:526-534) the batch is
    half the free memory over the fullfused (or fused) stack's buffers a
    row, in multiples of 64, at least 32 and at most 512."""
    from medaka_tpu_torch.models.gru import GRUModel
    model = GRUModel(**kwargs)
    gib = 1 << 30
    for free in (80 * gib, 8 * gib, gib // 4):
        want = max(32, min(512, (free // 2 // per_row) // 64 * 64))
        assert prediction.auto_batch_size(
            model, "cuda", free_bytes=free) == want


@pytest.mark.parametrize("edits", [0, 1, 40])
def test_greedy_edit_count_counts_planted_edits(edits):
    """Isolated substitutions, insertions and deletions are counted
    exactly; the walk is an upper bound on the edit distance."""
    rng = np.random.default_rng(edits)
    a = bytes(rng.choice(list(b"ACGT"), 20000).astype(np.uint8))
    b = bytearray(a)
    spots = np.sort(rng.choice(np.arange(100, 19900, 400), edits,
                               replace=False))[::-1]
    for k, p in enumerate(spots):
        if k % 3 == 0:
            b[p] = ord("C") if b[p] != ord("C") else ord("G")
        elif k % 3 == 1:
            del b[p]
        else:
            b.insert(p, b[p] ^ 2)          # a byte unlike its neighbour
    assert testing.greedy_edit_count(a, bytes(b)) == edits
