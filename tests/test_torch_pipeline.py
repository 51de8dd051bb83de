"""The port's inference + sequence against medaka_tpu's, end to end on CPU.

Both packages polish the same synthetic BAM with the same bundle; the
probabilities agree within the stated bars, the consensus FASTAs are
byte-identical, and each package stitches the other's probability file.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from medaka_tpu import prediction as jax_prediction
from medaka_tpu import stitch as jax_stitch
from medaka_tpu_torch import datastore, prediction, stitch, testing
from tests.mock_data import create_synth_bam

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
    """Both packages' probability files, full precision and bf16.

    medaka_tpu runs on one device, as the port does: over the test
    session's 8 virtual CPU devices its batch would be split into
    per-device shapes whose bf16 results XLA rounds differently.
    """
    bam, _ = synth
    d = tmp_path_factory.mktemp("runs")
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    out = {}
    for full in (True, False):
        tag = "f32" if full else "bf16"
        jax_hdf = str(d / "jax_{}.hdf".format(tag))
        port_hdf = str(d / "port_{}.hdf".format(tag))
        jax_prediction.predict(bam, jax_hdf, model_path=MODEL,
                               full_precision=full, mesh=mesh, **RUN)
        prediction.predict(bam, port_hdf, model_path=MODEL,
                           full_precision=full, device="cpu", **RUN)
        out[tag] = (jax_hdf, port_hdf)
    return out


def _probs(path):
    index = datastore.DataIndex(path)
    with datastore.DataStore(path) as ds:
        return {name: ds.load_sample(name).label_probs
                for name, _ in index.samples}


@pytest.mark.parametrize("tag,atol", [("f32", 1e-4), ("bf16", 2e-2)])
def test_probabilities_match(runs, tag, atol):
    jax_hdf, port_hdf = runs[tag]
    want, got = _probs(jax_hdf), _probs(port_hdf)
    assert sorted(want) == sorted(got) and len(got) > 8
    worst = max(np.abs(got[k] - want[k]).max() for k in want)
    assert worst <= atol


def test_bf16_argmax_differs_only_at_near_ties(runs):
    """In bf16 the two CPU routes round at different points (XLA keeps
    f32 inside its fused gate arithmetic and has its own tanh/logistic;
    PyTorch rounds every bf16 op), so a column whose two best classes
    are within twice the probability bar may decode differently.
    Measured on this BAM (create_synth_bam seed 42): 0 of 25,000
    columns differ."""
    jax_hdf, port_hdf = runs["bf16"]
    want, got = _probs(jax_hdf), _probs(port_hdf)
    n_diff = 0
    for key in want:
        differ = want[key].argmax(-1) != got[key].argmax(-1)
        top2 = np.sort(want[key], axis=-1)[:, -2:]
        assert np.all((top2[:, 1] - top2[:, 0])[differ] <= 4e-2)
        n_diff += int(differ.sum())
    assert n_diff <= 3


@pytest.mark.parametrize("tag", ["f32", "bf16"])
def test_consensus_and_cross_stitch(runs, synth, tag, tmp_path):
    """Each package stitches the other's HDF5 to the same bytes, and the
    two packages' consensus FASTAs are byte-identical, in f32 and in
    bf16 (measured on this BAM: 0 argmax differences in bf16)."""
    _, draft = synth
    jax_hdf, port_hdf = runs[tag]
    fastas = {}
    for name, fn, hdf in (
            ("jax", jax_stitch.stitch_to_fasta, jax_hdf),
            ("port", stitch.stitch_to_fasta, port_hdf),
            ("jax_stitches_port", jax_stitch.stitch_to_fasta, port_hdf),
            ("port_stitches_jax", stitch.stitch_to_fasta, jax_hdf)):
        path = str(tmp_path / (name + ".fasta"))
        fn(hdf, draft, path)
        with open(path, "rb") as fh:
            fastas[name] = fh.read()
    assert len(fastas["jax"]) > 20000
    assert fastas["jax_stitches_port"] == fastas["port"]
    assert fastas["port_stitches_jax"] == fastas["jax"]
    assert fastas["port"] == fastas["jax"]


def test_cli_inference_and_sequence(runs, synth, tmp_path):
    bam, draft = synth
    hdf = str(tmp_path / "cli.hdf")
    fasta = str(tmp_path / "cli.fasta")
    cmd = [sys.executable, "-m", "medaka_tpu_torch"]
    subprocess.run(cmd + [
        "inference", bam, hdf, "--model", MODEL, "--cpu", "--quiet",
        "--batch_size", "8", "--chunk_len", "1000", "--chunk_ovlp", "100"],
        check=True, cwd=REPO)
    subprocess.run(cmd + ["sequence", hdf, draft, fasta, "--quiet"],
                   check=True, cwd=REPO)
    want = str(tmp_path / "want.fasta")
    stitch.stitch_to_fasta(runs["bf16"][1], draft, want)
    with open(fasta, "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read()


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
