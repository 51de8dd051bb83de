"""The bf16 half of ``test_torch_pipeline.py``: the port's inference +
sequence against medaka_tpu's in bf16 on the CPU, and the command line.

The same synthetic BAM, bundle and chunks as that file; in a file of its
own so that xdist's ``--dist loadfile`` runs it on another worker than
the full-precision half.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

from medaka_tpu_torch import stitch
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
    """Both packages' probability files in bf16."""
    bam, _ = synth
    return {"bf16": predict_both(bam, tmp_path_factory.mktemp("runs"),
                                 MODEL, False, RUN)}


@pytest.mark.parametrize("tag,atol", [("bf16", 2e-2)])
def test_probabilities_match(runs, tag, atol):
    want, got = (probs(hdf) for hdf in runs[tag])
    assert sorted(want) == sorted(got) and len(got) > 8
    assert max(np.abs(got[k] - want[k]).max() for k in want) <= atol


def test_bf16_argmax_differs_only_at_near_ties(runs):
    """In bf16 the two CPU routes round at different points (XLA keeps
    f32 inside its fused gate arithmetic and has its own tanh/logistic;
    PyTorch rounds every bf16 op), so a column whose two best classes
    are within twice the probability bar may decode differently.
    Measured on this BAM (create_synth_bam seed 42): 0 of 25,000
    columns differ."""
    jax_hdf, port_hdf = runs["bf16"]
    want, got = probs(jax_hdf), probs(port_hdf)
    n_diff = 0
    for key in want:
        differ = want[key].argmax(-1) != got[key].argmax(-1)
        top2 = np.sort(want[key], axis=-1)[:, -2:]
        assert np.all((top2[:, 1] - top2[:, 0])[differ] <= 4e-2)
        n_diff += int(differ.sum())
    assert n_diff <= 3


@pytest.mark.parametrize("tag", ["bf16"])
def test_consensus_and_cross_stitch(runs, synth, tag, tmp_path):
    """Each package stitches the other's HDF5 to the same bytes, and the
    two packages' consensus FASTAs are byte-identical (measured on this
    BAM: 0 argmax differences in bf16)."""
    fastas = cross_stitch(runs[tag], synth[1], tmp_path)
    assert len(fastas["jax"]) > 20000
    assert fastas["jax_stitches_port"] == fastas["port"]
    assert fastas["port_stitches_jax"] == fastas["jax"]
    assert fastas["port"] == fastas["jax"]


def test_cli_inference_and_sequence(runs, synth, tmp_path):
    bam, draft = synth
    hdf = str(tmp_path / "cli.hdf")
    fasta = str(tmp_path / "cli.fasta")
    cmd = [sys.executable, "-m", "medaka_tpu_torch"]
    # one OpenMP thread in the child, as in this process (one_thread)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    subprocess.run(cmd + [
        "inference", bam, hdf, "--model", MODEL, "--cpu", "--quiet",
        "--batch_size", "8", "--chunk_len", "1000", "--chunk_ovlp", "100"],
        check=True, cwd=REPO, env=env)
    subprocess.run(cmd + ["sequence", hdf, draft, fasta, "--quiet"],
                   check=True, cwd=REPO, env=env)
    want = str(tmp_path / "want.fasta")
    stitch.stitch_to_fasta(runs["bf16"][1], draft, want)
    with open(fasta, "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read()
