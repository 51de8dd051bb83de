"""The bf16 half of ``test_torch_read_level.py``'s pipeline: the port's
read-level inference + sequence against medaka_tpu's in bf16 on the CPU,
and the command line.

The same 20 kb BAM, bundle and chunks as that file; in a file of its own
so that xdist's ``--dist loadfile`` runs it on another worker than the
full-precision half.
"""
import os

import pytest
import torch

from medaka_tpu_torch import cli, stitch, testing
from tests.torch_precision_runs import check_pipeline, predict_both
from tests.torch_threads import one_thread  # noqa: F401

DATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "medaka_tpu", "data")
LAMBDA = os.path.join(DATA, "rl_lstm128_lambda_demo.tar.gz")
RUN = dict(chunk_len=1000, chunk_overlap=100, batch_size=8)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' probability files of a 20 kb BAM at depth 15 in
    bf16; medaka_tpu on one device, as the port runs."""
    d = tmp_path_factory.mktemp("rl_runs")
    bam, draft = testing.create_synth_bam(str(d / "reads.bam"), ref_mb=0.02,
                                          depth=15, read_len=2000)
    return {"bam": bam, "draft": draft,
            "bf16": predict_both(bam, d, LAMBDA, False, RUN)}


@pytest.mark.parametrize("tag", ["bf16"])
def test_pipeline_matches_jax(runs, tag, tmp_path):
    """Probabilities within 2e-2; each package stitches the other's file
    to the same bytes; the consensus FASTAs are byte-identical on this
    BAM too (measured: the same 20,005 bp as in f32, 34 edits from the
    draft by greedy walk, identity 0.9983)."""
    check_pipeline(runs, tag, tmp_path)


def test_cli_read_level_inference_and_sequence(runs, tmp_path):
    """The command line of the read-level path: ``--cpu`` runs on the
    CPU and gives the bf16 pipeline's bytes; without ``--cpu`` and
    without a GPU it raises."""
    hdf, fasta = str(tmp_path / "cli.hdf"), str(tmp_path / "cli.fasta")
    args = ["inference", runs["bam"], hdf, "--model", LAMBDA,
            "--chunk_len", "1000", "--chunk_ovlp", "100", "--batch_size",
            "8", "--quiet"]
    assert cli.main(args + ["--cpu"]) == 0
    assert cli.main(["sequence", hdf, runs["draft"], fasta, "--quiet"]) == 0
    want = str(tmp_path / "want.fasta")
    stitch.stitch_to_fasta(runs["bf16"][1], runs["draft"], want)
    with open(fasta, "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no GPU"):
            cli.main(args[:2] + [str(tmp_path / "gpu.hdf")] + args[3:])
