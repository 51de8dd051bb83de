"""Shared runs of the end-to-end inference test files: each package's
probability file of one BAM at one precision, and the helpers that read
and stitch them (the workflow tests read probabilities with
:func:`probs` too). The f32 and bf16 halves of
a pipeline live in files of their own (``test_torch_pipeline.py`` and
``test_torch_bf16_pipeline.py``, ``test_torch_read_level.py`` and
``test_torch_bf16_read_level.py``) so that xdist's ``--dist loadfile``
runs them on different workers; the files keep the seeds, BAMs and bars
they had together."""
import jax
import numpy as np

from medaka_tpu import prediction as jax_prediction
from medaka_tpu import stitch as jax_stitch
from medaka_tpu_torch import datastore, prediction, stitch, testing
from medaka_tpu_torch.io.fastx import FastaReader


def predict_both(bam, d, model, full_precision, run):
    """(medaka_tpu's, the port's) probability files of ``bam`` in the
    directory ``d``; medaka_tpu on one device, as the port runs (over the
    test session's 8 virtual CPU devices its batch would be split into
    per-device shapes whose bf16 results XLA rounds differently)."""
    tag = "f32" if full_precision else "bf16"
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    jax_hdf = str(d / "jax_{}.hdf".format(tag))
    port_hdf = str(d / "port_{}.hdf".format(tag))
    jax_prediction.predict(bam, jax_hdf, model_path=model,
                           full_precision=full_precision, mesh=mesh, **run)
    prediction.predict(bam, port_hdf, model_path=model,
                       full_precision=full_precision, device="cpu", **run)
    return jax_hdf, port_hdf


def probs(path):
    """{sample name: probabilities} of a probability file."""
    index = datastore.DataIndex(path)
    with datastore.DataStore(path) as ds:
        return {name: ds.load_sample(name).label_probs
                for name, _ in index.samples}


def cross_stitch(hdfs, draft, tmp_path):
    """The FASTA bytes of each package stitching its own and the other's
    probability file: {"jax", "port", "jax_stitches_port",
    "port_stitches_jax"}."""
    jax_hdf, port_hdf = hdfs
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
    return fastas


def check_pipeline(runs, tag, tmp_path):
    """The read-level pipeline's checks at one precision: probabilities
    within 1e-4 (f32) or 2e-2 (bf16); each package stitches the other's
    file to the same bytes; the consensus FASTAs byte-identical, at
    identity 0.99 or more to the draft. ``runs``: the BAM's "draft" and
    the probability files by tag."""
    want, got = probs(runs[tag][0]), probs(runs[tag][1])
    assert sorted(want) == sorted(got) and len(got) > 10
    worst = max(np.abs(got[k] - want[k]).max() for k in want)
    assert worst <= (1e-4 if tag == "f32" else 2e-2)
    fastas = cross_stitch(runs[tag], runs["draft"], tmp_path)
    assert fastas["jax_stitches_port"] == fastas["port"]
    assert fastas["port_stitches_jax"] == fastas["jax"]
    assert fastas["port"] == fastas["jax"]
    with FastaReader(runs["draft"]) as fr:
        draft = fr.fetch("synth")
    with FastaReader(str(tmp_path / "port.fasta")) as fr:
        consensus = fr.fetch("synth")
    edits = testing.greedy_edit_count(consensus.encode(), draft.encode())
    assert 1.0 - edits / len(draft) >= 0.99
