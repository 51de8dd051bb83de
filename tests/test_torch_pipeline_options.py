"""The host pipeline options of the port against medaka_tpu, on the CPU.

- ``inference --output_shards N`` (``datastore.ShardedDataStore``, spawned
  writer processes): the manifest and shards that both packages'
  ``DataIndex`` expand, holding bit for bit the samples of a one-file
  run; medaka_tpu's sharded output loads in the port.
- ``DataLoader(feature_processes=2)``: the same samples as two threads.
- ``consensus_from_features`` (``prediction.predict_from_features``) on a
  ``features --truth`` file: medaka_tpu's probabilities at the same batch.
- ``variant --threads 4`` shards its probability file over 2 files and
  writes the VCF of ``--threads 2`` (one file).
- ``inference --profile_dir``: a non-empty ``torch.profiler`` trace.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from medaka_tpu import datastore as jax_datastore
from medaka_tpu import prediction as jax_prediction
from medaka_tpu_torch import cli, datastore, features, prediction, testing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = os.path.join(REPO, "medaka_tpu", "data",
                     "gru256_lambda_demo_model_pt.tar.gz")
#: small chunks and work pieces: several regions and samples a genome
RUN = ["--chunk_len", "500", "--chunk_ovlp", "50", "--bam_chunk", "2000",
       "--batch_size", "8", "--cpu"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """PyTorch's CPU operators on one thread for this module (restored
    after it): the CPU routes run many small operators a step, which the
    suite's parallel workers slow many times over when each spreads them
    over every core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    d = tmp_path_factory.mktemp("synth")
    return testing.create_synth_bam(str(d / "reads.bam"), ref_mb=0.006,
                                    depth=6, seed=3, read_len=1500)


def _samples(path, index_cls):
    """({name: sample} of every sample the index lists, the index)."""
    index = index_cls(path)
    return {s.name: s for s in index.yield_from_feature_files()}, index


@pytest.fixture(scope="module")
def runs(synth, tmp_path_factory):
    """One-file and 3-shard runs of ``inference`` on the same BAM, the
    sharded one featurised in a worker process."""
    bam, _ = synth
    d = tmp_path_factory.mktemp("runs")
    one, sharded = str(d / "one.hdf"), str(d / "sharded.hdf")
    assert cli.main(["inference", bam, one, "--model", MODEL] + RUN) == 0
    assert cli.main(["inference", bam, sharded, "--model", MODEL,
                     "--output_shards", "3", "--feature_processes", "1"]
                    + RUN) == 0
    return one, sharded


def test_sharded_inference_is_the_one_file_run(runs):
    """Both packages' DataIndex expand the manifest to the base and its 3
    shards; the union of the shards' samples is the one-file run's, bit
    for bit, round-robin over the shards; every shard holds the
    metadata."""
    one, sharded = runs
    want, _ = _samples(one, datastore.DataIndex)
    got, index = _samples(sharded, datastore.DataIndex)
    names = ["{}.shard{:02d}".format(sharded, k) for k in range(3)]
    assert index.filenames == [sharded] + names
    assert jax_datastore.expand_shards(sharded) == index.filenames
    assert len(want) > 6 and sorted(got) == sorted(want)
    for name, sample in want.items():
        for field in ("label_probs", "positions", "depth"):
            np.testing.assert_array_equal(getattr(got[name], field),
                                          getattr(sample, field))
    jax_index = jax_datastore.DataIndex(sharded)
    assert sorted(jax_index.samples) == sorted(index.samples)
    counts = [len(datastore.DataStore(n).sample_registry) for n in names]
    assert max(counts) - min(counts) <= 1 and sum(counts) == len(want)
    for name in [sharded] + names:
        with datastore.DataStore(name) as ds:
            assert ds.meta["model_function"]["type"] == "GRUModel"
        with jax_datastore.DataStore(name) as ds:
            assert type(ds.meta["label_scheme"]).__name__ == \
                "HaploidLabelScheme"


def test_medaka_tpu_shards_load_in_the_port(runs, tmp_path):
    """medaka_tpu's ShardedDataStore over the one-file run's samples: the
    port lists and loads the same samples."""
    one, _ = runs
    want, _ = _samples(one, datastore.DataIndex)
    path = str(tmp_path / "jax_sharded.hdf")
    jax_samples, _ = _samples(one, jax_datastore.DataIndex)
    with jax_datastore.ShardedDataStore(path, shards=2) as ds:
        with jax_datastore.DataStore(one) as src:
            ds.set_meta(src.meta["label_scheme"], "label_scheme")
        for sample in jax_samples.values():
            ds.write_sample(sample)
    got, index = _samples(path, datastore.DataIndex)
    assert len(index.filenames) == 3 and sorted(got) == sorted(want)
    for name, sample in want.items():
        np.testing.assert_array_equal(got[name].label_probs,
                                      sample.label_probs)


def test_a_dead_shard_writer_raises(tmp_path):
    """A writer process that dies makes ``close`` raise: nothing falls
    back to the parent process."""
    store = datastore.ShardedDataStore(str(tmp_path / "probs.hdf"),
                                       shards=2)
    store._procs[1].kill()
    store._procs[1].join()
    with pytest.raises(IOError, match="Shard writer failed"):
        store.close()


def test_feature_processes_give_the_threads_samples(synth):
    """``DataLoader(feature_processes=2)`` yields the samples and region
    events of ``bam_workers=2``, in the same batches' contents."""
    bam, _ = synth
    regions = prediction.plan_work(None, bam, bam_chunk=2000,
                                   chunk_overlap=50)
    assert len(regions) >= 3

    def collect(**kw):
        loader = prediction.DataLoader(
            bam, regions, features.CountsFeatureEncoder(), batch_size=4,
            chunk_len=500, chunk_overlap=50, emit_region_events=True,
            **kw)
        samples, events = [], []
        for item in loader:
            if isinstance(item, prediction.Batch):
                samples.extend((s.name, s.features.tobytes())
                               for s in item.samples)
            else:
                events.append(item[1])
        return sorted(samples), sorted(events)

    threads = collect(bam_workers=2)
    procs = collect(feature_processes=2)
    assert threads == procs
    assert threads[1] == list(range(len(regions)))


def test_consensus_from_features_matches(synth, tmp_path):
    """``consensus_from_features`` on a ``features --truth`` file gives
    medaka_tpu's ``predict_from_features`` probabilities at the same
    batch size, in float32 (the scan on both sides, whose matrix products
    sum in XLA's and in PyTorch's orders): within 2e-6 (measured 1.04e-6
    over a 15 kb genome), the same argmax."""
    bam, ref = synth
    truth = testing.create_truth_bam(str(tmp_path / "truth.bam"), ref)
    feats = str(tmp_path / "feats.hdf")
    assert cli.main(["features", bam, feats, "--truth", truth,
                     "--chunk_len", "500", "--chunk_ovlp", "50"]) == 0
    port, jax_out = str(tmp_path / "port.hdf"), str(tmp_path / "jax.hdf")
    assert cli.main(["consensus_from_features", feats, port, "--model",
                     MODEL, "--batch_size", "8", "--full_precision",
                     "--cpu"]) == 0
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    jax_prediction.predict_from_features(
        feats, jax_out, model_path=MODEL, batch_size=8,
        full_precision=True, mesh=mesh)
    got, _ = _samples(port, datastore.DataIndex)
    want, _ = _samples(jax_out, jax_datastore.DataIndex)
    assert len(want) > 6 and sorted(got) == sorted(want)
    for name, sample in want.items():
        np.testing.assert_allclose(got[name].label_probs,
                                   sample.label_probs, rtol=0, atol=2e-6)
        np.testing.assert_array_equal(got[name].label_probs.argmax(-1),
                                      sample.label_probs.argmax(-1))
        assert got[name].labels is None
    with datastore.DataStore(port) as ds:
        assert ds.meta["model_function"]["kwargs"]["gru_size"] == 256


def test_variant_at_four_threads_shards(tmp_path):
    """``variant --threads 4`` writes its probabilities over 2 shards
    (``max(1, min(4, threads // 2))``, as medaka_tpu) that medaka_tpu's
    DataIndex reads, and the same VCF as ``--threads 2`` (one file)."""
    bam, ref, _, _ = testing.create_variant_bam(
        str(tmp_path / "var.bam"), ref_mb=0.008, depth=10, seed=2)
    fastq = str(tmp_path / "reads.fastq")
    testing.write_reads_fastq(bam, fastq)
    vcfs = {}
    for threads in (2, 4):
        out = str(tmp_path / "t{}".format(threads))
        assert cli.main(["variant", fastq, ref, "-o", out, "--model",
                         "gru256_variant_demo", "-t", str(threads),
                         "--chunk_len", "2000", "--chunk_ovlp", "200",
                         "--cpu"]) == 0
        probs = os.path.join(out, "consensus_probs.hdf")
        shards = jax_datastore.expand_shards(probs)
        assert len(shards) == (1 if threads == 2 else 3)
        assert datastore.expand_shards(probs) == shards
        assert jax_datastore.DataIndex(probs).samples
        with open(os.path.join(out, "medaka.annotated.vcf"), "rb") as fh:
            vcfs[threads] = fh.read()
    assert vcfs[2] == vcfs[4] and b"\nsynth\t" in vcfs[2]


def test_profile_dir_writes_a_trace(synth, tmp_path):
    """``inference --profile_dir`` on the CPU: a Chrome trace with
    events, among them the model's operators."""
    bam, _ = synth
    prof = str(tmp_path / "prof")
    assert cli.main(["inference", bam, str(tmp_path / "p.hdf"), "--model",
                     MODEL, "--regions", "synth:400-800", "--chunk_len",
                     "200", "--chunk_ovlp", "50", "--batch_size", "2",
                     "--cpu", "--profile_dir", prof]) == 0
    with open(os.path.join(prof, cli.PROFILE_TRACE)) as fh:
        events = json.load(fh)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert len(events) > 100 and any("aten::" in n for n in names)
    assert datastore.DataIndex(str(tmp_path / "p.hdf")).samples
