"""Multi-process inference of the port against medaka_tpu, on the CPU.

The counterpart of tests/test_multihost.py: ``medaka_tpu_torch
inference --num_processes N --process_id i`` run as N concurrent
processes writes ``<output>_host<i>`` files that the port's ``sequence``
merges into the one-process FASTA and medaka_tpu's (N = 2, 4); a
single-contig genome divides at ``bam_chunk`` granularity; two processes
meet at a localhost coordinator and all-gather over gloo; without a
coordinator nothing is brought up. Every process is joined with a
timeout.
"""
import os
import pathlib
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch.distributed as dist

from medaka_tpu import models as jax_models
from medaka_tpu import parallel as jax_parallel
from medaka_tpu import prediction as jax_prediction
from medaka_tpu import stitch as jax_stitch
from medaka_tpu.common import Region as JaxRegion
from medaka_tpu.features import CountsFeatureEncoder
from medaka_tpu.labels import HaploidLabelScheme
from medaka_tpu.models.gru import GRUModel
from medaka_tpu_torch import cli, datastore, parallel, prediction
from medaka_tpu_torch.common import Region
from medaka_tpu_torch.io.bam import BamRecord, write_bam
from medaka_tpu_torch.io.fastx import FastaReader, FastaWriter
from tests.torch_threads import one_thread  # noqa: F401

HERE = pathlib.Path(__file__).parent
#: the longest a process of these tests may run
TIMEOUT_S = 300


def _rand_seq(n, rng):
    return np.frombuffer(b"ACGT", np.uint8)[
        rng.integers(0, 4, n)].tobytes().decode()


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    """3-contig draft + staggered perfect reads + a tiny model bundle
    (tests/test_multihost.py's)."""
    base = tmp_path_factory.mktemp("torch_multihost")
    rng = np.random.default_rng(17)
    contigs = {"ctg{}".format(i): _rand_seq(4000 + 700 * i, rng)
               for i in range(3)}
    draft = base / "draft.fasta"
    with FastaWriter(str(draft)) as fw:
        for name, seq in contigs.items():
            fw.write(name, seq)
    records, lengths = [], []
    for rid, (name, seq) in enumerate(contigs.items()):
        lengths.append((name, len(seq)))
        for j, start in enumerate(range(0, len(seq) - 1500, 700)):
            piece = seq[start:start + 1500]
            records.append(BamRecord.build(
                query_name="{}_r{}".format(name, j), ref_id=rid,
                pos=start, seq=piece, qual=[25] * len(piece),
                cigar="{}=".format(len(piece)), flag=0, mapq=60))
    bam = base / "reads.bam"
    write_bam(str(bam), records, lengths)
    model = GRUModel(num_features=10, num_classes=5, gru_size=8)
    bundle = base / "model.tar.gz"
    jax_models.save_model(
        str(bundle), model, model.init_params(jax.random.PRNGKey(7)),
        feature_encoder=CountsFeatureEncoder(),
        label_scheme=HaploidLabelScheme())
    return {"base": base, "draft": draft, "bam": bam, "model": bundle}


def _inference_cmd(genome, output, extra=()):
    """f32, so the FASTA is comparable byte for byte with medaka_tpu's."""
    return [
        sys.executable, "-m", "medaka_tpu_torch", "inference",
        str(genome["bam"]), str(output), "--model", str(genome["model"]),
        "--cpu", "--chunk_len", "1000", "--chunk_ovlp", "100",
        "--batch_size", "4", "--bam_workers", "1", "--full_precision",
        "--quiet"] + list(extra)


def _run_all(cmds):
    """Run the commands concurrently; each must succeed in TIMEOUT_S."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              cwd=str(HERE.parent)) for cmd in cmds]
    try:
        for p in procs:
            stdout, _ = p.communicate(timeout=TIMEOUT_S)
            assert p.returncode == 0, stdout
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()


def _sequence(inputs, draft, out):
    assert cli.main(["sequence"] + [str(p) for p in inputs]
                    + [str(draft), str(out), "--quiet"]) == 0
    reader = FastaReader(str(out))
    return {r: reader.fetch(r) for r in reader.references}


def _hosts(genome, name, n, extra=()):
    out = genome["base"] / "{}.hdf".format(name)
    _run_all([_inference_cmd(genome, out, list(extra) + [
        "--num_processes", str(n), "--process_id", str(pid)])
        for pid in range(n)])
    files = [genome["base"] / "{}_host{}.hdf".format(name, pid)
             for pid in range(n)]
    for f in files:
        assert f.exists(), "missing per-process output {}".format(f)
    return files


@pytest.fixture(scope="module")
def single(genome):
    out = genome["base"] / "single.hdf"
    _run_all([_inference_cmd(genome, out)])
    return _sequence([out], genome["draft"],
                     genome["base"] / "single.fasta")


def test_single_process_matches_medaka_tpu(genome, single):
    """The one-process FASTA is medaka_tpu's (f32, one device)."""
    out = str(genome["base"] / "jax.hdf")
    jax_prediction.predict(
        str(genome["bam"]), out, model_path=str(genome["model"]),
        batch_size=4, chunk_len=1000, chunk_overlap=100, bam_workers=1,
        full_precision=True, mesh=jax_parallel.make_mesh(
            jax.devices()[:1], data=1))
    jax_stitch.stitch_to_fasta([out], str(genome["draft"]),
                               str(genome["base"] / "jax.fasta"))
    reader = FastaReader(str(genome["base"] / "jax.fasta"))
    assert {r: reader.fetch(r) for r in reader.references} == single


@pytest.mark.parametrize("n_procs", [2, 4])
def test_sharded_run_matches_single(genome, single, n_procs):
    """N concurrent processes -> merged FASTA == the one-process FASTA
    (so medaka_tpu's)."""
    files = _hosts(genome, "n{}".format(n_procs), n_procs)
    assert _sequence(files, genome["draft"], genome["base"] / "n{}.fasta"
                     .format(n_procs)) == single


def test_plan_work_shards_single_contig():
    """A one-contig genome divides at bam_chunk granularity: both
    processes get work, their union is the work list, and the shares are
    medaka_tpu's."""
    work = prediction.plan_work([Region("ctg", 0, 5_000_000)], bam=None,
                                bam_chunk=1_000_000, chunk_overlap=1000)
    theirs = jax_prediction.plan_work(
        [JaxRegion("ctg", 0, 5_000_000)], bam=None, bam_chunk=1_000_000,
        chunk_overlap=1000)
    assert len(work) >= 5
    shards = [parallel.shard_regions(work, 2, pid) for pid in range(2)]
    assert all(len(s) >= 2 for s in shards)
    assert sorted(shards[0] + shards[1],
                  key=lambda r: (r.ref_name, r.start)) == sorted(
        work, key=lambda r: (r.ref_name, r.start))
    for pid in range(2):
        assert [(r.ref_name, r.start, r.end) for r in shards[pid]] == [
            (r.ref_name, r.start, r.end)
            for r in jax_parallel.shard_regions(theirs, 2, pid)]


def test_sharded_single_contig_matches_single(genome):
    """2 processes each do part of one contig; merged == 1-process."""
    extra = ["--regions", "ctg0", "--bam_chunk", "1500"]
    out = genome["base"] / "one_ctg.hdf"
    _run_all([_inference_cmd(genome, out, extra)])
    want = _sequence([out], genome["draft"],
                     genome["base"] / "one_ctg.fasta")
    files = _hosts(genome, "one_ctg_n2", 2, extra)
    for f in files:
        # every process got a share of the single contig
        assert datastore.DataIndex(str(f)).samples, f
    assert _sequence(files, genome["draft"],
                     genome["base"] / "one_ctg_n2.fasta") == want


def test_process_id_is_checked(genome, tmp_path):
    """--num_processes without a --process_id in range raises
    medaka_tpu's message."""
    for extra in (["--num_processes", "2"],
                  ["--num_processes", "2", "--process_id", "2"]):
        with pytest.raises(ValueError,
                           match=r"--num_processes requires --process_id "
                                 r"in \[0, 2\)"):
            cli.main(_inference_cmd(genome, tmp_path / "x.hdf", extra)[3:])


def test_localhost_coordinator_allgather(tmp_path):
    """initialize_distributed with 127.0.0.1:<free port>: 2 processes
    (gloo) all-gather their ids."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = "127.0.0.1:{}".format(port)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(HERE.parent) + ":" + env.get("PYTHONPATH", "")
    results = [tmp_path / "dist{}.txt".format(pid) for pid in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, str(HERE / "torch_multihost_worker.py"), coord,
         "2", str(pid), str(results[pid])], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, cwd=str(HERE.parent), env=env)
        for pid in range(2)]
    try:
        for p in procs:
            stdout, _ = p.communicate(timeout=120)
            assert p.returncode == 0, stdout
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, res in enumerate(results):
        assert res.read_text() == "DIST_OK {} [0, 1] gloo\n".format(pid)


def test_coordinatorless_multi_process_init():
    """--num_processes without --coordinator brings up no process group
    (region striding needs no collective), as in medaka_tpu; one process
    is a no-op too."""
    parallel.initialize_distributed(None, 2, 1)
    parallel.initialize_distributed("127.0.0.1:1", 1, 0)
    assert not dist.is_initialized()
