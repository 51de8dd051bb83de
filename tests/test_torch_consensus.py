"""The port's subcommands from reads (``consensus``, ``consensus
--direct``, ``consensus_joint``, ``variant``) against ``medaka_tpu``'s on
the CPU, and the floors of ``chip_smoke.py`` phase 21.

- ``consensus --cpu`` writes ``medaka_tpu consensus``'s BAM and FASTA
  bytes, from a FASTQ of a 30 kb ``create_synth_bam`` genome, with the
  bundled ``gru256_lambda_demo`` at ``--chunk_len 2000``; with ``-q`` the
  same sequence, qualities within 1 (bf16 rounding, ROADMAP.md queue 3
  item 2), and from each package's full-precision probabilities the same
  FASTQ bytes but for two qualities on a rounding boundary, named in the
  test. ``consensus --direct`` writes the bytes of the HDF5
  route. ``medaka_tpu`` runs on one JAX device: over the test
  session's eight virtual devices its bf16 rounding can move a near-tie
  column (queue 3 item 2 too).
- ``consensus_joint`` with a 20-feature model (``GRUModel(num_features=20,
  gru_size=8)``, two datatypes r9 and r10) whose JAX weights the port
  carries with ``GRUModel.load_jax_params``: the same FASTA.
- ``variant`` at ``--threads 1``, held as tests/test_torch_variant.py
  holds ``vcf``: in bf16 the same records, QUAL and GQ within 1; in full
  precision (probability files of each package's f32 inference, which
  ``variant`` then reuses) the same bytes for ``medaka.vcf`` and
  ``medaka.annotated.vcf``, but for one QUAL that sits on a 3-decimal
  rounding boundary, named in the test.
- The subcommands that run the model raise without a GPU unless ``--cpu``
  is given, before they map anything.
- The floors of phase 21 (b) and (c) (``testing.FROM_READS_FLOORS``) are
  met on a 0.1 Mb ``create_variant_bam`` genome mapped from its reads.
"""
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from medaka_tpu import cli as jcli
from medaka_tpu import models as jmodels
from medaka_tpu import prediction as jprediction
from medaka_tpu_torch import cli, testing
from medaka_tpu_torch.io.fastx import FastaReader
from tests.torch_threads import one_thread  # noqa: F401

CHUNKS = ["--chunk_len", "2000", "--chunk_ovlp", "200", "-b", "8"]


@pytest.fixture
def one_jax_device(monkeypatch):
    """``medaka_tpu``'s predictor builds its mesh over ``jax.devices()``:
    hold it to the first device, as the port runs on one."""
    first = jax.devices()[:1]
    monkeypatch.setattr(jax, "devices", lambda *args, **kw: first)


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """A 30 kb ``create_synth_bam`` genome at depth 10 (3 kb reads) as
    FASTQ, dealt over two files for ``consensus_joint``."""
    d = tmp_path_factory.mktemp("cons")
    bam, draft = testing.create_synth_bam(str(d / "synth.bam"), ref_mb=0.03,
                                          depth=10, seed=2, read_len=3000)
    fastq = str(d / "reads.fastq")
    truth = testing.write_reads_fastq(bam, fastq)
    halves = [str(d / "r9.fastq"), str(d / "r10.fastq")]
    testing.write_reads_fastq(bam, halves)
    return {"dir": d, "fastq": fastq, "draft": draft, "truth": truth,
            "halves": halves}


def _fastq(path):
    with open(path) as fh:
        lines = fh.read().split("\n")
    return lines[1], np.frombuffer(lines[3].encode(), np.uint8).astype(int)


def _f32_probabilities(bam, outputs, bundle, chunks=(2000, 200)):
    """Each package's full-precision probabilities of ``bam`` as
    ``consensus_probs.hdf`` in its output directory ({"port": dir, "jax":
    dir}), with the mapped BAM beside them: the stages that the
    subcommands from reads then skip."""
    name = os.path.basename(bam)
    for path in outputs.values():
        os.makedirs(path)
        for suffix in ("", ".bai"):
            shutil.copy(bam + suffix, os.path.join(path, name + suffix))
    assert cli.main([
        "inference", bam, os.path.join(outputs["port"], "consensus_probs.hdf"),
        "--model", bundle, "--cpu", "--full_precision", "--chunk_len",
        str(chunks[0]), "--chunk_ovlp", str(chunks[1]), "--batch_size",
        "8"]) == 0
    jprediction.predict(
        bam, os.path.join(outputs["jax"], "consensus_probs.hdf"),
        model_path=jmodels.resolve_model(bundle),
        full_precision=True, chunk_len=chunks[0], chunk_overlap=chunks[1],
        batch_size=8)


#: the columns of this run where the two packages' f32 probabilities
#: (their scans sum in another order) round to phred qualities either side
#: of an integer: column -> (port's quality, medaka_tpu's quality)
#: (ROADMAP.md queue 3 item 2)
F32_QUALITY_COLUMNS = {23301: (21, 20), 27200: (25, 26)}


def test_consensus_matches(synth, one_jax_device):
    """``consensus`` (FASTA, then ``-q`` reusing the stages): the mapped
    BAM and the FASTA are ``medaka_tpu consensus``'s bytes, every read
    placed at its true start; the FASTQ has the same sequence and, in
    bf16, qualities within 1 (the two packages round bf16 at other points,
    ROADMAP.md queue 3 item 2); from each package's full-precision
    probabilities the FASTQ is the same bytes but for the two qualities of
    :data:`F32_QUALITY_COLUMNS`. ``--direct`` writes the
    bytes of the HDF5 route, FASTA and FASTQ."""
    d = synth["dir"]
    args = [synth["fastq"], synth["draft"], "--model",
            "gru256_lambda_demo"] + CHUNKS
    port, ref = str(d / "port"), str(d / "jax")
    for extra in ([], ["-q"]):
        assert cli.main(["consensus"] + args + ["-o", port, "--cpu"]
                        + extra) == 0
        assert jcli.main(["consensus"] + args + ["-o", ref] + extra) == 0
    for name in ("calls_to_draft.bam", "calls_to_draft.bam.bai",
                 "consensus.fasta"):
        assert _read(os.path.join(port, name)) == \
            _read(os.path.join(ref, name)), name
    (seq, qual), (ref_seq, ref_qual) = (
        _fastq(os.path.join(out, "consensus.fastq")) for out in (port, ref))
    assert seq == ref_seq and len(qual) == len(ref_qual) > 25000
    assert np.abs(qual - ref_qual).max() <= 1
    mapped, wrong = testing.placement(
        os.path.join(port, "calls_to_draft.bam"), synth["truth"])
    assert mapped == 1.0 and not wrong
    for extra in ([], ["-q"]):
        direct = str(d / "direct{}".format("".join(extra)))
        assert cli.main(["consensus"] + args + ["-o", direct, "--cpu",
                                                "--direct"] + extra) == 0
        name = "consensus.fastq" if extra else "consensus.fasta"
        assert _read(os.path.join(direct, name)) == \
            _read(os.path.join(port, name)), name

    f32 = {k: str(d / (k + "_f32")) for k in ("port", "jax")}
    _f32_probabilities(os.path.join(port, "calls_to_draft.bam"), f32,
                       "gru256_lambda_demo")
    assert cli.main(["consensus"] + args + ["-o", f32["port"], "--cpu",
                                            "-q"]) == 0
    assert jcli.main(["consensus"] + args + ["-o", f32["jax"], "-q"]) == 0
    (seq, qual), (ref_seq, ref_qual) = (
        _fastq(os.path.join(out, "consensus.fastq")) for out in f32.values())
    assert seq == ref_seq
    moved = np.flatnonzero(qual != ref_qual)
    assert {int(i): (int(qual[i]) - 33, int(ref_qual[i]) - 33)
            for i in moved} == F32_QUALITY_COLUMNS


def test_consensus_joint_matches(synth, tmp_path, one_jax_device):
    """Two read sets tagged DT r9 and r10, a 20-feature model at
    ``gru_size`` 8 (seeded JAX weights carried into the port's model with
    ``load_jax_params``): the merged BAM and the FASTA are
    ``medaka_tpu``'s."""
    from medaka_tpu.features import CountsFeatureEncoder as JEncoder
    from medaka_tpu.labels import HaploidLabelScheme as JScheme
    from medaka_tpu.models import save_model as jsave_model
    from medaka_tpu.models.gru import GRUModel as JGRUModel
    from medaka_tpu_torch import models
    from medaka_tpu_torch.features import CountsFeatureEncoder
    from medaka_tpu_torch.labels import HaploidLabelScheme
    from medaka_tpu_torch.models.gru import GRUModel

    jmodel = JGRUModel(num_features=20, gru_size=8)
    params = jmodel.init_params(jax.random.PRNGKey(0))
    jax_bundle = str(tmp_path / "jax_joint.tar.gz")
    jsave_model(jax_bundle, jmodel, params,
                feature_encoder=JEncoder(dtypes=("r9", "r10")),
                label_scheme=JScheme())
    model = GRUModel(num_features=20, gru_size=8).load_jax_params(
        jax.tree.map(np.asarray, params))
    port_bundle = models.save_model(
        str(tmp_path / "port_joint.tar.gz"), model,
        CountsFeatureEncoder(dtypes=("r9", "r10")), HaploidLabelScheme())
    reads = []
    for path, value in zip(synth["halves"], ("r9", "r10")):
        reads += ["-i", path, "-v", value]
    common_args = ["consensus_joint"] + reads + [
        "-d", synth["draft"], "-t", "2"] + CHUNKS
    port, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    assert cli.main(common_args + ["-o", port, "-m", port_bundle,
                                   "--cpu"]) == 0
    assert jcli.main(common_args + ["-o", ref, "-m", jax_bundle]) == 0
    for name in ("calls_to_draft.bam", "consensus.fasta"):
        assert _read(os.path.join(port, name)) == \
            _read(os.path.join(ref, name)), name
    with FastaReader(os.path.join(port, "consensus.fasta")) as fr:
        assert len(fr.fetch("synth")) > 0.9 * 30000
    with pytest.raises(ValueError, match="one -v value"):
        cli.main(["consensus_joint", "-i", synth["fastq"], "-v", "r9",
                  "-v", "r10", "-d", synth["draft"], "-m", port_bundle,
                  "-o", str(tmp_path / "x"), "--cpu"])


@pytest.fixture(scope="module")
def variant_genome(tmp_path_factory):
    """A 30 kb ``create_variant_bam`` genome at depth 20 as FASTQ."""
    d = tmp_path_factory.mktemp("variant")
    bam, ref, truth_vcf, records = testing.create_variant_bam(
        str(d / "lift.bam"), ref_mb=0.03, depth=20, seed=1)
    fastq = str(d / "reads.fastq")
    testing.write_reads_fastq(bam, fastq)
    return {"dir": d, "fastq": fastq, "ref": ref, "truth": truth_vcf}


def _rows(path):
    return [line.split("\t") for line in _read(path).decode().split("\n")
            if line and not line.startswith("#")]


#: the one record of these runs where the two packages' f32 probabilities
#: (their scans sum in another order) fall on either side of QUAL's
#: 3-decimal rounding: POS -> (port's text, medaka_tpu's text), as
#: tests/test_torch_variant.py names its own (ROADMAP.md queue 3 item 2)
F32_ROUNDING_LINES = {29210: ("\t7.152\t", "\t7.153\t")}


def test_variant_matches(variant_genome, one_jax_device):
    """``variant --threads 1``: the same mapped BAM; in bf16 the same
    records (site, alleles, genotype, INFO annotations), QUAL and GQ
    within 1 (ROADMAP.md queue 3 item 2); from each package's
    full-precision probabilities the same ``medaka.vcf`` and
    ``medaka.annotated.vcf`` bytes but for the one QUAL rounding of
    :data:`F32_ROUNDING_LINES`."""
    d = variant_genome["dir"]
    args = [variant_genome["fastq"], variant_genome["ref"], "--model",
            "gru256_variant_demo", "-t", "1"] + CHUNKS
    out = {}
    for tag, main, extra in (("port", cli.main, ["--cpu"]),
                             ("jax", jcli.main, [])):
        out[tag] = str(d / tag)
        assert main(["variant"] + args + ["-o", out[tag]] + extra) == 0
    bam = os.path.join(out["port"], "calls_to_ref.bam")
    assert _read(bam) == _read(os.path.join(out["jax"], "calls_to_ref.bam"))
    for name in ("medaka.vcf", "medaka.annotated.vcf"):
        got, want = (_rows(os.path.join(out[k], name))
                     for k in ("port", "jax"))
        assert len(got) == len(want) > 30
        assert [r[:5] + r[6:9] + [r[9].split(":")[0]] for r in got] == \
            [r[:5] + r[6:9] + [r[9].split(":")[0]] for r in want]
        for a, b in zip(got, want):
            assert abs(float(a[5]) - float(b[5])) <= 1.0
            assert abs(int(a[9].split(":")[1])
                       - int(b[9].split(":")[1])) <= 1

    f32 = {k: str(d / (k + "_f32")) for k in ("port", "jax")}
    _f32_probabilities(bam, f32, "gru256_variant_demo")
    for tag, main, extra in (("port", cli.main, ["--cpu"]),
                             ("jax", jcli.main, [])):
        assert main(["variant"] + args + ["-o", f32[tag]] + extra) == 0
    for name in ("medaka.vcf", "medaka.annotated.vcf"):
        lines, ref_lines = (_read(os.path.join(f32[k], name)).decode()
                            .split("\n") for k in ("port", "jax"))
        assert len(lines) == len(ref_lines) > 30
        moved = {}
        for line, ref_line in zip(lines, ref_lines):
            if line != ref_line:
                pos = int(line.split("\t")[1])
                port_text, jax_text = F32_ROUNDING_LINES[pos]
                assert line.replace(port_text, jax_text, 1) == ref_line
                moved[pos] = line
        assert sorted(moved) == sorted(F32_ROUNDING_LINES), name


@pytest.mark.parametrize("command", ["consensus", "variant",
                                     "consensus_joint"])
def test_no_gpu_raises_before_mapping(synth, tmp_path, command):
    """Without ``--cpu`` the model's subcommands raise on a machine
    without a GPU, before any stage has written an output."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a GPU")
    out = str(tmp_path / "out")
    if command == "consensus_joint":
        args = ["consensus_joint", "-i", synth["fastq"], "-v", "r9", "-d",
                synth["draft"], "-m", "gru256_lambda_demo", "-o", out]
    else:
        args = [command, synth["fastq"], synth["draft"], "-m",
                "gru256_lambda_demo", "-o", out]
    with pytest.raises(RuntimeError, match="no GPU"):
        cli.main(args)
    assert not os.path.exists(out) or not os.listdir(out)


@pytest.mark.parametrize("seed", [0])
def test_from_reads_floors_on_the_cpu_path(seed, tmp_path):
    """The floors of ``chip_smoke.py`` phase 21 (b) and (c)
    (``testing.FROM_READS_FLOORS``) on a 0.1 Mb ``create_variant_bam``
    genome at depth 30 mapped from its reads, through the port's CPU path
    at the default chunks and in bf16, as on the card: ``variant`` with
    annotation (every record annotated), then ``consensus`` with the same
    bundle on the same mapped BAM and ``tools consensus2vcf`` in mode NW.
    Measured here at seeds 0, 1 and 2 (2 threads): ``variant`` SNP P/R/F1
    0.9375-0.9848/1.0/0.9677-0.9924, indel 0.8966-0.9255/0.9774-0.993/
    0.9353-0.9521; ``consensus2vcf`` SNP 0.9333-0.9848/1.0/0.9655-0.9924,
    indel 0.8966-0.9255/0.9774-0.993/0.9353-0.9521."""
    bam, ref, truth, _ = testing.create_variant_bam(
        str(tmp_path / "lift.bam"), ref_mb=0.1, depth=30, seed=seed)
    fastq = str(tmp_path / "reads.fastq")
    testing.write_reads_fastq(bam, fastq)
    var, cons = str(tmp_path / "var"), str(tmp_path / "cons")
    assert cli.main(["variant", fastq, ref, "-o", var, "--model",
                     "gru256_variant_demo", "--cpu", "-b", "8", "-t",
                     "2"]) == 0
    annotated = os.path.join(var, "medaka.annotated.vcf")
    score = testing.score_vcf(truth, annotated, ref)
    floors = testing.FROM_READS_FLOORS
    assert not testing.below_floors(score, floors["variant"]), score
    for row in _rows(annotated):
        assert {"DP", "DPS", "DPSP", "SR", "SC", "AR"} <= \
            {kv.split("=")[0] for kv in row[7].split(";")}
    os.makedirs(cons)
    for suffix in ("", ".bai"):
        shutil.copy(os.path.join(var, "calls_to_ref.bam" + suffix),
                    os.path.join(cons, "calls_to_draft.bam" + suffix))
    assert cli.main(["consensus", fastq, ref, "-o", cons, "--model",
                     "gru256_variant_demo", "--cpu", "-b", "8", "-t",
                     "2"]) == 0
    prefix = str(tmp_path / "c2v")
    assert cli.main(["tools", "consensus2vcf",
                     os.path.join(cons, "consensus.fasta"), ref,
                     "--out_prefix", prefix, "--mode", "NW"]) == 0
    score = testing.score_vcf(truth, prefix + ".vcf", ref)
    assert not testing.below_floors(score, floors["consensus2vcf"]), score
