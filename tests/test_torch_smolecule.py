"""The port's smolecule workflow and native POA against ``medaka_tpu``'s on
the CPU, and the two command lines' parsers.

- ``native.poa_consensus`` gives ``medaka_tpu.native.poa_consensus``'s
  string on 200 seeded cases: 0, 1 and up to 20 sequences of 1-2000
  bases with 0-15% errors.
- ``smolecule`` with ``MajorityVoteModel`` on a seeded grouped-subread
  FASTA (``testing.write_subreads_fasta``) writes ``medaka_tpu``'s
  ``poa.fasta``, the records of ``subreads_to_poa.bam`` and
  ``consensus.fasta`` (at ``threads`` 1) and ``consensus.fastq`` (at 2);
  the depth and length filters and one file per molecule behave the
  same; the polished consensus stays near its POA draft, as
  tests/test_smolecule.py holds it on the reference's data.
- ``smolecule`` with ``gru256_lambda_demo`` in bf16 (two molecules of
  600-800 bases: one batch of 32 rows, the split path's batch on the
  card): probabilities within 2e-2, the argmax the same but at near ties
  (two best classes within 4e-2, ROADMAP.md queue 3 item 2), the FASTA
  the same bytes when no argmax differs. ``medaka_tpu`` runs on one JAX
  device, as the port does.
- ``smolecule --cpu`` writes the library call's bytes; without ``--cpu``
  and without a GPU it raises before any host stage.
- For every subcommand that both packages have, the two parsers take
  the same options, defaults, choices and ``nargs``; the port adds only
  ``--cpu``.
"""
import argparse
import os

import jax
import numpy as np
import pytest
import torch

from medaka_tpu import cli as jcli
from medaka_tpu import native as jnative
from medaka_tpu import smolecule as jsmolecule
from medaka_tpu.features import CountsFeatureEncoder as JCounts
from medaka_tpu.labels import HaploidLabelScheme as JHaploid
from medaka_tpu.models.majority import MajorityVoteModel as JMajority
from medaka_tpu_torch import cli, models, native, smolecule, testing
from medaka_tpu_torch.features import CountsFeatureEncoder
from medaka_tpu_torch.io.bam import BamReader
from medaka_tpu_torch.io.fastx import read_fastx
from medaka_tpu_torch.labels import HaploidLabelScheme
from medaka_tpu_torch.models.majority import MajorityVoteModel
from tests.torch_precision_runs import probs
from tests.torch_threads import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = os.path.join(REPO, "medaka_tpu", "data",
                     "gru256_lambda_demo_model_pt.tar.gz")
#: the majority-vote runs' chunks, as tests/test_smolecule.py's
MAJORITY_RUN = dict(chunk_len=500, chunk_ovlp=100, batch_size=4)


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


# ---------------------------------------------------------------------------
# native POA
# ---------------------------------------------------------------------------


def _noisy(rng, seq, rate):
    out = []
    for ch in seq:
        r = rng.random()
        if r < rate / 4:
            continue
        if r < rate / 2:
            out.append(str(rng.choice(list("ACGT"))))
            out.append(ch)
        elif r < rate:
            out.append(str(rng.choice([c for c in "ACGT" if c != ch])))
        else:
            out.append(ch)
    return "".join(out)


POA_GROUPS = 8
POA_CASES = 25


@pytest.mark.parametrize("group", range(POA_GROUPS))
def test_poa_consensus_matches(group):
    """25 cases a group: the first group starts with no sequence, one and
    two; the rest draw 1-2000 bases (log-uniform) and 2-20 sequences,
    fewer of the longest (at most 4000 // length, for the time), at 0-15%
    errors."""
    rng = np.random.default_rng(1000 + group)
    for case in range(POA_CASES):
        if group == 0 and case < 3:
            n = case
        else:
            n = None
        length = int(np.exp(rng.uniform(0, np.log(2000))))
        if n is None:
            n = int(rng.integers(2, min(20, max(2, 4000 // length)) + 1))
        rate = float(rng.uniform(0, 0.15))
        base = "".join(rng.choice(list("ACGT"), length))
        seqs = [_noisy(rng, base, rate) or base[:1] for _ in range(n)]
        want = jnative.poa_consensus(seqs)
        got = native.poa_consensus(seqs)
        assert got == want, (group, case, n, length, rate)


# ---------------------------------------------------------------------------
# smolecule with the majority-vote model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def subreads(tmp_path_factory):
    """Eight molecules of ~500 bases with 6 subreads at 8% errors, then
    one with two subreads (under the default depth 3) and one of ~300
    bases (under the default length filter of 400)."""
    d = tmp_path_factory.mktemp("subreads")
    path = str(d / "subreads.fasta")
    truth = testing.write_subreads_fasta(
        path, n_molecules=8, length=500, n_subreads=6, error=0.08, seed=3)
    few = str(d / "few.fasta")
    testing.write_subreads_fasta(few, n_molecules=1, length=500,
                                 n_subreads=2, seed=4)
    short = str(d / "short.fasta")
    testing.write_subreads_fasta(short, n_molecules=1, length=300,
                                 n_subreads=6, seed=5)
    with open(path, "a") as out:
        for src, name in ((few, "molfew"), (short, "molshort")):
            for rec in read_fastx(src):
                out.write(">{}_{}\n{}\n".format(
                    name, rec.name.split("_")[1], rec.sequence))
    return path, truth


def _majority_jax(fastx, out, threads, qualities):
    return jsmolecule.smolecule(
        fastx, out, model=JMajority(), params={},
        feature_encoder=JCounts(), label_scheme=JHaploid(),
        threads=threads, qualities=qualities, **MAJORITY_RUN)


def _majority_port(fastx, out, threads, qualities):
    return smolecule.smolecule(
        fastx, out, model=MajorityVoteModel(),
        feature_encoder=CountsFeatureEncoder(),
        label_scheme=HaploidLabelScheme(), threads=threads,
        qualities=qualities, device="cpu", **MAJORITY_RUN)


@pytest.fixture(scope="module")
def majority_runs(subreads, tmp_path_factory):
    """Both packages at threads 1 (FASTA) and 2 (FASTQ)."""
    path, _ = subreads
    d = tmp_path_factory.mktemp("majority")
    out = {}
    for threads, qualities in ((1, False), (2, True)):
        dirs = []
        for tag, run in (("jax", _majority_jax), ("port", _majority_port)):
            target = str(d / "{}{}".format(tag, threads))
            run(path, target, threads, qualities)
            dirs.append(target)
        out[threads] = tuple(dirs)
    return out


def _bam_records(path):
    with BamReader(path) as reader:
        refs = list(zip(reader.references, reader.lengths))
        recs = [(r.query_name, r.flag, r.ref_id, r.pos, r.mapq,
                 r.cigarstring, r.query_sequence) for r in reader]
    return refs, recs


@pytest.mark.parametrize("threads", [1, 2])
def test_majority_poa_and_bam(majority_runs, threads):
    jdir, pdir = majority_runs[threads]
    poa = _read(os.path.join(pdir, "poa.fasta"))
    assert poa == _read(os.path.join(jdir, "poa.fasta"))
    # the default filters drop the too-few and too-short molecules
    assert b">molfew\n" not in poa and b">molshort\n" not in poa
    refs, recs = _bam_records(os.path.join(pdir, "subreads_to_poa.bam"))
    assert (refs, recs) == _bam_records(
        os.path.join(jdir, "subreads_to_poa.bam"))
    assert len(refs) == 8 and len(recs) >= 40


@pytest.mark.parametrize("threads,ext", [(1, "fasta"), (2, "fastq")])
def test_majority_consensus(majority_runs, threads, ext):
    jdir, pdir = majority_runs[threads]
    got = _read(os.path.join(pdir, "consensus." + ext))
    assert got == _read(os.path.join(jdir, "consensus." + ext))
    assert got.count(b"\n+\n" if ext == "fastq" else b">") == 8


def test_majority_consensus_near_draft(majority_runs):
    """tests/test_smolecule.py's bounds on the reference's data: the
    polished consensus over 90% of its POA draft's length, and within
    12% of it in edits."""
    _, pdir = majority_runs[1]
    poa = {r.name: r.sequence for r in read_fastx(
        os.path.join(pdir, "poa.fasta"))}
    records = list(read_fastx(os.path.join(pdir, "consensus.fasta")))
    assert len(records) == len(poa)
    for rec in records:
        draft = poa[rec.name.split("_")[0]]
        assert len(rec.sequence) > 0.9 * len(draft)
        assert native.edit_distance(rec.sequence, draft) < 0.12 * len(draft)


def test_poa_near_truth(majority_runs, subreads):
    """Two POA rounds over 6 subreads at 8% errors land near each true
    molecule."""
    _, truth = subreads
    _, pdir = majority_runs[1]
    for rec in read_fastx(os.path.join(pdir, "poa.fasta")):
        if rec.name in truth:
            assert native.edit_distance(rec.sequence, truth[rec.name]) \
                <= 0.03 * len(truth[rec.name])


@pytest.mark.parametrize("depth,length", [
    (1, 0), (3, 0), (7, 0), (3, 400), (1, 700)])
def test_filters_match(subreads, depth, length):
    path, _ = subreads

    def summary(reads):
        return [(r.name, [tuple(s) for s in r.subreads]) for r in reads]

    want = summary(jsmolecule.Read.multi_from_fastx(
        path, depth_filter=depth, length_filter=length))
    got = summary(smolecule.Read.multi_from_fastx(
        path, depth_filter=depth, length_filter=length))
    assert got == want


def test_read_orientation_and_rounds_match(subreads):
    """Orientation by SW score, interleaving, each POA round and the
    re-alignments to the consensus give ``medaka_tpu``'s."""
    path, _ = subreads
    for jread, read in zip(jsmolecule.Read.multi_from_fastx(path),
                           smolecule.Read.multi_from_fastx(path)):
        assert read.orient_subreads() == [
            tuple(a) for a in jread.orient_subreads()]
        read.initialize()
        jread.initialize()
        assert read._orient == jread._orient
        assert read._orient[:2] == [True, False]
        orients, reads = read.interleaved_subreads
        jorients, jreads = jread.interleaved_subreads
        assert orients == jorients and [tuple(r) for r in reads] == [
            tuple(r) for r in jreads]
        for _ in range(2):
            assert read.poa_consensus() == jread.poa_consensus()
        assert read.align_to_template(read.consensus, read.name) == [
            tuple(a) for a in jread.align_to_template(
                jread.consensus, jread.name)]


def test_one_file_per_molecule(subreads, tmp_path):
    """Many inputs: one molecule a file, named after the file."""
    path, _ = subreads
    files = []
    for read in list(smolecule.Read.multi_from_fastx(path))[:3]:
        name = str(tmp_path / "{}.fasta".format(read.name))
        with open(name, "w") as fh:
            for sub in read.subreads:
                fh.write(">{}\n{}\n".format(sub.name, sub.seq))
        files.append(name)
    jout = _majority_jax(files, str(tmp_path / "jax"), 1, False)
    out = _majority_port(files, str(tmp_path / "port"), 1, False)
    assert _read(out) == _read(jout)
    assert _read(out).count(b">") == 3
    one = smolecule.Read.from_fastx(files[0], name="named")
    assert one.name == "named" and one.nseqs == 6


# ---------------------------------------------------------------------------
# smolecule with the bundled GRU in bf16
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def gru_runs(tmp_path_factory):
    """Two molecules of 600-800 bases (one batch of 32 rows at chunk 1000,
    overlap 500), through each package's smolecule at its defaults
    (bf16, batch 32); ``medaka_tpu`` on one JAX device."""
    d = tmp_path_factory.mktemp("gru")
    path = str(d / "subreads.fasta")
    testing.write_subreads_fasta(path, n_molecules=2, length=700,
                                 n_subreads=8, error=0.08, seed=7)
    first = jax.devices()[:1]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "devices", lambda *args, **kw: first)
        jsmolecule.smolecule(path, str(d / "jax"), model_path=MODEL,
                             threads=2)
    smolecule.smolecule(path, str(d / "port"), model_path=MODEL,
                        threads=2, device="cpu")
    return str(d / "jax"), str(d / "port")


def test_gru_probabilities_match(gru_runs):
    jdir, pdir = gru_runs
    want = probs(os.path.join(jdir, "consensus.hdf"))
    got = probs(os.path.join(pdir, "consensus.hdf"))
    assert sorted(got) == sorted(want) and len(got) == 2
    assert max(np.abs(got[k] - want[k]).max() for k in want) <= 2e-2


def test_gru_consensus_matches(gru_runs):
    jdir, pdir = gru_runs
    want = probs(os.path.join(jdir, "consensus.hdf"))
    got = probs(os.path.join(pdir, "consensus.hdf"))
    n_diff = 0
    for key in want:
        differ = want[key].argmax(-1) != got[key].argmax(-1)
        top2 = np.sort(want[key], axis=-1)[:, -2:]
        assert np.all((top2[:, 1] - top2[:, 0])[differ] <= 4e-2)
        n_diff += int(differ.sum())
    fastas = [_read(os.path.join(d, "consensus.fasta")) for d in gru_runs]
    if n_diff == 0:
        assert fastas[0] == fastas[1]
    else:
        got_seq = [r.sequence for r in read_fastx(
            os.path.join(pdir, "consensus.fasta"))]
        want_seq = [r.sequence for r in read_fastx(
            os.path.join(jdir, "consensus.fasta"))]
        assert sum(native.edit_distance(a, b) for a, b in zip(
            got_seq, want_seq)) <= n_diff


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------


def test_cli_cpu_gives_library_bytes(subreads, tmp_path):
    """``smolecule --cpu --model <majority bundle>`` at the CLI's defaults
    writes the library call's consensus; without ``--cpu`` and without a
    GPU it raises before any host stage (no output directory)."""
    path, _ = subreads
    bundle = models.save_model(
        str(tmp_path / "majority.tar.gz"), MajorityVoteModel(),
        CountsFeatureEncoder(), HaploidLabelScheme())
    assert cli.main(["smolecule", str(tmp_path / "cli"), path, "--model",
                     bundle, "--cpu", "--quiet"]) == 0
    lib = smolecule.smolecule(
        path, str(tmp_path / "lib"), model=MajorityVoteModel(),
        feature_encoder=CountsFeatureEncoder(),
        label_scheme=HaploidLabelScheme(), device="cpu")
    assert _read(str(tmp_path / "cli" / "consensus.fasta")) == _read(lib)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no GPU"):
            cli.main(["smolecule", str(tmp_path / "gpu"), path, "--model",
                      bundle, "--quiet"])
        assert not os.path.exists(str(tmp_path / "gpu"))


class _Parsed(Exception):
    pass


def _jax_parser():
    """``medaka_tpu``'s parser: its ``main`` builds it and parses."""
    def grab(self, *args, **kwargs):
        raise _Parsed(self)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(_Parsed) as caught:
            jcli.main([])
    return caught.value.args[0]


def _subparsers(parser, prefix=()):
    out = {}
    for action in parser._actions:
        if isinstance(action, argparse._SubParsersAction):
            for name, sub in action.choices.items():
                out[prefix + (name,)] = sub
                out.update(_subparsers(sub, prefix + (name,)))
    return out


def _options(parser):
    return {
        tuple(a.option_strings) or (a.dest,): (
            a.dest, a.default, a.choices and list(a.choices), a.nargs,
            a.required, type(a).__name__, getattr(a.type, "__name__", None))
        for a in parser._actions
        if not isinstance(a, (argparse._HelpAction,
                              argparse._SubParsersAction))}


JAX_SUBCOMMANDS = _subparsers(_jax_parser())
PORT_SUBCOMMANDS = _subparsers(cli.build_parser())
SHARED = sorted(set(JAX_SUBCOMMANDS) & set(PORT_SUBCOMMANDS))


def test_workflow_subcommands_present():
    """Every subcommand of ``medaka_tpu``'s parser, at any depth (``tools
    <name>`` included), is in the port's."""
    assert ("smolecule",) in SHARED and ("tandem",) in SHARED
    assert set(JAX_SUBCOMMANDS) - set(PORT_SUBCOMMANDS) == set()
    assert len([k for k in JAX_SUBCOMMANDS if k[:1] == ("tools",)
                and len(k) == 2]) == 20


@pytest.mark.parametrize("command", SHARED, ids=" ".join)
def test_parsers_match(command):
    want = _options(JAX_SUBCOMMANDS[command])
    got = _options(PORT_SUBCOMMANDS[command])
    assert set(got) - set(want) <= {("--cpu",)}
    assert {k: got.get(k) for k in want} == want
