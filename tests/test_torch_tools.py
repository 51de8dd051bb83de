"""Every ``tools`` subcommand the port added, and the console scripts,
against ``medaka_tpu`` on the CPU.

Each subcommand runs through both packages' ``cli.main`` on the same
input files (in two copies where it writes beside its input or into the
working directory); the files it writes and what it prints must be
``medaka_tpu``'s bytes. Inputs, all made here from seeds:

- haploid and diploid VCFs: the truth VCFs of two 20 kb
  ``testing.create_variant_bam`` genomes, and the ``vcf`` and ``snp``
  calls (both packages', the same bytes) on one probability file a genome
  of random probabilities over its reference;
- 30 seeded pairs of random haploid VCFs over random two-contig
  references, with SNPs, MNPs, insertions and deletions that overlap and
  abut across (and abut within) the haplotypes, for ``haploid2diploid``
  under every combination of ``--adjacent``, ``--discard_phase`` and
  ``--split_mnp``;
- the genomes' BAMs (``pileup_counts``, ``prepare_tagged_bam``,
  ``is_compatible``) and the bundled models (``get_model_dtypes``,
  ``get_alignment_params``, ``is_compatible``).
"""
import contextlib
import io
import os
import shutil

import numpy as np
import pytest

from medaka_tpu import cli as jcli
from medaka_tpu import vcf as jvcf
from medaka_tpu_torch import cli, datastore, labels, stitch, testing, vcf
from medaka_tpu_torch.common import Sample, make_positions
from medaka_tpu_torch.io.bam import BamReader
from medaka_tpu_torch.io.fastx import FastaReader, FastaWriter
from tests.torch_threads import one_thread  # noqa: F401

DATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "medaka_tpu", "data")
BUNDLES = sorted(n[:-len(".tar.gz")] for n in os.listdir(DATA)
                 if n.endswith(".tar.gz"))


def _run(main, argv, cwd=None):
    """(return code or exception type, standard output, standard error)."""
    out, err = io.StringIO(), io.StringIO()
    here = os.getcwd()
    try:
        if cwd:
            os.chdir(cwd)
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            try:
                rc = main(argv)
            except Exception as e:  # noqa: BLE001 - compared by type
                rc = type(e)
    finally:
        os.chdir(here)
    return rc, out.getvalue(), err.getvalue()


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def _random_probabilities(rng, ref_seq, diploid):
    """Three overlapping samples of random probabilities over a
    reference: mostly its base (a gap at the insertion columns), a few
    columns another class."""
    scheme = labels.DiploidLabelScheme() if diploid \
        else labels.HaploidLabelScheme()
    n = len(ref_seq)
    out = []
    for start, end in ((0, n // 2 + 500), (n // 2 - 500, n)):
        majors, minors = [], []
        for m in range(start, end):
            majors.append(m)
            minors.append(0)
            if rng.random() < 0.03:
                majors.append(m)
                minors.append(1)
        logits = rng.normal(0, 1.0, (len(majors), scheme.num_classes))
        for i, (m, mi) in enumerate(zip(majors, minors)):
            base = "*" if mi else ref_seq[m]
            call = scheme._encoding[(base,) * scheme.n_elements]
            if rng.random() < 0.02:
                call = int(rng.integers(0, scheme.num_classes))
            logits[i, call] += rng.uniform(2.0, 9.0)
        probs = np.exp(logits - logits.max(1, keepdims=True))
        probs = (probs / probs.sum(1, keepdims=True)).astype(np.float32)
        out.append(Sample("synth", None, None, None,
                          make_positions(majors, minors), probs))
    return scheme, out


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("tools")
    out = {}
    rng = np.random.default_rng(23)
    for diploid in (False, True):
        tag = "dip" if diploid else "hap"
        bam, ref, truth, _ = testing.create_variant_bam(
            str(d / (tag + ".bam")), ref_mb=0.02, depth=6, seed=4,
            diploid=diploid, read_len=2000)
        with FastaReader(ref) as fr:
            ref_seq = fr.fetch("synth")
        scheme, samples = _random_probabilities(rng, ref_seq, diploid)
        hdf = str(d / (tag + ".hdf"))
        with datastore.DataStore(hdf, "w") as ds:
            ds.set_meta(scheme, "label_scheme")
            for s in samples:
                ds.write_sample(s)
            ds.write_registry()
        command = "snp" if diploid else "vcf"
        calls = str(d / (tag + "_calls.vcf"))
        other = str(d / (tag + "_calls_jax.vcf"))
        assert cli.main([command, hdf, ref, calls]) == 0
        assert jcli.main([command, hdf, ref, other]) == 0
        assert _read(calls) == _read(other)
        out[tag] = {"bam": bam, "ref": ref, "truth": truth, "hdf": hdf,
                    "calls": calls}
    return out


VCFS = ["hap/truth", "hap/calls", "dip/truth", "dip/calls"]
DIPLOID_VCFS = ["dip/truth", "dip/calls"]


def _vcf(data, key):
    tag, kind = key.split("/")
    return data[tag][kind], data[tag]["ref"]


def _copies(tmp_path, path):
    """The file copied into two directories, ``port`` and ``jax``."""
    out = []
    for name in ("port", "jax"):
        d = tmp_path / name
        d.mkdir()
        out.append(str(d / os.path.basename(path)))
        shutil.copy(path, out[-1])
    return out


def _same_dirs(tmp_path):
    """Every file of the ``port`` directory has ``medaka_tpu``'s bytes in
    the ``jax`` one, and the two hold the same names."""
    a, b = tmp_path / "port", tmp_path / "jax"
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for name in names:
        assert _read(str(a / name)) == _read(str(b / name)), name
    return names


@pytest.mark.parametrize("replace_info", [False, True])
@pytest.mark.parametrize("key", VCFS)
def test_classify_variants(data, tmp_path, key, replace_info):
    port, jax = _copies(tmp_path, _vcf(data, key)[0])
    flags = ["--replace_info"] if replace_info else []
    got = _run(cli.main, ["tools", "classify_variants", port] + flags)
    want = _run(jcli.main, ["tools", "classify_variants", jax] + flags)
    assert got == want == (0, "", "")
    names = _same_dirs(tmp_path)
    assert len(names) == 4


@pytest.mark.parametrize("key", VCFS)
def test_vcf2tsv(data, tmp_path, key):
    port, jax = _copies(tmp_path, _vcf(data, key)[0])
    got = _run(cli.main, ["tools", "vcf2tsv", port])
    want = _run(jcli.main, ["tools", "vcf2tsv", jax])
    assert got[0] == want[0] == 0
    assert got[1] == port + ".tsv\n" and want[1] == jax + ".tsv\n"
    _same_dirs(tmp_path)


@pytest.mark.parametrize("notrim", [False, True])
@pytest.mark.parametrize("key", DIPLOID_VCFS)
def test_diploid2haploid(data, tmp_path, key, notrim):
    port, jax = _copies(tmp_path, _vcf(data, key)[0])
    flags = ["--notrim"] if notrim else []
    got = _run(cli.main, ["tools", "diploid2haploid", port] + flags)
    want = _run(jcli.main, ["tools", "diploid2haploid", jax] + flags)
    assert got[0] == want[0] == 0
    assert got[1].replace(str(tmp_path / "port"), "") == \
        want[1].replace(str(tmp_path / "jax"), "")
    assert len(_same_dirs(tmp_path)) == 3


@pytest.mark.parametrize("args", [[], ["--min_len", "200"],
                                  ["--min_len", "50", "--suffix", "r.txt"]])
@pytest.mark.parametrize("key", DIPLOID_VCFS)
def test_homozygous_regions(data, tmp_path, key, args):
    path = _vcf(data, key)[0]
    for name in ("port", "jax"):
        (tmp_path / name).mkdir()
    for main, name in ((cli.main, "port"), (jcli.main, "jax")):
        assert _run(main, ["tools", "homozygous_regions", path,
                           "synth:0-20000"] + args,
                    cwd=str(tmp_path / name)) == (0, "", "")
    assert len(_same_dirs(tmp_path)) == 2


@pytest.mark.parametrize("key", ["hap/truth", "dip/truth", "hap/calls"])
def test_vcf2fasta(data, tmp_path, key):
    path, ref = _vcf(data, key)
    got, want = str(tmp_path / "port.fasta"), str(tmp_path / "jax.fasta")
    assert _run(cli.main, ["tools", "vcf2fasta", path, ref, got]) == \
        _run(jcli.main, ["tools", "vcf2fasta", path, ref, want]) == \
        (0, "", "")
    assert _read(got) == _read(want)
    with FastaReader(got) as a, FastaReader(ref) as b:
        assert a.references == b.references


@pytest.mark.parametrize("tag", ["hap", "dip"])
def test_hdf_to_bed(data, tmp_path, tag):
    got, want = str(tmp_path / "port.bed"), str(tmp_path / "jax.bed")
    assert _run(cli.main, ["tools", "hdf_to_bed", data[tag]["hdf"], got]) \
        == _run(jcli.main, ["tools", "hdf_to_bed", data[tag]["hdf"],
                            want]) == (0, "", "")
    assert _read(got) == _read(want) == b"synth\t0\t20000\n"


@pytest.mark.parametrize("regions", [None, "string", "bed"])
def test_stitch_entry(data, tmp_path, regions):
    """``stitch.stitch`` over the port's parsed ``sequence`` arguments,
    its regions parsed as the CLI's ``sequence`` parses them, writes
    ``medaka_tpu``'s ``sequence`` bytes, and so does the port's CLI."""
    hdf, ref = data["hap"]["hdf"], data["hap"]["ref"]
    extra = []
    if regions == "string":
        extra = ["--regions", "synth:1000-9000", "synth:12000-15000"]
    elif regions == "bed":
        bed = tmp_path / "r.bed"
        bed.write_text("synth\t2000\t15000\n")
        extra = ["--regions", str(bed)]
    outs = {name: str(tmp_path / (name + ".fasta"))
            for name in ("jax", "cli", "entry")}
    assert jcli.main(["sequence", hdf, ref, outs["jax"]] + extra) == 0
    assert cli.main(["sequence", hdf, ref, outs["cli"]] + extra) == 0
    args = cli.build_parser().parse_args(
        ["sequence", hdf, ref, outs["entry"]] + extra)
    args.regions = cli._regions_arg(args.regions) if args.regions else None
    stitch.stitch(args)
    assert _read(outs["entry"]) == _read(outs["cli"]) == _read(outs["jax"])


@pytest.mark.parametrize("region", ["synth:0-20000", "synth:5000-6000"])
@pytest.mark.parametrize("tag", ["hap", "dip"])
def test_pileup_counts_print(data, tag, region):
    argv = ["tools", "pileup_counts", data[tag]["bam"], region, "--print"]
    got, want = _run(cli.main, argv), _run(jcli.main, argv)
    assert got[0] == want[0] == 0
    # the first line is the seconds the pileup took
    head = [r[1].split("\n", 1)[0] for r in (got, want)]
    assert all(h.startswith("pileup time: ") for h in head)
    assert [h.split("(")[1] for h in head] == [head[1].split("(")[1]] * 2
    rows = got[1].split("\n", 1)[1]
    assert rows == want[1].split("\n", 1)[1] and rows.count("\n") > 100


def test_prepare_tagged_bam(data, tmp_path):
    """Two BAMs over the same reference, tagged HP 1 and 2 and merged: the
    merged BAM holds ``medaka_tpu``'s records."""
    second = testing.write_basecaller_bam(
        data["hap"]["bam"], str(tmp_path / "second.bam"), [],
        max_records=40)
    outs = {}
    for main, name in ((cli.main, "port"), (jcli.main, "jax")):
        outs[name] = str(tmp_path / (name + ".bam"))
        assert _run(main, ["tools", "prepare_tagged_bam",
                           data["hap"]["bam"], second, "--values", "1", "2",
                           "--output", outs[name], "--threads", "2"]) == \
            (0, "", "")
    records = {}
    for name, path in outs.items():
        with BamReader(path) as reader:
            records[name] = [bytes(r.raw) for r in reader]
    assert records["port"] == records["jax"]
    with BamReader(outs["port"]) as reader:
        tags = [r.tags["HP"] for r in reader]
    assert tags.count(2) == 40 and tags.count(1) == len(tags) - 40
    # an existing output is refused by both
    assert _run(cli.main, ["tools", "prepare_tagged_bam", second,
                           "--values", "1", "--output", outs["jax"]])[0] \
        is ValueError


@pytest.mark.parametrize("tool", ["get_model_dtypes", "get_alignment_params",
                                  "is_rle_model"])
@pytest.mark.parametrize("bundle", BUNDLES)
def test_model_tools(tool, bundle):
    argv = ["tools", tool, bundle]
    got, want = _run(cli.main, argv), _run(jcli.main, argv)
    assert got == want and got[0] == 0 and got[1]


@pytest.fixture(scope="module")
def dwells_bam(tmp_path_factory):
    bam, _ = testing.create_synth_bam(
        str(tmp_path_factory.mktemp("mv") / "mv.bam"), ref_mb=0.005,
        depth=3, read_len=1000, move_tables=True)
    return bam


@pytest.mark.parametrize("bundle", ["gru256_lambda_demo", "gru256_rle_demo",
                                    "rl_lstm128_lambda_demo",
                                    "rl_lstm128_dwells_demo"])
@pytest.mark.parametrize("moves", [False, True], ids=["plain", "mv"])
def test_is_compatible(data, dwells_bam, bundle, moves):
    """``Compatible.``, or for the model that reads dwells on reads
    without move tables rc 1 and its refusal on standard error."""
    bam = dwells_bam if moves else data["hap"]["bam"]
    argv = ["tools", "is_compatible", "--model", bundle, bam]
    got = _run(cli.main, argv)
    # on a dwells model the port reads the first record of the first
    # contig fetched to its length, medaka_tpu's of [0, 2^40) (~13 s of
    # index bins a call): the same record, so the same answer
    assert got == _run(jcli.main, argv)
    dwells = bundle == "rl_lstm128_dwells_demo"
    if dwells and not moves:
        assert got == (1, "", "Model requires dwells but BAM reads lack mv "
                              "tags.\n")
    else:
        assert got == (0, "Compatible.\n", "")


@pytest.mark.parametrize("variant", [
    ("A", ["G"], "snp"), ("AC", ["GT"], "mnp"), ("ACG", ["TTT", "CCC"], "mnp"),
    ("A", ["AT"], "sni"), ("A", ["TA"], "sni"), ("A", ["ATT"], "mni"),
    ("AC", ["A"], "snd"), ("AC", ["C"], "snd"), ("ACG", ["A"], "mnd"),
    ("A", ["AT", "ATT"], "mni"), ("ACG", ["AC", "A"], "mnd"),
    ("A", ["GT"], "indel"), ("ACG", ["T"], "indel"),
    ("A", ["G", "AT"], "indel"), ("AC", ["G", "ACT"], "indel")],
    ids=lambda v: "{}>{}".format(v[0], ",".join(v[1])))
def test_classify_variant(variant):
    ref, alts, want = variant
    got = vcf.classify_variant(vcf.Variant("c", 10, ref, alts))
    assert got == jvcf.classify_variant(jvcf.Variant("c", 10, ref, alts))
    assert got == want


# ---------------------------------------------------------------------------
# haploid2diploid over random haplotype pairs
# ---------------------------------------------------------------------------

N_PAIRS = 30
CONTIGS = ("chr1", "chr10")


def _other_base(rng, base):
    return str(rng.choice([b for b in "ACGT" if b != base]))


def _haplotype(rng, seq):
    """Random non-overlapping records over ``seq``, now and then abutting:
    SNPs, MNPs, insertions, deletions and, rarely, a record whose alt is
    its ref."""
    out = []
    pos = int(rng.integers(0, 8))
    while True:
        kind = rng.choice(["snp", "snp", "mnp", "ins", "del", "same"],
                          p=[0.3, 0.2, 0.2, 0.12, 0.13, 0.05])
        length = {"snp": 1, "mnp": int(rng.integers(2, 4)), "ins": 1,
                  "del": int(rng.integers(2, 5)), "same": 1}[str(kind)]
        if pos + length >= len(seq):
            return out
        ref = seq[pos:pos + length]
        if kind in ("snp", "mnp"):
            alt = "".join(_other_base(rng, b) for b in ref)
        elif kind == "ins":
            alt = ref + "".join(rng.choice(list("ACGT"),
                                           int(rng.integers(1, 4))))
        elif kind == "del":
            alt = ref[0]
        else:
            alt = ref
        out.append((pos, ref, alt, round(float(rng.uniform(1, 60)), 3)))
        pos += length + int(rng.integers(0, 20))


def _write_haploid(path, contigs, records):
    with vcf.VCFWriter(path, contigs=[
            "{},length={}".format(c, len(s)) for c, s in contigs.items()],
            meta_info=[vcf.MetaInfo("FORMAT", "GT", 1, "String",
                                    "Genotype")]) as writer:
        for chrom, (pos, ref, alt, qual) in records:
            writer.write_variant(vcf.Variant(
                chrom, pos, ref, alt, qual=qual,
                genotype_data={"GT": "1"}))


def _pair(d, seed):
    rng = np.random.default_rng(1000 + seed)
    contigs = {c: "".join(rng.choice(list("ACGT"),
                                     int(rng.integers(150, 400))))
               for c in CONTIGS}
    ref = str(d / "ref{}.fasta".format(seed))
    with FastaWriter(ref) as fw:
        for c, s in contigs.items():
            fw.write(c, s)
    vcfs = []
    for hap in (1, 2):
        records = [(c, r) for c in CONTIGS
                   for r in _haplotype(rng, contigs[c])]
        vcfs.append(str(d / "pair{}_hap{}.vcf".format(seed, hap)))
        _write_haploid(vcfs[-1], contigs, records)
    return vcfs[0], vcfs[1], ref


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    d = tmp_path_factory.mktemp("pairs")
    return [_pair(d, seed) for seed in range(N_PAIRS)]


@pytest.mark.parametrize("split_mnp", [False, True])
@pytest.mark.parametrize("discard_phase", [False, True])
@pytest.mark.parametrize("adjacent", [False, True])
def test_haploid2diploid(pairs, tmp_path, adjacent, discard_phase,
                         split_mnp):
    flags = [f for f, on in (("--adjacent", adjacent),
                             ("--discard_phase", discard_phase),
                             ("--split_mnp", split_mnp)) if on]
    written = 0
    for i, (vcf1, vcf2, ref) in enumerate(pairs):
        got, want = (str(tmp_path / "{}{}.vcf".format(name, i))
                     for name in ("port", "jax"))
        a = _run(cli.main, ["tools", "haploid2diploid", vcf1, vcf2, ref,
                            got] + flags)
        b = _run(jcli.main, ["tools", "haploid2diploid", vcf1, vcf2, ref,
                             want] + flags)
        assert a == b, i
        if a[0] == 0:
            assert _read(got) == _read(want), i
            written += 1
    assert written == N_PAIRS


def test_the_pairs_overlap_and_abut(pairs):
    """The generator gives what the test above needs: records of the two
    haplotypes that overlap, that abut, and MNPs."""
    seen = set()
    for vcf1, vcf2, _ in pairs:
        spans = [[(v.chrom, v.pos, v.pos + len(v.ref), len(v.ref),
                   len(v.alt[0])) for v in vcf.VCFReader(p).fetch()]
                 for p in (vcf1, vcf2)]
        for c1, s1, e1, r1, a1 in spans[0]:
            if r1 == a1 > 1:
                seen.add("mnp")
            for c2, s2, e2, _, _ in spans[1]:
                if c1 == c2 and s1 < e2 and s2 < e1:
                    seen.add("overlap")
                if c1 == c2 and (e1 == s2 or e2 == s1):
                    seen.add("abut")
    assert seen == {"mnp", "overlap", "abut"}


# ---------------------------------------------------------------------------
# console scripts
# ---------------------------------------------------------------------------


def test_counts_entry(data):
    argv = [data["hap"]["bam"], "synth:1000-3000", "--print"]
    got, want = _run(cli.counts_entry, argv), _run(jcli.counts_entry, argv)
    assert got[0] == want[0] == 0
    assert got[1].split("\n", 1)[1] == want[1].split("\n", 1)[1]


def test_data_path():
    got, want = _run(cli.data_path, None), _run(jcli.data_path, None)
    assert got[0] == want[0] == 0
    assert os.path.realpath(got[1].strip()) == \
        os.path.realpath(want[1].strip()) == os.path.realpath(DATA)


def test_version_report():
    import torch
    rc, text, _ = _run(cli.version_report, None)
    lines = text.splitlines()
    assert rc == 0
    assert lines[0].startswith("medaka_tpu_torch ")
    assert lines[1] == "torch {} cuda {}".format(torch.__version__,
                                                 torch.version.cuda)
    if not torch.cuda.is_available():
        assert "device: CUDA unavailable" in lines
    assert "native library: ok" in lines
    assert lines[-1].startswith("nvcc: ")
