"""The port's variant and SNP calling against ``medaka_tpu`` on the CPU.

- The decoders (``decode_variants``, ``decode_snps``, both schemes'
  ``_prob_to_snp``) and ``join_samples`` on seeded random probability
  samples give the records and cuts of ``medaka_tpu``'s.
- On probability files written by ``medaka_tpu``, the port's ``vcf`` and
  ``snp`` write the same bytes, for each flag combination of the CLI.
- End to end on a 20 kb ``testing.create_variant_bam`` genome (reads
  aligned without a mapper), ``medaka_tpu``'s ``predict`` + decode and the
  port's ``inference --cpu`` + ``vcf`` / ``snp`` write the same bytes, in
  full precision. In bf16 the two CPU routes round at other points
  (ROADMAP.md queue 3 item 2): the records are the same, their QUAL and GQ
  move in the last digits.
- The P/R/F1 floors that ``chip_smoke.py`` holds the card to
  (``testing.VARIANT_FLOORS``) are met here, on 0.1 Mb genomes of the same
  generator through the port's CPU path.
- The generator's lift is right: at every planted variant the pileup
  shows the planted allele.
- ``DiploidLabelScheme``: its truth encoding on haplotagged truth
  alignments, and the decoding cases of tests/test_labels.py, match.
"""
import os

import jax
import numpy as np
import pytest

from medaka_tpu import common as jcommon
from medaka_tpu import labels as jlabels
from medaka_tpu import prediction as jprediction
from medaka_tpu import variant as jvariant
from medaka_tpu.io.fastx import FastaWriter as JFastaWriter
from medaka_tpu_torch import cli, common, features, labels, testing, \
    variant
from medaka_tpu_torch.io.bam import BamRecord, write_bam
from medaka_tpu_torch.io.fastx import FastaReader
from tests.torch_threads import one_thread  # noqa: F401

DATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "medaka_tpu", "data")
BUNDLE = {False: "gru256_variant_demo", True: "gru256_diploid_snp_demo"}
RUN = dict(chunk_len=1000, chunk_overlap=200, batch_size=8)


# ---------------------------------------------------------------------------
# decoders on random probabilities
# ---------------------------------------------------------------------------


def _fields(v):
    return (v.chrom, v.pos, v.ident, v.ref, list(v.alt), v.qual, v.filt,
            dict(v.info), dict(v.genotype_data))


def _same_records(got, want):
    assert [_fields(v) for v in got] == [_fields(v) for v in want]
    assert [v.to_dict() for v in got] == [v.to_dict() for v in want]


def _ref_seq(rng, n, ambiguous=0.02):
    seq = rng.choice(list("ACGT"), size=n)
    seq[rng.random(n) < ambiguous] = "N"
    return "".join(seq)


def _random_probs(rng, ref_seq, start, n_major, diploid, var_rate=0.08):
    """(positions, f32 probabilities) over ``n_major`` reference columns
    from ``start``, with insertion columns after some of them: the call is
    the reference (a gap at insertion columns) except at a few columns,
    with a random runner-up, now and then a near tie."""
    scheme = labels.DiploidLabelScheme() if diploid \
        else labels.HaploidLabelScheme()
    majors, minors = [], []
    for m in range(start, start + n_major):
        majors.append(m)
        minors.append(0)
        if rng.random() < 0.08:
            for j in range(1, int(rng.integers(2, 4))):
                majors.append(m)
                minors.append(j)
    n_cls = scheme.num_classes
    logits = rng.normal(0, 1.5, (len(majors), n_cls))
    for i, (m, mi) in enumerate(zip(majors, minors)):
        base = "*" if mi else ref_seq[m]
        if base not in "ACGT*":
            base = "A"
        key = (base,) * scheme.n_elements
        call = scheme._encoding[key]
        if rng.random() < var_rate:
            call = int(rng.integers(0, n_cls))
        logits[i, call] += rng.uniform(1.0, 9.0)
        if rng.random() < 0.05:     # a runner-up close behind
            logits[i, int(rng.integers(0, n_cls))] = logits[i, call] - 0.05
    probs = np.exp(logits - logits.max(1, keepdims=True))
    probs = (probs / probs.sum(1, keepdims=True)).astype(np.float32)
    return majors, minors, probs


def _samples(majors, minors, probs, name="ctg"):
    def make(mod):
        return mod.Sample(name, None, None, None,
                          mod.make_positions(majors, minors), probs)
    return make(common), make(jcommon)


def _schemes(diploid, verbose=True):
    cls = "DiploidLabelScheme" if diploid else "HaploidLabelScheme"
    port, ref = getattr(labels, cls)(), getattr(jlabels, cls)()
    port.verbose = ref.verbose = verbose
    return port, ref


@pytest.mark.parametrize("verbose", [True, False])
@pytest.mark.parametrize("return_all", [False, True])
@pytest.mark.parametrize("ambig_ref", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_decode_variants_matches(seed, ambig_ref, return_all, verbose):
    rng = np.random.default_rng(seed)
    ref_seq = _ref_seq(rng, 900)
    port_s, jax_s = _samples(*_random_probs(rng, ref_seq, 20, 800, False))
    port, ref = _schemes(False, verbose)
    got = port.decode_variants(port_s, ref_seq, ambig_ref=ambig_ref,
                               return_all=return_all)
    want = ref.decode_variants(jax_s, ref_seq, ambig_ref=ambig_ref,
                               return_all=return_all)
    assert len(got) > 10
    _same_records(got, want)


@pytest.mark.parametrize("threshold", [0.04, 0.2])
@pytest.mark.parametrize("seed", [0, 1])
def test_haploid_decode_snps_matches(seed, threshold):
    rng = np.random.default_rng(10 + seed)
    ref_seq = _ref_seq(rng, 900)
    port_s, jax_s = _samples(*_random_probs(rng, ref_seq, 0, 850, False))
    port, ref = _schemes(False)
    got = port.decode_snps(port_s, ref_seq, threshold=threshold)
    want = ref.decode_snps(jax_s, ref_seq, threshold=threshold)
    assert got
    _same_records(got, want)


@pytest.mark.parametrize("return_all", [False, True])
@pytest.mark.parametrize("het_rescue", [None, 0.1, 0.3])
@pytest.mark.parametrize("seed", [0, 1])
def test_prob_to_snp_matches(seed, het_rescue, return_all):
    """Both schemes' ``_prob_to_snp`` over the same loci; the diploid one
    with and without ``het_rescue``."""
    rng = np.random.default_rng(20 + seed)
    ref_seq = _ref_seq(rng, 600)
    for diploid in (False, True):
        majors, minors, probs = _random_probs(rng, ref_seq, 0, 600, diploid,
                                              var_rate=0.2)
        # the loci ``decode_snps`` hands on: reference columns whose
        # reference base is A, C, G or T
        keep = np.flatnonzero([mi == 0 and ref_seq[m] in "ACGT"
                               for m, mi in zip(majors, minors)])
        loci = np.asarray(majors)[keep]
        symbols = "".join(ref_seq[m] for m in loci)
        port, ref = _schemes(diploid)
        port.secondary_threshold = ref.secondary_threshold = 0.04
        if diploid and het_rescue is not None:
            port.het_rescue = ref.het_rescue = het_rescue
        got = port._prob_to_snp(probs[keep], loci, "ctg", symbols,
                                return_all=return_all)
        want = ref._prob_to_snp(probs[keep], loci, "ctg", symbols,
                                return_all=return_all)
        assert got
        _same_records(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_join_samples_makes_the_same_cuts(seed):
    """Overlapping chunks of one pileup, trimmed, re-split at non-variant
    anchors by both packages: the same samples."""
    rng = np.random.default_rng(30 + seed)
    ref_seq = _ref_seq(rng, 2500, ambiguous=0.0)
    port_s, jax_s = _samples(*_random_probs(rng, ref_seq, 0, 2400, False,
                                            var_rate=0.15))
    port, ref = _schemes(False)
    got = list(variant.join_samples(common.Sample.trim_samples(
        port_s.chunks(300, 60)), ref_seq, port))
    want = list(jvariant.join_samples(jcommon.Sample.trim_samples(
        jax_s.chunks(300, 60)), ref_seq, ref))
    assert len(got) == len(want) > 3
    for a, b in zip(got, want):
        assert a.name == b.name
        np.testing.assert_array_equal(a.positions, b.positions)
        np.testing.assert_array_equal(a.label_probs, b.label_probs)


def test_from_samples_and_version_sort_match():
    rng = np.random.default_rng(5)
    ref_seq = _ref_seq(rng, 400)
    port_s, jax_s = _samples(*_random_probs(rng, ref_seq, 0, 300, False))
    cuts = [0, 50, 120, port_s.size]
    got = common.Sample.from_samples(
        port_s.slice(slice(a, b)) for a, b in zip(cuts, cuts[1:]))
    assert got == port_s
    with pytest.raises(ValueError, match="non-abutting"):
        common.Sample.from_samples([port_s.slice(slice(0, 50)),
                                    port_s.slice(slice(60, 90))])
    names = ["chr10-5", "chr2-17", "chr2-3", "chrX-1", "chr1-100"]
    assert common.loose_version_sort(names) == \
        jcommon.loose_version_sort(names)


# ---------------------------------------------------------------------------
# the diploid scheme: truth encoding and the decoding cases
# ---------------------------------------------------------------------------


def _md(ref_seq, pos, cigar):
    """The MD tag of an =/X/I/D alignment at ``pos``."""
    from medaka_tpu_torch.io.bam import parse_cigar
    parts, run, r = [], 0, pos
    for op, n in parse_cigar(cigar):
        if op == 7:                         # =
            run += n
            r += n
        elif op == 8:                       # X
            for k in range(n):
                parts.append("{}{}".format(run, ref_seq[r + k]))
                run = 0
            r += n
        elif op == 2:                       # D
            parts.append("{}^{}".format(run, ref_seq[r:r + n]))
            run = 0
            r += n
    return "".join(parts) + str(run)


@pytest.fixture(scope="module")
def haplotagged(tmp_path_factory):
    """A truth BAM of two haplotypes (HP 1 and 2), each with its own
    planted SNPs and indels, aligned to the reference by the generator's
    lift."""
    d = tmp_path_factory.mktemp("truth")
    rng = np.random.default_rng(77)
    ref_seq = "".join(rng.choice(list("ACGT"), size=8000))
    ref_arr = np.frombuffer(ref_seq.encode(), np.uint8)
    records = []
    for hp in (1, 2):
        (hap,), planted = testing.plant_variants(ref_seq, rng)
        columns = testing._hap_columns(len(ref_seq), [
            (r["pos"], r["ref"], r["alt"]) for r in planted])
        pos, bases, cigar = testing.lift_read(
            columns, ref_arr, 0, np.frombuffer(hap.encode(), np.uint8),
            np.zeros(len(hap), np.int8))
        seq = bases.tobytes().decode()
        records.append(BamRecord.build(
            query_name="hap{}".format(hp), ref_id=0, pos=pos, seq=seq,
            qual=np.full(len(seq), 60, np.uint8), cigar=cigar, mapq=60,
            tags={"HP": hp, "MD": _md(ref_seq, pos, cigar)}))
    path = str(d / "truth.bam")
    write_bam(path, sorted(records, key=lambda r: r.pos),
              [("ctg", len(ref_seq))])
    return path, ref_seq


def test_diploid_encode_matches_on_haplotagged_truth(haplotagged):
    path, ref_seq = haplotagged
    got_alns = labels.TruthAlignment.bam_to_alignments(
        path, common.Region("ctg", 0, len(ref_seq)), haplotag="HP")
    want_alns = jlabels.TruthAlignment.bam_to_alignments(
        path, jcommon.Region("ctg", 0, len(ref_seq)), haplotag="HP")
    assert len(got_alns) == len(want_alns) == 1
    port, ref = labels.DiploidLabelScheme(), jlabels.DiploidLabelScheme()
    got_pos, got_lab = port.encode(got_alns[0])
    want_pos, want_lab = ref.encode(want_alns[0])
    np.testing.assert_array_equal(got_pos, want_pos)
    np.testing.assert_array_equal(got_lab, want_lab)
    # insertion columns, heterozygous and gap classes all occur
    assert (got_pos["minor"] > 0).any()
    assert len(set(got_lab.tolist())) > 8
    np.testing.assert_array_equal(
        port.encoded_labels_to_training_vectors(got_lab),
        ref.encoded_labels_to_training_vectors(want_lab))
    assert port.padding_vector == ref.padding_vector
    assert port._unordered_label_combinations() == \
        ref._unordered_label_combinations()
    assert port._encoding == ref._encoding and port.num_classes == 15
    assert labels.from_dict(ref.to_dict()).to_dict() == ref.to_dict()
    assert port._labels_to_encoded_labels([("C", "A")]).tolist() == \
        ref._labels_to_encoded_labels([("C", "A")]).tolist()


@pytest.mark.parametrize("pair,ref_symbol,return_all", [
    (("C", "C"), "C", True), (("C", "C"), "C", False),
    (("A", "A"), "C", False), (("A", "T"), "C", False),
    (("C", "T"), "C", False), (("*", "*"), "C", False),
    (("C", "*"), "C", False), (("T", "*"), "C", False)])
def test_diploid_prob_to_snp_cases(pair, ref_symbol, return_all):
    """tests/test_labels.py's per-case diploid genotypes, both packages."""
    out = []
    for mod in (labels, jlabels):
        scheme = mod.DiploidLabelScheme()
        key = tuple(sorted(pair, key="*ACGT".index))
        probs = np.zeros((1, scheme.num_classes), dtype=np.float32)
        probs[0, scheme._encoding[key]] = 1.0
        out.append(scheme._prob_to_snp(probs, np.array([10]), "chr1",
                                       [ref_symbol], return_all=return_all))
    _same_records(*out)


def test_diploid_decode_snps_golden():
    """tests/test_labels.py's gapped pair table, both packages."""
    ref = "CATGCGTCGATGCAT*G"
    hp1 = "gAgGTGatacT*CATCG".upper()
    hp2 = "Cca***T*c**a**c**".upper()
    majors, minors, major = [], [], -1
    for r in ref:
        if r == "*":
            minors.append(minors[-1] + 1)
        else:
            major += 1
            minors.append(0)
        majors.append(major)
    scheme = labels.DiploidLabelScheme()
    probs = np.zeros((len(ref), scheme.num_classes), dtype=np.float32)
    for i, (a, b) in enumerate(zip(hp1, hp2)):
        probs[i, scheme._encoding[tuple(sorted((a, b),
                                               key="*ACGT".index))]] = 1.0
    port_s, jax_s = _samples(majors, minors, probs, "chr1")
    got = scheme.decode_snps(port_s, ref.replace("*", ""))
    want = jlabels.DiploidLabelScheme().decode_snps(jax_s,
                                                    ref.replace("*", ""))
    assert [(v.pos, v.ref, v.alt, v.genotype_data["GT"]) for v in got] == [
        (0, "C", ["G"], "0/1"), (1, "A", ["C"], "0/1"),
        (2, "T", ["A", "G"], "1/2"), (4, "C", ["T"], "1/1"),
        (6, "T", ["A"], "0/1"), (7, "C", ["T"], "1/1"),
        (8, "G", ["A", "C"], "1/2"), (9, "A", ["C"], "1/1"),
        (11, "G", ["A"], "1/1"), (14, "T", ["C"], "0/1")]
    _same_records(got, want)


@pytest.mark.parametrize("hom_ref,het,rescue", [
    (0.7, 0.25, None), (0.7, 0.25, 0.1), (0.7, 0.25, 0.4),
    (0.2, 0.7, None), (0.2, 0.7, 0.1)])
def test_diploid_het_rescue_cases(hom_ref, het, rescue):
    """tests/test_labels.py's het rescue cases, both packages."""
    out = []
    for mod in (labels, jlabels):
        scheme = mod.DiploidLabelScheme()
        probs = np.zeros((1, scheme.num_classes), np.float32)
        probs[0, scheme._encoding[("A", "A")]] = hom_ref
        probs[0, scheme._encoding[("A", "C")]] = het
        probs[0] /= probs[0].sum()
        if rescue is not None:
            scheme.het_rescue = rescue
        out.append(scheme._prob_to_snp(probs, np.array([7]), "ctg", "A"))
    _same_records(*out)
    called = (rescue is not None and rescue <= 0.25) or het > hom_ref
    assert [v.genotype_data["GT"] for v in out[0]] == \
        (["0/1"] if called else [])


# ---------------------------------------------------------------------------
# probability files and the end-to-end path
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def genomes(tmp_path_factory):
    """For each bundle: a 20 kb genome of ``create_variant_bam``, the
    probabilities of ``medaka_tpu.prediction.predict`` and of the port's
    ``inference --cpu``, in full precision and in bf16, and a copy of the
    reference with some bases made ambiguous."""
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    out = {}
    for diploid, bundle in BUNDLE.items():
        d = tmp_path_factory.mktemp("dip" if diploid else "hap")
        bam, ref, truth, records = testing.create_variant_bam(
            str(d / "reads.bam"), ref_mb=0.02, depth=30, seed=3,
            diploid=diploid)
        run = {"bam": bam, "ref": ref, "truth": truth, "records": records}
        for full in (True, False):
            tag = "f32" if full else "bf16"
            jax_hdf = str(d / "jax_{}.hdf".format(tag))
            port_hdf = str(d / "port_{}.hdf".format(tag))
            jprediction.predict(
                bam, jax_hdf, model_path=os.path.join(
                    DATA, bundle + ".tar.gz"),
                full_precision=full, mesh=mesh, **RUN)
            args = ["inference", bam, port_hdf, "--model", bundle, "--cpu",
                    "--chunk_len", "1000", "--chunk_ovlp", "200",
                    "--batch_size", "8"]
            assert cli.main(args + (["--full_precision"] if full
                                    else [])) == 0
            run[tag] = (jax_hdf, port_hdf)
        with FastaReader(ref) as fr:
            seq = np.array(list(fr.fetch("synth")))
        seq[np.random.default_rng(9).random(len(seq)) < 0.01] = "N"
        run["ambig_ref"] = str(d / "ambig.fasta")
        with JFastaWriter(run["ambig_ref"]) as fw:
            fw.write("synth", "".join(seq))
        out[diploid] = run
    return out


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def _jax_decode(command, hdf, ref, out, flags):
    """``medaka_tpu``'s ``vcf`` / ``snp`` through its own CLI."""
    from medaka_tpu import cli as jcli
    return jcli.main([command, hdf, ref, out] + flags)


VCF_FLAGS = [[], ["--verbose"], ["--ambig_ref"], ["--gvcf"],
             ["--min_qual", "5"], ["--regions", "synth:5000-15000"],
             ["--verbose", "--ambig_ref", "--gvcf", "--min_qual", "5"]]
SNP_FLAGS = {False: [[], ["--threshold", "0.2"], ["--verbose"]],
             True: [[], ["--het_rescue", "0.1"], ["--threshold", "0.2"],
                    ["--verbose", "--het_rescue", "0.1"],
                    ["--regions", "synth:5000-15000"]]}


@pytest.mark.parametrize("ref_kind", ["ref", "ambig_ref"])
@pytest.mark.parametrize("diploid", [False, True])
def test_decode_of_a_jax_probability_file(genomes, diploid, ref_kind,
                                          tmp_path):
    """The port's ``vcf`` and ``snp`` on the probability file
    ``medaka_tpu`` wrote: the bytes of ``medaka_tpu``'s, for each flag
    combination."""
    run = genomes[diploid]
    hdf, ref = run["f32"][0], run[ref_kind]
    cases = [("snp", f) for f in SNP_FLAGS[diploid]]
    if not diploid:
        cases += [("vcf", f) for f in VCF_FLAGS]
    for command, flags in cases:
        got, want = str(tmp_path / "port.vcf"), str(tmp_path / "jax.vcf")
        assert cli.main([command, hdf, ref, got] + flags) == 0
        assert _jax_decode(command, hdf, ref, want, flags) == 0
        assert _read(got) == _read(want), (command, flags)
    if not diploid:
        with pytest.raises(ValueError, match="diploid models only"):
            cli.main(["snp", hdf, ref, got, "--het_rescue", "0.1"])


#: the one line of these runs where the two packages' f32 probabilities
#: (their scans sum in another order: within 1.2e-6 of each other) fall on
#: either side of a 3-decimal rounding of ``vcf --verbose``'s per-column
#: quality (3.2295): POS -> (port's text, medaka_tpu's text). ROADMAP.md
#: queue 3 item 2 names it too.
F32_ROUNDING_LINES = {
    19640: ("pred_q=3.229;pred_qs=3.229", "pred_q=3.230;pred_qs=3.230")}


@pytest.mark.parametrize("diploid", [False, True])
def test_end_to_end_matches_in_full_precision(genomes, diploid, tmp_path):
    """Reads to VCF: ``medaka_tpu``'s ``predict`` + decode and the port's
    ``inference --cpu --full_precision`` + ``vcf`` (haploid) or ``snp`` and
    ``snp --het_rescue 0.1`` (diploid) write the same bytes; ``vcf
    --verbose`` too, but for the one rounding of
    :data:`F32_ROUNDING_LINES`."""
    run = genomes[diploid]
    jax_hdf, port_hdf = run["f32"]
    commands = ([("snp", []), ("snp", ["--het_rescue", "0.1"])] if diploid
                else [("vcf", []), ("vcf", ["--verbose"])])
    for command, flags in commands:
        got, want = str(tmp_path / "port.vcf"), str(tmp_path / "jax.vcf")
        assert cli.main([command, port_hdf, run["ref"], got] + flags) == 0
        assert _jax_decode(command, jax_hdf, run["ref"], want, flags) == 0
        body = _read(got)
        assert body.count(b"\nsynth\t") > 30
        if flags != ["--verbose"]:
            assert body == _read(want), (command, flags)
            continue
        lines = body.decode().split("\n")
        ref_lines = _read(want).decode().split("\n")
        assert len(lines) == len(ref_lines)
        moved = {}
        for line, ref_line in zip(lines, ref_lines):
            if line != ref_line:
                pos = int(line.split("\t")[1])
                port_text, jax_text = F32_ROUNDING_LINES[pos]
                assert line.replace(port_text, jax_text) == ref_line
                moved[pos] = line
        assert sorted(moved) == sorted(F32_ROUNDING_LINES)


@pytest.mark.parametrize("diploid", [False, True])
def test_end_to_end_bf16_calls_the_same_records(genomes, diploid, tmp_path):
    """In bf16 the CPU routes round at other points (ROADMAP.md queue 3
    item 2): every record has the same site, alleles and genotype; only
    QUAL and GQ move, QUAL by at most 1 phred."""
    run = genomes[diploid]
    jax_hdf, port_hdf = run["bf16"]
    command = "snp" if diploid else "vcf"
    got, want = str(tmp_path / "port.vcf"), str(tmp_path / "jax.vcf")
    assert cli.main([command, port_hdf, run["ref"], got]) == 0
    assert _jax_decode(command, jax_hdf, run["ref"], want, []) == 0

    def records(path):
        rows = [line.split("\t") for line in _read(path).decode().split("\n")
                if line and not line.startswith("#")]
        return ([(r[1], r[3], r[4], r[9].split(":")[0]) for r in rows],
                np.array([float(r[5]) for r in rows]))

    (got_sites, got_q), (want_sites, want_q) = records(got), records(want)
    assert got_sites == want_sites and len(got_sites) > 30
    assert np.abs(got_q - want_q).max() <= 1.0


@pytest.mark.parametrize("diploid", [False, True])
def test_the_lift_holds(genomes, diploid):
    """At each planted variant covered by at least 10 reads the port's
    counts pileup shows the planted allele: the alt base in most reads of
    a SNP (in about half of them for a het one), the inserted bases in
    the insertion columns, the deletion in the deleted columns."""
    run = genomes[diploid]
    cols = {}
    for counts, pos in features.pileup_counts(
            common.Region("synth", 0, 20000), run["bam"]):
        for c, (ma, mi) in zip(counts, pos):
            cols[(int(ma), int(mi))] = c
    B = common.PLP_BASES
    kinds = set()
    for r in run["records"]:
        p = r["pos"]
        depth = cols.get((p, 0), np.zeros(10)).sum()
        if depth < 10:
            continue
        if len(r["ref"]) == len(r["alt"]) == 1:
            c = cols[(p, 0)]
            share = (c[B.index(r["alt"])] + c[B.index(r["alt"].lower())]) \
                / depth
            ok = 0.25 <= share <= 0.75 if r["gt"] == "0/1" else share > 0.75
            kinds.add("het" if r["gt"] == "0/1" else "snp")
        elif len(r["alt"]) > 1:
            ok = all(
                (cols.get((p, j + 1), np.zeros(10))[[B.index(b),
                                                     B.index(b.lower())]]
                 .sum() / depth) > 0.75 for j, b in enumerate(r["alt"][1:]))
            kinds.add("ins")
        else:
            ok = all(cols[(p + j + 1, 0)][[B.index("d"), B.index("D")]]
                     .sum() / cols[(p + j + 1, 0)].sum() > 0.75
                     for j in range(len(r["ref"]) - 1))
            kinds.add("del")
        assert ok, r
    assert kinds == ({"snp", "het"} if diploid else {"snp", "ins", "del"})


@pytest.mark.parametrize("diploid", [False, True])
def test_floors_on_the_cpu_path(diploid, tmp_path):
    """The floors of ``chip_smoke.py``'s variant phases
    (``testing.VARIANT_FLOORS``), fixed on 0.1 Mb genomes at depth 30
    through the port's CPU path at the default chunks (10,000 columns,
    1,000 overlap) and in bf16, as on the card. Measured here at seeds 0,
    1 and 2: haploid SNP P/R/F1 0.946-0.990/1.0/0.972-0.995, indel
    0.899-0.921/1.0/0.947-0.959; diploid SNP 0.939-0.955/0.898-0.907/
    0.918-0.929, GT concordance 0.845-0.882, and with ``--het_rescue
    0.1`` 0.907-0.931/0.967-0.983/0.937-0.956."""
    bam, ref, truth, _ = testing.create_variant_bam(
        str(tmp_path / "reads.bam"), ref_mb=0.1, depth=30, seed=0,
        diploid=diploid)
    hdf = str(tmp_path / "probs.hdf")
    assert cli.main(["inference", bam, hdf, "--model", BUNDLE[diploid],
                     "--cpu", "--batch_size", "8"]) == 0
    called = str(tmp_path / "called.vcf")
    assert cli.main(["snp" if diploid else "vcf", hdf, ref, called]) == 0
    score = testing.score_vcf(truth, called, ref)
    kind = "diploid" if diploid else "haploid"
    assert not testing.below_floors(score, testing.VARIANT_FLOORS[kind]), \
        score
    if diploid:
        rescued = str(tmp_path / "rescued.vcf")
        assert cli.main(["snp", hdf, ref, rescued, "--het_rescue",
                         "0.1"]) == 0
        again = testing.score_vcf(truth, rescued, ref)
        assert again["snp"]["recall"] > score["snp"]["recall"], again
        assert not testing.below_floors(
            again, testing.VARIANT_FLOORS["diploid_rescue"]), again
