"""The port's tandem-repeat workflow against ``medaka_tpu``'s on the CPU.

- ``features.get_trimmed_reads`` gives ``medaka_tpu``'s reads for
  ``min_mapq`` 0/1/5, ``include_empty_reads`` on and off and ``partial``
  on and off, over each locus of a seeded diploid STR genome
  (``testing.create_str_bam``), padded, not, and inside the deleted
  arrays (whose reads arrive empty), and over the whole contig in pieces.
- ``RecordName``, the clusterers (prephased, de novo, hybrid) and
  ``determine_gt_and_alleles`` give ``medaka_tpu``'s results.
- ``tandem.main`` with ``MajorityVoteModel`` for each ``--phasing``,
  replacement-style and decomposed, at ``workers=1``, writes
  ``medaka_tpu``'s VCF, ``poa.fasta``, ``consensus.fasta``, ``skipped.bed``
  and ``*_region_metrics.txt`` byte for byte; at ``workers=2`` the same
  records in the order threads finish (compared sorted); with regions
  inside their arrays and no padding the reads of a deleted array are
  empty and become the "N" sentinel.
- ``tandem.main`` with ``gru256_lambda_demo`` (full precision: the float32
  scan in both packages): probabilities within 1e-4, the VCF the same
  bytes. ``medaka_tpu`` runs on one JAX device, as the port does.
- The planted genotypes are recovered (``testing.str_genotypes``): every
  locus with ``hybrid`` and ``abpoa``, the loci whose reads are all
  HP-tagged with ``prephased``.
- ``tandem --cpu`` writes the library call's VCF; without ``--cpu`` and
  without a GPU it raises before any host stage.
"""
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from medaka_tpu import tandem as jtandem
from medaka_tpu.common import Region as JRegion
from medaka_tpu.features import CountsFeatureEncoder as JCounts
from medaka_tpu.features import get_trimmed_reads as jget_trimmed_reads
from medaka_tpu.labels import HaploidLabelScheme as JHaploid
from medaka_tpu.models import ModelBundle as JBundle
from medaka_tpu.models.majority import MajorityVoteModel as JMajority
from medaka_tpu.smolecule import Subread as JSubread
from medaka_tpu.tandem import clustering as jclustering
from medaka_tpu.tandem import io_utils as jio_utils
from medaka_tpu.tandem.record_name import RecordName as JRecordName
from medaka_tpu_torch import cli, models, tandem, testing
from medaka_tpu_torch.common import Region, reverse_complement
from medaka_tpu_torch.features import CountsFeatureEncoder, \
    get_trimmed_reads
from medaka_tpu_torch.labels import HaploidLabelScheme
from medaka_tpu_torch.models.majority import MajorityVoteModel
from medaka_tpu_torch.smolecule import Subread
from medaka_tpu_torch.tandem import clustering, io_utils
from medaka_tpu_torch.tandem.record_name import RecordName
from tests.torch_precision_runs import probs
from tests.torch_threads import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = os.path.join(REPO, "medaka_tpu", "data",
                     "gru256_lambda_demo_model_pt.tar.gz")
PHASINGS = ("prephased", "hybrid", "abpoa", "unphased")
#: the files each run writes that the packages must write alike
OUTPUTS = ("medaka_to_ref.TR.vcf", "poa.fasta", "consensus.fasta",
           "skipped.bed", "prephased_region_metrics.txt",
           "abpoa_region_metrics.txt", "unphased_region_metrics.txt")


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    """Ten loci (each kind twice; the first five's reads all HP-tagged),
    depth 12 a haplotype."""
    d = tmp_path_factory.mktemp("str")
    return testing.create_str_bam(str(d / "reads.bam"), n_loci=10,
                                  depth=12, seed=1)


# ---------------------------------------------------------------------------
# trimmed reads
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("min_mapq", [0, 1, 5])
@pytest.mark.parametrize("include_empty", [True, False])
@pytest.mark.parametrize("partial", [True, False])
def test_get_trimmed_reads_matches(genome, min_mapq, include_empty,
                                   partial):
    bam, _, loci = genome
    regions = []
    for locus in loci[:5]:
        r = locus["region"]
        regions += [(r, 2 * r.size),
                    (Region(r.ref_name, r.start - 10, r.end + 10),
                     2 * (r.size + 20))]
    # 3 kb over the first two loci, in pieces of 1000 overlapping by 100
    start = loci[0]["region"].start - 500
    regions.append((Region(loci[0]["region"].ref_name, start, start + 3000),
                    1000))
    for locus in loci:
        if locus["kind"] == "del":
            # strictly inside the deletion: its reads trim to nothing
            r = locus["region"]
            regions.append((Region(r.ref_name, r.start + 1, r.end - 1),
                            2 * r.size))
    n_empty = 0
    for region, split in regions:
        kwargs = dict(region_split=split, partial=partial,
                      min_mapq=min_mapq, include_empty_reads=include_empty,
                      workers=2, chunk_overlap=100)
        want = [(str(reg), [tuple(t) for t in reads])
                for reg, reads in jget_trimmed_reads(
                    JRegion(*region), bam, **kwargs)]
        got = [(str(reg), [tuple(t) for t in reads])
               for reg, reads in get_trimmed_reads(region, bam, **kwargs)]
        assert got == want
        n_empty += sum(not t[2] for _, reads in got for t in reads)
    # inside the deleted arrays reads are empty, kept only when asked
    assert (n_empty > 0) == include_empty


# ---------------------------------------------------------------------------
# names, clusterers, genotypes
# ---------------------------------------------------------------------------


def _record(ploidy=2, start=100, end=160, cls=RecordName):
    return cls(query_name="tr", ref_name="chr1", ref_start=start,
               ref_end=end, ref_start_padded=start - 10,
               ref_end_padded=end + 10, hap=0, ploidy=ploidy)


@pytest.mark.parametrize("name,known", [
    ("readA_chr20_100_200_pad_90_210_rev_hap2_phased-set7_ploidy2", None),
    ("tr_chr1_KI270706v1_random_100_200_pad_90_210_fwd_hap0_"
     "phased-set0_ploidy1", None),
    ("tr_chr1_KI270706v1_random_100_200_pad_90_210_fwd_hap0_"
     "phased-set0_ploidy1", {"chr1_KI270706v1_random", "chr2"}),
    ("tr_HOM_chr1_5_9_pad_0_19_fwd_hap1_phased-set0_ploidy2", {"chr1"})])
def test_record_name_matches(name, known):
    got = RecordName.from_str(name, known_refs=known)
    want = JRecordName.from_str(name, known_refs=known)
    assert vars(got) == vars(want) and str(got) == str(want) == name
    assert tuple(got.to_padded_region()) == tuple(want.to_padded_region())
    assert got.sorter() == want.sorter()


def _locus_reads(rng, delta, depth, with_hp, units=12):
    """Reads of a CAG locus (as tests/test_tandem.py's), both packages'
    Subreads."""
    flank_a = "".join(rng.choice(list("ACGT"), 40))
    flank_b = "".join(rng.choice(list("ACGT"), 40))
    alleles = {1: flank_a + "CAG" * units + flank_b,
               2: flank_a + "CAG" * (units + delta) + flank_b}
    rec = _record()
    reads = []
    for i in range(depth):
        hap = 1 + (i % 2)
        seq = "".join(
            c for c in alleles[hap] if rng.random() > 0.02)
        strand = "rev" if i % 3 == 2 else "fwd"
        rn = RecordName(
            query_name="read{}".format(i), ref_name=rec.ref_name,
            ref_start=rec.ref_start, ref_end=rec.ref_end,
            ref_start_padded=rec.ref_start_padded,
            ref_end_padded=rec.ref_end_padded,
            hap=hap if with_hp else 0, phased_set=7, ploidy=2,
            strand=strand)
        reads.append((str(rn), seq if strand == "fwd"
                      else reverse_complement(seq)))
    return reads


def _clustered(d, clusters):
    return d, {str(k): [tuple(s) for s in v] for k, v in clusters.items()}


@pytest.mark.parametrize("kind", ["prephased", "abpoa", "hybrid"])
@pytest.mark.parametrize("delta,with_hp", [(0, True), (6, True),
                                           (6, False), (1, False)])
def test_clusterers_match(kind, delta, with_hp):
    rng = np.random.default_rng(10 * delta + with_hp)
    reads = _locus_reads(rng, delta, 12, with_hp)
    got = clustering.SpanningReadClusterFactory.create_clusterer(
        kind, min_depth=3).cluster_spanningreads(
            _record(), [Subread(*r) for r in reads])
    want = jclustering.SpanningReadClusterFactory.create_clusterer(
        kind, min_depth=3).cluster_spanningreads(
            _record(cls=JRecordName), [JSubread(*r) for r in reads])
    assert _clustered(*got) == _clustered(*want)
    if kind == "abpoa" and delta == 6:
        assert not got[0]["is_homozygous"]


@pytest.mark.parametrize("alts", [
    ("AATA",), ("AAA",), ("ATA",), ("AAA", "AAA"), ("AAA", "ATA"),
    ("ATA", "AGA"), ("ATA", "ATA"), ("ATA", "AGA", "ACA")])
@pytest.mark.parametrize("query", ["m", "m_HOM", "m_HET"])
def test_determine_gt_and_alleles_matches(monkeypatch, alts, query):
    class Aln:
        def __init__(self, name, alt):
            self.query_name = name
            self.alt = alt

    alns = [Aln(str(RecordName(query_name=query, ref_name="chr1",
                               ref_start=10, ref_end=20, hap=h + 1)), a)
            for h, a in enumerate(alts[:2])] + [
        Aln(str(RecordName(query_name=query, ref_name="chr1",
                           ref_start=10, ref_end=20, hap=1)), a)
        for a in alts[2:]]
    results = []
    for mod in (jio_utils, io_utils):
        monkeypatch.setattr(mod, "get_alt_from_aln",
                            lambda aln, rn: aln.alt)
        try:
            results.append(mod.determine_gt_and_alleles(alns, "AAA"))
        except ValueError as e:
            results.append(("raised", str(e)))
    assert results[0] == results[1]


@pytest.mark.parametrize("ref_name,sex,phasing", [
    ("chr1", "female", "hybrid"), ("chrX", "male", "hybrid"),
    ("chrX", "female", "abpoa"), ("chr1", "male", "unphased")])
def test_determine_ploidy_matches(ref_name, sex, phasing):
    region = Region(ref_name, 20000, 20100)
    pars = [Region.from_string("chrX:10000-2781479")]
    got = tandem.determine_ploidy(region, phasing, sex, ("chrX", "chrY"),
                                  pars)
    want = jtandem.determine_ploidy(
        JRegion(*region), phasing, sex, ("chrX", "chrY"),
        [JRegion(*pars[0])])
    assert got == want


# ---------------------------------------------------------------------------
# the workflow with the majority-vote model
# ---------------------------------------------------------------------------


def _jax_majority():
    return JBundle(JMajority(), {}, feature_encoder=JCounts(),
                   label_scheme=JHaploid())


def _port_majority():
    return models.ModelBundle(MajorityVoteModel(), CountsFeatureEncoder(),
                              HaploidLabelScheme())


@pytest.fixture(scope="module")
def majority(genome, tmp_path_factory):
    """Runs of either package by (package, phasing, decompose, workers,
    padding), each made once."""
    bam, ref, loci = genome
    d = tmp_path_factory.mktemp("tandem")
    regions = [locus["region"] for locus in loci]
    done = {}

    def run(package, phasing, decompose=False, workers=1, inner=False):
        """``inner``: each region one base inside its array at each end,
        with no padding."""
        key = (package, phasing, decompose, workers, inner)
        if key not in done:
            out = str(d / "_".join(map(str, key)))
            kwargs = dict(phasing=phasing, decompose=decompose,
                          workers=workers, padding=0 if inner else 10)
            these = [Region(r.ref_name, r.start + 1, r.end - 1)
                     for r in regions] if inner else regions
            if package == "jax":
                vcf = jtandem.main(
                    bam, ref, [JRegion(*r) for r in these], out,
                    model_bundle=_jax_majority(), **kwargs)
            else:
                vcf = tandem.main(bam, ref, these, out,
                                  model_bundle=_port_majority(),
                                  device="cpu", **kwargs)
            assert vcf == os.path.join(out, "medaka_to_ref.TR.vcf")
            done[key] = out
        return done[key]
    return run


@pytest.mark.parametrize("phasing", PHASINGS)
@pytest.mark.parametrize("decompose", [False, True])
def test_majority_outputs_match(majority, genome, phasing, decompose,
                                tmp_path):
    """``decompose`` changes only the last stage (``bam_to_vcfs``): with
    ``hybrid`` both packages run the workflow with it, with the other
    phasings each decomposes its replacement-style run's BAMs."""
    _, ref, _ = genome
    jdir = majority("jax", phasing, decompose and phasing == "hybrid")
    pdir = majority("port", phasing, decompose and phasing == "hybrid")
    for name in OUTPUTS:
        assert _read(os.path.join(pdir, name)) == \
            _read(os.path.join(jdir, name)), name
    assert len(_read(os.path.join(pdir, "poa.fasta"))) > 0
    if decompose and phasing != "hybrid":
        vcfs = [mod.bam_to_vcfs(
            os.path.join(run, "medaka_to_ref.bam"), ref,
            os.path.join(run, "trimmed_reads_to_poa.bam"),
            replacement_style=False) for mod, run in (
                (jio_utils, shutil.copytree(jdir, str(tmp_path / "j"))),
                (io_utils, shutil.copytree(pdir, str(tmp_path / "p"))))]
        assert _read(vcfs[1]) == _read(vcfs[0])
        assert _read(vcfs[1]) != _read(
            os.path.join(pdir, "medaka_to_ref.TR.vcf"))


def _records(path):
    """The lines of a file as a sorted list (FASTA: one record a line)."""
    text = _read(path).decode()
    if text.startswith(">"):
        return sorted(">" + r.replace("\n", " ", 1)
                      for r in text.split(">")[1:])
    return sorted(text.splitlines())


@pytest.mark.parametrize("phasing", ["hybrid", "abpoa"])
def test_majority_two_workers_match(majority, phasing):
    """Threads append their regions' results in the order they finish
    (``generator.py``): the same records, compared sorted."""
    jdir = majority("jax", phasing, workers=2)
    pdir = majority("port", phasing, workers=2)
    one = majority("port", phasing)
    for name in OUTPUTS:
        got = _records(os.path.join(pdir, name))
        assert got == _records(os.path.join(jdir, name)), name
        assert got == _records(os.path.join(one, name)), name


def test_majority_empty_reads_sentinel(majority, genome):
    """Regions inside their arrays, no padding: the reads of the deleted
    arrays arrive empty and become "N" (``io_utils.SpanningReadsExtractor``);
    both packages write the same bytes."""
    jdir = majority("jax", "hybrid", inner=True)
    pdir = majority("port", "hybrid", inner=True)
    for name in OUTPUTS + ("trimmed_reads.fasta",):
        assert _read(os.path.join(pdir, name)) == \
            _read(os.path.join(jdir, name)), name
    trimmed = _read(os.path.join(pdir, "trimmed_reads.fasta")).decode()
    assert "\nN\n" in trimmed


@pytest.mark.parametrize("phasing", ["prephased", "hybrid", "abpoa"])
def test_majority_genotypes_recovered(majority, genome, phasing):
    """Each called locus has its planted genotype and allele lengths
    within one base (a deleted array reads as its one-base anchor);
    ``hybrid`` and ``abpoa`` call every locus, ``prephased`` every locus
    whose reads are all tagged (held to the bar) and none whose reads are
    untagged."""
    _, _, loci = genome
    called = testing.str_genotypes(
        os.path.join(majority("port", phasing), "medaka_to_ref.TR.vcf"),
        loci)
    if phasing == "prephased":
        assert {i for i, locus in enumerate(loci) if locus["phased"]} \
            <= set(called)
        assert not any(loci[i]["phased"] is False for i in called)
    else:
        assert sorted(called) == list(range(len(loci)))
    for i, (gt, got_gt, lengths, got_lengths) in called.items():
        if phasing == "prephased" and not loci[i]["phased"]:
            continue  # a few tagged reads of one haplotype: no bar
        assert got_gt == gt, (i, loci[i]["kind"])
        assert all(abs(a - b) <= 1
                   for a, b in zip(lengths, got_lengths)), (i, lengths,
                                                            got_lengths)


# ---------------------------------------------------------------------------
# the workflow with the bundled GRU, full precision
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def gru_runs(tmp_path_factory):
    """Five loci (one of each kind, phased), depth 10 a haplotype, through
    each package's ``tandem`` with the bundled counts GRU."""
    d = tmp_path_factory.mktemp("gru")
    bam, ref, loci = testing.create_str_bam(
        str(d / "reads.bam"), n_loci=5, depth=10, seed=2, spacing=1200)
    regions = [locus["region"] for locus in loci]
    first = jax.devices()[:1]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "devices", lambda *args, **kw: first)
        jtandem.main(bam, ref, [JRegion(*r) for r in regions],
                     str(d / "jax"), model=MODEL)
    tandem.main(bam, ref, regions, str(d / "port"), model=MODEL,
                device="cpu")
    return str(d / "jax"), str(d / "port"), loci


def test_gru_probabilities_match(gru_runs):
    jdir, pdir, _ = gru_runs
    want = probs(os.path.join(jdir, "consensus_probs.hdf"))
    got = probs(os.path.join(pdir, "consensus_probs.hdf"))
    assert sorted(got) == sorted(want) and len(got) >= 5
    assert max(np.abs(got[k] - want[k]).max() for k in want) <= 1e-4


def test_gru_vcf_matches(gru_runs):
    jdir, pdir, loci = gru_runs
    for name in OUTPUTS:
        assert _read(os.path.join(pdir, name)) == \
            _read(os.path.join(jdir, name)), name
    called = testing.str_genotypes(
        os.path.join(pdir, "medaka_to_ref.TR.vcf"), loci)
    assert sorted(called) == list(range(len(loci)))
    assert all(gt == got for gt, got, _, _ in called.values())


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------


def test_cli_cpu_gives_library_bytes(genome, majority, tmp_path):
    bam, ref, loci = genome
    bundle = models.save_model(
        str(tmp_path / "majority.tar.gz"), MajorityVoteModel(),
        CountsFeatureEncoder(), HaploidLabelScheme())
    regions = [str(locus["region"]) for locus in loci]
    out = str(tmp_path / "cli")
    assert cli.main(["tandem", bam, ref, out, "--regions", *regions,
                     "--model", bundle, "--cpu", "--quiet"]) == 0
    lib = majority("port", "hybrid")
    for name in OUTPUTS:
        assert _read(os.path.join(out, name)) == \
            _read(os.path.join(lib, name)), name
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no GPU"):
            cli.main(["tandem", bam, ref, str(tmp_path / "gpu"),
                      "--regions", *regions, "--model", bundle, "--quiet"])
        assert not os.path.exists(str(tmp_path / "gpu"))
