"""The port's read mapper, ``align_reads``, ``tag_merge_bams``, the read
trimmer and ``tools annotate`` against ``medaka_tpu`` on the CPU.

- ``Mapper.map_all`` returns ``medaka_tpu.native.Mapper.map_all``'s
  mappings on the cases of tests/test_mapping.py: exact placement,
  reverse strand, garbage unmapped, several contigs, a repetitive genome
  (MAPQ 0) and a chimeric read (a supplementary).
- ``align_reads`` and the ``align`` subcommand write the same BAM bytes at
  threads 1 and 2, with MD tags, a ``min_score`` gate and
  ``tags_by_read``; ``compute_md`` gives the same tags.
- ``tag_merge_bams`` writes the same bytes.
- ``get_trimmed_reads`` yields the same reads, partial or not.
- ``tools annotate`` writes the same VCF bytes, with the spanning-read
  annotations on and off, a read-group filter and chunks that split the
  variants.
- ``testing.write_reads_fastq`` reads map back to their true starts.
- A native library that fails to build raises; nothing maps without it.

Every comparison is exact: both packages run the same C++ source and the
same host code.
"""
import dataclasses

import numpy as np
import pytest

from medaka_tpu import cli as jcli
from medaka_tpu import common as jcommon
from medaka_tpu import features as jfeatures
from medaka_tpu import mapping as jmapping
from medaka_tpu import native as jnative
from medaka_tpu_torch import cli, common, features, mapping, native, \
    testing
from medaka_tpu_torch.io.bam import BamReader
from medaka_tpu_torch.io.fastx import FastaReader, FastaWriter


def rand_seq(n, seed):
    rng = np.random.default_rng(seed)
    return np.frombuffer(b"ACGT", np.uint8)[
        rng.integers(0, 4, n)].tobytes().decode()


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def _hits(mapper, seq):
    return [dataclasses.asdict(h) for h in mapper.map_all(seq)]


def _mappers(refs):
    return native.Mapper(refs), jnative.Mapper(refs)


def test_mapper_unique_genome():
    """Exact placement (with a substitution and a deletion), the reverse
    strand, and a random read that maps nowhere."""
    ref = rand_seq(50000, 0)
    port, ref_mapper = _mappers([("c1", ref)])
    read = list(ref[10000:15000])
    read[100] = "A" if read[100] != "A" else "C"
    del read[2000]
    read = "".join(read)
    cases = {"exact": read,
             "reverse": common.reverse_complement(ref[20000:24000]),
             "garbage": rand_seq(3000, 99)}
    got = {k: _hits(port, s) for k, s in cases.items()}
    assert got == {k: _hits(ref_mapper, s) for k, s in cases.items()}
    assert (got["exact"][0]["ref_start"], got["exact"][0]["flag"],
            got["exact"][0]["cigar"]) == (10000, 0, "100=1X1899=1D2999=")
    assert (got["reverse"][0]["ref_start"], got["reverse"][0]["flag"]) == \
        (20000, 16)
    assert got["garbage"] == [] and port.map(cases["garbage"]) is None
    port.close()


def test_mapper_multi_contig_and_chimera():
    """A read of the second contig; a chimera of two contigs gives a
    primary and a supplementary on the other strand."""
    refs = [("a", rand_seq(20000, 1)), ("b", rand_seq(20000, 2))]
    with native.Mapper(refs) as port:
        ref_mapper = jnative.Mapper(refs)
        read = refs[1][1][5000:9000]
        chimera = refs[0][1][0:1500] + common.reverse_complement(
            refs[1][1][2000:3500])
        for seq in (read, chimera):
            assert _hits(port, seq) == _hits(ref_mapper, seq)
        assert (port.map(read).ref_id, port.map(read).ref_start) == (1, 5000)
        hits = port.map_all(chimera)
        assert sorted(h.is_supplementary for h in hits) == [False, True]
        assert {(h.ref_id, h.flag & 16, h.ref_start) for h in hits} == \
            {(0, 0, 0), (1, 16, 2000)}


def test_mapper_repetitive_genome():
    """A read inside a duplicated 2 kb segment maps with MAPQ near 0; a
    unique read with MAPQ of at least 50."""
    a, b = rand_seq(4000, 11), rand_seq(4000, 12)
    dup = a[1000:3000]
    ref = a[:1000] + dup + b[:500] + dup + b[500:]
    port, ref_mapper = _mappers([("rep", ref)])
    for seq in (ref[100:900], dup[200:1800]):
        assert _hits(port, seq) == _hits(ref_mapper, seq)
    assert port.map(ref[100:900]).mapq >= 50
    assert port.map(dup[200:1800]).mapq < 5


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    """A 20 kb ``create_synth_bam`` genome at depth 8 as FASTQ, plus a
    second contig, a chimeric read across the two, a short chimera whose
    primary scores below 1000, and a random read."""
    d = tmp_path_factory.mktemp("reads")
    bam, ref = testing.create_synth_bam(str(d / "synth.bam"), ref_mb=0.02,
                                        depth=8, seed=1, read_len=2000)
    fastq = str(d / "reads.fastq")
    truth = testing.write_reads_fastq(bam, fastq)
    with FastaWriter(str(d / "draft.fasta")) as fw, open(fastq, "a") as fh:
        with FastaReader(ref) as fr:
            genome = fr.fetch("synth")
        other = rand_seq(8000, 5)
        fw.write("synth", genome)
        fw.write("other", other)
        extra = {
            "chimera": genome[3000:4500] + common.reverse_complement(
                other[2000:3500]),
            "low_primary": genome[100:500] + common.reverse_complement(
                other[1000:1300]),
            "garbage": rand_seq(1500, 6)}
        for name, seq in extra.items():
            fh.write("@{}\n{}\n+\n{}\n".format(name, seq, "5" * len(seq)))
    return {"dir": d, "fastq": fastq, "draft": str(d / "draft.fasta"),
            "truth": truth}


@pytest.mark.parametrize("threads,options", [
    (1, {}),
    (2, {"md": True}),
    (1, {"min_score": 1000, "md": True}),
    (2, {"tags_by_read": {"r3": {"RG": "rg1", "mv": [5, 1, 0, 1]},
                          "chimera": {"HP": 2}}, "band": 100})])
def test_align_reads_matches(reads, threads, options):
    """The mapped BAM and its index: ``medaka_tpu``'s bytes, and the same
    at 1 and 2 threads; every synthetic read placed within 50 bases of
    its true start on its strand."""
    d = reads["dir"]
    tag = "{}_{}".format(threads, "_".join(sorted(options)))
    got, want = str(d / "port_{}.bam".format(tag)), \
        str(d / "jax_{}.bam".format(tag))
    stats = mapping.align_reads(reads["fastq"], reads["draft"], got,
                                threads=threads, **options)
    assert stats == jmapping.align_reads(reads["fastq"], reads["draft"],
                                         want, threads=threads, **options)
    assert _read(got) == _read(want)
    assert _read(got + ".bai") == _read(want + ".bai")
    assert stats["unmapped"] >= 1
    mapped, wrong = testing.placement(got, reads["truth"])
    assert mapped == 1.0 and not wrong
    with BamReader(got) as reader:
        recs = list(reader)
    # no supplementary without its primary; the min_score gate drops the
    # low-scoring chimera whole
    primaries = {r.query_name for r in recs if not r.flag & 2048}
    supplementary = {r.query_name for r in recs if r.flag & 2048}
    assert "chimera" in supplementary and supplementary <= primaries
    assert ("low_primary" in primaries) == ("min_score" not in options)
    if options.get("md"):
        assert all("MD" in r.tags for r in recs)
    if "tags_by_read" in options:
        assert [r.tags["RG"] for r in recs if r.query_name == "r3"] == \
            ["rg1"]


def test_align_cli_and_threads_match(reads):
    """``align`` (``--band``) writes ``medaka_tpu align``'s bytes, and
    ``align_reads`` at 2 threads writes what 1 thread writes."""
    d = reads["dir"]
    got, want = str(d / "cli_port.bam"), str(d / "cli_jax.bam")
    args = [reads["fastq"], reads["draft"]]
    assert cli.main(["align"] + args + [got, "-t", "2", "--band", "300"]) \
        == 0
    assert jcli.main(["align"] + args + [want, "-t", "2", "--band",
                                         "300"]) == 0
    assert _read(got) == _read(want)
    one = str(d / "one.bam")
    mapping.align_reads(reads["fastq"], reads["draft"], one, threads=1,
                        band=300)
    assert _read(one) == _read(got)


def test_compute_md_matches():
    """MD tags of seeded alignments with substitutions, insertions and
    deletions, from a query offset, as ``medaka_tpu``'s."""
    rng = np.random.default_rng(7)
    for i in range(20):
        ref = rand_seq(600, 100 + i)
        q = list(ref[50:550])
        for pos in rng.integers(0, len(q) - 1, 6):
            q[pos] = "ACGT"[(("ACGT".index(q[pos])) + 1) % 4]
        cut = int(rng.integers(100, 400))
        q = q[:cut] + q[cut + 3:]
        q.insert(int(rng.integers(10, 300)), "T")
        query = "GG" + "".join(q)
        aln = native.align(query[2:], ref, mode="hw")
        assert mapping.compute_md(ref, aln.ref_start, aln.cigar, query,
                                  query_start=2) == \
            jmapping.compute_md(ref, aln.ref_start, aln.cigar, query,
                                query_start=2)


def test_tag_merge_bams_matches(reads, tmp_path):
    """Two mapped BAMs tagged DT=r9 and r10 and merged: the same bytes;
    a mismatch of inputs and values, or an existing output, raises."""
    bams = []
    for i in range(2):
        path = str(tmp_path / "in{}.bam".format(i))
        mapping.align_reads(reads["fastq"], reads["draft"], path)
        bams.append(path)
    got, want = str(tmp_path / "port.bam"), str(tmp_path / "jax.bam")
    common.tag_merge_bams(bams, ["r9", "r10"], "DT", got)
    jcommon.tag_merge_bams(bams, ["r9", "r10"], "DT", want)
    assert _read(got) == _read(want)
    with BamReader(got) as reader:
        assert {r.tags["DT"] for r in reader} == {"r9", "r10"}
    with pytest.raises(ValueError, match="must match"):
        common.tag_merge_bams(bams, ["r9"], "DT", str(tmp_path / "x.bam"))
    with pytest.raises(ValueError, match="exists"):
        common.tag_merge_bams(bams, ["r9", "r10"], "DT", got)


@pytest.fixture(scope="module")
def variant_reads(tmp_path_factory):
    """A 30 kb ``create_variant_bam`` genome at depth 20: its reads mapped
    by the port, half of them in read group ``rg1``, and its truth VCF."""
    d = tmp_path_factory.mktemp("ann")
    bam, ref, truth_vcf, _ = testing.create_variant_bam(
        str(d / "lift.bam"), ref_mb=0.03, depth=20, seed=2)
    fastq = str(d / "reads.fastq")
    truth = testing.write_reads_fastq(bam, fastq)
    groups = {name: {"RG": "rg1"} for i, name in enumerate(sorted(truth))
              if i % 2}
    mapped = str(d / "mapped.bam")
    mapping.align_reads(fastq, ref, mapped, threads=2, tags_by_read=groups)
    return {"dir": d, "bam": mapped, "ref": ref, "vcf": truth_vcf,
            "truth": truth}


@pytest.mark.parametrize("region,split,partial", [
    (("synth", 5000, 5060), 120, False), (("synth", 5000, 9000), 750, True),
    (("synth", 0, 30000), 1500, False)])
def test_trimmed_reads_match(variant_reads, region, split, partial):
    """``get_trimmed_reads``: the same sub-regions and trimmed reads as
    ``medaka_tpu.features``'s."""
    got = [(tuple(r), [tuple(s) for s in seqs])
           for r, seqs in features.get_trimmed_reads(
               common.Region(*region), variant_reads["bam"],
               region_split=split, partial=partial)]
    want = [(tuple(r), [tuple(s) for s in seqs])
            for r, seqs in jfeatures.get_trimmed_reads(
                jcommon.Region(*region), variant_reads["bam"],
                region_split=split, partial=partial)]
    assert got == want
    assert sum(len(seqs) - 1 for _, seqs in got) > 10


@pytest.mark.parametrize("flags", [
    [], ["--no-dpsp"], ["--RG", "rg1"], ["--chunk_size", "7000",
                                         "--pad", "15"]])
def test_annotate_matches(variant_reads, flags, tmp_path):
    """``tools annotate`` of the truth VCF against the mapped reads:
    ``medaka_tpu``'s bytes; every record carries DP and DPS, and DPSP, SR,
    SC and AR unless ``--no-dpsp``."""
    args = [variant_reads["vcf"], variant_reads["ref"], variant_reads["bam"]]
    got, want = str(tmp_path / "port.vcf"), str(tmp_path / "jax.vcf")
    assert cli.main(["tools", "annotate"] + args + [got] + flags) == 0
    assert jcli.main(["tools", "annotate"] + args + [want] + flags) == 0
    assert _read(got) == _read(want)
    rows = [line.split("\t") for line in _read(got).decode().split("\n")
            if line and not line.startswith("#")]
    assert len(rows) > 20
    keys = {"DP", "DPS"} | (set() if "--no-dpsp" in flags
                            else {"DPSP", "SR", "SC", "AR"})
    for row in rows:
        assert keys <= {kv.split("=")[0] for kv in row[7].split(";")}


def test_failed_native_build_raises(reads, tmp_path, monkeypatch):
    """A native library that does not build raises ``NativeBuildError``
    from the mapper: nothing maps quietly without it, and the failure is
    kept for the next call instead of compiling again."""
    src = tmp_path / "src"
    src.mkdir()
    for name in native._SOURCES:
        (src / name).write_text("#error a broken source\n")
    monkeypatch.setattr(native, "_SRC_DIR", str(src))
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_LOAD_ERROR", None)
    out = tmp_path / "calls.bam"
    with pytest.raises(native.NativeBuildError, match="Failed to build"):
        mapping.align_reads(reads["fastq"], reads["draft"], str(out))
    assert not out.exists()
    with pytest.raises(native.NativeBuildError, match="cached"):
        native.Mapper([("a", "ACGT" * 10)])
    assert not native.available()
