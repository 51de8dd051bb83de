"""The port's native aligner, ``align.py`` and ``tools consensus2vcf``
against ``medaka_tpu`` on the CPU.

- ``native.align`` in modes nw/hw/sw/shw, with no band and with a band,
  on seeded random pairs with substitutions and indels: the same score,
  coordinates and cigar, call for call. ``edit_distance`` the same, with
  and without ``max_k``.
- The cigar helpers (``trim_cigar``, ``cigar_lengths``), ``local_to_sam``
  and ``sw_align`` give the same values.
- ``chunked_align`` in modes NW/HW/HWT yields the same records, byte for
  byte, on contigs with a chunk that holds a net deletion.
- ``tools consensus2vcf`` writes the same VCF, BAM and coverage beds in
  each mode.

Every comparison is exact: both packages run the same C++ source.
"""
import dataclasses

import numpy as np
import pytest

from medaka_tpu import align as jalign
from medaka_tpu import cli as jcli
from medaka_tpu import native as jnative
from medaka_tpu_torch import align, cli, native
from medaka_tpu_torch.io.fastx import FastaWriter

BASES = np.array(list("ACGT"))


def rand_seq(rng, n):
    return "".join(BASES[rng.integers(0, 4, n)])


def mutate(rng, seq, rate=0.03, max_indel=4):
    """``seq`` with substitutions, insertions and deletions at ``rate``."""
    out, i = [], 0
    while i < len(seq):
        r = rng.random()
        if r < rate / 3:
            out.append(BASES[(BASES.tolist().index(seq[i])
                              + rng.integers(1, 4)) % 4])
            i += 1
        elif r < 2 * rate / 3:
            out.append(rand_seq(rng, int(rng.integers(1, max_indel + 1))))
        elif r < rate:
            i += int(rng.integers(1, max_indel + 1))
        else:
            out.append(seq[i])
            i += 1
    return "".join(out)


def pairs(seed, n=6):
    """(query, reference) pairs: a mutated copy of the reference, and a
    mutated piece of it with flanks (for the modes with free ends)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ref = rand_seq(rng, int(rng.integers(200, 1200)))
        out.append((mutate(rng, ref), ref))
        a = int(rng.integers(0, len(ref) // 3))
        b = int(rng.integers(2 * len(ref) // 3, len(ref)))
        out.append((mutate(rng, ref[a:b]), ref))
    return out


@pytest.mark.parametrize("band", [0, 25])
@pytest.mark.parametrize("mode", ["nw", "hw", "sw", "shw"])
def test_align_matches(mode, band):
    """Each call: the same score, coordinates and cigar as
    ``medaka_tpu.native.align``, at the default scores and at the
    annotator's (match 5, mismatch 4, open 2, extend 3)."""
    for seed in (0, 1):
        for query, ref in pairs(seed):
            for scores in ({}, dict(match=5, mismatch=4, gap_open=2,
                                    gap_extend=3)):
                got = native.align(query, ref, mode=mode, band=band,
                                   **scores)
                want = jnative.align(query, ref, mode=mode, band=band,
                                     **scores)
                assert dataclasses.asdict(got) == dataclasses.asdict(want)
                assert got.cigar


@pytest.mark.parametrize("max_k", [-1, 5, 40])
def test_edit_distance_matches(max_k):
    """Unit-cost distance (-1 beyond ``max_k``) as ``medaka_tpu``'s."""
    values = []
    for query, ref in pairs(2):
        got = native.edit_distance(query, ref, max_k)
        assert got == jnative.edit_distance(query, ref, max_k)
        values.append(got)
    if max_k == 5:
        assert -1 in values


def test_cigar_helpers_match():
    """``trim_cigar`` at both ends, ``cigar_lengths``, ``local_to_sam``
    and ``sw_align`` give ``medaka_tpu.align``'s values."""
    for cigar in ("2X1I5=3D2=", "1D1I10=4X", "7=", "3I2X4=1I1X", "4=2D1X"):
        for start in (True, False):
            assert align.trim_cigar(cigar, start) == \
                jalign.trim_cigar(cigar, start)
        assert align.cigar_lengths(cigar) == jalign.cigar_lengths(cigar)
    with pytest.raises(ValueError):
        align.trim_cigar("3S4=", True)
    for query, ref in pairs(3, n=3):
        got = native.align(query, ref, mode="sw")
        assert align.local_to_sam(got, query) == \
            jalign.local_to_sam(jnative.align(query, ref, mode="sw"), query)
        assert align.sw_align(query, ref) == jalign.sw_align(query, ref)


def contig_pair(seed, n=26000):
    """A reference and a polished copy of it: SNPs, small indels, and a
    400-base deletion and 300-base insertion that make net indels inside
    one chunk."""
    rng = np.random.default_rng(seed)
    ref = rand_seq(rng, n)
    query = mutate(rng, ref, rate=0.002, max_indel=3)
    cut = len(query) // 2
    query = query[:cut] + query[cut + 400:]
    cut = len(query) // 4
    query = query[:cut] + rand_seq(rng, 300) + query[cut:]
    return query, ref


@pytest.mark.parametrize("mode", ["NW", "HW", "HWT"])
def test_chunked_align_matches(mode):
    """The records of ``chunked_align`` (name, place, cigar, NM), byte for
    byte, with a chunk holding each net indel."""
    for seed in (4, 5):
        query, ref = contig_pair(seed)
        got = list(align.chunked_align(query, ref, "ctg", chunk_size=6000,
                                       pad=1000, mode=mode))
        want = list(jalign.chunked_align(query, ref, "ctg",
                                         chunk_size=6000, pad=1000,
                                         mode=mode))
        assert len(got) >= 4
        assert [r.raw for r in got] == [r.raw for r in want]
    with pytest.raises(KeyError):
        next(align.chunked_align("ACGT", "ACGT", "c", mode="SW"))


@pytest.fixture(scope="module")
def consensus_files(tmp_path_factory):
    """Two contigs of a reference, an N in the second, and a consensus of
    each with variants."""
    d = tmp_path_factory.mktemp("c2v")
    ref_fa, cons_fa = str(d / "ref.fasta"), str(d / "cons.fasta")
    q1, r1 = contig_pair(6)
    q2, r2 = contig_pair(7, n=9000)
    r2 = r2[:3000] + "N" + r2[3001:]
    with FastaWriter(ref_fa) as fw:
        fw.write("ctg1", r1)
        fw.write("ctg2", r2)
    with FastaWriter(cons_fa) as fw:
        fw.write("ctg1", q1)
        fw.write("ctg2", q2)
    return d, ref_fa, cons_fa


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("flags", [
    ["--mode", "NW"], ["--mode", "HW", "--chunk_size", "6000"],
    ["--mode", "HWT", "--chunk_size", "6000"],
    ["--mode", "NW", "--chunk_size", "4000",
     "--regions", "ctg2"]])
def test_consensus2vcf_matches(consensus_files, flags):
    """``tools consensus2vcf``: the VCF, the chunk BAM and its index, and
    both coverage beds are ``medaka_tpu``'s bytes."""
    d, ref_fa, cons_fa = consensus_files
    tag = "_".join(f.strip("-") for f in flags)
    port, ref = str(d / ("port_" + tag)), str(d / ("jax_" + tag))
    assert cli.main(["tools", "consensus2vcf", cons_fa, ref_fa,
                     "--out_prefix", port] + flags) == 0
    assert jcli.main(["tools", "consensus2vcf", cons_fa, ref_fa,
                      "--out_prefix", ref] + flags) == 0
    for suffix in (".vcf", ".bam", ".bam.bai", "_coverage.bed",
                   "_coverage_gaps.bed"):
        assert _read(port + suffix) == _read(ref + suffix), suffix
    records = [line for line in _read(port + ".vcf").decode().split("\n")
               if line and not line.startswith("#")]
    assert len(records) > 10


#: the last chunk of a 0.1 Mb consensus against its reference (a
#: ``create_variant_bam`` genome at seed 1 polished by ``consensus``):
#: both start on the previous chunk's last match column, and their global
#: alignment opens with an insertion (``2I3=1I90=``)
LAST_QUERY = ("GGGTGCGTACCTGGCACTTAATCCTGAAATTGCGGTTCGTTTTTATATCGCTGCCTTTGCGGAG"
              "TACGGAAAGATGGGGCACTAGACAGGCTCAAT")
LAST_REF = ("GTGGTACCTGGCACTTAATCCTGAAATTGCGGTTCGTTTTTATATCGCTGCCTTTGCGGAGTACG"
            "GAAAGATGGGGCACTAGACAGGCTCAAT")


@pytest.mark.parametrize("mode", ["NW", "HW"])
def test_chunk_opening_with_an_indel(mode):
    """Where a continuation chunk's alignment opens with an indel,
    ``medaka_tpu`` raises ("did not start with a match"); the port keeps
    the shared match column and aligns the rest in the same mode: the
    records before it are ``medaka_tpu``'s, the chunk starts on a match
    and spans the rest of both sequences."""
    rng = np.random.default_rng(8)
    prefix = rand_seq(rng, 1999) + LAST_QUERY[0]
    query, ref = prefix + LAST_QUERY[1:], prefix + LAST_REF[1:]
    assert jnative.align(LAST_QUERY, LAST_REF, mode="nw",
                         band=1000).cigar == "2I3=1I90="
    want = []
    with pytest.raises(ValueError, match="did not start with a match"):
        for rec in jalign.chunked_align(query, ref, "ctg", chunk_size=2000,
                                        pad=200, mode=mode):
            want.append(rec)
    got = list(align.chunked_align(query, ref, "ctg", chunk_size=2000,
                                   pad=200, mode=mode))
    assert [r.raw for r in got[:len(want)]] == [r.raw for r in want]
    last = got[-1]
    assert len(got) == len(want) + 1
    assert (last.pos, last.reference_end) == (1999, len(ref))
    assert last.query_sequence == LAST_QUERY
    cigar = "".join("{}{}".format(n, "MIDNSHP=X"[op])
                    for op, n in last.cigar_array)
    assert cigar == "1=2I2=1I90=" and last.tags["NM"] == 3
