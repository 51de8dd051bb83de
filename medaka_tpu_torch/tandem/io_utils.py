"""Spanning-read extraction and VCF export for tandem genotyping.

Counterpart of ``medaka_tpu/tandem/io_utils.py`` (the reference's
``medaka/tandem/io.py``), on the port's ``vcf``, ``variant``, ``io.bam``
and ``io.fastx``.
"""
from __future__ import annotations

import collections
import os
from typing import Dict, List

import numpy as np

from medaka_tpu_torch import common
from medaka_tpu_torch import variant as variant_mod
from medaka_tpu_torch import vcf as vcf_mod
from medaka_tpu_torch.features import get_trimmed_reads
from medaka_tpu_torch.io.bam import BamReader
from medaka_tpu_torch.io.fastx import FastaReader
from medaka_tpu_torch.smolecule import Subread
from medaka_tpu_torch.tandem.record_name import RecordName


class SpanningReadsExtractor:
    """Extract reads fully spanning a (padded) region as Subreads."""

    def __init__(self, bam_path: str, read_filters: Dict):
        """:param read_filters: e.g. {'min_mapq': 5}."""
        self.bam_path = bam_path
        self.read_filters = dict(read_filters)

    def get_subreads(self, rec: RecordName) -> List[Subread]:
        """Spanning reads of the padded region, oriented forward,
        names encoding strand/HP/PS (reference ``io.py:39-80``)."""
        region = rec.to_padded_region()
        _ref_seq, reads = self.get_trimmed_reads(region)
        rn_kwargs = {
            k: v for k, v in vars(rec).items()
            if k not in {"query_name", "strand", "hap", "phased_set"}}
        subreads = []
        for is_rev, read_name, seq, hap, phased_set in reads:
            # a read supporting full deletion of the array arrives with
            # an empty sequence; the "N" sentinel is what the consensus
            # and clustering stages key on (generator.py
            # consensus_from_reads) — and keeps RLE/POA off empties
            oriented = common.reverse_complement(seq) if is_rev else seq
            subreads.append(Subread(
                str(RecordName(
                    query_name=str(read_name),
                    strand="rev" if is_rev else "fwd", hap=hap,
                    phased_set=phased_set, **rn_kwargs)),
                oriented or "N"))
        return subreads

    def get_trimmed_reads(self, region: common.Region):
        """(ref placeholder, spanning reads) for a region."""
        result = next(
            get_trimmed_reads(
                region, self.bam_path, partial=False,
                region_split=2 * region.size, include_empty_reads=True,
                **self.read_filters),
            (region, []))
        region_got, reads = result
        if not reads:
            raise ValueError(
                "No reads found for {} nor even reference sequence; "
                "check bam file {}".format(region, self.bam_path))
        if region != region_got:
            raise ValueError(
                "Expected region {}, got region {}".format(
                    region, region_got))
        ref_entry = reads.pop(0)
        return ref_entry.seq, reads


# ---------------------------------------------------------------------------
# VCF export
# ---------------------------------------------------------------------------


def create_vcf_header_meta():
    """Header meta lines (reference ``io.py:252-323``)."""
    M = vcf_mod.MetaInfo
    return [
        M("INFO", "rec", ".", "String",
          "Name for haplotype-specific consensus record."),
        M("FORMAT", "GT", 1, "String", "Genotype."),
        M("FORMAT", "PS", 1, "Integer", "Phase set identifier."),
        M("FORMAT", "SD", ".", "Integer",
          "Number of spanning reads supporting each allele, reported "
          "separately per haplotype when phased."),
        M("FORMAT", "MAD", ".", "Float",
          "Median absolute deviation of read lengths per haplotype."),
        M("FORMAT", "ALLR", ".", "String",
          "Allele length range per haplotype."),
        M("INFO", "read_names_hap1", "1", "String",
          "Names of supporting reads for hap1."),
        M("INFO", "read_names_hap2", "1", "String",
          "Names of supporting reads for hap2."),
        M("INFO", "read_names_hap0", "1", "String",
          "Names of supporting reads for sex chromosome."),
    ]


def get_alt_from_aln(aln, record: RecordName) -> str:
    """Consensus subsequence covering the (unpadded) repeat region.

    Reference rule (``io.py:121-146``) plus one extension: an insertion
    run abutting the first in-range match is pulled into the window.
    Global alignment left-aligns an expanded repeat to the region start
    boundary, which the plain inclusive-range rule would miss.
    """
    pairs = list(aln.get_aligned_pairs())
    in_range = [
        i for i, (q, r) in enumerate(pairs)
        if q is not None and r is not None
        and record.ref_start <= r <= record.ref_end]
    if not in_range:
        return "<DEL>"
    first, last = in_range[0], in_range[-1]
    # absorb a left-adjacent insertion run (ref is None)
    while first > 0 and pairs[first - 1][1] is None \
            and pairs[first - 1][0] is not None:
        first -= 1
    qstart = pairs[first][0]
    qend = pairs[last][0]
    if qstart == qend:
        return aln.query_sequence[qstart]
    # NOTE: the slice excludes the base aligned at ref_end (the
    # single-base branch above treats it inclusively) — this mirrors
    # the reference exactly (``io.py:140-146``), and the tandem truth
    # goldens pin the resulting alleles
    return aln.query_sequence[qstart:qend]


def determine_gt_and_alleles(alignments, ref_seq: str):
    """(alts, genotype) for one or two consensus alignments.

    Reference: ``io.py:149-191``.
    """
    if len(alignments) > 2:
        raise ValueError("More than two consensus sequences found.")
    rn = RecordName.from_str(alignments[0].query_name)
    alts = [get_alt_from_aln(a, rn) for a in alignments]
    alleles = set(alts + [ref_seq])
    if rn.query_name.endswith("_HOM"):
        if alts[0] == ref_seq:
            return ".", "0|0"
        return alts[0], "1|1"
    if len(alleles) == 1:
        if len(alts) == 2:
            return ".", "0|0"
        return ".", "0|." if rn.hap == 1 else ".|0"
    if len(alleles) == 2:
        if len(alts) == 1:
            return alts, "1|." if rn.hap == 1 else ".|1"
        genotype = "{}|{}".format(
            int(ref_seq != alts[0]), int(ref_seq != alts[1]))
        return alts[1] if ref_seq == alts[0] else alts[0], genotype
    if len(alleles) == 3:
        return alts, "1|2"
    raise ValueError("Impossible")


def _reads_of(reads_bam: BamReader, query_name: str, _length: int = 0):
    """All reads aligned to a consensus contig in the trimmed-reads bam."""
    try:
        idx = reads_bam.references.index(query_name)
    except ValueError:
        return []
    return list(
        reads_bam.fetch(query_name, 0, reads_bam.lengths[idx]))


def convert_alignments_to_variants_replacement_style(
        alignments, reads_bam, add_read_names, ref_fasta):
    """One whole-allele record per region (reference ``io.py:422-500``)."""
    fmt = {}
    info = {}
    depths, ranges, mads = [], [], []
    chrom = RecordName.from_str(alignments[0].query_name).ref_name
    for aln in alignments:
        rn = RecordName.from_str(aln.query_name)
        reads = _reads_of(reads_bam, aln.query_name, len(
            aln.query_sequence or ""))
        if add_read_names:
            info["read_names_hap{}".format(rn.hap)] = [
                RecordName.from_str(r.query_name).query_name
                for r in reads]
        lens = np.array(
            [r.query_length for r in reads]) if reads else np.array([0])
        ranges.append("{}-{}".format(int(lens.min()), int(lens.max())))
        med = np.median(lens)
        mads.append("{:.2f}".format(np.median(np.abs(lens - med))))
        depths.append(str(len(reads)))
    fmt["SD"] = ",".join(depths)
    fmt["ALLR"] = ",".join(ranges)
    fmt["MAD"] = ",".join(mads)

    rns = [RecordName.from_str(a.query_name) for a in alignments]
    ref = ref_fasta.fetch(chrom)[
        rns[0].ref_start:rns[0].ref_end].upper()
    alts, gt = determine_gt_and_alleles(alignments, ref)
    info["rec"] = [a.query_name for a in alignments]

    phase_sets = list({r.phased_set for r in rns})
    is_phased = len(phase_sets) == 1 and phase_sets[0] != 0
    is_phased &= not rns[0].query_name.endswith("_HOM")
    is_phased &= not rns[0].query_name.endswith("_HET")
    if is_phased:
        fmt["PS"] = phase_sets[0]
        fmt["GT"] = gt
    else:
        fmt["GT"] = "/".join(gt.split("|"))
    ident = "{}_{}_{}".format(
        rns[0].ref_name, rns[0].ref_start, rns[0].ref_end)
    return vcf_mod.Variant(
        chrom=chrom, pos=rns[0].ref_start, ref=ref, alt=alts, ident=ident,
        genotype_data=fmt, info=info)


def convert_alignments_to_variants_decomposition(
        alignments, reads_bam, add_read_names, rseq):
    """Left-aligned per-difference records (reference ``io.py:368-419``)."""
    results = []
    for aln in alignments:
        rn = RecordName.from_str(aln.query_name)
        reads = _reads_of(reads_bam, aln.query_name, len(
            aln.query_sequence or ""))
        depth = len(reads)
        for v in variant_mod.yield_variants_from_aln(
                aln, rseq, rn.ref_name):
            if not (rn.ref_start <= v.pos <= rn.ref_end):
                continue
            v.genotype_data = v.genotype_data or {}
            v.genotype_data["SD"] = depth
            v.ident = "{}_{}_{}_{}_hap{}".format(
                rn.ref_name, rn.ref_start, rn.ref_end, v.pos, rn.hap)
            if add_read_names:
                v.info["read_names_hap{}".format(rn.hap)] = [
                    RecordName.from_str(r.query_name).query_name
                    for r in reads]
            if rn.query_name.endswith("_HOM"):
                v.genotype_data["GT"] = "1|1"
            elif rn.hap == 1:
                v.genotype_data["GT"] = "1|0"
            elif rn.hap == 2:
                v.genotype_data["GT"] = "0|1"
            results.append(v)
    return results


def bam_to_vcfs(bam_fp, ref_fasta, trimmed_reads_to_poa, *,
                replacement_style=False, add_read_names=False,
                sample_name="SAMPLE"):
    """Decode per-region consensus alignments into the TR VCF.

    Reference: ``io.py:503-566``. Writes ``<prefix>.TR.vcf``.
    """
    logger = common.get_named_logger("BAM2VCF")
    fasta = FastaReader(ref_fasta)
    contigs = [
        "{},length={}".format(name, fasta.get_reference_length(name))
        for name in fasta.references]
    prefix, _ext = os.path.splitext(bam_fp)
    vcf_final = prefix + ".TR.vcf"
    header = ("CHROM", "POS", "ID", "REF", "ALT", "QUAL", "FILTER",
              "INFO", "FORMAT", sample_name)
    variants = []
    with BamReader(bam_fp) as bam, BamReader(trimmed_reads_to_poa) as rb:
        for chrom in common.loose_version_sort(bam.references):
            length = bam.lengths[bam.references.index(chrom)]
            ref_seq = (fasta.fetch(chrom).upper()
                       if not replacement_style else None)
            groups = collections.defaultdict(list)
            for aln in bam.fetch(chrom, 0, length):
                rn = RecordName.from_str(aln.query_name)
                groups[(rn.ref_start, rn.ref_end)].append(aln)
            for _key, alignments in sorted(groups.items()):
                alignments.sort(
                    key=lambda a: RecordName.from_str(a.query_name).hap)
                if replacement_style:
                    variants.append(
                        convert_alignments_to_variants_replacement_style(
                            alignments, rb, add_read_names, fasta))
                else:
                    variants.extend(
                        convert_alignments_to_variants_decomposition(
                            alignments, rb, add_read_names, ref_seq))
    with vcf_mod.VCFWriter(
            vcf_final, contigs=contigs,
            meta_info=create_vcf_header_meta(), header=header) as out:
        out.write_variants(variants, sort=True)
    logger.info("Variants written to %s.", vcf_final)
    return vcf_final
