"""Variant and SNP calling from chunked network outputs.

Counterpart of ``medaka_tpu/variant.py`` (``apply_variants``,
``join_samples``, ``variants_from_hdf``, ``snps_from_hdf``,
``samples_to_bed``, and the calls from a consensus-to-reference
alignment: ``yield_variants_from_aln``, ``vcf_from_fasta``). The stream of overlap-trimmed
samples is re-partitioned at non-variant anchor positions so that
multi-column variants (indel runs) never straddle a chunk boundary, then
handed to the label scheme's ``decode_variants``. Everything here runs
on the host and reads probability files through the port's own
``datastore`` and ``io/hdf5.py``.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from medaka_tpu_torch import common
from medaka_tpu_torch import datastore
from medaka_tpu_torch import labels as labels_mod
from medaka_tpu_torch import vcf as vcf_mod
from medaka_tpu_torch.io.fastx import FastaReader
from medaka_tpu_torch.utils.intervals import IntervalSet


def apply_variants(variants, ref_seq: str) -> str:
    """Apply variants to a reference (like ``bcftools consensus``)."""
    out = list(ref_seq)
    for v in variants:
        out[v.pos:v.pos + len(v.ref)] = len(v.ref) * [""]
        out[v.pos] = v.alt[0] if isinstance(v.alt, (list, tuple)) else v.alt
    return "".join(out)


def join_samples(sample_gen, ref_seq: str, label_scheme):
    """Re-split a trimmed sample stream at non-variant anchors.

    Guarantees a variant run is never split across the yielded samples:
    each yield ends at the last major position (with no trailing insertion
    columns) whose call equals the reference.

    :param sample_gen: stream of (`Sample`, is_last_in_contig, heuristic).
    :param ref_seq: reference/draft sequence for the contig.
    :param label_scheme: scheme providing ``decode_consensus``.

    :yields: `Sample` objects whose ends are safe variant boundaries.
    """
    queue: List[common.Sample] = []
    sample = None
    # encode the contig once: doing it per sample re-encodes the whole
    # reference string each time (3+ s over a 16 Mb contig)
    ref_codes = np.frombuffer(ref_seq.encode(), dtype="u1")
    for sample, is_last_in_contig, _ in sample_gen:
        if is_last_in_contig:
            queue.append(sample)
            yield common.Sample.from_samples(queue)
            queue = []
            continue

        majors = sample.positions["major"]
        minors = sample.positions["minor"]
        call = label_scheme.decode_consensus(
            sample, with_gaps=True, dtype="|U1")
        # reference symbol per column: the ref base at major positions,
        # gap at inserted (minor) columns
        ref_arr = ref_codes[majors].view("S1").astype("U1")
        ref_arr = np.where(minors == 0, ref_arr, "*")

        # a column "is variant" when call != ref, or both are gaps at a
        # minor column (a called gap at an insertion is not a match)
        is_var = (call != ref_arr) | ((call == "*") & (ref_arr == "*"))
        if np.all(is_var):
            queue.append(sample)
            continue

        major_idx = np.flatnonzero(minors == 0)
        diff_major = call[major_idx] != ref_arr[major_idx]
        # anchor before the trailing variant run; even when the final
        # major is itself a match it cannot anchor (the next chunk might
        # begin with an insertion at that position)
        offset = 0
        for offset, d in enumerate(diff_major[::-1]):
            if not d:
                break
        last_non_var_pos = majors[major_idx][-1 - offset]
        cut = int(np.searchsorted(majors, last_non_var_pos, side="left"))

        to_yield = queue
        if cut > 0:
            to_yield = queue + [sample.slice(slice(None, cut))]
        if to_yield:
            yield common.Sample.from_samples(to_yield)
        queue = [sample.slice(slice(cut, None))]

    if queue:
        raise ValueError(
            "Reached end of stream at {} without is_last_in_contig "
            "being True".format(sample.name if sample else "?"))


def _load_label_scheme(index, logger):
    try:
        return index.metadata["label_scheme"]
    except KeyError:
        logger.debug(
            "No label_scheme metadata found; assuming HaploidLabelScheme.")
        return labels_mod.HaploidLabelScheme()


def variants_from_hdf(
        inputs, ref_fasta: str, output: str,
        regions: Optional[List[common.Region]] = None,
        verbose: bool = False, ambig_ref: bool = False,
        gvcf: bool = False, min_qual: Optional[float] = None):
    """Decode variants from sample HDF5s into a VCF.

    :param inputs: HDF5 file(s) with ``label_probs`` samples.
    :param ref_fasta: the reference the reads were aligned against.
    :param output: output VCF path.
    :param regions: restrict decoding to these regions.
    :param verbose: add verbose info fields to records.
    :param ambig_ref: decode variants at ambiguous (non-ACGT) reference.
    :param gvcf: emit records for all reference positions.
    :param min_qual: drop records with QUAL below this (default off:
        every record; gVCF reference rows are never dropped).
    """
    logger = common.get_named_logger("Variants")
    index = datastore.DataIndex(inputs)
    if regions is None:
        regions = index.regions
    label_scheme = _load_label_scheme(index, logger)
    for method in ("decode_variants", "decode_consensus"):
        if not hasattr(label_scheme, method):
            raise AttributeError(
                "{} does not support {}".format(label_scheme, method))
    label_scheme.verbose = verbose

    with FastaReader(ref_fasta) as fa:
        lengths = {r: fa.get_reference_length(r) for r in fa.references}
        ref_seqs = {
            reg.ref_name: fa.fetch(reg.ref_name).upper()
            for reg in regions}

    with vcf_mod.VCFWriter(
            output, "w", version="4.1",
            contigs=["{},length={}".format(r.ref_name, lengths[r.ref_name])
                     for r in regions],
            meta_info=label_scheme.variant_metainfo) as writer:
        for reg in regions:
            logger.info("Processing %s.", reg)
            ref_seq = ref_seqs[reg.ref_name]
            samples = index.yield_from_feature_files([reg])
            trimmed = common.Sample.trim_samples(samples)
            for sample in join_samples(trimmed, ref_seq, label_scheme):
                variants = label_scheme.decode_variants(
                    sample, ref_seq, ambig_ref=ambig_ref,
                    return_all=gvcf)
                if min_qual is not None:
                    variants = [
                        v for v in variants
                        if v.alt == ["."] or (
                            v.qual != "." and float(v.qual) >= min_qual)]
                writer.write_variants(variants, sort=True)


def snps_from_hdf(
        inputs, ref_fasta: str, output: str,
        regions: Optional[List[common.Region]] = None,
        threshold: float = 0.04, verbose: bool = False,
        het_rescue: Optional[float] = None):
    """Decode SNPs (single-locus) from sample HDF5s into a VCF.

    No ``join_samples`` pass is needed since loci are treated
    independently.

    :param het_rescue: diploid-scheme only — call a het genotype when
        the argmax is hom-ref but the best (ref, X) class carries at
        least this probability (default off: the argmax). See
        ``DiploidLabelScheme._prob_to_snp``.
    """
    logger = common.get_named_logger("SNPs")
    index = datastore.DataIndex(inputs)
    if regions is None:
        regions = index.regions
    label_scheme = _load_label_scheme(index, logger)
    label_scheme.verbose = verbose
    if het_rescue is not None:
        if not isinstance(label_scheme, labels_mod.DiploidLabelScheme):
            raise ValueError(
                "--het_rescue applies to diploid models only; these "
                "probabilities carry a {} (a haploid argmax has no "
                "het class to rescue).".format(
                    type(label_scheme).__name__))
        label_scheme.het_rescue = float(het_rescue)

    with FastaReader(ref_fasta) as fa:
        lengths = {r: fa.get_reference_length(r) for r in fa.references}
        ref_seqs = {
            reg.ref_name: fa.fetch(reg.ref_name).upper()
            for reg in regions}

    with vcf_mod.VCFWriter(
            output, "w", version="4.1",
            contigs=["{},length={}".format(r.ref_name, lengths[r.ref_name])
                     for r in regions],
            meta_info=label_scheme.snp_metainfo) as writer:
        for reg in regions:
            logger.info("Processing %s.", reg)
            ref_seq = ref_seqs[reg.ref_name]
            samples = index.yield_from_feature_files(regions=[reg])
            for sample, _is_last, _h in common.Sample.trim_samples(samples):
                snps = label_scheme.decode_snps(
                    sample, ref_seq, threshold=threshold)
                writer.write_variants(snps, sort=True)


def samples_to_bed(inputs, output: str):
    """Write the genomic intervals covered by samples to a bed file."""
    logger = common.get_named_logger("HDF2Bed")
    index = datastore.DataIndex(inputs)
    sets: Dict[str, IntervalSet] = {}
    for name, _fname in index.samples:
        d = common.Sample.decode_sample_name(name)
        if d is None:
            continue
        start, end = int(float(d["start"])), int(float(d["end"]))
        sets.setdefault(d["ref_name"], IntervalSet()).add(start, end + 1)

    with open(output, "w") as fh:
        for contig, iset in sets.items():
            # merge abutting-or-overlapping intervals
            merged = []
            for s, e, _ in iset:
                if merged and s <= merged[-1][1]:
                    merged[-1][1] = max(merged[-1][1], e)
                else:
                    merged.append([s, e])
            for s, e in merged:
                fh.write("{}\t{}\t{}\n".format(contig, s, e))
    logger.info("Bed file written to %s.", output)


# ---------------------------------------------------------------------------
# Variants by consensus-to-reference alignment (`consensus2vcf`)
# ---------------------------------------------------------------------------


class AlignPos:
    """One aligned column: (rpos, rbase, qbase)."""

    __slots__ = ("rpos", "rbase", "qbase")

    def __init__(self, rpos, rbase, qbase):
        self.rpos = rpos
        self.rbase = rbase
        self.qbase = qbase


def yield_variants_from_aln(rec, ref_seq, ref_name=None):
    """Decode variants from one alignment record.

    Walks match-anchored runs of aligned pairs; each run of differences,
    padded by a match on both sides where available, becomes one
    (trimmed) variant (reference ``variant.py:280-353``).

    :param rec: `BamRecord`-like with cigar/aligned pairs.
    :param ref_seq: reference contig sequence.
    :param ref_name: contig name for emitted records.
    """
    tags = dict(rec.tags)
    if tags.get("NM") == 0:
        return
    if rec.flag & (4 | 256):
        return
    seq = rec.query_sequence
    chrm = ref_name or getattr(rec, "reference_name", None) or "ref"
    gt = {"GT": "1"}
    queue = []
    last_match = None

    def decode(queue):
        pos = next(p.rpos for p in queue if p.rpos is not None)
        ref = "".join(p.rbase for p in queue).replace("-", "").upper()
        alt = "".join(p.qbase for p in queue).replace("-", "").upper()
        return vcf_mod.Variant(
            chrm, pos, ref, alt, genotype_data=gt).trim()

    for qp, rp in rec.get_aligned_pairs():
        qb = seq[qp] if qp is not None else "-"
        rb = ref_seq[rp] if rp is not None else "-"
        p = AlignPos(rp, rb, qb)
        if qb == rb:
            if queue:
                queue.append(p)
                yield decode(queue)
                queue = []
            last_match = p
        else:
            if not queue and last_match is not None:
                queue.append(last_match)
            queue.append(p)
    if queue:
        yield decode(queue)


def vcf_from_fasta(
        consensus: str, ref_fasta: str, out_prefix: str,
        regions: Optional[List[common.Region]] = None,
        chunk_size: int = 100000, pad: int = 10000, mode: str = "NW"):
    """Call variants by aligning a consensus FASTA to a reference.

    Reference: ``medaka/variant.py:380-474`` (the ``consensus2vcf``
    tool). Writes ``<prefix>.vcf``, coverage/gap beds and the chunked
    alignments as ``<prefix>.bam``.

    :returns: path of the VCF written.
    """
    from medaka_tpu_torch import align as align_mod
    from medaka_tpu_torch.io import bam as bam_mod

    logger = common.get_named_logger("CONS2VCF")
    ref = FastaReader(ref_fasta)
    query = FastaReader(consensus)
    contigs = [c for c in ref.references if c in query.references]
    if regions is not None:
        wanted = {r.ref_name for r in regions}
        contigs = [c for c in contigs if c in wanted]
    if not contigs:
        raise KeyError("Reference and query contig names should match.")
    lengths = {c: ref.get_reference_length(c) for c in ref.references}

    vcf_path = out_prefix + ".vcf"
    meta_info = [vcf_mod.MetaInfo(
        "FORMAT", "GT", 1, "String", "Genotype.")]
    header_contigs = [
        "{},length={}".format(c, lengths[c]) for c in ref.references]
    coverage: Dict[str, List] = {}
    bam_records = []
    ref_ids = {c: i for i, c in enumerate(ref.references)}
    with vcf_mod.VCFWriter(
            vcf_path, contigs=header_contigs,
            meta_info=meta_info) as writer:
        for contig in contigs:
            rseq = ref.fetch(contig)
            qseq = query.fetch(contig)
            for rec in align_mod.chunked_align(
                    qseq, rseq, contig, chunk_size=chunk_size, pad=pad,
                    mode=mode, ref_id=ref_ids[contig]):
                coverage.setdefault(contig, []).append(
                    (rec.pos, rec.reference_end))
                for v in yield_variants_from_aln(rec, rseq, contig):
                    if "N" in v.ref:
                        continue
                    writer.write_variant(v)
                bam_records.append(rec)

    bam_mod.write_bam(
        out_prefix + ".bam", bam_records,
        [(c, lengths[c]) for c in ref.references])

    # coverage + gap beds (merging abutting chunk alignments)
    def merged(intervals):
        out = []
        for s, e in sorted(intervals):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    with open(out_prefix + "_coverage.bed", "w") as cov_fh, \
            open(out_prefix + "_coverage_gaps.bed", "w") as gap_fh:
        for contig in contigs:
            cursor = 0
            for s, e in merged(coverage.get(contig, [])):
                cov_fh.write("{}\t{}\t{}\n".format(contig, s, e))
                if s > cursor:
                    gap_fh.write(
                        "{}\t{}\t{}\n".format(contig, cursor, s))
                cursor = e
            if cursor < lengths[contig]:
                gap_fh.write("{}\t{}\t{}\n".format(
                    contig, cursor, lengths[contig]))
    logger.info("VCF written to %s.", vcf_path)
    return vcf_path
