"""Read-to-draft mapping and the polishing workflow.

Counterpart of ``medaka_tpu/mapping.py``. The reference's polishing
workflow shells out to minimap2 via the ``mini_align`` wrapper
(``scripts/medaka_consensus:165-176``); here the native minimizer mapper
(:class:`medaka_tpu_torch.native.Mapper`) writes the sorted, indexed BAM
directly. :func:`consensus_workflow` then runs inference on the GPU
(``device``) unless the CPU is asked for.
"""
from __future__ import annotations

import concurrent.futures
from typing import List, Optional

from medaka_tpu_torch import common, native
from medaka_tpu_torch.io.bam import (
    C_D, C_EQ, C_I, C_M, C_X, BamRecord, parse_cigar, write_bam)
from medaka_tpu_torch.io.fastx import FastaReader, read_fastx


def compute_md(ref_seq: str, pos: int, cigar: str, query: str,
               query_start: int = 0) -> str:
    """MD tag for an alignment (SAM spec; minimap2 ``--MD`` analogue).

    :param ref_seq: full reference sequence of the target contig.
    :param pos: 0-based reference start of the alignment.
    :param cigar: core cigar (no leading/trailing clips).
    :param query: oriented query sequence.
    :param query_start: query offset where the core cigar begins.

    Needed by truth-to-draft BAMs: label extraction reconstructs the
    aligned reference from MD (``labels.TruthAlignment`` via
    ``BamRecord.get_reference_sequence``), as the reference toolchain
    does with pysam.
    """
    md = []
    run = 0
    rpos, qpos = pos, query_start
    for op, ln in parse_cigar(cigar):
        if op in (C_M, C_EQ, C_X):
            for k in range(ln):
                if ref_seq[rpos + k] == query[qpos + k]:
                    run += 1
                else:
                    md.append(str(run))
                    md.append(ref_seq[rpos + k])
                    run = 0
            rpos += ln
            qpos += ln
        elif op == C_D:
            md.append(str(run))
            md.append("^" + ref_seq[rpos:rpos + ln])
            run = 0
            rpos += ln
        elif op == C_I:
            qpos += ln
    md.append(str(run))
    return "".join(md)


def align_reads(
        reads_fastx: str, draft_fasta: str, out_bam: str,
        threads: int = 1, band: int = 500,
        min_score: Optional[int] = None, md: bool = False,
        tags_by_read: Optional[dict] = None) -> dict:
    """Map reads to a draft and write a sorted, indexed BAM.

    :param reads_fastx: fasta/q(.gz) of reads.
    :param draft_fasta: the assembly to polish.
    :param band: alignment band (net indel drift bound).
    :param min_score: drop mappings below this alignment score.
    :param md: write MD tags (required for truth-to-draft BAMs feeding
        label extraction; the reference runs minimap2 ``--MD`` for the
        same reason).
    :param tags_by_read: optional {read_name: {tag: value}} aux tags to
        attach to each read's records (e.g. basecaller ``mv`` move
        tables, which fastq cannot carry — the analogue of mapping a
        tag-bearing basecaller BAM with minimap2 -y).

    :returns: stats dict {mapped, unmapped}.
    """
    logger = common.get_named_logger("Mapper")
    draft = FastaReader(draft_fasta)
    references = [
        (name, draft.fetch(name)) for name in draft.references]
    mapper = native.Mapper(references)
    ref_lengths = [(name, len(seq)) for name, seq in references]

    records: List[BamRecord] = []
    n_mapped = n_unmapped = 0

    def _map(item):
        name, seq, qual = item
        hits = mapper.map_all(seq, band=band)
        return name, seq, qual, hits

    def read_iter():
        for rec in read_fastx(reads_fastx):
            yield rec.name, rec.sequence, rec.quality

    with concurrent.futures.ThreadPoolExecutor(max(1, threads)) as ex:
        for name, seq, qual, hits in ex.map(_map, read_iter()):
            if min_score is not None and hits:
                # gate the read on its PRIMARY score: keeping only a
                # supplementary would write a SAM-invalid flag-2048
                # record with no primary (and downstream read filters
                # drop supplementaries, silently losing the read)
                primary_ok = any(
                    not (h.flag & 2048) and h.score >= min_score
                    for h in hits)
                hits = [
                    h for h in hits
                    if primary_ok and h.score >= min_score]
            if not hits:
                n_unmapped += 1
                continue
            for hit in hits:
                reverse = bool(hit.flag & 16)
                oriented = common.reverse_complement(seq) if reverse \
                    else seq
                quals = None
                if qual is not None:
                    q = [ord(c) - 33 for c in qual]
                    quals = q[::-1] if reverse else q
                tags = None
                if md:
                    tags = {"MD": compute_md(
                        references[hit.ref_id][1], hit.ref_start,
                        hit.cigar, oriented,
                        query_start=hit.query_start)}
                if tags_by_read and name in tags_by_read:
                    tags = {**(tags or {}), **tags_by_read[name]}
                cigar = hit.cigar
                if hit.query_start:
                    cigar = "{}S".format(hit.query_start) + cigar
                end_clip = len(seq) - hit.query_end
                if end_clip:
                    cigar += "{}S".format(end_clip)
                records.append(BamRecord.build(
                    query_name=name, ref_id=hit.ref_id,
                    pos=hit.ref_start, seq=oriented, qual=quals,
                    cigar=cigar, flag=hit.flag, mapq=hit.mapq,
                    tags=tags))
            n_mapped += 1
    mapper.close()
    write_bam(out_bam, records, ref_lengths)
    logger.info(
        "Mapped %d reads (%d unmapped) -> %s.",
        n_mapped, n_unmapped, out_bam)
    return {"mapped": n_mapped, "unmapped": n_unmapped}


def consensus_workflow(
        reads_fastx: str, draft_fasta: str, output_dir: str,
        model_path: Optional[str] = None, model=None,
        feature_encoder=None, label_scheme=None, threads: int = 1,
        batch_size=None, chunk_len: int = 10000,
        chunk_ovlp: int = 1000, qualities: bool = False,
        direct: bool = False, device=None) -> str:
    """The full polishing pipeline (``medaka_consensus`` equivalent).

    reads + draft -> BAM (native mapper) -> probabilities (predict) ->
    polished consensus (stitch). Stages are skipped when their outputs
    already exist, mirroring the resumable reference script
    (``scripts/medaka_consensus:185-199``).

    ``direct=True`` decodes argmax + quality on the device and stitches
    in-process: no probability HDF5 is written or re-read. Byte-identical
    output; the trade-off is that the inference stage is no longer
    resumable and no probability file remains for ``vcf``.

    :param device: "cuda" (default) or "cpu", passed to prediction.
    :returns: path of the polished fasta/fastq.
    """
    import os

    from medaka_tpu_torch import prediction, stitch

    logger = common.get_named_logger("Consensus")
    # before mapping: without a GPU, a run that did not ask for the CPU
    # raises here and not after the mapping stage
    device = common.resolve_device(device)
    os.makedirs(output_dir, exist_ok=True)
    bam = os.path.join(output_dir, "calls_to_draft.bam")
    if not os.path.exists(bam):
        align_reads(reads_fastx, draft_fasta, bam, threads=threads)
    else:
        logger.info("Reusing existing %s.", bam)
    out_ext = "fastq" if qualities else "fasta"
    out = os.path.join(output_dir, "consensus." + out_ext)
    if direct:
        prediction.predict_direct(
            bam, out, draft_fasta, model_path=model_path, model=model,
            feature_encoder=feature_encoder,
            label_scheme=label_scheme, batch_size=batch_size,
            chunk_len=chunk_len, chunk_overlap=chunk_ovlp,
            bam_workers=max(1, threads // 2), qualities=qualities,
            device=device)
        logger.info("Polished consensus written to %s.", out)
        return out
    probs = os.path.join(output_dir, "consensus_probs.hdf")
    if not os.path.exists(probs):
        # a single plain HDF5, as in medaka_tpu: consensus_probs.hdf is a
        # stage artifact that other tools may read directly
        prediction.predict(
            bam, probs, model_path=model_path, model=model,
            feature_encoder=feature_encoder,
            label_scheme=label_scheme, batch_size=batch_size,
            chunk_len=chunk_len, chunk_overlap=chunk_ovlp,
            bam_workers=max(1, threads // 2), device=device)
    else:
        logger.info("Reusing existing %s.", probs)
    stitch.stitch_to_fasta(
        probs, draft_fasta, out, threads=threads, qualities=qualities)
    logger.info("Polished consensus written to %s.", out)
    return out
