"""Stitch chunked network outputs into contiguous consensus sequences.

Counterpart of ``medaka_tpu/stitch.py`` (the ``sequence`` subcommand)
without the direct-decode stitcher: overlapping chunk probabilities are
trimmed against each other in (major, minor) coordinate space, argmax
decoded per chunk, neighbouring pieces concatenated, and coverage gaps
either broken into separate output contigs or filled from the draft.
Region parallelism uses spawned worker processes (h5py serialises all
reads behind a global lock, so threads only add contention here).
"""
from __future__ import annotations

import concurrent.futures
import functools
import itertools
from typing import Dict, Iterable, List, Optional, Tuple

from medaka_tpu_torch import common
from medaka_tpu_torch import datastore
from medaka_tpu_torch.io.fastx import FastaReader
from medaka_tpu_torch.utils.intervals import IntervalSet

# A stitched piece: ((ref_name, start_major, stop_major), [seq...], [qual...])
Piece = Tuple[Tuple[str, int, int], List[str], List[str]]

MAX_REGION_SIZE = int(1e6)


def stitch_samples(samples, label_scheme, region,
                   min_depth=0) -> List[Piece]:
    """Decode a stream of samples for one region into contig pieces.

    Overlaps between successive samples are reconciled by
    ``Sample.trim_samples_to_region``; coverage breaks (gapped samples or
    depth-filter splits) terminate a piece (reference
    ``stitch.py:33-84``).

    :param samples: iterable of `Sample` with ``label_probs``.
    :param label_scheme: scheme providing ``decode_consensus``.
    :param region: `Region` bounding the decode.
    :param min_depth: if non-zero, positions below this depth are dropped,
        breaking contiguity.

    :returns: list of pieces ((ref, first_major, last_major), seqs, quals).
    """
    logger = common.get_named_logger("Stitch")
    stream = common.Sample.trim_samples_to_region(
        samples, start=region.start, end=region.end)
    if min_depth:
        stream = common.Sample.filter_samples(stream, min_depth=min_depth)
    pieces: List[Piece] = []
    seqs: List[str] = []
    quals: List[str] = []
    start: Optional[int] = None
    heuristic_count = 0
    last_sample = None
    for sample, is_last_in_contig, heuristic in stream:
        heuristic_count += heuristic
        if start is None:
            start = int(sample.positions["major"][0])
        seq, qual = label_scheme.decode_consensus(
            sample, with_qualities=True)
        seqs.append(seq)
        quals.append(qual)
        last_sample = sample
        if is_last_in_contig:
            pieces.append((
                (sample.ref_name, start,
                 int(sample.positions["major"][-1])), seqs, quals))
            seqs, quals, start = [], [], None
    if seqs:
        pieces.append((
            (last_sample.ref_name, start,
             int(last_sample.positions["major"][-1])), seqs, quals))
    if heuristic_count:
        logger.debug(
            "Used overlap heuristic %d times for %s.",
            heuristic_count, region)
    return pieces


def stitch_from_probs(inputs, region, min_depth=0) -> List[Piece]:
    """Stitch one region from HDF5 sample files (worker entry)."""
    index = datastore.DataIndex(inputs)
    label_scheme = index.metadata["label_scheme"]
    samples = index.yield_from_feature_files(regions=[region])
    return stitch_samples(samples, label_scheme, region, min_depth)


def collapse_neighbours(pieces: Iterable[Piece]) -> Iterable[Piece]:
    """Merge pieces that abut exactly (end + 1 == next start)."""
    it = iter(pieces)
    try:
        (ref, start, stop), seqs, quals = next(it)
    except StopIteration:
        return
    for (nref, nstart, nstop), nseqs, nquals in it:
        if nref == ref and nstart == stop + 1:
            stop = nstop
            seqs.extend(nseqs)
            quals.extend(nquals)
        else:
            yield (ref, start, stop), seqs, quals
            (ref, start, stop), seqs, quals = (nref, nstart, nstop), \
                nseqs, nquals
    yield (ref, start, stop), seqs, quals


def fill_gaps(pieces: List[Piece], draft, fill_char: Optional[str] = None):
    """Join pieces per contig, filling gaps from the draft (or a char).

    Sample coordinates are end-inclusive; interval/bed bookkeeping is
    end-exclusive, hence the +1 on piece ends (reference
    ``stitch.py:109-166``).

    :returns: (full-length pieces, {ref_name: [(gap_start, gap_end), ...]}).
    """
    if isinstance(draft, str):
        draft = FastaReader(draft)
    fill_char = None if fill_char in (None, "") else str(fill_char)[0]

    by_contig: Dict[str, IntervalSet] = {}
    order: List[str] = []
    for (ref, start, stop), seqs, quals in pieces:
        if ref not in by_contig:
            by_contig[ref] = IntervalSet()
            order.append(ref)
        by_contig[ref].add(start, stop + 1, (seqs, quals))

    gaps: Dict[str, List[Tuple[int, int]]] = {}
    out: List[Piece] = []
    for ref in order:
        length = draft.get_reference_length(ref)
        gaps[ref] = by_contig[ref].complement(0, length)
        draft_seq = draft.fetch(ref) if fill_char is None else None
        events = sorted(
            list(by_contig[ref]) + [(s, e, None) for s, e in gaps[ref]],
            key=lambda iv: (iv[0], iv[1]))
        seq_parts: List[str] = []
        qual_parts: List[str] = []
        for s, e, data in events:
            if data is None:
                seq_parts.append(
                    draft_seq[s:e] if fill_char is None
                    else fill_char * (e - s))
                qual_parts.append("!" * (e - s))
            else:
                seq_parts.extend(data[0])
                qual_parts.extend(data[1])
        out.append(((ref, 0, length), seq_parts, qual_parts))
    return out, gaps


def write_fastx_segment(fh, name, seq_parts, qual_parts, qualities=False):
    """Write one fasta/fastq record from sequence pieces."""
    prefix = "@" if qualities else ">"
    fh.write("{}{}\n{}\n".format(prefix, name, "".join(seq_parts)))
    if qualities:
        fh.write("+\n{}\n".format("".join(qual_parts)))


def write_gaps_bed(gaps: Dict[str, List[Tuple[int, int]]], path: str):
    """Write gap intervals (draft coordinates) to a bed file."""
    with open(path, "w") as fh:
        for ref in sorted(gaps):
            for start, end in sorted(gaps[ref]):
                fh.write("{}\t{}\t{}\n".format(ref, start, end))


def stitch_to_fasta(
        inputs, draft_path: str, output: str,
        regions: Optional[List[common.Region]] = None,
        threads: int = 1, min_depth: int = 0, fillgaps: bool = True,
        fill_char: Optional[str] = None, qualities: bool = False):
    """Programmatic `medaka sequence` (reference ``stitch.py:197-309``).

    :param inputs: HDF5 sample file(s) with ``label_probs``.
    :param draft_path: FASTA draft that was polished.
    :param output: output fasta/fastq path.
    :param regions: restrict to regions (default: all draft contigs).
    :param threads: worker threads for region decoding.
    :param min_depth: break contigs where depth drops below this.
    :param fillgaps: fill breaks from the draft (else emit split contigs).
    :param fill_char: when filling, use this char instead of draft bases.
    :param qualities: write fastq instead of fasta.
    """
    logger = common.get_named_logger("Stitcher")
    index = datastore.DataIndex(inputs)
    draft = FastaReader(draft_path)

    if regions is None:
        req_regions = [
            common.Region.from_string(r) for r in draft.references]
    else:
        req_regions = list(regions)

    indexed_refs = {r.ref_name for r in index.regions}
    to_process = []
    for region in req_regions:
        if region.ref_name not in indexed_refs:
            continue
        start = region.start or 0
        end = region.end if region.end is not None \
            else draft.get_reference_length(region.ref_name)
        to_process.append(common.Region(region.ref_name, start, end))

    if not to_process:
        logger.warning(
            "No overlap between draft contigs (%d) and probability "
            "contigs (%d) — output will be empty. Did you pass the "
            "draft that was polished?",
            len(req_regions), len(indexed_refs))
    work = list(itertools.chain.from_iterable(
        r.split(MAX_REGION_SIZE, overlap=0, fixed_size=False)
        for r in to_process))

    if threads <= 1:
        label_scheme = index.metadata["label_scheme"]

        def produce():
            for region in work:
                samples = index.yield_from_feature_files(regions=[region])
                yield from stitch_samples(
                    samples, label_scheme, region, min_depth)
        pieces = produce()
    else:
        # worker PROCESSES, like the reference (stitch.py:232-243):
        # h5py serialises all reads behind one global lock, so threads
        # only add contention here (measured slower than serial);
        # spawned processes each own their file handles and decode
        # independently, returning picklable piece tuples
        def produce():
            import multiprocessing
            ctx = multiprocessing.get_context("spawn")
            with concurrent.futures.ProcessPoolExecutor(
                    threads, mp_context=ctx) as ex:
                worker = functools.partial(
                    stitch_from_probs, inputs, min_depth=min_depth)
                yield from itertools.chain.from_iterable(
                    ex.map(worker, work, chunksize=4))
        pieces = produce()

    write_consensus_output(
        pieces, draft, output,
        present_refs={r.ref_name for r in to_process},
        all_refs={r.ref_name for r in req_regions},
        fillgaps=fillgaps, fill_char=fill_char, qualities=qualities)
    draft.close()


def write_consensus_output(
        pieces: Iterable[Piece], draft, output: str,
        present_refs, all_refs, fillgaps: bool = True,
        fill_char: Optional[str] = None, qualities: bool = False):
    """Write stitched pieces as fasta/fastq (+ gaps bed when filling).

    :param present_refs: contigs that had probability data.
    :param all_refs: every requested contig (missing ones are copied
        verbatim from the draft).
    """
    logger = common.get_named_logger("Stitcher")
    close_draft = isinstance(draft, str)
    if close_draft:
        draft = FastaReader(draft)
    gap_record: Dict[str, List[Tuple[int, int]]] = {}
    with open(output, "w") as fastx:
        contigs = collapse_neighbours(pieces)
        if fillgaps:
            filled, gaps = fill_gaps(list(contigs), draft, fill_char)
            gap_record.update(gaps)
            for (ref, _start, _stop), seqs, quals in filled:
                write_fastx_segment(fastx, ref, seqs, quals, qualities)
            # a contig whose samples were ALL filtered away (e.g. by
            # min_depth) yields no pieces and — matching the reference
            # (stitch.py:291-305 only copies index-absent contigs) —
            # is absent from the output; at least say so
            emitted = {ref for (ref, _s, _e), _, _ in filled}
            silent = set(present_refs) - emitted
            if silent:
                logger.warning(
                    "Contigs %s had probability data but produced no "
                    "stitchable pieces (all samples filtered?); they "
                    "are absent from the output.", sorted(silent))
            # contigs with no data at all: copy from draft verbatim
            missing = set(all_refs) - set(present_refs)
            for ref in sorted(missing):
                logger.info("Copying contig '%s' verbatim from input.", ref)
                seq = draft.fetch(ref)
                write_fastx_segment(
                    fastx, ref, [seq], ["!" * len(seq)], qualities)
                gap_record[ref] = [(0, len(seq))]
        else:
            counter = -1
            prev_ref = None
            for (ref, start, stop), seqs, quals in contigs:
                counter = counter + 1 if ref == prev_ref else 0
                name = "{}_{} {}-{}".format(ref, counter, start, stop + 1)
                write_fastx_segment(fastx, name, seqs, quals, qualities)
                prev_ref = ref

    if fillgaps:
        write_gaps_bed(gap_record, output + ".gaps_in_draft_coords.bed")
    if close_draft:
        draft.close()
