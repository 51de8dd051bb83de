"""Run-length encoding tooling.

Counterpart of ``medaka_tpu/rle.py``: homopolymer-compressed sequences
with run lengths carried in phred qualities (``compress_seq``, the
``fastrle`` tool) and re-alignment of reads in RLE space
(``compress_bam``) on the port's native aligner (``align.sw_align``,
``native/src/align.cpp``) and BAM writer. The output of the run-length
models' pipeline starts here: ``compress_bam`` of a BAM against its
draft, then ``inference`` with an RLE bundle on the compressed BAM
against the compact draft.

The Weibull parameters of a read come from its fast5 file
(:mod:`medaka_tpu_torch.io.fast5`): ``compress_bam(use_fast5_info=...)``
attaches them as WL/WK tags, and :func:`rlebam` (``tools rlebam``)
appends them to the lines of a SAM stream in spawned worker processes.
"""
from __future__ import annotations

import concurrent.futures
import multiprocessing
import sys
from typing import List, Optional

import numpy as np

from medaka_tpu_torch import align as align_mod
from medaka_tpu_torch import common
from medaka_tpu_torch.io.bam import BamReader, write_bam
from medaka_tpu_torch.io.fastx import FastaReader, FastxRecord, read_fastx

# printable phred alphabet; max encodable run length 93
_SCORES = "".join(chr(x) for x in range(33, 127))


class RLEConverter:
    """Basecall <-> RLE coordinate conversion
    (``medaka_tpu.rle.RLEConverter``)."""

    def __init__(self, basecall: str):
        """Compress ``basecall`` and build coordinate maps."""
        self.basecall = basecall
        self.rle_conversion = common.rle(basecall)
        self.compact_basecall = "".join(self.rle_conversion["value"])
        self.homop_length = self.rle_conversion["length"]
        self.inverse = np.repeat(
            np.arange(len(self.rle_conversion)),
            self.rle_conversion["length"])

    def transform_coords(self, start: int, end: int):
        """Map an (uncompressed) slice to compact coordinates."""
        return int(self.inverse[start]), int(self.inverse[end - 1]) + 1

    def trimmed_compact(self, start: int, end: int) -> str:
        """Compact sequence of an uncompressed slice."""
        s, e = self.transform_coords(start, end)
        return self.compact_basecall[s:e]

    def coord_compact_to_full(self, coord):
        """Compact index -> uncompressed start coordinate."""
        return self.rle_conversion[coord]["start"]


def compress_seq(record: FastxRecord) -> FastxRecord:
    """RLE-compress one fastx record, run lengths as phred qualities
    (capped at 93, the largest printable phred)."""
    logger = common.get_named_logger("Compress_basecalls")
    conv = RLEConverter(record.sequence)
    lengths = conv.homop_length.copy()
    over = lengths >= len(_SCORES)
    if over.any():
        logger.warning(
            "Some homopolymers in %s are longer than the longest "
            "supported length", record.name)
        lengths[over] = len(_SCORES) - 1
    quality = "".join(_SCORES[x] for x in lengths)
    return FastxRecord(
        name=record.name, comment=record.comment or "",
        sequence=conv.compact_basecall, quality=quality)


def fastrle(input_fastx: str, output, block_size: int = 94):
    """Stream a fastx file as RLE fastq (the ``fastrle`` tool).

    :param output: open file handle (or path) for fastq output.
    :param block_size: maximum encodable run length + 1 (<= 94); longer
        runs split into several blocks of the same base.
    """
    if block_size > 94:
        raise ValueError("block_size must be <= 94.")
    close = False
    if isinstance(output, str):
        output = open(output, "w")
        close = True
    try:
        for record in read_fastx(input_fastx):
            conv = RLEConverter(record.sequence)
            runs = conv.homop_length
            k = (runs - 1) // block_size + 1
            bases = np.repeat(
                np.frombuffer(conv.compact_basecall.encode(), np.uint8), k)
            lens = np.full(int(k.sum()), block_size, dtype=np.int64)
            lens[np.cumsum(k) - 1] = runs - (k - 1) * block_size
            output.write("@{}\n{}\n+\n{}\n".format(
                record.name, bases.tobytes().decode(),
                (lens + 33).astype(np.uint8).tobytes().decode()))
    finally:
        if close:
            output.close()


def add_extra_clipping(cigar: str, start_clip: int, end_clip: int) -> str:
    """Extend soft clips at either end of a cigar string."""

    def merge(cigar, clip, at_start):
        if clip == 0:
            return cigar
        ops = list(align_mod.cigar_ops_from_start(cigar))
        if at_start:
            n, op = ops[0]
            if op == "S":
                return "{}S".format(int(n) + clip) + cigar[len(n) + 1:]
            return "{}S".format(clip) + cigar
        n, op = ops[-1]
        if op == "S":
            return cigar[:-(len(n) + 1)] + "{}S".format(int(n) + clip)
        return cigar + "{}S".format(clip)

    return merge(merge(cigar, start_clip, True), end_clip, False)


def _rl_tags(rec, query_rle: RLEConverter, fast5_index):
    """The WL (the table's shape) and WK (scale) tags of a read from its
    fast5 file, in alignment orientation, as ``medaka_tpu``'s
    ``_compress_alignment`` attaches them; None (the read is skipped, as
    there) when the summary does not name the read, its table is missing
    or its basecall differs from the read's."""
    logger = common.get_named_logger("Compress_bam")
    if rec.query_name not in fast5_index:
        logger.warning("Not found in summary file: %s", rec.query_name)
        return None
    try:
        fast5_call, wl, wk = fast5_index.get_rl_params(rec.query_name)
    except (KeyError, FileNotFoundError) as exc:
        logger.info("RLE table not found for read %s: %s",
                    rec.query_name, exc)
        return None
    # fast5 tables are in read orientation; flip for reverse hits
    if rec.flag & 16:
        wl, wk = wl[::-1], wk[::-1]
        fast5_call = common.reverse_complement(fast5_call)
    if fast5_call != query_rle.compact_basecall:
        logger.warning(
            "RLE table within fast5 file is inconsistent with compressed "
            "basecall for read %s. %s != %s", rec.query_name, fast5_call,
            query_rle.compact_basecall)
        return None
    return {"WL": np.asarray(wl, np.float32),
            "WK": np.asarray(wk, np.float32)}


def _compress_alignment(rec, ref_rle: RLEConverter, fast5_index=None):
    """Re-align one read in RLE space (``medaka_tpu.rle._compress_alignment``):
    the aligned part of the compressed read against the compressed
    reference span, SW, the read's clipped ends as soft clips, run lengths
    as qualities, and with ``fast5_index`` (an ``io.fast5.Fast5Index``) the
    WL/WK tags of :func:`_rl_tags`. Unmapped, secondary and supplementary
    records, and reads without tags when tags are asked for, give None."""
    logger = common.get_named_logger("Compress_bam")
    if rec.flag & (4 | 256 | 2048):
        logger.info(
            "Alignment of read %s is unmapped/secondary/supplementary."
            " Skip.", rec.query_name)
        return None
    query_rle = RLEConverter(rec.query_sequence)
    ops = list(align_mod.cigar_ops_from_start(rec.cigarstring))
    lead = int(ops[0][0]) if ops and ops[0][1] == "S" else 0
    tail = int(ops[-1][0]) if len(ops) > 1 and ops[-1][1] == "S" else 0
    qc_start, qc_end = query_rle.transform_coords(
        lead, rec.query_length - tail)
    compact_query = query_rle.compact_basecall[qc_start:qc_end]

    rc_start, rc_end = ref_rle.transform_coords(rec.pos, rec.reference_end)
    compact_ref = ref_rle.compact_basecall[rc_start:rc_end]

    rstart, cigar = align_mod.sw_align(
        compact_query, compact_ref, match=5, mismatch=4, gap_open=5,
        gap_extend=3)
    cigar = add_extra_clipping(
        cigar, qc_start, len(query_rle.compact_basecall) - qc_end)
    rstart += rc_start
    tags = {}
    if fast5_index is not None:
        tags = _rl_tags(rec, query_rle, fast5_index)
        if tags is None:
            return None
    quals = np.minimum(query_rle.homop_length, 255).astype(int).tolist()
    return align_mod.initialise_alignment(
        rec.query_name, rec.ref_id, rstart, query_rle.compact_basecall,
        cigar, rec.flag, query_qualities=quals, tags=tags)


def compress_bam(
        bam_input: str, bam_output: str, ref_fname: str,
        regions: Optional[List[common.Region]] = None, threads: int = 1,
        use_fast5_info=None):
    """Re-express a BAM in an RLE coordinate system
    (``medaka_tpu.rle.compress_bam``): reads and the reference are
    homopolymer compressed, each read is re-aligned (SW, in ``threads``
    threads; the native aligner releases the GIL) to the compressed
    reference, run lengths are stored as qualities, and the header holds
    the compressed reference lengths. Writes a sorted, indexed BAM.

    :param use_fast5_info: (fast5 directory, summary file): attach each
        read's Weibull WL/WK tags from its fast5 file, and skip reads the
        summary does not name or whose table does not match.
    """
    fast5_index = None
    if use_fast5_info:
        from medaka_tpu_torch.io.fast5 import Fast5Index
        fast5_index = Fast5Index(*use_fast5_info)
    regions = common.get_bam_regions(bam_input, regions)
    ref_fasta = FastaReader(ref_fname)
    records = []
    with BamReader(bam_input) as reader:
        references = list(zip(reader.references, reader.lengths))
        ref_rles = {}
        for region in regions:
            if region.ref_name not in ref_rles:
                ref_rles[region.ref_name] = RLEConverter(
                    ref_fasta.fetch(region.ref_name))
            ref_rle = ref_rles[region.ref_name]
            recs = list(reader.fetch(
                region.ref_name, region.start, region.end))
            if threads > 1:
                with concurrent.futures.ThreadPoolExecutor(threads) as ex:
                    outs = list(ex.map(
                        lambda r: _compress_alignment(r, ref_rle,
                                                      fast5_index), recs))
            else:
                outs = [_compress_alignment(r, ref_rle, fast5_index)
                        for r in recs]
            records.extend(o for o in outs if o is not None)
    compressed_refs = [
        (name, len(ref_rles[name].compact_basecall) if name in ref_rles
         else length)
        for name, length in references]
    write_bam(bam_output, records, compressed_refs)
    return bam_output


def _decorate_sam_line(line: str, read_id, is_rev, fname):
    """Append WL/WK tags from a fast5 file to one SAM line (the worker of
    ``medaka_tpu.rle.rlebam``, reference ``rle.py:296-337``).

    Header lines (``read_id`` None) and reads whose run-length table is
    not a valid RLE sequence (adjacent equal bases) pass through
    unchanged. The reference's rlebam writes the table's scale as WL and
    its shape as WK, the transpose of its ``compress_bam``; each path
    keeps its own.
    """
    if read_id is None:
        return line
    from medaka_tpu_torch.io import fast5
    call, shape, scale = fast5.get_runlength_basecall(fname, read_id)
    if any(a == b for a, b in zip(call[1:], call[:-1])):
        common.get_named_logger("BAMDecor").info(
            "Invalid RLE/basecall dataset for %s in file %s.", read_id,
            fname)
        return line
    if is_rev:
        scale, shape = scale[::-1], shape[::-1]
    return "{}\t{}\t{}".format(
        line, "WL:B:f," + ",".join(str(float(x)) for x in scale),
        "WK:B:f," + ",".join(str(float(x)) for x in shape))


def _decorate_sam_line_star(args):
    return _decorate_sam_line(*args)


def rlebam(read_index: str, workers: int = 4, input_sam=None, output=None):
    """Decorate a SAM stream with WL/WK run-length tags from fast5 files
    (``medaka_tpu.rle.rlebam``, the ``tools rlebam`` entry).

    :param read_index: two-column TSV, read_id -> fast5 path.
    :param input_sam: SAM lines (default stdin); a read the index lacks
        passes through untagged, with a warning, as in ``medaka_tpu``.
    :param output: where the lines go (default stdout).

    The lines are decorated in ``workers`` spawned processes (never
    forked: the caller may hold a CUDA context); a worker's error raises
    here.
    """
    logger = common.get_named_logger("BAMDecor")
    index = common.read_key_value_tsv(read_index)
    logger.info("Found %d reads in index", len(index))
    input_sam = sys.stdin if input_sam is None else input_sam
    output = sys.stdout if output is None else output

    def ingress():
        for line in input_sam:
            if line.startswith("@"):
                yield line.rstrip(), None, None, None
                continue
            read_id, flag, _ = line.split("\t", 2)
            fast5 = index.get(read_id)
            if fast5 is None:
                logger.warning("Read %s not in the fast5 index; passing "
                               "through untagged.", read_id)
                yield line.rstrip(), None, None, None
                continue
            yield line.rstrip(), read_id, bool(int(flag) & 16), fast5

    with concurrent.futures.ProcessPoolExecutor(
            max_workers=workers,
            mp_context=multiprocessing.get_context("spawn")) as executor:
        for decorated in executor.map(_decorate_sam_line_star, ingress(),
                                      chunksize=10):
            output.write(decorated + "\n")
