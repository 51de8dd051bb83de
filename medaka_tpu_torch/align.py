"""Alignment helpers built on the native engine.

Counterpart of ``medaka_tpu/align.py``: cigar parsing/trimming,
local-alignment-to-SAM conversion (reference ``parasail_to_sam``,
``align.py:63-97``) and chunked whole-contig alignment (reference
``chunked_edlib_align``, ``align.py:198-330``) on the port's
:mod:`medaka_tpu_torch.native` aligner. One repair: where a continuation
chunk's alignment opens with an indel, ``medaka_tpu`` raises; the port
keeps the chunk's shared first match column and aligns the rest
(ROADMAP.md queue 3 item 7). Elsewhere the two yield the same records.
"""
from __future__ import annotations

import re
from typing import Iterator, Optional, Tuple

from medaka_tpu_torch import native
from medaka_tpu_torch.io.bam import BamRecord

_RE_CIGAR = re.compile(r"(?P<len>\d+)(?P<op>[MIDNSHP=X])")


def cigar_ops_from_start(cigar: str):
    """Yield (length str, op) from the start of a cigar."""
    for m in _RE_CIGAR.finditer(cigar):
        yield m.group("len"), m.group("op")


def cigar_ops_from_end(cigar: str):
    """Yield (length str, op) from the end of a cigar, reversed."""
    ops = list(_RE_CIGAR.finditer(cigar))
    for m in reversed(ops):
        yield m.group("len"), m.group("op")


def trim_cigar(cigar: str, start: bool = True) -> Tuple[str, int, int]:
    """Trim a cigar so it starts (or ends) on a match.

    :returns: (cigar, query bases trimmed, ref-start offset).
    """
    trimmed_chars, rstart_offset, q_trim = 0, 0, 0
    gen = cigar_ops_from_start if start else cigar_ops_from_end
    for n, op in gen(cigar):
        if op == "=":
            break
        trimmed_chars += len(n) + len(op)
        if op in ("I", "X"):
            q_trim += int(n)
            rstart_offset += int(n) if (op == "X" and start) else 0
        elif op == "D":
            rstart_offset += int(n) if start else 0
        else:
            raise ValueError(
                "Encountered unsupported cigar operation: {}".format(op))
    out = cigar[trimmed_chars:] if start else \
        cigar[:len(cigar) - trimmed_chars]
    return out, q_trim, rstart_offset


def cigar_lengths(cigar: str) -> Tuple[int, int]:
    """(query length, reference length) consumed by a cigar."""
    q = r = 0
    for n, op in cigar_ops_from_start(cigar):
        n = int(n)
        if op in ("M", "=", "X", "I", "S"):
            q += n
        if op in ("M", "=", "X", "D", "N"):
            r += n
    return q, r


def local_to_sam(aln: native.Alignment, seq: str) -> Tuple[int, str]:
    """SAM-ify a local alignment: soft-clip unaligned query ends.

    Reference contract: ``parasail_to_sam`` (``align.py:63-97``).

    :returns: (reference start, cigar with S clips).
    """
    cigar = aln.cigar
    rstart = aln.ref_start
    pre = "{}S".format(aln.query_start) if aln.query_start else ""
    end_clip = len(seq) - aln.query_end
    suf = "{}S".format(end_clip) if end_clip > 0 else ""
    return rstart, pre + cigar + suf


def sw_align(query: str, ref: str, match=2, mismatch=4, gap_open=4,
             gap_extend=2) -> Tuple[int, str]:
    """Local (SW) alignment returning (ref start, SAM cigar)."""
    aln = native.align(
        query, ref, mode="sw", match=match, mismatch=mismatch,
        gap_open=gap_open, gap_extend=gap_extend)
    return local_to_sam(aln, query)


def initialise_alignment(
        query_name: str, reference_id: int, reference_start: int,
        query_sequence: str, cigarstring: str, flag: int,
        mapping_quality: int = 60, query_qualities=None,
        tags: Optional[dict] = None) -> BamRecord:
    """Create an alignment record (reference ``align.py:152-195``)."""
    return BamRecord.build(
        query_name=query_name, ref_id=reference_id, pos=reference_start,
        seq=query_sequence, qual=query_qualities, cigar=cigarstring,
        flag=flag, mapq=mapping_quality, tags=tags or {})


def chunked_align(
        qseq: str, rseq: str, contig_name: str, chunk_size: int = 100000,
        pad: int = 10000, mode: str = "NW",
        ref_id: int = 0) -> Iterator[BamRecord]:
    """Align a query contig to a reference in overlapping chunks.

    Behavioural equivalent of ``chunked_edlib_align``
    (``align.py:198-330``): chunks are aligned sequentially, consecutive
    alignments overlap by exactly one match column, the first chunk may
    start anywhere in the reference (HW) and subsequent chunks extend
    with an anchored start (SHW). Modes 'NW', 'HW', 'HWT' follow the
    reference semantics.

    The affine aligner runs with a band of 1000 (net indel drift bound
    per chunk), but for the free-ended first chunk of modes HW and HWT.

    :yields: `BamRecord` objects named ``contig_qstart_qend``.
    """
    ends_modes = {
        "HW": ("hw", "shw"),
        "NW": ("shw", "nw"),
        "HWT": ("hw", "shw"),
    }
    if mode not in ends_modes:
        raise KeyError(
            "Unrecognised mode {}; use one of {}".format(
                mode, set(ends_modes)))
    mode_first, mode_last = ends_modes[mode]

    def _align(q, r, m):
        return native.align(
            q, r, mode=m, match=2, mismatch=4, gap_open=4, gap_extend=2,
            band=1000 if m != "hw" else 0)

    def _align_anchored(q, r, m):
        # a continuation chunk starts on the previous chunk's last match
        # column (q[0] == r[0]); where the aligner's tie-break opens with
        # an indel there instead (medaka_tpu raises below), keep that
        # match and align the rest in the same mode; the score is that of
        # the returned cigar: the match's (2) plus the rest's
        aln = _align(q, r, m)
        if next(cigar_ops_from_start(aln.cigar))[1] == "=" or q[0] != r[0]:
            return aln
        tail = _align(q[1:], r[1:], m)
        n, op = next(cigar_ops_from_start(tail.cigar)) if tail.cigar \
            else ("0", "")
        cigar = "{}={}".format(int(n) + 1, tail.cigar[len(n) + 1:]) \
            if op == "=" else "1=" + tail.cigar
        qlen, rlen = cigar_lengths(cigar)
        return native.Alignment(tail.score + 2, cigar, 0, rlen, 0, qlen)

    def check_starts_with_match(cigar):
        n, op = next(cigar_ops_from_start(cigar))
        if op != "=":
            raise ValueError(
                "Alignment did not start with a match: {}{}".format(n, op))

    qend_last = 0
    qend = 0
    rend_last = 0
    trim_qend = 0
    while qend + trim_qend < len(qseq):
        qstart = max(0, qend_last - 1)  # overlap by one match
        qend = min(qend_last + chunk_size, len(qseq))
        is_last_chunk = qend == len(qseq)
        if qstart == 0:
            rstart = 0
            rend = min(len(rseq), qend + pad)
            if is_last_chunk and mode == "NW":
                aln = _align(qseq, rseq, "nw")
            else:
                aln = _align(qseq[qstart:qend], rseq[rstart:rend],
                             mode_first)
            cigar = aln.cigar
            rstart_aln = aln.ref_start
            if mode == "HWT":
                cigar, trim_qstart, r_offset = trim_cigar(cigar, True)
                qstart += trim_qstart
                rstart_aln += r_offset
            if not is_last_chunk or mode == "HWT":
                cigar, trim_qend, _ = trim_cigar(cigar, False)
                qend -= trim_qend
            else:
                trim_qend = 0
        else:
            rstart = rend_last - 1  # overlap by one match
            if is_last_chunk:
                rend = len(rseq)
                aln = _align_anchored(qseq[qstart:qend], rseq[rstart:rend],
                                      mode_last)
                cigar, rstart_aln = aln.cigar, aln.ref_start
                check_starts_with_match(cigar)
                if mode == "HWT":
                    cigar, trim_qend, _ = trim_cigar(cigar, False)
                    qend -= trim_qend
                else:
                    trim_qend = 0
            else:
                # unlike the reference (``align.py:307``) continuation
                # windows get `pad` extra reference bases so chunks with
                # net deletions still fit
                rend = min(len(rseq), rstart + (qend - qstart) + pad)
                aln = _align_anchored(qseq[qstart:qend], rseq[rstart:rend],
                                      "shw")
                cigar, rstart_aln = aln.cigar, aln.ref_start
                check_starts_with_match(cigar)
                cigar, trim_qend, _ = trim_cigar(cigar, False)
                qend -= trim_qend

        record_start = rstart + rstart_aln
        _qlen, rlen_used = cigar_lengths(cigar)
        rec = initialise_alignment(
            "{}_{}_{}".format(contig_name, qstart, qend), ref_id,
            record_start, qseq[qstart:qend], cigar, 0,
            tags=dict(NM=_cigar_edits(cigar)))
        yield rec
        qend_last = qend
        rend_last = record_start + rlen_used


def _cigar_edits(cigar: str) -> int:
    edits = 0
    for n, op in cigar_ops_from_start(cigar):
        if op in ("X", "I", "D"):
            edits += int(n)
    return edits
