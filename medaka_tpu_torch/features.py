"""Pileup featurisation: BAM alignments -> network input arrays.

Counterpart of ``medaka_tpu/features.py``: ``pileup_counts`` with its
native helpers and the Weibull partial counts of run-length reads,
``CountsFeatureEncoder``, the run-length encoders
(``HardRLEFeatureEncoder``, ``SymHardRLEFeatureEncoder``,
``SoftRLEFeatureEncoder``), ``read_alignment_matrix``,
``ReadAlignmentFeatureEncoder``, ``SampleGenerator`` (with and without a
truth BAM), ``create_samples``, which writes the (labelled) feature
files that ``train`` reads, and ``get_trimmed_reads``, the region-trimmed
reads of the VCF annotator.

A single-datatype region goes from BGZF bytes to counts in the native
library (``native/src/pileup.cpp``). Regions it cannot take (several
datatypes, no .bai, CG long cigars) expand each CIGAR with numpy into
flat event arrays (column, channel) reduced with one ``bincount``.
Read-level matrices are filled by ``native/src/read_matrix.cpp``, and by
a per-read numpy path only for regions holding a CG long cigar.
"""
from __future__ import annotations

import concurrent.futures
import inspect
import itertools
import os
from collections import defaultdict
from typing import List, Optional

import numpy as np

from medaka_tpu_torch import common
from medaka_tpu_torch.common import (
    FEATLEN, FWD_DEL, NT16_TO_CHANNEL, PLP_BASES, REV_DEL, Region, Sample,
    make_positions)
from medaka_tpu_torch.io.bam import (
    C_D, C_EQ, C_I, C_M, C_N, C_S, C_X, BamReader, BamRecord)

#: Weibull partial counts are stored as integers of this scale
#: (``medaka_tpu/features.py`` WEIBULL_SCALE)
WEIBULL_SCALE = 10000

_CONSUMES_Q = np.array([1, 1, 0, 0, 1, 0, 0, 1, 1], dtype=np.int64)
_CONSUMES_R = np.array([1, 0, 1, 1, 0, 0, 0, 1, 1], dtype=np.int64)
_ALN_OPS = frozenset((C_M, C_EQ, C_X))


def from_dict(d):
    """Instantiate a feature encoder from its config dict."""
    cls = feature_encoders.get(d["type"])
    if cls is None:
        raise NotImplementedError(
            "Feature encoder {} is not ported to medaka_tpu_torch yet "
            "(ported: {}).".format(d["type"], ", ".join(feature_encoders)))
    return cls(**d["kwargs"])


def filter_read(
        rec: BamRecord, min_mapq: int = 1, tag_name: Optional[str] = None,
        tag_value: Optional[int] = None, keep_missing: bool = False,
        read_group: Optional[str] = None) -> bool:
    """Apply the reference's read filters (``medaka_bamiter.c:16-48``).

    :returns: True when the read should be used.
    """
    if rec.flag & (4 | 256 | 512 | 1024 | 2048):
        return False
    if rec.mapq < min_mapq:
        return False
    if tag_name:
        tag = rec.tags.get(tag_name)
        if tag is None:
            if not keep_missing:
                return False
        elif not isinstance(tag, (int, np.integer)):
            return False
        elif int(tag) != tag_value:
            return False
    if read_group is not None:
        if rec.tags.get("RG") != read_group:
            return False
    return True


class ReadEvents:
    """CIGAR-expansion of one read clipped to a region.

    Attributes are flat numpy arrays describing where each query base and
    each deletion lands in (reference position, minor index) space.
    """

    __slots__ = (
        "aln_rpos", "aln_qpos", "ins_anchor", "ins_minor", "ins_qpos",
        "del_rpos", "cover_start", "cover_end", "is_rev", "rec")

    def __init__(self, rec: BamRecord, start: int, end: int):
        self.rec = rec
        self.is_rev = rec.is_reverse
        ca = rec.cigar_array
        ops, lens = ca[:, 0], ca[:, 1]
        q_excl = np.cumsum(_CONSUMES_Q[ops] * lens) - _CONSUMES_Q[ops] * lens
        r_excl = rec.pos + (
            np.cumsum(_CONSUMES_R[ops] * lens) - _CONSUMES_R[ops] * lens)

        def expand(op_mask):
            """(op_index repeated, within-op offset) for selected ops."""
            sel = np.flatnonzero(op_mask)
            ls = lens[sel]
            idx = np.repeat(sel, ls)
            off = np.arange(ls.sum()) - np.repeat(np.cumsum(ls) - ls, ls)
            return idx, off

        # aligned bases
        idx, off = expand((ops == C_M) | (ops == C_EQ) | (ops == C_X))
        rp = r_excl[idx] + off
        keep = (rp >= start) & (rp < end)
        self.aln_rpos = rp[keep]
        self.aln_qpos = (q_excl[idx] + off)[keep]

        # deletions
        idx, off = expand(ops == C_D)
        rp = r_excl[idx] + off
        self.del_rpos = rp[(rp >= start) & (rp < end)]

        # insertions: anchored at the last consumed reference base
        idx, off = expand(ops == C_I)
        anchor = r_excl[idx] - 1
        keep = (anchor >= rec.pos) & (anchor >= start) & (anchor < end)
        self.ins_anchor = anchor[keep]
        self.ins_minor = off[keep] + 1
        self.ins_qpos = (q_excl[idx] + off)[keep]

        self.cover_start = max(rec.pos, start)
        self.cover_end = min(rec.reference_end, end)


class BatchedReadEvents:
    """CIGAR expansion of MANY reads in one vectorised pass.

    All per-read loops are replaced by concatenated-array operations —
    the per-read numpy overhead dominated host featurization otherwise.
    Produces flat event arrays carrying the originating read index so
    per-read attributes (strand, dtype, quals) can be gathered.
    """

    __slots__ = (
        "reads", "aln_rpos", "aln_read", "aln_nt16", "aln_qual",
        "ins_anchor", "ins_minor", "ins_read", "ins_nt16", "ins_qual",
        "del_rpos", "del_read", "cover_start", "cover_end")

    def __init__(self, reads, start: int, end: int):
        self.reads = reads
        n_ops = np.array([len(r.cigar_array) for r in reads])
        if n_ops.sum() == 0:
            empty = np.empty(0, np.int64)
            for name in self.__slots__[1:]:
                setattr(self, name, empty)
            return
        ca = np.concatenate([r.cigar_array for r in reads])
        ops, lens = ca[:, 0].astype(np.int64), ca[:, 1].astype(np.int64)
        op_read = np.repeat(np.arange(len(reads)), n_ops)
        first_op = np.concatenate(([0], np.cumsum(n_ops)))[:-1]

        # per-read exclusive cumsums of query/ref consumption
        tq = _CONSUMES_Q[ops] * lens
        tr = _CONSUMES_R[ops] * lens
        cq = np.cumsum(tq)
        cr = np.cumsum(tr)
        q_excl = cq - tq
        r_excl = cr - tr
        q_excl = q_excl - q_excl[first_op][op_read]
        r_excl = r_excl - r_excl[first_op][op_read]
        pos = np.array([r.pos for r in reads], dtype=np.int64)
        r_excl = r_excl + pos[op_read]

        # concatenated per-read base/qual arrays with offsets
        seq_lens = np.array([len(r.seq_nt16) for r in reads])
        seq_off = np.concatenate(([0], np.cumsum(seq_lens)))[:-1]
        self_nt16 = np.concatenate([r.seq_nt16 for r in reads]) \
            if len(reads) else np.empty(0, np.uint8)
        quals = [
            r.query_qualities if r.query_qualities is not None
            else np.zeros(len(r.seq_nt16), dtype=np.int64)
            for r in reads]
        self_qual = np.concatenate(quals) if quals else np.empty(
            0, np.int64)

        def expand(mask):
            sel = np.flatnonzero(mask)
            ls = lens[sel]
            idx = np.repeat(sel, ls)
            off = np.arange(ls.sum()) - np.repeat(np.cumsum(ls) - ls, ls)
            return idx, off

        # aligned bases
        idx, off = expand((ops == C_M) | (ops == C_EQ) | (ops == C_X))
        rp = r_excl[idx] + off
        keep = (rp >= start) & (rp < end)
        idx, off, rp = idx[keep], off[keep], rp[keep]
        self.aln_rpos = rp
        self.aln_read = op_read[idx]
        qpos_g = seq_off[self.aln_read] + q_excl[idx] + off
        self.aln_nt16 = self_nt16[qpos_g]
        self.aln_qual = self_qual[qpos_g]

        # deletions
        idx, off = expand(ops == C_D)
        rp = r_excl[idx] + off
        keep = (rp >= start) & (rp < end)
        self.del_rpos = rp[keep]
        self.del_read = op_read[idx[keep]]

        # insertions (anchored at preceding consumed reference base)
        idx, off = expand(ops == C_I)
        anchor = r_excl[idx] - 1
        keep = (anchor >= pos[op_read[idx]]) & (anchor >= start) \
            & (anchor < end)
        idx, off, anchor = idx[keep], off[keep], anchor[keep]
        self.ins_anchor = anchor
        self.ins_minor = off + 1
        self.ins_read = op_read[idx]
        qpos_g = seq_off[self.ins_read] + q_excl[idx] + off
        self.ins_nt16 = self_nt16[qpos_g]
        self.ins_qual = self_qual[qpos_g]

        self.cover_start = np.maximum(pos, start)
        self.cover_end = np.minimum(
            np.array([r.reference_end for r in reads], dtype=np.int64),
            end)


def _split_blocks(counts, majors, minors):
    """Split per-column kernel output into contiguous blocks on gaps in
    the major coordinates."""
    positions = make_positions(majors, minors)
    if len(majors) == 0:
        return [(counts, positions)]
    block_bounds = np.flatnonzero(np.diff(majors) > 1) + 1
    if len(block_bounds) == 0:
        return [(counts, positions)]
    out = []
    for piece in np.split(np.arange(len(majors)), block_bounds):
        out.append((counts[piece], positions[piece]))
    return out


def _pileup_counts_payload(reader, region, num_qstrat, min_mapq,
                           tag_name, tag_value, keep_missing,
                           read_group):
    """Fully native single-dtype pileup: BGZF bytes -> counts.

    Inflates the region's index-chunk span in one multi-threaded
    native pass (``BamReader.region_payload``), scans + filters the
    records in C++ (``native/src/bam_scan.cpp`` — the reference's
    ``medaka_bamiter.c`` filters), and feeds the surviving record
    offsets straight to the pileup kernel. No ``BamRecord`` objects
    are created. Returns None when the BAM has no .bai, the region's
    span is too large to inflate at once, or a record carries a CG
    long cigar (callers use the numpy path); native faults raise.
    """
    from medaka_tpu_torch import native
    rp = reader.region_payload(region.ref_name, region.start, region.end)
    if rp is None:
        return None
    payload, seg_start, seg_end, tid = rp
    try:
        rec_off = native.bam_scan_filter(
            payload, seg_start, seg_end, tid, region.start, region.end,
            min_mapq=min_mapq, tag_name=tag_name,
            tag_value=tag_value if tag_value is not None else 0,
            keep_missing=keep_missing, read_group=read_group)
    except native.LongCigarInPayload:
        return None  # cigar-expanding numpy path handles CG records
    if len(rec_off) == 0:
        return [(
            np.empty((0, FEATLEN * num_qstrat), dtype=np.int32),
            make_positions([], []))]
    rec_off = np.append(rec_off, payload.size)
    counts, majors, minors = native.pileup_counts_raw(
        payload, rec_off, np.zeros(len(rec_off) - 1, np.int32),
        region.start, region.end, 1, num_qstrat)
    return _split_blocks(counts, majors, minors)


def _weibull_fractions(rec: BamRecord, qpos: np.ndarray, num_qstrat: int,
                       logger) -> np.ndarray:
    """Per-base homopolymer partial counts from WL/WK Weibull tags
    (``medaka_tpu.features._weibull_fractions``, ``medaka_counts.c:133-171``:
    zero counts when the tags are missing or out of range)."""
    out = np.zeros((len(qpos), num_qstrat), dtype=np.float64)
    wl = rec.tags.get("WL")
    wk = rec.tags.get("WK")
    if wl is None or wk is None:
        logger.debug(
            "Failed to retrieve Weibull parameter tags for read %s.",
            rec.query_name)
        return out
    ok = qpos < min(len(wl), len(wk))
    scale = np.asarray(wl, dtype=np.float64)[qpos[ok]]
    shape = np.asarray(wk, dtype=np.float64)[qpos[ok]]
    x = np.arange(1, num_qstrat + 1, dtype=np.float64)
    with np.errstate(over="ignore", invalid="ignore"):
        a = np.power((x - 1)[None, :] / scale[:, None], shape[:, None])
        b = np.power(x[None, :] / scale[:, None], shape[:, None])
        # fmax (not maximum): C fmax(0, NaN) == 0 for overflowed shapes
        out[ok] = np.fmax(0.0, -np.exp(-a) * np.expm1(a - b))
    return out


def pileup_counts(
        region: Region, bam, dtype_prefixes=None, region_split=100000,
        workers=8, tag_name=None, tag_value=None, keep_missing=False,
        num_qstrat=1, weibull_summation=False, read_group=None, min_mapq=1):
    """Create pileup count matrices for a region.

    :param region: `Region` to process.
    :param bam: path to a sorted, indexed BAM (or an open `BamReader`).
    :param dtype_prefixes: names of datatypes split by the ``DT`` tag;
        `None` or a singleton means no splitting.
    :param num_qstrat: number of qscore stratification layers.
    :param weibull_summation: base counts are the reads' WL/WK Weibull
        partial counts over the ``num_qstrat`` run lengths, times
        :data:`WEIBULL_SCALE` (the numpy path, read by read).
    :param region_split: accepted for ``medaka_tpu``'s signature; unused,
        as there: the native kernel streams the whole region in one pass.
    :param workers: accepted for ``medaka_tpu``'s signature; unused (see
        ``region_split``).

    :returns: list of (counts, positions) tuples, one per contiguous block
        of covered reference positions. ``counts`` has shape
        (n_cols, featlen * num_dtypes * num_qstrat), int32 from the
        native kernel (int64 from the numpy fallback); ``positions`` is
        a structured (major, minor) array.

    Matches ``calculate_pileup`` (``src/medaka_counts.c:199-372``) composed
    with the chunk-contiguity fixup of ``medaka/features.py:111-164``.
    """
    del region_split, workers  # medaka_tpu's signature only
    if dtype_prefixes is None or isinstance(dtype_prefixes, str):
        dtypes = [""]
    else:
        dtypes = list(dtype_prefixes)
    num_dtypes = len(dtypes)
    dtype_index = {d: i for i, d in enumerate(dtypes)}
    start, end = region.start, region.end
    span = end - start
    col_feat = FEATLEN * num_dtypes * num_qstrat

    reader = bam if isinstance(bam, BamReader) else BamReader(bam)
    try:
        if num_dtypes == 1 and not weibull_summation:
            # hot path: record scan + filter + pileup fully in C++
            # over the inflated payload, no BamRecord objects at all
            payload_result = _pileup_counts_payload(
                reader, region, num_qstrat, min_mapq, tag_name,
                tag_value, keep_missing, read_group)
            if payload_result is not None:
                return payload_result
        reads = [
            rec for rec in reader.fetch(region.ref_name, start, end)
            if filter_read(
                rec, min_mapq, tag_name, tag_value, keep_missing, read_group)]
    finally:
        if reader is not bam:
            reader.close()

    if not reads:
        # dtype matches the native kernel's (the default path)
        return [(
            np.empty((0, col_feat), dtype=np.int32),
            make_positions([], []))]

    ev = BatchedReadEvents(reads, start, end)

    # per-read attributes gathered per event
    is_rev = np.array([r.is_reverse for r in reads], dtype=bool)
    if num_dtypes > 1:
        dtypes_of_read = np.empty(len(reads), dtype=np.int64)
        for i, rec in enumerate(reads):
            dt_tag = rec.tags.get("DT")
            if dt_tag is None or dt_tag not in dtype_index:
                raise ValueError(
                    "Datatype not found for {}.".format(rec.query_name))
            dtypes_of_read[i] = dtype_index[dt_tag]
    else:
        dtypes_of_read = np.zeros(len(reads), dtype=np.int64)
    dtype_off_of_read = FEATLEN * dtypes_of_read * num_qstrat

    # coverage per position and max insertion length per anchor position
    cover = np.zeros(span + 1, dtype=np.int32)
    max_ins = np.zeros(span, dtype=np.int64)
    has_cover = ev.cover_end > ev.cover_start
    np.add.at(cover, ev.cover_start[has_cover] - start, 1)
    np.add.at(cover, ev.cover_end[has_cover] - start, -1)
    if len(ev.ins_anchor):
        np.maximum.at(max_ins, ev.ins_anchor - start, ev.ins_minor)
    covered = np.cumsum(cover[:-1]) > 0
    cov_pos = np.flatnonzero(covered)  # positions relative to start
    if len(cov_pos) == 0:
        return [(
            np.empty((0, col_feat), dtype=np.int64),
            make_positions([], []))]

    cols_per_pos = 1 + max_ins[cov_pos]
    col_start = np.concatenate(([0], np.cumsum(cols_per_pos)))
    n_cols = int(col_start[-1])
    # map reference offset -> first column index (-1 when uncovered)
    col_of_pos = np.full(span, -1, dtype=np.int64)
    col_of_pos[cov_pos] = col_start[:-1]

    # positions array
    majors = np.repeat(cov_pos + start, cols_per_pos)
    minors = np.arange(n_cols) - np.repeat(col_start[:-1], cols_per_pos)
    positions = make_positions(majors, minors)

    # accumulate all events in single bincount passes
    flat = np.zeros(n_cols * col_feat, dtype=np.int64)

    # deletion events (always land in qstrat layer 0)
    if len(ev.del_rpos):
        del_chan = np.where(is_rev[ev.del_read], REV_DEL, FWD_DEL)
        cols = col_of_pos[ev.del_rpos - start]
        idx = cols * col_feat + dtype_off_of_read[ev.del_read] + del_chan
        flat += np.bincount(idx, minlength=flat.size)

    # base events: aligned (minor 0) and inserted (minor >= 1)
    cols = np.concatenate([
        col_of_pos[ev.aln_rpos - start],
        col_of_pos[ev.ins_anchor - start] + ev.ins_minor])
    read_of = np.concatenate([ev.aln_read, ev.ins_read])
    nt16 = np.concatenate([ev.aln_nt16, ev.ins_nt16])
    quals = np.concatenate([ev.aln_qual, ev.ins_qual])
    if len(cols):
        chan = NT16_TO_CHANNEL[
            nt16.astype(np.int64) + 16 * is_rev[read_of]]
        valid = chan >= 0
        cols, chan, read_of = cols[valid], chan[valid], read_of[valid]
        quals = quals[valid]
        dtype_off = dtype_off_of_read[read_of]
        if weibull_summation:
            # Weibull partial counts need each read's WL/WK tags
            logger = common.get_named_logger("Pileup")
            for rec_i, rec in enumerate(reads):
                rev = ReadEvents(rec, start, end)
                qpos = np.concatenate([rev.aln_qpos, rev.ins_qpos])
                if not len(qpos):
                    continue
                rcols = np.concatenate([
                    col_of_pos[rev.aln_rpos - start],
                    col_of_pos[rev.ins_anchor - start] + rev.ins_minor])
                rchan = NT16_TO_CHANNEL[
                    rec.seq_nt16[qpos] + (16 if rev.is_rev else 0)]
                ok = rchan >= 0
                rcols, rchan, qpos = rcols[ok], rchan[ok], qpos[ok]
                frac = _weibull_fractions(rec, qpos, num_qstrat, logger)
                contrib = (WEIBULL_SCALE * frac).astype(np.int64)
                idx = (rcols[:, None] * col_feat + dtype_off_of_read[rec_i]
                       + FEATLEN * np.arange(num_qstrat)[None, :]
                       + rchan[:, None])
                np.add.at(flat, idx.ravel(), contrib.ravel())
        else:
            if num_qstrat > 1:
                qstrat = np.maximum(
                    0, np.minimum(quals.astype(np.int64), num_qstrat) - 1)
            else:
                qstrat = 0
            idx = cols * col_feat + dtype_off + FEATLEN * qstrat + chan
            flat += np.bincount(idx, minlength=flat.size)

    counts = flat.reshape(n_cols, col_feat)

    # split into contiguous blocks on gaps in major coordinates
    block_bounds = np.flatnonzero(np.diff(cov_pos) > 1) + 1
    if len(block_bounds) == 0:
        return [(counts, positions)]
    out = []
    col_cuts = col_start[block_bounds]
    pieces = np.split(np.arange(n_cols), col_cuts)
    for piece in pieces:
        out.append((counts[piece], positions[piece]))
    return out


def pileup_counts_norm_indices(dtypes, num_qstrat=1):
    """Group feature-vector indices by (datatype, is_reverse).

    Mirrors ``medaka/features.py:647-687``.
    """
    indices = defaultdict(list)
    for dti, _dt in enumerate(dtypes):
        for qindex in range(num_qstrat):
            for base_i, code in enumerate(PLP_BASES):
                indices[_dt, code.islower()].append(
                    base_i + dti * num_qstrat * FEATLEN + qindex * FEATLEN)
    return dict(indices)


# ---------------------------------------------------------------------------
# Feature encoders
# ---------------------------------------------------------------------------

feature_encoders = {}


class _EncoderMeta(type):
    def __new__(mcls, name, bases, attrs):
        cls = super().__new__(mcls, name, bases, attrs)
        if name != "BaseFeatureEncoder":
            feature_encoders[name] = cls
        return cls


class BaseFeatureEncoder(metaclass=_EncoderMeta):
    """Base class turning BAM pileups into `Sample` objects."""

    def __init__(self):
        self.logger = common.get_named_logger("Feature")

    def to_dict(self):
        """Serialise constructor arguments."""
        kwargs = {}
        params = inspect.signature(self.__class__.__init__).parameters
        for opt, param in params.items():
            if opt == "self":
                continue
            if hasattr(self, opt):
                kwargs[opt] = getattr(self, opt)
            elif param.default is not inspect.Parameter.empty:
                kwargs[opt] = param.default
            else:
                raise ValueError("Missing value for {}".format(opt))
        return {"type": self.__class__.__name__, "kwargs": kwargs}

    def __getstate__(self):
        # the logger does not pickle: encoders travel to feature worker
        # processes (prediction.DataLoader(feature_processes=...))
        state = self.__dict__.copy()
        state.pop("logger", None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.logger = common.get_named_logger("Feature")

    def bam_to_sample(self, reads_bam, region: Region) -> List[Sample]:
        """Featurise a region of a BAM into (one or more) `Sample` s."""
        pileups = self._pileup_function(region, reads_bam)
        samples = []
        for counts, positions in pileups:
            if len(counts) == 0:
                self.logger.warning(
                    "Pileup-feature is zero-length for {} indicating no "
                    "reads in this region.".format(region))
                samples.append(Sample(
                    ref_name=region.ref_name, features=None, labels=None,
                    ref_seq=None, positions=positions, label_probs=None))
                continue
            samples.append(
                self._post_process_pileup(counts, positions, region))
        return samples

    def bams_to_training_samples(
            self, truth_bam, bam, region: Region, label_scheme,
            truth_haplotag=None, min_length=1000):
        """Create labelled training samples for a region.

        Aligns label-scheme encodings of truth alignments with the feature
        positions, padding feature-only (read-insertion) columns with the
        scheme's padding vector.
        """
        from medaka_tpu_torch import labels as labels_mod
        alns = labels_mod.TruthAlignment.bam_to_alignments(
            truth_bam, region, haplotag=truth_haplotag,
            min_length=min_length)
        if len(alns) == 0:
            self.logger.info(
                "Filtering and grouping removed all alignments of truth to "
                "ref from {}.".format(region))

        samples = []
        for aln in alns:
            truth_pos, truth_labels = label_scheme.encode(aln)
            aln_samples = self.bam_to_sample(
                bam, Region(region.ref_name, aln[0].start, aln[0].end))
            for sample in aln_samples:
                shape = list(truth_labels.shape)
                shape[0] = len(sample.positions)
                padded = np.full(
                    shape, label_scheme.padding_vector,
                    dtype=truth_labels.dtype)
                t_in = np.isin(truth_pos, sample.positions)
                s_in = np.isin(sample.positions, truth_pos)
                assert t_in.sum() == s_in.sum()
                padded[np.where(s_in)] = truth_labels[np.where(t_in)]
                samples.append(sample.amend(labels=padded))
        return tuple(samples)


class CountsFeatureEncoder(BaseFeatureEncoder):
    """Normalised base-count pileup features (10 channels per dtype)."""

    _norm_modes_ = ["total", "fwd_rev", None]
    feature_dtype = np.float32

    def __init__(
            self, normalise="total", dtypes=("",), tag_name=None,
            tag_value=None, tag_keep_missing=False, read_group=None,
            min_mapq=1, sym_indels=False):
        """Initialise the encoder.

        :param normalise: 'total', 'fwd_rev' or None.
        :param dtypes: datatype names split by the ``DT`` read tag.
        :param sym_indels: count lack of insertion as deletion at minor
            columns.
        """
        self.normalise = normalise
        self.dtypes = tuple(dtypes)
        self.tag_name = tag_name
        self.tag_value = tag_value
        self.tag_keep_missing = tag_keep_missing
        self.read_group = read_group
        self.min_mapq = min_mapq
        self.sym_indels = sym_indels
        self.feature_indices = pileup_counts_norm_indices(self.dtypes)
        if self.normalise not in self._norm_modes_:
            raise ValueError("normalise={} is not one of {}".format(
                self.normalise, self._norm_modes_))
        super().__init__()

    def _qstrat(self):
        return 1

    def _pileup_function(self, region, bam):
        return pileup_counts(
            region, bam, dtype_prefixes=self.dtypes,
            tag_name=self.tag_name, tag_value=self.tag_value,
            keep_missing=self.tag_keep_missing, read_group=self.read_group,
            min_mapq=self.min_mapq)

    def _post_process_pileup(self, counts, positions, region) -> Sample:
        start, end = positions["major"][0], positions["major"][-1]
        if start != region.start or end + 1 != region.end:
            self.logger.warning(
                "Pileup counts do not span requested region, requested {}, "
                "received {}-{}.".format(region, start, end))

        if (self.normalise == "total" and not self.sym_indels
                and counts.dtype == np.int32):
            # hot path: depth + normalisation in one native pass
            # (no per-column numpy temporaries)
            from medaka_tpu_torch import native
            feats, depth = native.counts_norm_total(
                counts, positions["minor"])
            return Sample(
                ref_name=region.ref_name, features=feats, labels=None,
                ref_seq=None, positions=positions, label_probs=None,
                depth=depth)

        minor_inds = np.where(positions["minor"] > 0)
        major_at_minor = positions["major"][minor_inds]
        major_ind = np.searchsorted(
            positions["major"], major_at_minor, side="left")

        depth = np.sum(counts, axis=1)
        depth[minor_inds] = depth[major_ind]

        if self.sym_indels:
            # fill in implied deletions at minor columns: reads which span
            # the insertion site but do not carry the insertion
            for (dt, is_rev), inds in self.feature_indices.items():
                dt_depth = np.sum(counts[:, inds], axis=1)
                featlen_index = REV_DEL if is_rev else FWD_DEL
                dtype_size = FEATLEN * self._qstrat()
                del_ind = [
                    x for x in inds if x % dtype_size == featlen_index][0]
                counts[minor_inds, del_ind] = \
                    dt_depth[major_ind] - dt_depth[minor_inds]

        if self.normalise == "total":
            feature_array = np.divide(
                counts, np.maximum(1, depth)[:, None],
                dtype=self.feature_dtype)
        elif self.normalise == "fwd_rev":
            feature_array = np.empty_like(counts, dtype=self.feature_dtype)
            for (dt, is_rev), inds in self.feature_indices.items():
                dt_depth = np.sum(counts[:, inds], axis=1)
                dt_depth[minor_inds] = dt_depth[major_ind]
                feature_array[:, inds] = np.divide(
                    counts[:, inds], np.maximum(1, dt_depth)[:, None],
                    dtype=self.feature_dtype)
        else:
            feature_array = counts.astype(self.feature_dtype)

        return Sample(
            ref_name=region.ref_name, features=feature_array, labels=None,
            ref_seq=None, positions=positions, label_probs=None, depth=depth)


class HardRLEFeatureEncoder(CountsFeatureEncoder):
    """Counts stratified by run length encoded in base qualities
    (``medaka_tpu.features.HardRLEFeatureEncoder``)."""

    def __init__(
            self, normalise="total", dtypes=("",), tag_name=None,
            tag_value=None, tag_keep_missing=False, num_qstrat=15,
            read_group=None, min_mapq=1):
        """Initialise with ``num_qstrat`` stratification layers."""
        self.num_qstrat = num_qstrat
        super().__init__(
            normalise, dtypes=dtypes, tag_name=tag_name, tag_value=tag_value,
            tag_keep_missing=tag_keep_missing, read_group=read_group,
            min_mapq=min_mapq)
        self.feature_indices = pileup_counts_norm_indices(
            self.dtypes, num_qstrat=self.num_qstrat)

    @property
    def feature_vector_length(self):
        """Width of one feature vector."""
        return len(self.dtypes) * FEATLEN * self.num_qstrat

    def _qstrat(self):
        return self.num_qstrat

    def _pileup_function(self, region, bam):
        return pileup_counts(
            region, bam, dtype_prefixes=self.dtypes,
            tag_name=self.tag_name, tag_value=self.tag_value,
            keep_missing=self.tag_keep_missing, num_qstrat=self.num_qstrat,
            read_group=self.read_group, min_mapq=self.min_mapq)


class SymHardRLEFeatureEncoder(HardRLEFeatureEncoder):
    """HardRLE where a spanned-but-absent insertion counts as deletion
    (``medaka_tpu.features.SymHardRLEFeatureEncoder``)."""

    def _pileup_function(self, region, bam):
        # per coverage block (a gapped region yields several)
        out = []
        for counts, positions in super()._pileup_function(region, bam):
            minor_inds = np.where(positions["minor"] > 0)
            major_at_minor = positions["major"][minor_inds]
            major_ind = np.searchsorted(
                positions["major"], major_at_minor, side="left")
            for (dt, is_rev), inds in self.feature_indices.items():
                dt_depth = np.sum(counts[:, inds], axis=1)
                featlen_index = REV_DEL if is_rev else FWD_DEL
                dtype_size = FEATLEN * self.num_qstrat
                del_ind = [
                    x for x in inds if x % dtype_size == featlen_index][0]
                counts[minor_inds, del_ind] = \
                    dt_depth[major_ind] - dt_depth[minor_inds]
            out.append((counts, positions))
        return out


class SoftRLEFeatureEncoder(HardRLEFeatureEncoder):
    """RLE pileups from Weibull partial counts (WL/WK tags)
    (``medaka_tpu.features.SoftRLEFeatureEncoder``)."""

    def _pileup_function(self, region, bam):
        return pileup_counts(
            region, bam, dtype_prefixes=self.dtypes,
            tag_name=self.tag_name, tag_value=self.tag_value,
            keep_missing=self.tag_keep_missing, num_qstrat=self.num_qstrat,
            weibull_summation=True, read_group=self.read_group,
            min_mapq=self.min_mapq)


# ---------------------------------------------------------------------------
# Read-level (3-D) feature matrices
# ---------------------------------------------------------------------------

# strand-symmetric nt16 -> base code (1..4), 0 = pad, 5 = deletion
# (reference ``medaka_read_matrix.h:37-46``)
NT16_TO_SYMM = np.zeros(16, dtype=np.int8)
for _code, _base in ((1, 1), (2, 2), (4, 3), (8, 4)):
    NT16_TO_SYMM[_code] = _base
READ_DEL_VAL = 5
BASE_FEATLEN = 4  # base, qual, strand, mapq
READ_ROW_MIN_GAP = 5  # reference ``medaka_read_matrix.c:329``


def calculate_dwells(rec: BamRecord) -> Optional[np.ndarray]:
    """Per-base dwell times (basecaller strides) from the ``mv`` tag.

    Mirrors ``calculate_dwells`` (``medaka_read_matrix.c:169-228``):
    returns None when the tag is absent or inconsistent with the
    sequence length (clipped records).
    """
    mv = rec.tags.get("mv")
    if mv is None:
        return None
    mv = np.asarray(mv)
    length = len(rec.seq_nt16)
    # tag layout: [stride, move, move, ...]; a move of 1 starts a base
    moves = np.flatnonzero(mv[1:] == 1) + 1  # indices into mv
    if len(moves) != length:
        common.get_named_logger("Dwells").debug(
            "Invalid move array detected for read %s.", rec.query_name)
        return None
    out = np.empty(length, dtype=np.int64)
    if rec.is_reverse:
        # the first basecalled base is the last stored base
        bounds = np.concatenate((moves, [len(mv)]))
        out[:] = np.diff(bounds)[::-1]
    else:
        out[:-1] = np.diff(moves)
        out[-1] = len(mv) - moves[-1]
    return np.minimum(out, np.iinfo(np.int8).max).astype(np.int8)


def _read_matrix_native(reads, start, end, dtype_index, num_dtypes,
                        include_dwells, include_haplotype, row_per_read,
                        max_reads):
    """Native read-level matrix; None when a read has a CG long cigar.

    Tag-derived per-read values (DT, HP, dwells from ``mv``) are parsed
    here; the C++ kernel (``native/src/read_matrix.cpp``) does the
    O(reads x bases) fill over raw BAM record bytes. Native faults raise.
    """
    from medaka_tpu_torch import native
    if any(r.has_long_cigar for r in reads):
        return None  # CG-tag long cigars: the numpy path expands them
    n = len(reads)
    read_dtype = np.zeros(n, dtype=np.int32)
    if num_dtypes > 1:
        for i, rec in enumerate(reads):
            dt_tag = rec.tags.get("DT")
            if dt_tag is None or dt_tag not in dtype_index:
                raise ValueError(
                    "Datatype not found for {}.".format(rec.query_name))
            read_dtype[i] = dtype_index[dt_tag]
    read_hap = np.zeros(n, dtype=np.int8)
    if include_haplotype:
        for i, rec in enumerate(reads):
            read_hap[i] = int(rec.tags.get("HP", 0))
    dwell_off = np.full(n, -1, dtype=np.int64)
    dwell_parts = []
    if include_dwells:
        total = 0
        for i, rec in enumerate(reads):
            dw = calculate_dwells(rec)
            if dw is not None:
                dwell_off[i] = total
                dwell_parts.append(dw)
                total += len(dw)
    dwells = (np.concatenate(dwell_parts) if dwell_parts
              else np.empty(0, np.int8))
    raw = [r.raw for r in reads]
    rec_off = np.zeros(n + 1, dtype=np.int64)
    rec_off[1:] = np.cumsum([len(b) for b in raw])
    matrix, majors, minors, _left, _right = native.read_matrix_raw(
        b"".join(raw), rec_off, read_dtype, read_hap, dwells, dwell_off,
        start, end, num_dtypes, include_dwells, include_haplotype,
        row_per_read, max_reads)
    return _split_blocks(matrix, majors, minors)


def read_alignment_matrix(
        region: Region, bam, dtype_prefixes=None, tag_name=None,
        tag_value=None, keep_missing=False, read_group=None, min_mapq=1,
        row_per_read=False, include_dwells=True, include_haplotype=False,
        max_reads=100):
    """Build read-level feature tensors for a region.

    Counterpart of ``read_alignment_matrix`` in ``medaka_tpu/features.py``:
    an int8 tensor (n_cols, n_reads, featlen) with per-read channels [base,
    qual, strand, mapq(, dwell)(, haplotype)(, dtype)] following
    ``calculate_read_alignment`` (``src/medaka_read_matrix.c:277-615``):
    deletion columns get ``del_val=5``/qual -1, columns a read spans but
    has no insertion for are filled as deletions, read rows are reused
    once a prior occupant has ended ``min_gap=5`` positions earlier. The
    whole region is processed in one pass, so row identity is globally
    consistent.

    :returns: list of (matrix, positions) per contiguous coverage block.
    """
    logger = common.get_named_logger("ReadMatrix")
    if dtype_prefixes is None or isinstance(dtype_prefixes, str):
        dtypes = [""]
    else:
        dtypes = list(dtype_prefixes)
    num_dtypes = len(dtypes)
    dtype_index = {d: i for i, d in enumerate(dtypes)}
    featlen = (BASE_FEATLEN + int(include_dwells) + int(include_haplotype)
               + int(num_dtypes > 1))
    start, end = region.start, region.end
    span = end - start

    reader = bam if isinstance(bam, BamReader) else BamReader(bam)
    try:
        reads = [
            rec for rec in reader.fetch(region.ref_name, start, end)
            if filter_read(
                rec, min_mapq, tag_name, tag_value, keep_missing,
                read_group)]
    finally:
        if reader is not bam:
            reader.close()

    def empty():
        return [(
            np.empty((0, 0, featlen), dtype=np.int8),
            make_positions([], []))]

    if not reads:
        return empty()

    native_result = _read_matrix_native(
        reads, start, end, dtype_index, num_dtypes, include_dwells,
        include_haplotype, row_per_read, max_reads)
    if native_result is not None:
        return native_result

    events = [ReadEvents(rec, start, end) for rec in reads]
    events = [ev for ev in events if ev.cover_end > ev.cover_start]
    if not events:
        return empty()

    # column geometry (as for counts)
    cover = np.zeros(span + 1, dtype=np.int32)
    max_ins = np.zeros(span, dtype=np.int64)
    for ev in events:
        cover[ev.cover_start - start] += 1
        cover[ev.cover_end - start] -= 1
        if len(ev.ins_anchor):
            np.maximum.at(
                max_ins, ev.ins_anchor - start,
                ev.ins_minor.astype(np.int64))
    covered = np.cumsum(cover[:-1]) > 0
    cov_pos = np.flatnonzero(covered)
    if len(cov_pos) == 0:
        return empty()
    cols_per_pos = 1 + max_ins[cov_pos]
    col_start = np.concatenate(([0], np.cumsum(cols_per_pos)))
    n_cols = int(col_start[-1])
    col_of_pos = np.full(span, -1, dtype=np.int64)
    col_of_pos[cov_pos] = col_start[:-1]
    majors = np.repeat(cov_pos + start, cols_per_pos)
    minors = np.arange(n_cols) - np.repeat(col_start[:-1], cols_per_pos)

    # row assignment in pileup order with slot reuse
    row_end: List[int] = []    # current occupant's reference end per row
    rows: List[int] = []       # row of each event (-1 = dropped)
    for ev in events:
        p0 = ev.cover_start
        row = None
        if not row_per_read:
            for r, rend in enumerate(row_end):
                if p0 >= rend + READ_ROW_MIN_GAP:
                    row = r
                    break
        if row is None:
            row = len(row_end)
            row_end.append(ev.rec.reference_end)
        else:
            row_end[row] = ev.rec.reference_end
        rows.append(row if row < max_reads else -1)
    n_reads = min(max_reads, len(row_end))

    matrix = np.zeros((n_cols, n_reads, featlen), dtype=np.int8)
    dwell_ch = BASE_FEATLEN if include_dwells else None
    hap_ch = (BASE_FEATLEN + int(include_dwells)
              if include_haplotype else None)
    dt_ch = (BASE_FEATLEN + int(include_dwells) + int(include_haplotype)
             if num_dtypes > 1 else None)

    for ev, row in zip(events, rows):
        if row < 0:
            continue
        rec = ev.rec
        strand = -1 if ev.is_rev else 1
        mapq = min(rec.mapq, np.iinfo(np.int8).max)
        hap = int(rec.tags.get("HP", 0)) if include_haplotype else 0
        if num_dtypes > 1:
            dt_tag = rec.tags.get("DT")
            if dt_tag is None or dt_tag not in dtype_index:
                raise ValueError(
                    "Datatype not found for {}.".format(rec.query_name))
            dtype = dtype_index[dt_tag]
        else:
            dtype = 0
        dwells = calculate_dwells(rec) if include_dwells else None

        # default-fill the read's whole covered column span as deletions
        lo = col_of_pos[ev.cover_start - start]
        hi_pos = ev.cover_end - 1 - start
        hi = col_of_pos[hi_pos] + max_ins[hi_pos] + 1
        sl = matrix[lo:hi, row]
        sl[:, 0] = READ_DEL_VAL
        sl[:, 1] = -1
        sl[:, 2] = strand
        sl[:, 3] = mapq
        if dwell_ch is not None:
            sl[:, dwell_ch] = -1
        if hap_ch is not None:
            sl[:, hap_ch] = hap
        if dt_ch is not None:
            sl[:, dt_ch] = dtype

        # overwrite with real base calls (aligned + inserted)
        qpos = np.concatenate([ev.aln_qpos, ev.ins_qpos])
        if len(qpos):
            cols = np.concatenate([
                col_of_pos[ev.aln_rpos - start],
                col_of_pos[ev.ins_anchor - start] + ev.ins_minor])
            matrix[cols, row, 0] = NT16_TO_SYMM[rec.seq_nt16[qpos]]
            quals = rec.query_qualities
            matrix[cols, row, 1] = (
                np.minimum(quals[qpos], np.iinfo(np.int8).max)
                if quals is not None else 0)
            if dwell_ch is not None and dwells is not None:
                matrix[cols, row, dwell_ch] = dwells[qpos]

    logger.debug(
        "Processed %s: %d cols x %d reads.", region, n_cols, n_reads)
    return _split_blocks(matrix, majors, minors)


class ReadAlignmentFeatureEncoder(CountsFeatureEncoder):
    """Read-level 3-D feature tensors (reference ``features.py:1100-1205``).

    Counterpart of ``ReadAlignmentFeatureEncoder`` in
    ``medaka_tpu/features.py``.
    Features are int8 (positions, reads, channels); channels are [base,
    qual, strand, mapq(, dwell)(, haplotype)]. Bases are 0-5 for [pad, A,
    C, G, T, deletion] (strand symmetric); strand is +1/-1; dwell is
    basecaller strides.
    """

    feature_dtype = np.int8

    def __init__(
            self, dtypes=("",), tag_name=None, tag_value=None,
            tag_keep_missing=False, read_group=None, min_mapq=1,
            max_reads=100, row_per_read=False, include_dwells=True,
            include_haplotype=False):
        """See class docstring; parameters follow the reference."""
        self.max_reads = max_reads
        self.row_per_read = row_per_read
        self.include_dwells = include_dwells
        self.include_haplotype = include_haplotype
        super().__init__(
            normalise=None, dtypes=dtypes, tag_name=tag_name,
            tag_value=tag_value, tag_keep_missing=tag_keep_missing,
            read_group=read_group, min_mapq=min_mapq)

    @property
    def feature_vector_length(self):
        """Channels per read per position."""
        return (BASE_FEATLEN + int(self.include_dwells)
                + int(self.include_haplotype) + int(len(self.dtypes) > 1))

    def _pileup_function(self, region, bam):
        return read_alignment_matrix(
            region, bam, dtype_prefixes=self.dtypes,
            tag_name=self.tag_name, tag_value=self.tag_value,
            keep_missing=self.tag_keep_missing,
            read_group=self.read_group, min_mapq=self.min_mapq,
            row_per_read=self.row_per_read,
            include_dwells=self.include_dwells,
            include_haplotype=self.include_haplotype,
            max_reads=self.max_reads)

    def _post_process_pileup(self, features, positions, region) -> Sample:
        """The sample with ``depth``: the non-empty read rows per column."""
        depth = np.count_nonzero(features[..., 0], axis=-1)
        return Sample(
            ref_name=region.ref_name, features=features, labels=None,
            ref_seq=None, positions=positions, label_probs=None,
            depth=depth)


# ---------------------------------------------------------------------------
# Sample generation / chunking
# ---------------------------------------------------------------------------


class SampleGenerator:
    """Chunked inference/training sample production for one region."""

    def __init__(
            self, bam, region, feature_encoder, truth_bam=None,
            label_scheme=None, truth_haplotag=None, chunk_len=1000,
            chunk_overlap=200, enable_chunking=True, min_truth_length=1000):
        """See reference ``features.py:1208-1254`` for the contract."""
        self.logger = common.get_named_logger("Sampler")
        self.bam = bam
        self.region = region
        self.fencoder = feature_encoder
        self.truth_bam = truth_bam
        self.label_scheme = label_scheme
        self.truth_haplotag = truth_haplotag
        self.chunk_len = chunk_len
        self.chunk_overlap = chunk_overlap
        self.enable_chunking = enable_chunking
        self.min_truth_length = min_truth_length
        self._source = None
        self._quarantined = []
        if truth_bam is not None and label_scheme is None:
            raise ValueError(
                "A `LabelScheme` must be given to create training data.")

    def _fill_features(self):
        if self._source is not None:
            return
        if self.truth_bam is not None:
            self._source = self.fencoder.bams_to_training_samples(
                self.truth_bam, self.bam, self.region, self.label_scheme,
                truth_haplotag=self.truth_haplotag,
                min_length=self.min_truth_length)
        else:
            self._source = self.fencoder.bam_to_sample(self.bam, self.region)

    @property
    def samples(self) -> List[Sample]:
        """Return (possibly chunked) samples for the region."""
        self._fill_features()
        self._quarantined = []
        out = []
        for source in self._source:
            if source.is_empty:
                continue
            if not self.enable_chunking:
                out.append(source)
                continue
            if source.size < self.chunk_len:
                self.logger.debug(
                    "Region {} ({} positions) is smaller than inference "
                    "chunk length {}, quarantining.".format(
                        source.name, source.size, self.chunk_len))
                start, _ = source.first_pos
                end, _ = source.last_pos
                self._quarantined.append((
                    Region(source.ref_name, start, end + 1), source.size))
                continue
            out.extend(source.chunks(
                chunk_len=self.chunk_len, overlap=self.chunk_overlap))
        return out


# ---------------------------------------------------------------------------
# Feature-file creation (`medaka_tpu_torch features`)
# ---------------------------------------------------------------------------


def featurize_region(bam, region, encoder, chunk_len, chunk_overlap):
    """Featurise one region in a worker process of
    ``prediction.DataLoader(feature_processes=...)``
    (``medaka_tpu.prediction._featurize_region_task``): its samples and
    the quarantined short sub-regions with their unchunked samples. It
    lives here, and not in ``prediction``, so that the spawned worker
    imports no torch: it builds features only (numpy and the native
    library, which the parent has built) and never touches the GPU."""
    gen = SampleGenerator(bam, region, encoder, chunk_len=chunk_len,
                          chunk_overlap=chunk_overlap)
    samples = list(gen.samples)
    quarantined = []
    for qregion, _size in gen._quarantined:
        sub = SampleGenerator(bam, qregion, encoder, enable_chunking=False)
        quarantined.append((qregion, list(sub.samples)))
    return samples, quarantined


def _samples_worker(bam, region, feature_encoder, label_scheme, truth_bam,
                    truth_haplotag, chunk_len, chunk_ovlp):
    gen = SampleGenerator(
        bam, region, feature_encoder, truth_bam=truth_bam,
        label_scheme=label_scheme, truth_haplotag=truth_haplotag,
        chunk_len=chunk_len, chunk_overlap=chunk_ovlp)
    return list(gen.samples), region


def create_samples(
        bam, output, truth_bam=None, regions=None,
        feature_encoder_name="CountsFeatureEncoder",
        feature_encoder_args=None, label_scheme_name="HaploidLabelScheme",
        label_scheme_args=None, truth_haplotag=None, chunk_len=1000,
        chunk_ovlp=0, threads=1, min_region_size=0):
    """Create a feature HDF5 (labelled when ``truth_bam`` is given).

    Counterpart of ``create_samples`` in ``medaka_tpu/features.py``,
    including the num_qstrat/max_run agreement rule between run-length
    encoders and schemes, and the registry lookups by name (which refuse
    classes not ported yet).

    :returns: number of samples written.
    """
    from medaka_tpu_torch import datastore as datastore_mod
    from medaka_tpu_torch import labels as labels_mod

    logger = common.get_named_logger("Prepare")
    if chunk_ovlp >= chunk_len:
        raise ValueError(
            "chunk_ovlp {} is not smaller than chunk_len {}".format(
                chunk_ovlp, chunk_len))
    regions = common.get_bam_regions(bam, regions)
    regions = [r for r in regions if r.size >= min_region_size]
    if truth_bam is None:
        logger.warning(
            "Running feature creation without a truth bam; unlabelled "
            "data will be produced.")

    feature_encoder_args = dict(feature_encoder_args or {})
    label_scheme_args = dict(label_scheme_args or {})
    # keep RLE stratification consistent between encoder and scheme
    num_qstrat = feature_encoder_args.get("num_qstrat")
    max_run = label_scheme_args.get("max_run")
    if max_run is None and num_qstrat is not None:
        label_scheme_args["max_run"] = num_qstrat
    elif max_run is not None and num_qstrat is None:
        feature_encoder_args["num_qstrat"] = max_run
    elif max_run is not None and max_run != num_qstrat:
        raise ValueError(
            "num_qstrat in feature_encoder_args must agree with max_run "
            "in label_scheme_args")

    feature_encoder = from_dict({"type": feature_encoder_name,
                                 "kwargs": feature_encoder_args})
    label_scheme = labels_mod.from_dict({"type": label_scheme_name,
                                         "kwargs": label_scheme_args})

    n_written = 0
    with datastore_mod.DataStore(output, "w") as ds:
        ds.set_meta(feature_encoder, "feature_encoder")
        ds.set_meta(label_scheme, "label_scheme")
        work = list(itertools.chain.from_iterable(
            r.split(int(1e6)) for r in regions))
        with concurrent.futures.ThreadPoolExecutor(threads) as executor:
            futures = [
                executor.submit(
                    _samples_worker, bam, reg, feature_encoder,
                    label_scheme if truth_bam else None, truth_bam,
                    truth_haplotag, chunk_len, chunk_ovlp)
                for reg in work]
            failures = []
            for fut in concurrent.futures.as_completed(futures):
                if fut.exception() is not None:
                    logger.error("Worker failed: %s", fut.exception())
                    failures.append(fut.exception())
                    continue
                samples, region = fut.result()
                logger.info(
                    "Writing %d samples for region %s.",
                    len(samples), region)
                for sample in samples:
                    ds.write_sample(sample)
                    n_written += 1
        ds.write_registry()
        empty = ds.n_samples == 0
    if failures:
        # successful regions were written for inspection, but a silently
        # gapped feature file must not look like success
        raise RuntimeError(
            "{} of {} feature regions failed; first error: "
            "{}".format(len(failures), len(work), failures[0]))
    if empty:
        logger.critical("No data written; deleting output.")
        os.remove(output)
    return n_written


# ---------------------------------------------------------------------------
# Region-trimmed reads (reference ``src/medaka_trimbam.c``)
# ---------------------------------------------------------------------------


class TrimmedRead(tuple):
    """(is_rev, name, seq, haplotype, phased_set) of a trimmed read."""

    def __new__(cls, is_rev, name, seq, hap, phased_set):
        return tuple.__new__(cls, (is_rev, name, seq, hap, phased_set))

    is_rev = property(lambda self: self[0])
    name = property(lambda self: self[1])
    seq = property(lambda self: self[2])
    hap = property(lambda self: self[3])
    phased_set = property(lambda self: self[4])


def _trim_one_read(rec: BamRecord, start: int, end: int, partial: bool):
    """Query span [qstart, qend) of a read clipped to [start, end).

    Mirrors ``trim_read`` (``medaka_trimbam.c:101-246``): soft clips
    consume query coordinates, the first aligned base at or past the
    boundary anchors the trim.
    """
    qstart = qend = -1
    spans_start = rec.pos <= start
    if not spans_start:
        if not partial:
            return None
        qstart = 0
    read_pos = 0
    ref_pos = rec.pos
    last_op = last_len = None
    for op, ln in rec.cigar_array:
        read_inc = ref_inc = 0
        aligned = False
        if op in (C_M, C_EQ, C_X):
            aligned = True
            read_inc = ref_inc = 1
        elif op == C_D:
            ref_inc = 1
        elif op == C_N:
            return None  # unhandled, as in the reference
        elif op in (C_I, C_S):
            read_inc = 1
        last_op, last_len = op, ln
        if aligned:
            # first aligned base at the boundary anchors the trim; when
            # the boundary was skipped (deletion), take the previous
            # query position (reference ``medaka_trimbam.c:202-224``)
            if qstart == -1:
                if ref_pos > start:
                    qstart = read_pos - 1
                elif ref_pos + ln > start:
                    qstart = read_pos + (start - ref_pos)
            if qend == -1:
                if ref_pos > end:
                    qend = read_pos - 1
                elif ref_pos + ln > end:
                    qend = read_pos + (end - ref_pos)
        read_pos += int(read_inc * ln)
        ref_pos += int(ref_inc * ln)
    if qend == -1:
        if not partial:
            return None
        qend = read_pos
        if last_op == C_S:
            qend -= int(last_len)
    if qstart == -1:
        return None
    return qstart, qend


def get_trimmed_reads(
        region: Region, bam, dtype_prefixes=None, region_split=750,
        chunk_overlap=150, workers=8, tag_name=None, tag_value=None,
        keep_missing=False, partial=True, num_qstrat=1, read_group=None,
        min_mapq=1, include_empty_reads=False):
    """Fetch reads trimmed to (chunks of) a region.

    Reference: ``medaka/features.py:561-644`` +
    ``src/medaka_trimbam.c``. The region is split into pieces of
    ``region_split`` overlapping by ``chunk_overlap``, fetched by
    ``workers`` threads. Yields (sub_region, seqs) where ``seqs`` is a
    list of :class:`TrimmedRead`; element 0 is the reference placeholder
    entry (the reference sequence calculation is disabled in the
    reference C too, ``medaka_trimbam.c:123-127``). Reads pass
    :func:`filter_read` (``min_mapq``, the tag filter, ``read_group``);
    reads trimmed to nothing are dropped unless ``include_empty_reads``
    (a read that spans a deleted region arrives empty).
    """
    del dtype_prefixes, num_qstrat  # accepted for interface parity

    def _process_region(reg):
        reader = bam if isinstance(bam, BamReader) else BamReader(bam)
        try:
            seqs = [TrimmedRead(False, reg.ref_name, "N", 0, 0)]
            for rec in reader.fetch(reg.ref_name, reg.start, reg.end):
                if not filter_read(
                        rec, min_mapq, tag_name, tag_value, keep_missing,
                        read_group):
                    continue
                span = _trim_one_read(rec, reg.start, reg.end, partial)
                if span is None:
                    continue
                qstart, qend = span
                seq = rec.query_sequence[qstart:qend]
                if not seq and not include_empty_reads:
                    continue
                seqs.append(TrimmedRead(
                    rec.is_reverse, rec.query_name, seq,
                    int(rec.tags.get("HP", 0)),
                    int(rec.tags.get("PS", 0))))
            return reg, seqs
        finally:
            if reader is not bam:
                reader.close()

    regions = region.split(region_split, chunk_overlap)
    if len(regions) > 1:
        ex = concurrent.futures.ThreadPoolExecutor(max_workers=workers)
        with ex as executor:
            yield from executor.map(_process_region, regions)
    else:
        yield _process_region(region)
