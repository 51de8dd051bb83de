"""Counts pileup featurisation: BAM alignments -> network input arrays.

Counterpart of ``medaka_tpu/features.py``, trimmed to the counts
encoder: ``pileup_counts`` with its native helpers,
``CountsFeatureEncoder`` and ``SampleGenerator``. The run-length and
read-level encoders are not ported yet; ``from_dict`` refuses them by
name.

A single-datatype region goes from BGZF bytes to counts in the native
library (``native/src/pileup.cpp``). Regions it cannot take (several
datatypes, no .bai, CG long cigars) expand each CIGAR with numpy into
flat event arrays (column, channel) reduced with one ``bincount``.
"""
from __future__ import annotations

import inspect
from collections import defaultdict
from typing import List, Optional

import numpy as np

from medaka_tpu_torch import common
from medaka_tpu_torch.common import (
    FEATLEN, FWD_DEL, NT16_TO_CHANNEL, PLP_BASES, REV_DEL, Region, Sample,
    make_positions)
from medaka_tpu_torch.io.bam import (
    C_D, C_EQ, C_I, C_M, C_X, BamReader, BamRecord)

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


def _split_counts_blocks(counts, majors, minors):
    """Split kernel output into contiguous blocks on major-coord gaps."""
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
    return _split_counts_blocks(counts, majors, minors)


def pileup_counts(
        region: Region, bam, dtype_prefixes=None, tag_name=None,
        tag_value=None, keep_missing=False, num_qstrat=1, read_group=None,
        min_mapq=1):
    """Create pileup count matrices for a region.

    :param region: `Region` to process.
    :param bam: path to a sorted, indexed BAM (or an open `BamReader`).
    :param dtype_prefixes: names of datatypes split by the ``DT`` tag;
        `None` or a singleton means no splitting.
    :param num_qstrat: number of qscore stratification layers.

    :returns: list of (counts, positions) tuples, one per contiguous block
        of covered reference positions. ``counts`` has shape
        (n_cols, featlen * num_dtypes * num_qstrat), int32 from the
        native kernel (int64 from the numpy fallback); ``positions`` is
        a structured (major, minor) array.

    Matches ``calculate_pileup`` (``src/medaka_counts.c:199-372``) composed
    with the chunk-contiguity fixup of ``medaka/features.py:111-164``.
    """
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
        if num_dtypes == 1:
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


# ---------------------------------------------------------------------------
# Sample generation / chunking
# ---------------------------------------------------------------------------


class SampleGenerator:
    """Chunked inference sample production for one region."""

    def __init__(
            self, bam, region, feature_encoder, chunk_len=1000,
            chunk_overlap=200, enable_chunking=True):
        """See reference ``features.py:1208-1254`` for the contract."""
        self.logger = common.get_named_logger("Sampler")
        self.bam = bam
        self.region = region
        self.fencoder = feature_encoder
        self.chunk_len = chunk_len
        self.chunk_overlap = chunk_overlap
        self.enable_chunking = enable_chunking
        self._source = None
        self._quarantined = []

    def _fill_features(self):
        if self._source is None:
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

