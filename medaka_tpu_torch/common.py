"""Core data structures: genomic regions, pileup samples and their algebra.

Counterpart of ``medaka_tpu/common.py``, trimmed to what the counts and
read-level consensus paths use, plus :func:`resolve_device` for the
port's entry points. A ``Sample`` carries 2-D (positions, features)
counts or 3-D (positions, reads, channels) int8 read-level features;
slicing, chunking and depth filtering act on the first axis of either.
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
import logging
import re
from typing import List, Optional

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the CPU is asked for.

    Raises when CUDA is asked for (the default) and no GPU is present;
    nothing falls back to the CPU quietly.
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but no GPU is available; pass "
            "device='cpu' (--cpu on the command line) to run on the CPU.")
    return device


# ---------------------------------------------------------------------------
# Base-space constants.
#
# Pileup count features use ten channels: reverse-strand a,c,g,t then
# forward-strand A,C,G,T then reverse deletion 'd' and forward deletion 'D'.
# (reference: src/medaka_counts.h:19-22)
# ---------------------------------------------------------------------------
PLP_BASES = "acgtACGTdD"
FEATLEN = len(PLP_BASES)  # 10
REV_DEL = PLP_BASES.index("d")  # 8
FWD_DEL = PLP_BASES.index("D")  # 9
base2index = {b: i for i, b in enumerate(PLP_BASES)}

# nt16 (4-bit BAM base code) -> count channel, forward strand rows 0-15,
# reverse strand rows 16-31 (reference: src/medaka_counts.h:25-30).
NT16_TO_CHANNEL = np.full(32, -1, dtype=np.int8)
for _code, _fwd in ((1, 4), (2, 5), (4, 6), (8, 7)):  # A,C,G,T forward
    NT16_TO_CHANNEL[_code] = _fwd
    NT16_TO_CHANNEL[16 + _code] = _fwd - 4  # reverse strand lowercase

POSITIONS_DTYPE = np.dtype([("major", np.int64), ("minor", np.int64)])


def make_positions(major, minor) -> np.ndarray:
    """Build a structured (major, minor) position array."""
    out = np.empty(len(major), dtype=POSITIONS_DTYPE)
    out["major"] = major
    out["minor"] = minor
    return out


def get_named_logger(name: str) -> logging.Logger:
    """Return a package logger with a short display name."""
    logger = logging.getLogger("medaka_tpu_torch.{}".format(name))
    logger.name = name
    return logger


# ---------------------------------------------------------------------------
# Small utilities
# ---------------------------------------------------------------------------


def rle(array) -> np.ndarray:
    """Run-length encode a 1-D array.

    :returns: structured array with fields ``length``, ``start``, ``value``.
    """
    if not isinstance(array, np.ndarray):
        array = np.fromiter(array, dtype="U1", count=len(array))
    if array.ndim != 1:
        raise TypeError("Input array must be one dimensional.")
    n = len(array)
    if n == 0:
        return np.empty(
            0, dtype=[("length", int), ("start", int),
                      ("value", array.dtype)])
    starts = np.concatenate(
        ([0], np.flatnonzero(array[1:] != array[:-1]) + 1)).astype(int)
    out = np.empty(
        len(starts),
        dtype=[("length", int), ("start", int), ("value", array.dtype)])
    out["start"] = starts
    out["length"] = np.diff(np.concatenate((starts, [n])))
    out["value"] = array[starts]
    return out


# ---------------------------------------------------------------------------
# Region
# ---------------------------------------------------------------------------


class Region(tuple):
    """A (possibly half-open) genomic interval. 0-based, end-exclusive."""

    __slots__ = ()

    def __new__(cls, ref_name: str, start: Optional[int], end: Optional[int]):
        return tuple.__new__(cls, (ref_name, start, end))

    def __getnewargs__(self):
        """Pickle support (tuple subclass with a custom __new__)."""
        return tuple(self)

    @property
    def ref_name(self):  # noqa: D102
        return self[0]

    @property
    def start(self):  # noqa: D102
        return self[1]

    @property
    def end(self):  # noqa: D102
        return self[2]

    @property
    def size(self) -> int:
        """Span of the region."""
        return self.end - self.start

    @property
    def name(self) -> str:
        """Samtools-style 0-based end-exclusive string."""
        return str(self)

    def __str__(self):
        start = 0 if self.start is None else self.start
        end = "" if self.end is None else self.end
        return "{}:{}-{}".format(self.ref_name, start, end)

    def __repr__(self):
        return "Region(ref_name={!r}, start={!r}, end={!r})".format(
            self.ref_name, self.start, self.end)

    @classmethod
    def from_string(cls, region: str) -> "Region":
        """Parse a region string.

        >>> Region.from_string('Ecoli') == Region('Ecoli', None, None)
        True
        >>> Region.from_string('Ecoli:1000-2000') == Region('Ecoli', 1000, 2000)
        True
        >>> Region.from_string('Ecoli:-1000') == Region('Ecoli', 0, 1000)
        True
        >>> Region.from_string('Ecoli:500-') == Region('Ecoli', 500, None)
        True
        >>> Region.from_string('A:B:c:500-') == Region('A:B:c', 500, None)
        True
        """
        if ":" not in region:
            return cls(region, None, None)
        ref_name, bounds = region.rsplit(":", 1)
        if bounds.startswith("-"):
            return cls(ref_name, 0, int(bounds[1:]))
        if "-" not in bounds:
            return cls(ref_name, int(bounds), None)
        if bounds.endswith("-"):
            return cls(ref_name, int(bounds[:-1]), None)
        s, e = bounds.split("-")
        return cls(ref_name, int(s), int(e))

    def split(self, size: int, overlap: int = 0, fixed_size: bool = True):
        """Split into sub-regions of at most ``size`` columns.

        With ``fixed_size`` the final chunk is re-anchored to the region end
        so that all chunks have exactly ``size`` span (reference
        ``common.py:712-737``).
        """
        if size >= self.size:
            return [self]
        regions = [
            Region(self.ref_name, start, min(start + size, self.end))
            for start in range(self.start, self.end, size - overlap)]
        if len(regions) > 1 and fixed_size and regions[-1].size < size:
            del regions[-1]
            start = self.end - size
            if start > regions[-1].start:
                regions.append(Region(self.ref_name, start, self.end))
        return regions

    def overlaps(self, other: "Region") -> bool:
        """Test interval overlap on the same contig."""
        if self.ref_name != other.ref_name:
            return False

        def limits(r):
            return (
                -1 if r.start is None else r.start,
                float("inf") if r.end is None else r.end)

        a0, a1 = limits(self)
        b0, b1 = limits(other)
        return a0 < b1 and a1 > b0


# ---------------------------------------------------------------------------
# Sample
# ---------------------------------------------------------------------------


class OverlapException(Exception):
    """Raised when two samples cannot be reconciled by overlap trimming."""


class Relationship(enum.Enum):
    """Relative genomic arrangement of two samples."""

    different_ref_name = "Samples come from different reference contigs."
    forward_overlap = "The end of s1 overlaps the start of s2."
    reverse_overlap = "The end of s2 overlaps the start of s1."
    forward_abutted = "The end of s1 abuts the start of s2."
    reverse_abutted = "The end of s2 abuts the start of s1."
    forward_gapped = "s2 follows s1 with a gap inbetween."
    reverse_gapped = "s1 follows s2 with a gap inbetween."
    s2_within_s1 = "s2 is fully contained within s1."
    s1_within_s2 = "s1 is fully contained within s2."


_SAMPLE_FIELDS = (
    "ref_name", "features", "labels", "ref_seq", "positions", "label_probs",
    "depth")


@dataclasses.dataclass(frozen=True)
class Sample:
    """A pileup slice: features/labels/probabilities over pileup columns.

    ``positions`` is a structured array of (major, minor) coordinates: major
    is a reference position, minor>0 marks inserted columns following it.
    Mirrors the reference ``Sample`` namedtuple (``common.py:59-65``).
    """

    ref_name: str
    features: Optional[np.ndarray]
    labels: Optional[np.ndarray]
    ref_seq: Optional[str]
    positions: np.ndarray
    label_probs: Optional[np.ndarray]
    depth: Optional[np.ndarray] = None

    _fields = _SAMPLE_FIELDS

    # -- basic introspection -------------------------------------------------

    def amend(self, **kwargs) -> "Sample":
        """Return a copy with selected fields replaced."""
        bad = set(kwargs) - set(_SAMPLE_FIELDS)
        if bad:
            raise KeyError("Invalid key(s) for Sample: {}".format(bad))
        return dataclasses.replace(self, **kwargs)

    @property
    def first_pos(self):
        """(major, minor) of the first column."""
        p = self.positions[0]
        return int(p["major"]), int(p["minor"])

    @property
    def last_pos(self):
        """(major, minor) of the last column."""
        p = self.positions[-1]
        return int(p["major"]), int(p["minor"])

    @property
    def span(self) -> int:
        """Reference span covered by the sample."""
        return self.last_pos[0] - self.first_pos[0]

    @property
    def size(self) -> int:
        """Number of pileup columns."""
        return len(self.positions)

    @property
    def is_empty(self) -> bool:
        """True when the pileup has no columns."""
        return self.size == 0

    @property
    def name(self) -> str:
        """Zero-based end-inclusive region string with minor coordinates."""
        fmaj, fmin = self.first_pos
        lmaj, lmin = self.last_pos
        return "{}:{}.{}-{}.{}".format(self.ref_name, fmaj, fmin, lmaj, lmin)

    @staticmethod
    def decode_sample_name(name: str):
        """Invert :attr:`name` into a dict of ref_name/start/end strings."""
        m = re.match(
            r"(?P<ref_name>.+):(?P<start>\d+\.\d+)-(?P<end>\d+\.\d+)", name)
        return m.groupdict() if m else None

    def __eq__(self, other):
        if not isinstance(other, Sample):
            return NotImplemented
        for field in _SAMPLE_FIELDS:
            s, o = getattr(self, field), getattr(other, field)
            if type(s) is not type(o):
                return False
            if isinstance(s, np.ndarray):
                if s.shape != o.shape or np.any(s != o):
                    return False
            elif s != o:
                return False
        return True

    # -- slicing / concatenation ---------------------------------------------

    def slice(self, key) -> "Sample":
        """Slice all array fields along the column axis."""
        def cut(attr):
            val = getattr(self, attr)
            if attr == "ref_name" or val is None:
                return val
            return val[key]
        return Sample(**{f: cut(f) for f in _SAMPLE_FIELDS})

    def chunks(self, chunk_len: int = 1000, overlap: int = 200):
        """Yield overlapping fixed-length column windows of the sample."""
        step = chunk_len - overlap
        n = self.size
        starts = list(range(0, n - chunk_len + 1, step))
        last_end = starts[-1] + chunk_len if starts else 0
        if n > last_end:
            starts.append(n - chunk_len)
        for start in starts:
            yield self.slice(slice(start, start + chunk_len))

    # -- derived representations ----------------------------------------------

    @property
    def counts_matrix(self) -> np.ndarray:
        """2-D counts features; for 3-D read-level features, the normalised
        per-column histogram of base codes over reads, split by strand
        (``medaka_tpu/common.py:441-478``)."""
        if self.features.ndim == 2:
            return self.features
        x = self.features
        out = np.zeros((x.shape[0], FEATLEN), dtype=np.float32)
        minor_inds = np.where(self.positions["minor"] > 0)
        major_at_minor = self.positions["major"][minor_inds]
        major_ind = np.searchsorted(
            self.positions["major"], major_at_minor, side="left")
        depth = np.sum(x[:, :, 0] != 0, axis=1)
        depth[minor_inds] = depth[major_ind]
        depth = np.maximum(depth, 1)
        fwd = x[:, :, 2] == 1
        rev = ~fwd
        # forward counts land in the LOWERCASE channels, the opposite of
        # the pileup encoder's convention: the reference's counts_matrix
        # does the same (its common.py:163-168), and the consumers either
        # sum the strands (majority_vote_probs) or were trained on it
        # read-level base codes: 0 pad, 1..4 acgt, 5 deletion
        for code, base in enumerate("pacgtd"):
            if base == "p":
                continue
            n_f = np.sum(fwd * (x[:, :, 0] == code), axis=1)
            n_r = np.sum(rev * (x[:, :, 0] == code), axis=1)
            out[:, base2index[base]] = n_f / depth
            out[:, base2index[base.upper()]] = n_r / depth
        return out

    @property
    def majority_vote_probs(self) -> np.ndarray:
        """Per-column (del, A, C, G, T) vote fractions from the pileup."""
        pileup = self.counts_matrix
        b2i = base2index
        bases = pileup[:, b2i["a"]:b2i["t"] + 1] + \
            pileup[:, b2i["A"]:b2i["T"] + 1]
        dels = pileup[:, b2i["d"]:b2i["d"] + 1] + \
            pileup[:, b2i["D"]:b2i["D"] + 1]
        out = np.concatenate([dels, bases], axis=-1)
        out[:, 0] += 1 - out.sum(axis=-1)
        return out

    # -- filtering -------------------------------------------------------------

    def depth_filter(self, min_depth: int = 5):
        """Yield contiguous sub-samples whose depth >= ``min_depth``."""
        runs = rle(self.depth >= min_depth)
        for run in runs[runs["value"]]:
            yield self.slice(slice(run["start"], run["start"] + run["length"]))

    # -- relative arrangement ----------------------------------------------------

    @staticmethod
    def relative_position(s1: "Sample", s2: "Sample") -> Relationship:
        """Classify how two samples relate along the genome.

        Mirrors reference ``common.py:232-324`` over (major, minor) space.
        """
        if s1.ref_name != s2.ref_name:
            return Relationship.different_ref_name

        a, b = sorted((s1, s2), key=lambda s: (s.first_pos, -s.size))
        ordered = a.name == s1.name
        a_end, b_start = a.last_pos, b.first_pos

        def fwd(result, reverse):
            return result if ordered else reverse

        # containment
        if b.first_pos >= a.first_pos and b.last_pos <= a.last_pos:
            return fwd(Relationship.s2_within_s1, Relationship.s1_within_s2)
        # abutting: next major at minor 0, or next minor at same major
        if ((b_start[0] == a_end[0] + 1 and b_start[1] == 0) or
                (b_start[0] == a_end[0] and b_start[1] == a_end[1] + 1)):
            return fwd(
                Relationship.forward_abutted, Relationship.reverse_abutted)
        # overlapping
        if (b_start[0] < a_end[0] or
                (b_start[0] == a_end[0] and b_start[1] < a_end[1] + 1)):
            return fwd(
                Relationship.forward_overlap, Relationship.reverse_overlap)
        # gapped
        if (b_start[0] > a_end[0] + 1 or
                (b_start[0] > a_end[0] and b_start[1] > 0) or
                (b_start[0] == a_end[0] and b_start[1] > a_end[1] + 1)):
            return fwd(
                Relationship.forward_gapped, Relationship.reverse_gapped)
        raise RuntimeError(
            "Could not calculate relative position of {} and {}".format(
                s1.name, s2.name))

    @staticmethod
    def overlap_indices(s1: "Sample", s2: "Sample"):
        """Find trim indices (end1, start2) to join overlapping samples.

        Splits the overlap at its midpoint when both samples agree on the
        minor-position structure; otherwise searches outward from the middle
        for a major position carried with identical insert counts by both
        samples (reference ``common.py:326-427``).

        :returns: (end1, start2, used_heuristic)
        """
        rel = Sample.relative_position(s1, s2)
        if rel is Relationship.forward_abutted:
            return None, None, False
        if rel is not Relationship.forward_overlap:
            raise OverlapException(
                "Cannot overlap samples {} and {} with relationship {}".format(
                    s1.name, s2.name, repr(rel)))

        ovl_start_ind1 = int(np.searchsorted(s1.positions, s2.positions[0]))
        ovl_end_ind2 = int(np.searchsorted(
            s2.positions, s1.positions[-1], side="right"))
        pos1_ovl = s1.positions[ovl_start_ind1:]
        pos2_ovl = s2.positions[:ovl_end_ind2]

        if np.array_equal(pos1_ovl["minor"], pos2_ovl["minor"]):
            # identical minor structure: split the overlap at its
            # midpoint (s1 keeps the left half)
            overlap_len = len(pos1_ovl)
            pad_1 = overlap_len // 2
            return (ovl_start_ind1 + pad_1,
                    ovl_end_ind2 - (overlap_len - pad_1), False)

        # Heuristic: find a major position near the overlap midpoint that
        # appears with the same column multiplicity in both samples.
        UNIQ_MAJ = 3
        if (len(np.unique(pos1_ovl["major"])) > UNIQ_MAJ and
                len(np.unique(pos2_ovl["major"])) > UNIQ_MAJ):
            start, end = int(pos1_ovl["major"][0]), int(pos1_ovl["major"][-1])
            mid = start + (end - start) // 2
            offset = 1
            while True:
                if (mid + offset > s1.positions["major"].max() and
                        mid - offset < s2.positions["major"].min()):
                    break
                for test in (offset, -offset):
                    left = np.flatnonzero(s1.positions["major"] == mid + test)
                    right = np.flatnonzero(s2.positions["major"] == mid + test)
                    if len(left) and len(left) == len(right):
                        return int(left[0]), int(right[0]), True
                offset += 1
        raise OverlapException(
            "Could not find viable junction for {} and {}".format(
                s1.name, s2.name))

    # -- streaming transforms --------------------------------------------------

    @staticmethod
    def trim_samples(sample_gen, logger_name="TrimOlap", quiet=False):
        """Trim a sorted sample stream so consecutive samples abut.

        :yields: (trimmed Sample, is_last_in_contig, used_heuristic)
        """
        logger = get_named_logger(logger_name)
        log = logger.debug if quiet else logger.info

        sample_gen = iter(sample_gen)
        try:
            s1 = next(sample_gen)
        except StopIteration:
            return
        start_1 = None
        start_2 = None
        for s2 in itertools.chain(sample_gen, (None,)):
            heuristic = False
            is_last_in_contig = False
            if s2 is None:
                end_1 = None
                is_last_in_contig = True
            else:
                rel = Sample.relative_position(s1, s2)
                if rel is Relationship.s2_within_s1:
                    log("{} is contained within {}, skipping.".format(
                        s2.name, s1.name))
                    continue
                elif rel is Relationship.forward_gapped:
                    is_last_in_contig = True
                    end_1, start_2 = None, None
                    log("{} and {} cannot be concatenated as there is no "
                        "overlap and they do not abut.".format(
                            s1.name, s2.name))
                else:
                    end_1, start_2, heuristic = Sample.overlap_indices(s1, s2)
                    if heuristic:
                        logger.debug(
                            "Used heuristic to stitch {} and {}.".format(
                                s1.name, s2.name))
            yield s1.slice(slice(start_1, end_1)), is_last_in_contig, heuristic
            s1 = s2
            start_1 = start_2

    @staticmethod
    def trim_samples_to_region(samples, start=None, end=None):
        """Overlap-trim a sample stream, then clip it to [start, end)."""

        def trim_starts(stream):
            for sample, last, heuristic in stream:
                if start is not None:
                    if sample.positions["major"][-1] < start:
                        continue
                    if sample.positions["major"][0] < start:
                        query = np.array([(start, 0)], dtype=POSITIONS_DTYPE)
                        cut = np.searchsorted(sample.positions, query[0])
                        sample = sample.slice(slice(cut, None))
                if len(sample.positions):
                    yield sample, last, heuristic

        def trim_ends(stream):
            for sample, last, heuristic in stream:
                if end is not None:
                    if sample.positions["major"][0] >= end:
                        return
                    if sample.positions["major"][-1] >= end:
                        cut = np.searchsorted(sample.positions["major"], end)
                        sample = sample.slice(slice(None, cut))
                if len(sample.positions):
                    yield sample, last, heuristic

        yield from trim_ends(trim_starts(Sample.trim_samples(samples)))

    @staticmethod
    def filter_samples(samples, min_depth: int = 10):
        """Depth-filter a (sample, last, heuristic) stream, then re-trim."""

        def filtered(stream):
            for s, *_ in stream:
                yield from s.depth_filter(min_depth)

        yield from Sample.trim_samples(
            filtered(samples), logger_name="DepthFilt")


def get_bam_regions(bam, regions=None) -> List["Region"]:
    """Regions from a BAM header, bounds-clipped (reference
    ``common.py:762-789``).

    :param bam: BAM path.
    :param regions: optional iterable of `Region` to validate/clip.
    """
    from medaka_tpu_torch.io.bam import BamReader
    with BamReader(bam) as reader:
        ref_lengths = dict(zip(reader.references, reader.lengths))
    if regions is None:
        return [
            Region(name, 0, end) for name, end in ref_lengths.items()]
    out = []
    for r in regions:
        if r.ref_name not in ref_lengths:
            raise KeyError(
                "Contig {} is not one of the bam references.".format(
                    r.ref_name))
        start = max(0, r.start) if r.start is not None else 0
        length = ref_lengths[r.ref_name]
        end = min(r.end, length) if r.end is not None else length
        out.append(Region(r.ref_name, start, end))
    return out


