"""Label schemes: encode truth alignments, decode network outputs.

Counterpart of ``medaka_tpu/labels.py``, trimmed to what consensus
decoding and haploid training data use: ``TruthAlignment`` (load, filter
and group truth-to-draft alignments), the encode half of
``BaseLabelScheme``, ``HaploidLabelScheme`` with its truth encoding,
``decode_consensus`` and ``_phred``, and ``from_dict``. The diploid and
RLE schemes and the VCF decoders are not ported yet; ``from_dict``
refuses those schemes by name.
"""
from __future__ import annotations

import abc
import collections
import functools
import itertools
from copy import copy

import numpy as np

from medaka_tpu_torch import common
from medaka_tpu_torch.io.bam import BamReader
from medaka_tpu_torch.utils.intervals import IntervalSet

label_schemes = {}


def from_dict(d):
    """Instantiate a label scheme from a config dict."""
    cls = label_schemes.get(d["type"])
    if cls is None:
        raise NotImplementedError(
            "Label scheme {} is not ported to medaka_tpu_torch yet "
            "(ported: {}).".format(d["type"], ", ".join(label_schemes)))
    return cls(**d.get("kwargs", {}))


class TruthAlignment:
    """A truth-to-reference alignment segment used to derive labels."""

    def __init__(self, alignment):
        """Wrap a `BamRecord`; start/end may be trimmed by filtering."""
        self.aln = alignment
        self.start = alignment.reference_start
        self.end = alignment.reference_end
        self.is_kept = True

    @staticmethod
    def _filter_alignments(
            alignments, region, min_length=1000, length_ratio=2.0,
            overlap_fraction=0.5):
        """Resolve overlapping truth segments and drop unusable ones.

        For each overlapping pair, segments of comparable length split
        the disputed window (or are both dropped when one is mostly
        engulfed), while a much longer segment wins the window outright
        (the engulfed shorter one is dropped).
        """
        ACGT = frozenset("ACGT")

        def clean(al):
            return (
                ACGT.issuperset(al.aln.get_reference_sequence().upper())
                and ACGT.issuperset(al.aln.query_sequence.upper()))

        kept = [
            copy(a) for a in alignments
            # zero-reference-length records have no window to dispute
            if a.aln.reference_length > 0 and clean(a)]

        for a, b in itertools.combinations(kept, 2):
            left, right = sorted(
                (a, b), key=lambda t: t.aln.reference_start)
            disputed = (left.aln.reference_end
                        - right.aln.reference_start)
            if disputed <= 0:
                continue
            small, big = sorted(
                (a, b), key=lambda t: t.aln.reference_length)
            engulfed = (disputed / small.aln.reference_length
                        >= overlap_fraction)
            comparable = (big.aln.reference_length
                          < length_ratio * small.aln.reference_length)
            if engulfed:
                small.is_kept = False
                if comparable:
                    big.is_kept = False
            else:
                right.start = left.aln.reference_end
                if comparable:
                    left.end = right.aln.reference_start

        for al in kept:
            al.start = max(al.start, region.start)
            if region.end is not None:
                al.end = min(al.end, region.end)
        return sorted(
            (al for al in kept
             if al.is_kept and al.end - al.start >= min_length),
            key=lambda t: t.start)

    @staticmethod
    def _load_alignments(truth_bam, region, haplotag=None):
        by_hap = collections.defaultdict(list)
        with BamReader(truth_bam) as bam:
            for rec in bam.fetch(region.ref_name, region.start, region.end):
                if rec.is_unmapped or rec.is_secondary:
                    continue
                hap = rec.get_tag(haplotag) if haplotag is not None else None
                by_hap[hap].append(TruthAlignment(rec))
        for segments in by_hap.values():
            segments.sort(key=lambda t: t.start)
        return by_hap

    @staticmethod
    def _group_and_trim_by_haplotype(alignments):
        """Group per-haplotype segments to their common window.

        Each anchor-haplotype segment collects, per other haplotype, the
        overlapping segment that covers most of the running window; every
        member is then trimmed to the window intersection.
        """
        logger = common.get_named_logger("Group_and_trim")
        haps = sorted(alignments, key=lambda h: (h is None, h))
        anchor, others = haps[0], haps[1:]
        if not others:
            return [(a,) for a in alignments[anchor]]
        index = {
            h: IntervalSet((a.start, a.end, a) for a in alignments[h])
            for h in others}
        groups = []
        for a in alignments[anchor]:
            lo, hi = a.start, a.end
            members = [a]
            for h in others:
                hits = index[h].overlap(lo, hi)
                if not hits:
                    logger.info(
                        "No haplotype-%s truth segment overlaps "
                        "%s:%d-%d; skipping the group.",
                        h, a.aln.ref_id, a.start, a.end)
                    break
                best = max(
                    hits,
                    key=lambda iv: min(hi, iv[1]) - max(lo, iv[0]))[2]
                lo = max(lo, best.start)
                hi = min(hi, best.end)
                members.append(best)
            else:
                for m in members:
                    m.start, m.end = lo, hi
                groups.append(tuple(members))
        return groups

    @staticmethod
    def bam_to_alignments(truth_bam, region, haplotag=None, min_length=1000):
        """Load, filter and group truth alignments for a region."""
        loaded = TruthAlignment._load_alignments(truth_bam, region, haplotag)
        if not loaded:
            return []
        filtered = {
            hap: TruthAlignment._filter_alignments(
                segments, region=region, min_length=min_length)
            for hap, segments in loaded.items()}
        return TruthAlignment._group_and_trim_by_haplotype(filtered)


class _SchemeMeta(abc.ABCMeta):
    def __new__(mcls, name, bases, attrs):
        cls = super().__new__(mcls, name, bases, attrs)
        if name != "BaseLabelScheme":
            label_schemes[name] = cls
        return cls


class BaseLabelScheme(metaclass=_SchemeMeta):
    """Logic for truth encoding and network-output decoding."""

    symbols = "*ACGT"

    @property
    @abc.abstractmethod
    def n_elements(self):
        """Number of truth elements per position (~ploidy)."""

    @property
    @abc.abstractmethod
    def num_classes(self):
        """Size of the network output layer."""

    @property
    @abc.abstractmethod
    def padding_vector(self):
        """Encoded label marking a gap/insertion padding column."""

    @property
    @abc.abstractmethod
    def _encoding(self):
        """dict: label tuple -> integer."""

    def to_dict(self):
        """Serialise the scheme."""
        return dict(type=type(self).__name__)

    @staticmethod
    def _phred(err, cap=70.0):
        """Error probability to phred score, capped."""
        floor = 10.0 ** (cap / -10.0)
        return np.minimum(cap, -10 * np.log10(np.clip(err, floor, 1)))

    # --- encoding ---

    @abc.abstractmethod
    def _alignment_to_pairs(self, aln):
        """Yield (ref_pos, label) pairs from an alignment record."""

    def _alignments_to_labels(self, truth_alns):
        """Expand truth alignments to ((major, minor) positions, labels)."""
        if len(truth_alns) != self.n_elements:
            raise ValueError(
                "{} alignments were passed to {}, requires {}".format(
                    len(truth_alns), type(self), self.n_elements))
        spans = {(a.start, a.end) for a in truth_alns}
        if len(spans) != 1:
            raise ValueError(
                "Alignments must have identical genomic start and end.")
        lo, hi = spans.pop()

        def keyed_symbols(aln):
            # ((major, minor), symbol) stream clipped to [lo, hi); minor
            # counts insertions after their anchoring major
            major, minor = None, 0
            for rpos, symbol in self._alignment_to_pairs(aln):
                if rpos is None:
                    if major is None:  # insertion before the window
                        continue
                    minor += 1
                elif rpos < lo:
                    continue
                elif rpos >= hi:
                    return
                else:
                    major, minor = rpos, 0
                yield (major, minor), symbol

        per_hap = [dict(keyed_symbols(a.aln)) for a in truth_alns]
        keys = sorted(set().union(*per_hap))
        labels = [tuple(h.get(k, "*") for h in per_hap) for k in keys]
        positions = np.array(keys, dtype=common.POSITIONS_DTYPE)
        return positions, labels

    @abc.abstractmethod
    def _labels_to_encoded_labels(self, labels):
        """Map label tuples to integer encodings."""

    @abc.abstractmethod
    def encoded_labels_to_training_vectors(self, enc_labels):
        """Map integer encodings to training target vectors."""

    def encode(self, truth_alns):
        """Truth alignments -> (positions, encoded labels)."""
        positions, labels = self._alignments_to_labels(truth_alns)
        return positions, self._labels_to_encoded_labels(labels)

    @property
    @functools.lru_cache(1)
    def _decoding(self):
        """dict: integer -> label tuple."""
        return {idx: label for label, idx in self._encoding.items()}

    @property
    def _unitary_encoding(self):
        return {(s,): i for i, s in enumerate(self.symbols)}


class HaploidLabelScheme(BaseLabelScheme):
    """Single truth element per position; 5-class softmax output."""

    @property
    def n_elements(self):
        """Ploidy (1)."""
        return 1

    @property
    def num_classes(self):
        """Output classes (5)."""
        return len(self._decoding)

    @property
    def padding_vector(self):
        """Gap encoding."""
        return self._labels_to_encoded_labels([("*",)])[0]

    @property
    @functools.lru_cache(1)
    def _encoding(self):
        return self._unitary_encoding

    def _alignment_to_pairs(self, aln):
        bases = aln.query_sequence.upper()
        return (
            (rpos, "*" if qpos is None else bases[qpos])
            for qpos, rpos in aln.get_aligned_pairs())

    def _labels_to_encoded_labels(self, labels):
        return np.fromiter(map(self._encoding.__getitem__, labels),
                           dtype=int)

    def encoded_labels_to_training_vectors(self, enc_labels):
        """Integer encodings -> sparse one-hot targets."""
        if len(enc_labels.dtype) == 2:
            # legacy (base, runlength) encoding
            enc_labels = np.array(
                [max(0, x[0] - 4) for x in enc_labels], dtype="int64")
        return np.expand_dims(enc_labels, axis=1)

    def decode_consensus(self, sample, with_gaps=False, dtype=None,
                         with_qualities=False):
        """Argmax decoding of network output into sequence (+ quals)."""
        classes = sample.label_probs.argmax(-1)
        keep = (slice(None) if with_gaps
                else classes != self.symbols.index("*"))
        alphabet = np.frombuffer(
            "".join(self.symbols).encode(), dtype=np.uint8)
        chars = alphabet[classes[keep]]
        seq = (chars.tobytes().decode() if dtype is None
               else chars.view("S1").astype(dtype))
        if not with_qualities:
            return seq
        best_p = np.take_along_axis(
            sample.label_probs, classes[:, None], -1)[keep, 0]
        qstring = (
            self._phred(1 - best_p).astype("u1") + 33).tobytes().decode()
        return seq, qstring
