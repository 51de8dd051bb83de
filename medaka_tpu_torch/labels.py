"""Label schemes: encode truth alignments, decode network outputs.

Counterpart of ``medaka_tpu/labels.py``: ``TruthAlignment`` (load,
filter and group truth-to-draft alignments), ``BaseLabelScheme`` (truth
encoding, SNP decoding), ``find_variant_columns``,
``HaploidLabelScheme`` (truth encoding, ``decode_consensus``,
``decode_variants``, threshold SNP calling), ``DiploidLabelScheme``
(the 15-class direct diploid scheme, with ``het_rescue``),
``RLELabelScheme`` (haploid labels over (base, run length): truth
encoding and a consensus decode that expands runs; its variant and SNP
decoders raise) and ``from_dict``.
"""
from __future__ import annotations

import abc
import collections
import functools
import itertools
from copy import copy

import numpy as np

from medaka_tpu_torch import common, vcf
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
    verbose = True

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
    def _singleton(it):
        return len(frozenset(it)) == 1

    @staticmethod
    def _phred(err, cap=70.0):
        """Error probability to phred score, capped."""
        floor = 10.0 ** (cap / -10.0)
        return np.minimum(cap, -10 * np.log10(np.clip(err, floor, 1)))

    @staticmethod
    def _pfmt(value, dp=3):
        if isinstance(value, np.ndarray):
            return np.char.mod("%.{}f".format(dp), value)
        return "{:.{dp}f}".format(round(value, dp), dp=dp)

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

    def _unordered_label_combinations(self):
        combos = itertools.combinations_with_replacement(
            self.symbols, self.n_elements)
        return tuple(combos)

    # --- SNP decoding ---

    def decode_snps(self, sample, ref_seq, ref_vcf=None, threshold=0.04):
        """Decode network outputs into SNP `Variant` records."""
        self.ref_seq, self.secondary_threshold = ref_seq, threshold
        self.ref_vcf = vcf.VCFReader(ref_vcf) if ref_vcf else None
        return self._decode_snps(sample)

    def _decode_snps(self, sample):
        majors = sample.positions["major"]
        # candidate loci: reference-anchor columns whose draft base is a
        # proper symbol, vectorised via a codepoint membership table
        anchor = sample.positions["minor"] == 0
        span = np.frombuffer(
            self.ref_seq[majors[0]:majors[-1] + 1].encode(), dtype=np.uint8)
        draft_bases = span[majors - majors[0]]
        proper = np.zeros(256, dtype=bool)
        proper[[ord(s) for s in self.symbols]] = True
        keep = anchor & proper[draft_bases]
        if self.ref_vcf is not None:
            # gVCF-style: restrict to loci present in the guiding VCF
            wanted = {
                v.pos for v in self.ref_vcf.fetch(
                    ref_name=sample.ref_name, start=sample.first_pos[0],
                    end=sample.last_pos[0])}
            keep &= np.isin(majors, np.fromiter(
                wanted, dtype=majors.dtype, count=len(wanted)))
        keep = np.flatnonzero(keep)
        return self._prob_to_snp(
            sample.label_probs[keep], majors[keep], sample.ref_name,
            draft_bases[keep].tobytes().decode(),
            return_all=self.ref_vcf is not None)

    @abc.abstractmethod
    def _prob_to_snp(self, outputs, positions, ref_name, ref_symbols,
                     return_all=False):
        """Convert network outputs at given loci to SNP records."""

    @property
    def snp_metainfo(self):
        """VCF header entries for SNP decoding."""
        MI = vcf.MetaInfo
        m = [MI("FORMAT", "GT", 1, "String", "Medaka genotype"),
             MI("FORMAT", "GQ", 1, "Integer",
                "Medaka genotype quality score")]
        if self.verbose:
            m.extend([
                MI("INFO", "ref_prob", 1, "Float",
                   "Medaka probability for reference allele"),
                MI("INFO", "primary_prob", 1, "Float",
                   "Medaka probability of primary call"),
                MI("INFO", "primary_call", 1, "String",
                   "Medaka primary call"),
                MI("INFO", "secondary_prob", 1, "Float",
                   "Medaka probability of secondary call"),
                MI("INFO", "secondary_call", 1, "String",
                   "Medaka secondary call")])
        return m


def find_variant_columns(minor, reference, prediction):
    """Mark pileup columns belonging to variant runs.

    A reference (minor==0) column is variant iff it differs; an insertion
    column is variant iff any column of its reference position differs.
    """
    minor = np.asarray(minor)
    if minor[0] != 0:
        raise ValueError(
            "minor array must contain 0 entry at index 0. Found: {}.".format(
                minor[0]))
    diff = np.asarray(reference) != np.asarray(prediction)
    group_starts = np.flatnonzero(minor == 0)
    group_any = np.logical_or.reduceat(diff, group_starts)
    group_id = np.cumsum(minor == 0) - 1
    return np.where(minor == 0, diff, group_any[group_id])


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

    def _prob_to_snp(self, outputs, positions, ref_name, ref_symbols,
                     return_all=False):
        """Threshold-based diploid-from-haploid SNP calling.

        Per locus the two highest-probability classes are inspected: a
        second call above ``secondary_threshold`` (and neither call a
        deletion) produces a heterozygous record; otherwise a non-ref,
        non-deletion top call produces a homozygous-alt record. Anything
        else is emitted as 0/0 only when ``return_all`` (gVCF mode).
        The same records as ``medaka_tpu.labels.HaploidLabelScheme``.
        """
        probs = np.asarray(outputs, dtype=float)
        if probs.size == 0:
            return []
        # per-locus class ranking, vectorised: [:, -1] best, [:, -2] runner-up
        ranked = np.argsort(probs, axis=1)
        top_idx, second_idx = ranked[:, -1], ranked[:, -2]
        rows = np.arange(len(probs))
        top_p, second_p = probs[rows, top_idx], probs[rows, second_idx]

        def make_record(pos, ref_symbol, alt, gt, err, info):
            q = self._phred(err)
            return vcf.Variant(
                ref_name, pos, ref_symbol, alt, filt="PASS", info=info,
                qual=self._pfmt(q),
                genotype_data={"GT": gt, "GQ": self._pfmt(q, 0)})

        results = []
        for i, (pos, ref_symbol) in enumerate(zip(positions, ref_symbols)):
            call = self._decoding[top_idx[i]][0]
            runner_up = self._decoding[second_idx[i]][0]
            p1, p2 = top_p[i], second_p[i]

            info = {}
            if self.verbose:
                ref_p = probs[i, self._encoding[(ref_symbol,)]]
                info = {
                    "ref_prob": self._pfmt(ref_p),
                    "primary_prob": self._pfmt(p1),
                    "primary_call": call,
                    "secondary_prob": self._pfmt(p2),
                    "secondary_call": runner_up}

            heterozygous = (
                p2 >= self.secondary_threshold
                and "*" not in (call, runner_up))
            if heterozygous:
                alt = [c for c in (call, runner_up) if c != ref_symbol]
                gt = "0/1" if ref_symbol in (call, runner_up) else "1/2"
                results.append(make_record(
                    pos, ref_symbol, alt, gt, 1.0 - (p1 + p2), info))
            elif call not in (ref_symbol, "*"):
                results.append(make_record(
                    pos, ref_symbol, call, "1/1", 1.0 - p1, info))
            elif return_all:
                results.append(make_record(
                    pos, ref_symbol, ".", "0/0", 1.0 - p1, info))
        return results

    @functools.lru_cache(1)
    def _symbol_class_lut(self):
        """Byte-codepoint -> class-index table for qual scoring.

        Symbols outside the alphabet (``N`` and any other ambiguity code)
        score as the gap class — they have no probability column of their
        own, so the gap column is the conventional stand-in.
        """
        lut = np.full(256, self._encoding[("*",)], dtype=np.intp)
        for sym in self.symbols:
            lut[ord(sym)] = self._encoding[(sym,)]
        return lut

    def decode_variants(self, sample, ref_seq, ambig_ref=False,
                        return_all=False):
        """Diff the argmax consensus against the reference into variants.

        Adjacent disagreeing pileup columns are grouped into spans
        (insertion columns inherit their anchor's status, see
        `find_variant_columns`), each span becoming one multi-base
        substitution/indel record whose quality is the phred-space
        log-likelihood ratio of called over reference symbols summed
        across the span. The same records as
        ``medaka_tpu.labels.HaploidLabelScheme.decode_variants``.
        """
        majors = sample.positions["major"]
        minors = sample.positions["minor"]
        if minors[0] != 0:
            raise ValueError(
                "The first position of a sample must not be an insertion.")
        probs = sample.label_probs

        # the window as two gapped symbol tracks: called consensus + ref
        called = self.decode_consensus(sample, with_gaps=True, dtype="|U1")
        window_ref = np.full(len(majors), "*", dtype="|U1")
        window_ref[minors == 0] = np.frombuffer(
            ref_seq[majors[0]:majors[-1] + 1].encode(),
            dtype="S1").astype("U1")

        # score every column once, for both tracks: phred(1 - P[symbol])
        lut = self._symbol_class_lut()
        cols = np.arange(len(majors))
        ref_qual = self._phred(
            1.0 - probs[cols, lut[window_ref.astype("S1").view(np.uint8)]])
        called_qual = self._phred(
            1.0 - probs[cols, lut[called.astype("S1").view(np.uint8)]])

        # span boundaries of the variant mask: edges of the padded 0/1 track
        flags = find_variant_columns(minors, window_ref, called)
        edges = np.flatnonzero(np.diff(np.r_[0, flags.astype(np.int8), 0]))

        allowed = set(self.symbols)
        records = []
        for start, stop in zip(edges[::2], edges[1::2]):
            ref_gapped = "".join(window_ref[start:stop])
            alt_gapped = "".join(called[start:stop])
            ref_allele = ref_gapped.replace("*", "")
            alt_allele = alt_gapped.replace("*", "")
            if ref_allele == alt_allele:
                # a deletion followed by an equal insertion cancels out
                continue
            if not ambig_ref and not allowed.issuperset(ref_allele):
                continue

            span_ref_q = ref_qual[start:stop]
            span_alt_q = called_qual[start:stop]
            score = sum(span_alt_q) - sum(span_ref_q)
            info = {}
            if self.verbose:
                info = {
                    "ref_seq": ref_gapped,
                    "pred_seq": alt_gapped,
                    "ref_qs": ",".join(self._pfmt(q) for q in span_ref_q),
                    "pred_qs": ",".join(self._pfmt(q) for q in span_alt_q),
                    "ref_q": self._pfmt(sum(span_ref_q)),
                    "pred_q": self._pfmt(sum(span_alt_q)),
                    "n_cols": int(stop - start)}

            at = majors[start]
            if minors[start] != 0:
                # span opens inside an insertion: normalisation can't left-
                # anchor that, so prepend the reference base ourselves
                ref_allele = ref_seq[at] + ref_allele
                alt_allele = ref_seq[at] + alt_allele
            record = vcf.Variant(
                sample.ref_name, at, ref_allele, alt=alt_allele,
                filt="PASS", info=info, qual=self._pfmt(score),
                genotype_data={"GT": "1", "GQ": self._pfmt(score, 0)})
            records.append(record.normalize(reference=ref_seq))

        if return_all:
            # gVCF backfill: one 0/0 record per reference-anchor column
            anchors = np.flatnonzero(minors == 0)
            for at, base, q in zip(
                    majors[anchors], window_ref[anchors], ref_qual[anchors]):
                records.append(vcf.Variant(
                    sample.ref_name, at, base, alt=".", filt=".", info={},
                    qual="%.3f" % q,
                    genotype_data=vcf.GenotypeData(
                        GT="0", GQ="%d" % np.rint(q))))
            records.sort(key=lambda v: v.pos)
        return records

    @property
    def variant_metainfo(self):
        """VCF header entries for variant decoding."""
        MI = vcf.MetaInfo
        m = [MI("FORMAT", "GT", 1, "String", "Medaka genotype."),
             MI("FORMAT", "GQ", 1, "Integer",
                "Medaka genotype quality score")]
        if self.verbose:
            m.extend([
                MI("INFO", "ref_seq", 1, "String",
                   "Medaka reference sequence"),
                MI("INFO", "pred_seq", 1, "String",
                   "Medaka predicted sequence"),
                MI("INFO", "ref_qs", ".", "Float",
                   "Medaka quality score for reference"),
                MI("INFO", "pred_qs", ".", "Float",
                   "Medaka quality score for prediction"),
                MI("INFO", "ref_q", 1, "Float",
                   "Medaka per position quality score for reference"),
                MI("INFO", "pred_q", 1, "Float",
                   "Medaka per position quality score for prediction"),
                MI("INFO", "n_cols", 1, "Integer",
                   "Number of medaka pileup columns in variant call")])
        return m

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


class DiploidLabelScheme(BaseLabelScheme):
    """Two truth elements per position; 15-class direct diploid calling."""

    @property
    def n_elements(self):
        """Ploidy (2)."""
        return 2

    @property
    def num_classes(self):
        """Output classes (15 = C(5+1, 2))."""
        return len(self._decoding)

    @property
    def padding_vector(self):
        """Gap encoding."""
        return self._labels_to_encoded_labels([("*", "*")])[0]

    @property
    @functools.lru_cache(1)
    def _encoding(self):
        return {v: k for k, v in
                enumerate(self._unordered_label_combinations())}

    def _alignment_to_pairs(self, aln):
        bases = aln.query_sequence.upper()
        return (
            (rpos, "*" if qpos is None else bases[qpos])
            for qpos, rpos in aln.get_aligned_pairs())

    def _labels_to_encoded_labels(self, labels):
        ordered = (tuple(sorted(pair)) for pair in labels)
        return np.fromiter(map(self._encoding.__getitem__, ordered),
                           dtype=int)

    def encoded_labels_to_training_vectors(self, enc_labels):
        """Integer encodings -> sparse one-hot targets."""
        return np.expand_dims(enc_labels, axis=1)

    def _prob_to_snp(self, outputs, positions, ref_name, ref_symbols,
                     return_all=False):
        """Direct diploid genotype calling: the argmax class per locus.

        When ``self.het_rescue`` is set (a probability threshold; default
        off, the argmax), loci whose argmax is the homozygous-reference
        class but whose best (ref, X) heterozygous class still carries at
        least that much probability are called het. The same records as
        ``medaka_tpu.labels.DiploidLabelScheme._prob_to_snp``.
        """
        het_rescue = getattr(self, "het_rescue", None)
        argmax = outputs.argmax(axis=1)
        probs = outputs[np.arange(outputs.shape[0]), argmax]
        quals = self._phred(1 - probs)
        results = []
        for network_output, amax, prob, qual, pos, ref_symbol in zip(
                outputs, argmax, probs, quals, positions, ref_symbols):
            call = self._decoding[amax]
            if (het_rescue is not None
                    and call == (ref_symbol, ref_symbol)
                    and ref_symbol in "ACGT"):
                best_p, best_call = 0.0, None
                for alt in "ACGT":
                    if alt == ref_symbol:
                        continue
                    pair = tuple(sorted((ref_symbol, alt)))
                    p_pair = float(network_output[self._encoding[pair]])
                    if p_pair > best_p:
                        best_p, best_call = p_pair, pair
                if best_call is not None and best_p >= het_rescue:
                    call, prob = best_call, best_p
                    qual = self._phred(1 - prob)

            def _info(rs, p, c):
                if not self.verbose:
                    return {}
                rp = network_output[self._encoding[(rs, rs)]]
                return {"ref_prob": self._pfmt(rp), "prob": self._pfmt(p),
                        "call": c}

            if call == (ref_symbol, ref_symbol):
                if return_all:
                    results.append(vcf.Variant(
                        ref_name, pos, ref_symbol, alt=".", filt="PASS",
                        info=_info(ref_symbol, prob, call),
                        qual=self._pfmt(qual),
                        genotype_data={
                            "GT": "0/0", "GQ": self._pfmt(qual, 0)}))
                continue
            contains_deletion = "*" in call
            if not self._singleton(call):  # heterozygous
                if not contains_deletion:
                    alt = [s for s in call if s != ref_symbol]
                    gt = "0/1" if len(alt) == 1 else "1/2"
                    results.append(vcf.Variant(
                        ref_name, pos, ref_symbol, alt, filt="PASS",
                        info=_info(ref_symbol, prob, call),
                        qual=self._pfmt(qual),
                        genotype_data={"GT": gt, "GQ": self._pfmt(qual, 0)}))
                else:
                    nonref_nondel = [
                        s for s in call if s != ref_symbol and s != "*"]
                    if nonref_nondel:
                        alt = [s for s in call if s != "*"]
                        results.append(vcf.Variant(
                            ref_name, pos, ref_symbol, alt, filt="PASS",
                            info=_info(ref_symbol, prob, call),
                            qual=self._pfmt(qual),
                            genotype_data={
                                "GT": "1/1", "GQ": self._pfmt(qual, 0)}))
            elif not contains_deletion:  # homozygous alt
                results.append(vcf.Variant(
                    ref_name, pos, ref_symbol, call[0], filt="PASS",
                    info=_info(ref_symbol, prob, call),
                    qual=self._pfmt(qual),
                    genotype_data={"GT": "1/1", "GQ": self._pfmt(qual, 0)}))
        return results

    @property
    def snp_metainfo(self):
        """VCF header entries for diploid SNP decoding."""
        MI = vcf.MetaInfo
        m = [MI("FORMAT", "GT", 1, "String", "Medaka genotype"),
             MI("FORMAT", "GQ", 1, "Float",
                "Medaka genotype quality score")]
        if self.verbose:
            m.extend([
                MI("INFO", "ref_prob", 1, "Float",
                   "Medaka probability of reference"),
                MI("INFO", "prob", 1, "Float",
                   "Medaka probability of variant"),
                MI("INFO", "call", 1, "String", "Medaka variant call")])
        return m


class RLELabelScheme(HaploidLabelScheme):
    """Haploid labels over a (base, run length) alphabet for run-length
    models (``medaka_tpu.labels.RLELabelScheme``): class 0 is a gap, then
    (A, 1) .. (A, max_run), (C, 1), ...: 1 + 4 max_run classes."""

    def __init__(self, max_run=12):
        """Runs longer than ``max_run`` are clipped."""
        self.max_run = max_run

    def to_dict(self):
        """Serialise including max_run."""
        return dict(type=type(self).__name__,
                    kwargs=dict(max_run=self.max_run))

    @property
    def padding_vector(self):
        """Gap encoding."""
        return self._labels_to_encoded_labels([(("*", 1),)])[0]

    @property
    @functools.lru_cache(1)
    def _encoding(self):
        encoding = {(("*", 1),): 0}
        bases = [s for s in self.symbols if s != "*"]
        for i, (b, n) in enumerate(
                itertools.product(bases, range(1, self.max_run + 1)), 1):
            encoding[((b, n),)] = i
        return encoding

    def _alignment_to_pairs(self, aln):
        """(reference position, (base, run)) of each aligned pair; the
        truth read's qualities hold its run lengths."""
        bases = aln.query_sequence
        runs = aln.query_qualities
        for qpos, rpos in aln.get_aligned_pairs():
            if qpos is None:
                yield rpos, ("*", 1)
            else:
                yield rpos, (bases[qpos], min(runs[qpos], self.max_run))

    def _labels_to_encoded_labels(self, labels):
        return np.fromiter(map(self._encoding.__getitem__, labels),
                           dtype=int)

    def decode_consensus(self, sample, with_qualities=False):
        """Argmax decode expanding run lengths; with ``with_qualities``
        the expanded bases of a run all carry the phred of the run's
        class probability."""
        decode = self._decoding
        mp = np.argmax(sample.label_probs, -1)
        parts = []
        quals = []
        probs = None
        if with_qualities:
            probs = np.take_along_axis(
                sample.label_probs, mp[:, None], -1).squeeze(-1)
        for i, x in enumerate(mp):
            ((base, run),) = decode[x]
            if base == "*":
                continue
            parts.append(base * run)
            if with_qualities:
                q = int(self._phred(1.0 - probs[i])) + 33
                quals.append(chr(min(q, 126)) * run)
        seq = "".join(parts)
        if with_qualities:
            return seq, "".join(quals)
        return seq

    def _prob_to_snp(self, *args, **kwargs):
        """SNP decoding is undefined for RLE outputs."""
        raise NotImplementedError

    def decode_variants(self, *args, **kwargs):
        """Variant decoding is undefined for RLE outputs."""
        raise NotImplementedError(
            "Variant decoding is undefined for RLE models; polish and "
            "call variants with a non-RLE model instead.")
