"""Sequence-name encoding of region/haplotype metadata.

Counterpart of ``medaka_tpu/tandem/record_name.py`` (the reference's
``medaka/tandem/record_name.py``): the same string format, so that
downstream tooling (and tests) can parse either implementation's
outputs.
"""
from __future__ import annotations

import re

from medaka_tpu_torch import common


class RecordName:
    """Encode/decode region + phasing metadata into sequence names."""

    def __init__(self, *, query_name, ref_name, ref_start, ref_end,
                 hap=0, phased_set=0, ploidy=1, strand="fwd",
                 ref_start_padded=None, ref_end_padded=None):
        """See reference ``record_name.py:10-50`` for field meanings."""
        self.query_name = query_name
        self.ref_name = ref_name
        self.ref_start = ref_start
        self.ref_end = ref_end
        self.hap = hap
        self.phased_set = phased_set
        self.ploidy = ploidy
        self.strand = strand
        self.ref_start_padded = (
            ref_start if ref_start_padded is None else ref_start_padded)
        self.ref_end_padded = (
            ref_end if ref_end_padded is None else ref_end_padded)

    def __str__(self):
        """Encode as a string (reference format)."""
        return (
            "{s.query_name}_{s.ref_name}_{s.ref_start}_{s.ref_end}_"
            "pad_{s.ref_start_padded}_{s.ref_end_padded}_{s.strand}_"
            "hap{s.hap}_phased-set{s.phased_set}_ploidy{s.ploidy}"
        ).format(s=self)

    # The query/ref boundary inside the name is AMBIGUOUS when either
    # side contains underscores; the greedy default matches the
    # reference (``record_name.py:68``: query takes the underscores).
    # ``from_str(..., known_refs=...)`` resolves the boundary against
    # the actual contig set — without it, multi-underscore contigs
    # (e.g. chr1_KI270706v1_random) mis-split exactly as upstream.
    # str() round-trips whichever way the boundary fell.
    _PATTERN = re.compile(
        r"(?P<query_name>.+)_(?P<ref_name>.+)_"
        r"(?P<ref_start>\d+)_(?P<ref_end>\d+)_"
        r"pad_(?P<ref_start_padded>\d+)_(?P<ref_end_padded>\d+)_"
        r"(?P<strand>fwd|rev)_hap(?P<hap>\d+)_"
        r"phased-set(?P<phased_set>\d+)_ploidy(?P<ploidy>\d+)")

    @classmethod
    def from_str(cls, name: str, known_refs=None) -> "RecordName":
        """Decode from a string.

        :param known_refs: optional contig-name collection used to
            place the ambiguous query/ref boundary (longest matching
            contig wins).
        """
        m = cls._PATTERN.match(name)
        if m is None:
            raise ValueError("Could not parse {}".format(name))
        d = m.groupdict()
        if known_refs is not None and d["ref_name"] not in known_refs:
            prefix = "{}_{}".format(d["query_name"], d["ref_name"])
            cut = None
            for i, ch in enumerate(prefix):
                if ch == "_" and prefix[i + 1:] in known_refs:
                    cut = i
                    break  # leftmost '_' -> longest contig suffix
            if cut is not None:
                d["query_name"], d["ref_name"] = (
                    prefix[:cut], prefix[cut + 1:])
        for field in ("ref_start", "ref_end", "hap", "ref_start_padded",
                      "ref_end_padded", "phased_set", "ploidy"):
            d[field] = int(d[field])
        return cls(**d)

    def copy(self) -> "RecordName":
        """Shallow copy."""
        return RecordName(
            query_name=self.query_name, ref_name=self.ref_name,
            ref_start=self.ref_start, ref_end=self.ref_end, hap=self.hap,
            phased_set=self.phased_set, ploidy=self.ploidy,
            strand=self.strand, ref_start_padded=self.ref_start_padded,
            ref_end_padded=self.ref_end_padded)

    def sorter(self):
        """Sorting key."""
        return self.ref_name, self.ref_start

    def to_padded_region(self) -> common.Region:
        """Padded `Region`."""
        return common.Region(
            self.ref_name, self.ref_start_padded, self.ref_end_padded)

    def to_unpadded_region(self) -> common.Region:
        """Unpadded `Region`."""
        return common.Region(self.ref_name, self.ref_start, self.ref_end)
