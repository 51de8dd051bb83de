"""Variant Call Format data structures and IO.

Counterpart of ``medaka_tpu/vcf.py``: the INFO column's parse and format,
``MetaInfo``, ``GenotypeData``, ``Variant`` (trim, normalize,
split_haplotypes, from_text, gt, alleles, to_dict, deep_copy),
``VCFWriter``, ``VCFReader`` (index, fetch) and the read-support
annotator (``annotate_vcf_n_reads``, aligning spanning reads to the
padded haplotypes with the native aligner), and the helpers of the
``tools`` subcommands: ``classify_variant``/``classify_variants`` and
``vcf2tsv``, the haploid/diploid conversions (``Haploid2DiploidConverter``,
``haploid2diploid``, ``split_mnp``, ``split_variants``) and
``get_homozygous_regions``. The header carries ``medaka_tpu_version=``
and the same version string as ``medaka_tpu``, so both packages write the
same bytes for the same records.
"""
from __future__ import annotations

import collections
import itertools
import os
from copy import deepcopy
from typing import Dict, Optional, Tuple

import numpy as np

from medaka_tpu_torch import __version__ as package_version
from medaka_tpu_torch import common
from medaka_tpu_torch.utils.intervals import IntervalSet


def self_return(x):
    """Identity (used as a no-op field parser)."""
    return x


# Reserved INFO fields from the VCF v4.3 spec, Table 1.
reserved_info_fields = {
    'AA': (1, str), 'AC': ('A', int), 'AD': ('R', int), 'ADF': ('R', int),
    'ADR': ('R', int), 'AF': ('A', float), 'AN': (1, int), 'BQ': (1, float),
    'CIGAR': ('A', str), 'DB': (0, self_return), 'DP': (1, int),
    'END': (1, int), 'H2': (0, self_return), 'H3': (0, self_return),
    'MQ': (1, self_return), 'MQ0': (1, int), 'NS': (1, int),
    'SB': ('.', self_return), 'SOMATIC': (0, self_return),
    'VALIDATED': (0, self_return), '1000G': (0, self_return)}
own_info_fields = {'SCORES': ('R', float)}
all_info_fields = dict(reserved_info_fields, **own_info_fields)


def parse_tags_to_string(tags: Dict) -> str:
    """Serialise an INFO dict to its VCF column representation."""
    if not tags:
        return '.'

    def one(key, value):
        if value is True:  # flag field: bare key
            return key
        if isinstance(value, (tuple, list)):
            value = ','.join(map(str, value))
        return '{}={}'.format(key, value)

    return ';'.join(one(k, v) for k, v in sorted(tags.items()))


def parse_string_to_tags(string: str, splitter: str = ',') -> Dict:
    """Parse a VCF INFO column into a dict."""
    tags = {}
    for field in string.split(';'):
        if field in ('', '.'):
            continue
        tag, eq, payload = field.partition('=')
        if not eq:
            tags[tag] = True  # flag field
            continue
        value = payload
        caster = all_info_fields.get(tag, (None, None))[1]
        if caster is not None:
            try:
                parts = [caster(x) for x in payload.split(splitter)]
                value = parts[0] if len(parts) == 1 else parts
            except ValueError:
                value = payload
        tags[tag] = value
    return tags


class MetaInfo:
    """A VCF header meta-information line."""

    __valid_groups__ = ('INFO', 'FILTER', 'FORMAT')
    __valid_group_sort__ = {v: k for k, v in enumerate(__valid_groups__)}
    __valid_non_int_nums__ = {'A', 'R', 'G', '.'}
    __valid_types__ = {'Integer', 'Float', 'Flag', 'Character', 'String'}

    def __init__(self, group, ident, number, typ, descr):
        """Validate and store the header entry fields."""
        number_ok = (
            isinstance(number, int)
            or (isinstance(number, str) and number.isdigit())
            or number in self.__valid_non_int_nums__)
        for ok, what, got, allowed in (
                (group in self.__valid_groups__, 'header group', group,
                 self.__valid_groups__),
                (number_ok, 'Number', number,
                 'an integer or ' + str(self.__valid_non_int_nums__)),
                (typ in self.__valid_types__, 'Type', typ,
                 self.__valid_types__)):
            if not ok:
                raise ValueError(
                    'Invalid VCF meta {} {!r}; expected {}.'.format(
                        what, got, allowed))
        self.group = group
        self.ident = ident
        self.number = number
        self.typ = typ
        self.descr = descr

    def __repr__(self):
        return '{}=<ID={},Number={},Type={},Description="{}">'.format(
            self.group, self.ident, self.number, self.typ, self.descr)

    __str__ = __repr__


class GenotypeData(dict):
    """Genotype FORMAT data; keeps GT as the first key."""

    def __init__(self, GT, **kwargs):
        """Store GT first, then other FORMAT fields."""
        super().__init__(GT=GT, **kwargs)


class Variant:
    """One genomic variant record (0-based position)."""

    def __init__(self, chrom, pos, ref, alt='.', ident='.', qual='.',
                 filt='.', info='.', genotype_data=None):
        """Create a variant; see the VCF spec for field meanings."""
        self.chrom = chrom
        self.pos = int(pos)
        self.ref = ref.upper()
        if isinstance(alt, str):
            alt = alt.split(',')
        self.alt = alt
        self.ident = str(ident)
        self.qual = qual if qual == '.' else float(qual)
        self.filt = filt if ';' not in filt else filt.split(';')
        if not isinstance(info, dict):
            info = parse_string_to_tags(info)
        self.info = info
        if genotype_data is None:
            self.genotype_data = collections.OrderedDict()
        elif isinstance(genotype_data, GenotypeData):
            self.genotype_data = genotype_data
        else:
            self.genotype_data = self._sort_genotype_data(genotype_data)

    @staticmethod
    def _sort_genotype_data(gd):
        rest = dict(gd)
        gt = rest.pop('GT')
        return GenotypeData(gt, **rest)

    def _record_fields(self):
        return (self.chrom, self.pos, self.ident, self.ref, self.alt,
                self.qual, self.filt, self.info, self.genotype_data)

    def __eq__(self, other):
        if not isinstance(other, Variant):
            return NotImplemented
        return self._record_fields() == other._record_fields()

    def __ne__(self, other):
        eq = self.__eq__(other)
        return eq if eq is NotImplemented else not eq

    def __repr__(self):
        gd = ';'.join(
            '{}={}'.format(k, v) for k, v in self.genotype_data.items())
        parts = [
            repr(self.chrom), str(self.pos), repr(self.ref),
            'alt={}'.format(self.alt), 'ident={}'.format(self.ident),
            'qual={}'.format(self.qual), 'filt={}'.format(self.filt),
            "info='{}'".format(self.info_string),
            "genotype_data='{}'".format(gd)]
        return 'Variant({})'.format(', '.join(parts))

    # --- derived fields ---

    @property
    def genotype_keys(self):
        """FORMAT column."""
        return ':'.join(str(k) for k in self.genotype_data)

    @property
    def genotype_values(self):
        """Sample column."""
        return ':'.join(str(v) for v in self.genotype_data.values())

    @property
    def info_string(self):
        """INFO column."""
        return parse_tags_to_string(self.info)

    @property
    def gt(self):
        """Genotype allele indices; None when absent or no-call."""
        gt = self.genotype_data.get('GT')
        if gt is None:
            return None
        alleles = gt.replace('|', '/').split('/')
        if '.' in alleles:  # no-call (./.) from external callers
            return None
        return tuple(int(x) for x in alleles)

    @property
    def phased(self):
        """Whether GT is phased (None when no GT)."""
        gt = self.genotype_data.get('GT')
        return None if gt is None else '|' in gt

    @property
    def alleles(self):
        """Alleles selected by the genotype."""
        if self.gt is None:
            return None
        all_alleles = [self.ref] + self.alt
        return tuple(all_alleles[i] for i in self.gt)

    @classmethod
    def from_text(cls, line: str) -> 'Variant':
        """Parse one VCF data line (tab separated, 1-based POS)."""
        (chrom, pos, ident, ref, alt, qual, filt, info,
         *rest) = line.rstrip('\n').split('\t')
        gt = None
        if len(rest) >= 2:
            gt = cls._sort_genotype_data(
                dict(zip(rest[0].split(':'), rest[1].split(':'))))
        return cls(chrom, int(pos) - 1, ref, alt=alt, ident=ident, qual=qual,
                   filt=filt, info=info, genotype_data=gt)

    def add_tag(self, tag, value=None):
        """Set an INFO tag, dropping any '.' placeholder entry."""
        self.info.pop('.', None)
        self.info[tag] = value

    def get_tag(self, tag):
        """Read an INFO tag."""
        return self.info[tag]

    def deep_copy(self):
        """Deep copy of the variant."""
        return deepcopy(self)

    def to_dict(self):
        """Flatten the record into a dict (used by vcf2tsv)."""
        d = dict(alt=','.join(self.alt))
        for attr in ('chrom', 'pos', 'qual', 'ident', 'filt', 'ref'):
            d[attr] = getattr(self, attr)
        d.update(self.info)
        d.update(self.genotype_data)
        return d

    # --- normalisation (https://genome.sph.umich.edu/wiki/Variant_Normalization)

    def trim(self, reference: Optional[str] = None) -> 'Variant':
        """Return a parsimonious (and, given a reference, left-aligned) copy."""
        alleles = [self.ref, *self.alt]
        pos = self.pos

        def matched_prefix(seqs):
            # longest run of identical leading bases, always leaving at
            # least one base of the shortest allele in place
            cap = min(map(len, seqs)) - 1
            n = 0
            while n < cap and len({s[n] for s in seqs}) == 1:
                n += 1
            return n

        if reference is None:
            # parsimony only: shave the shared tail (computed as the
            # shared head of the reversed alleles)
            k = matched_prefix([s[::-1] for s in alleles])
            if k:
                alleles = [s[:-k] for s in alleles]
        else:
            # left-align: keep shaving shared final bases, pulling in
            # reference context whenever an allele would run empty
            while True:
                if min(map(len, alleles)) == 0:
                    if pos == 0:
                        # deletion butting the contig start: borrow the
                        # base to the right instead
                        nxt = reference[len(alleles[0])]
                        alleles = [s + nxt for s in alleles]
                        break
                    pos -= 1
                    alleles = [reference[pos] + s for s in alleles]
                elif len({s[-1] for s in alleles}) == 1:
                    alleles = [s[:-1] for s in alleles]
                else:
                    break

        k = matched_prefix(alleles)
        if k:
            pos += k
            alleles = [s[k:] for s in alleles]
        out = self.deep_copy()
        out.pos = pos
        out.ref = alleles[0]
        out.alt = alleles[1:]
        return out

    def normalize(self, reference: str) -> 'Variant':
        """Trim and left-align against the full chrom reference sequence."""
        if all(x == self.ref for x in self.alt):
            return self
        return self.trim(reference=reference)

    def split_haplotypes(self) -> Tuple:
        """Split a multiploid record into per-haplotype records."""
        if 'GT' not in self.genotype_data:
            return tuple()
        out = []
        gd = self.genotype_data.copy()
        gd['GT'] = '1/1'
        for hap_n, n in enumerate(self.gt, 1):
            if n == 0:
                v = None
            else:
                v = Variant(
                    self.chrom, self.pos, self.ref, self.alt[n - 1],
                    qual=self.qual, info=self.info.copy(), genotype_data=gd)
            out.append((hap_n, v))
        return tuple(out)


class VCFWriter:
    """Write `Variant` records with a well-formed header."""

    version_options = {'4.3', '4.1'}

    def __init__(self, filename, mode='w',
                 header=('CHROM', 'POS', 'ID', 'REF', 'ALT', 'QUAL',
                         'FILTER', 'INFO', 'FORMAT', 'SAMPLE'),
                 contigs=None, meta_info=None, version='4.1'):
        """Write VCFv4.1 by default for maximal tool compatibility."""
        self.filename = filename
        self.mode = mode
        self.header = header
        if version not in self.version_options:
            raise ValueError(
                'version must be one of {}'.format(self.version_options))
        self.version = version
        self.meta = [
            'fileformat=VCFv{}'.format(self.version),
            'medaka_tpu_version={}'.format(package_version)]
        if contigs is not None:
            self.meta.extend('contig=<ID={}>'.format(c) for c in contigs)
        if meta_info is not None:
            try:
                meta_info.sort(
                    key=lambda x: MetaInfo.__valid_group_sort__[x.group])
            except Exception:
                pass
            meta_info = [str(m) for m in meta_info]
            self.meta.extend(
                m for m in meta_info if 'fileformat=VCFv' not in m)
        self.logger = common.get_named_logger('VCFWriter')

    def __enter__(self):
        self.handle = open(self.filename, self.mode, encoding='utf-8')
        self.handle.write(
            '\n'.join('##' + line for line in self.meta) + '\n')
        self.handle.write('#' + '\t'.join(self.header) + '\n')
        return self

    def __exit__(self, *exc):
        self.handle.close()

    def write_variants(self, variants, sort=True):
        """Write many records, optionally sorting by (chrom, pos)."""
        if sort:
            variants = common.loose_version_sort(
                variants, key=lambda v: '{}-{}'.format(v.chrom, v.pos))
        self.handle.writelines(self._format_row(v) for v in variants)

    def write_variant(self, variant: Variant):
        """Write one record (POS converted to 1-based)."""
        self.handle.write(self._format_row(variant))

    @staticmethod
    def _format_row(v: Variant) -> str:
        """One tab-separated VCF line (no mutation of ``v``)."""
        def joined(x, sep):
            return (sep.join(map(str, x))
                    if isinstance(x, (tuple, list)) else x)

        cols = (v.chrom, v.pos + 1, v.ident, v.ref, joined(v.alt, ','),
                v.qual, joined(v.filt, ';'), v.info_string,
                v.genotype_keys, v.genotype_values)
        return '\t'.join(str(c) for c in cols) + '\n'


class VCFReader:
    """Parse `.vcf` files with an optional in-memory interval index."""

    def __init__(self, filename, cache=True):
        """Read header eagerly; records lazily."""
        self.filename = filename
        self.cache = cache
        self.chroms = []
        self._indexed = False
        self._tree = None
        self.logger = common.get_named_logger('VCFReader')
        self.meta = []
        self.header = None
        with open(filename, encoding='utf-8') as handle:
            for line in handle:
                line = line.rstrip('\n')
                if line.startswith('##'):
                    self.meta.append(line[2:])
                elif line.startswith('#'):
                    self.header = line[1:].split('\t')
                    break

    def _parse(self):
        """Stream records, requiring position order within chrom runs.

        Order tracking resets whenever the chromosome changes, so a
        concatenation of per-region VCFs (each block internally
        sorted) streams fine even when a chromosome recurs.
        """
        run = (None, None)  # (current chrom, last position in its run)
        known = set(self.chroms)
        with open(self.filename, encoding='utf-8') as handle:
            for lineno, raw in enumerate(handle, 1):
                raw = raw.rstrip('\n')
                if not raw or raw[0] == '#':
                    continue
                try:
                    variant = Variant.from_text(raw)
                except Exception as e:
                    raise IOError(
                        'Malformed VCF record at line {} of {}: '
                        '{!r}'.format(lineno, self.filename, raw)) from e
                if variant.chrom == run[0] and run[1] is not None \
                        and variant.pos < run[1]:
                    raise IOError(
                        '{} is not position-sorted at line {} '
                        '({}:{} after position {}).'.format(
                            self.filename, lineno, variant.chrom,
                            variant.pos + 1, run[1] + 1))
                run = (variant.chrom, variant.pos)
                if variant.chrom not in known:
                    known.add(variant.chrom)
                    self.chroms.append(variant.chrom)
                yield variant

    def index(self):
        """Build the interval index (idempotent)."""
        if self._indexed:
            return
        self.cache = True
        self._tree = collections.defaultdict(IntervalSet)
        for variant in self._parse():
            self._tree[variant.chrom].add(
                variant.pos, variant.pos + len(variant.ref), variant)
        self._indexed = True

    def fetch(self, ref_name=None, start=None, end=None, strict=True):
        """Yield variants in a region.

        With ``strict`` any overlapping variant is returned, otherwise only
        variants fully contained in the region.
        """
        lo = float('-inf') if start is None else start
        hi = float('inf') if end is None else end
        if not self.cache:
            # stream without an index: contained-in-region, strict
            # inequalities, and no `strict` distinction — matching the
            # reference's cacheless path exactly (``vcf.py:656-659``),
            # which differs from the indexed path at region boundaries
            yield from (
                v for v in self._parse()
                if (ref_name is None or v.chrom == ref_name)
                and lo < v.pos and v.pos + len(v.ref) < hi)
            return
        self.index()
        lo_i = int(lo) if lo != float('-inf') else -(1 << 60)
        hi_i = int(hi) if hi != float('inf') else (1 << 60)
        for chrom in ([ref_name] if ref_name is not None else self.chroms):
            tree = self._tree[chrom]
            hits = (tree.overlap(lo_i, hi_i) if strict
                    else tree.envelop(lo_i, hi_i))
            for iv in sorted(hits, key=lambda iv: (iv[0], iv[1])):
                yield iv[2]


# ---------------------------------------------------------------------------
# Variant classification (reference vcf.py:985-1072)
# ---------------------------------------------------------------------------


def classify_variant(var: Variant) -> str:
    """Classify a variant record.

    :returns: one of snp, mnp, sni, mni, snd, mnd, indel, other.
    """
    def is_start_same(v):
        return all(a[0] == v.ref[0] for a in v.alt)

    def is_end_same(v):
        return all(a[-1] == v.ref[-1] for a in v.alt)

    len_ref = len(var.ref)
    alt_lens = {len(a) for a in var.alt}

    if alt_lens == {len_ref}:
        return 'snp' if len_ref == 1 else 'mnp'
    if all(len_ref < la for la in alt_lens) and (
            is_start_same(var) or is_end_same(var)):
        return 'sni' if alt_lens == {len_ref + 1} else 'mni'
    if all(len_ref > la for la in alt_lens) and (
            is_start_same(var) or is_end_same(var)):
        return 'snd' if alt_lens == {len_ref - 1} else 'mnd'
    if len(alt_lens) > 1 or (
            len_ref != next(iter(alt_lens))):
        return 'indel'
    return 'other'


def classify_variants(args):
    """``tools classify_variants``: write the records of ``args.vcf`` into
    one VCF a class group (snp, indel, all) beside it; returns the paths
    by group."""
    path = args.vcf
    base, dot, ext = path.rpartition('.')
    if not dot:
        base, ext = path, 'vcf'
    reader = VCFReader(path, cache=False)
    groups = {
        'snp': ['snp'], 'indel': ['sni', 'mni', 'snd', 'mnd', 'indel'],
        'all': ['snp', 'mnp', 'sni', 'mni', 'snd', 'mnd', 'indel', 'other']}
    writers = {}
    classified = {k: [] for k in groups}
    for variant in reader.fetch():
        klass = classify_variant(variant)
        for group, members in groups.items():
            if klass in members:
                classified[group].append(variant)
    for group, variants in classified.items():
        out = '{}.{}.{}'.format(base, group, ext)
        with VCFWriter(out, meta_info=reader.meta) as writer:
            writer.write_variants(variants, sort=False)
        writers[group] = out
    return writers


def vcf2tsv(args):
    """``tools vcf2tsv``: flatten ``args.vcf`` into ``<vcf>.tsv``, a column
    a field; returns its path."""
    reader = VCFReader(args.vcf, cache=False)
    rows = [v.to_dict() for v in reader.fetch()]
    cols = []
    for row in rows:
        for key in row:
            if key not in cols:
                cols.append(key)
    out = args.vcf + '.tsv'
    with open(out, 'w') as fh:
        fh.write('\t'.join(cols) + '\n')
        for row in rows:
            fh.write(
                '\t'.join(str(row.get(c, '.')) for c in cols) + '\n')
    return out


# ---------------------------------------------------------------------------
# Haploid <-> diploid conversion (reference ``vcf.py:680-982``)
# ---------------------------------------------------------------------------


def _splice_edits(ref, origin, edits):
    """Apply (pos, ref, alt) edits to ``ref`` (coordinates of ``origin``).

    Edits are applied right-to-left so earlier coordinates stay valid.
    """
    out = ref
    for pos, vref, valt in sorted(edits, reverse=True):
        lo = pos - origin
        found = ref[lo:lo + len(vref)]
        if found != vref:
            raise ValueError(
                'Edit ref allele {!r} disagrees with reference {!r} '
                'near offset {}'.format(vref, found, pos))
        out = out[:lo] + valt + out[lo + len(vref):]
    return out


def _merge_variants(interval, hap_of, ref_seq, detailed_info=False,
                    discard_phase=False):
    """Fuse the haploid variants covering one merged interval.

    Builds each haplotype's full alternative sequence over the interval,
    then emits a single diploid record with per-haplotype quality info.
    Behavioural parity target: reference ``vcf.py:688-790``.

    :param interval: (begin, end, [variants]) tuple.
    :param hap_of: mapping id(variant) -> haplotype number (1 or 2).
    :param ref_seq: reference sequence of the chromosome.
    """
    begin, end, group = interval
    if end > len(ref_seq):
        raise ValueError(
            'Merge interval extends beyond the reference sequence end.')
    ref = ref_seq[begin:end]

    by_hap = collections.defaultdict(list)
    for v in group:
        if len(v.alt) != 1:
            raise ValueError(
                'Haploid merge inputs must be single-allele records; got '
                '{} alts at {}:{}'.format(len(v.alt), v.chrom, v.pos))
        by_hap[str(hap_of[id(v)])].append(v)

    # Per-haplotype spliced sequence; haplotypes whose edits cancel back
    # to the reference are treated as absent from here on.
    hap_seqs = {}
    for hap in sorted(by_hap):
        spliced = _splice_edits(
            ref, begin, [(v.pos, v.ref, v.alt[0]) for v in by_hap[hap]])
        if spliced == ref:
            del by_hap[hap]
        else:
            hap_seqs[hap] = spliced

    info = {}
    hap_quals = []
    for hap in sorted(by_hap):
        hap_vars = by_hap[hap]
        quals = [0.0 if v.qual == '.' else float(v.qual) for v in hap_vars]
        mean_q = sum(quals) / len(quals)
        hap_quals.append(mean_q)
        info['q' + hap] = mean_q
        info['pos' + hap] = ','.join(str(v.pos + 1) for v in hap_vars)
        if detailed_info:
            info['ref' + hap] = ','.join(v.ref for v in hap_vars)
            info['alt' + hap] = ','.join(v.alt[0] for v in hap_vars)
    qual = sum(hap_quals) / len(hap_quals) if hap_quals else 0.0

    surviving = sorted(hap_seqs)
    if not surviving:
        # every haplotype's edits spliced back to the reference (e.g.
        # ref==alt input records): nothing to report for this interval
        return None
    alts = [hap_seqs[h] for h in surviving]
    sep = '/' if discard_phase else '|'
    if len(alts) == 2 and alts[0] == alts[1]:
        # both haplotypes carry the same sequence: homozygous alt
        alts = alts[:1]
        gt = sep.join(['1'] * len(surviving))
    elif len(alts) == 2:
        gt = sep.join(surviving)
    else:
        # one haplotype is reference; phased output keeps hap 1 first
        alleles = ['0', '1']
        if not discard_phase and surviving[0] == '1':
            alleles.reverse()
        gt = sep.join(alleles)

    merged = Variant(
        group[0].chrom, begin, ref, alt=alts, filt='PASS', info=info,
        qual=qual, genotype_data={'GT': gt, 'GQ': round(qual)})
    return merged.trim()


def split_mnp(v):
    """Split an MNP variant into per-base SNPs (others unchanged).

    At each column the alt bases may collapse (duplicates, or bases equal
    to the reference), in which case the GT indices are remapped to the
    deduplicated allele list.
    """
    if classify_variant(v) != 'mnp':
        return [v]
    phase = '|' if v.phased else '/'
    out = []
    for offset, column in enumerate(zip(v.ref, *v.alt)):
        ref_base = column[0]
        alt_bases = list(column[1:])
        gd = dict(v.genotype_data)
        kept = []
        for base in alt_bases:
            if base != ref_base and base not in kept:
                kept.append(base)
        if kept != alt_bases:
            # remap genotype indices onto the collapsed allele list
            alleles_in = [ref_base] + alt_bases
            alleles_out = [ref_base] + kept
            called = (alleles_in[g] for g in v.gt)
            gd['GT'] = phase.join(
                str(alleles_out.index(b)) for b in called)
            alt_bases = kept
        out.append(Variant(
            v.chrom, v.pos + offset, ref_base, alt_bases, ident=v.ident,
            qual=v.qual, filt=v.filt, info=v.info, genotype_data=gd))
    return out


class Haploid2DiploidConverter:
    """Merge two haploid VCFs into one diploid VCF.

    Reference: ``medaka/vcf.py:826-947``. Overlapping variants between
    the files have their alts padded against the reference; genotype is
    1|2 (or 1|1 when alts agree), with per-haplotype mean GQ.
    """

    def __init__(self, vcf1, vcf2, ref_fasta, only_overlapping=True,
                 discard_phase=False, detailed_info=False):
        """:param only_overlapping: merge only overlapping (not
        adjacent) variants."""
        from medaka_tpu_torch.io.fastx import FastaReader
        self.only_overlapping = only_overlapping
        self.discard_phase = discard_phase
        self.detailed_info = detailed_info
        self.logger = common.get_named_logger('VCFMERGE')
        self.vcfs = [VCFReader(v) for v in (vcf1, vcf2)]
        for vcf in self.vcfs:
            vcf.index()  # build trees (and populate .chroms)
        self.fasta = FastaReader(ref_fasta)
        self.chroms = sorted(
            set(itertools.chain(*[v.chroms for v in self.vcfs])))

    def variants(self):
        """Yield merged diploid variants, sorted by position."""
        for chrom in common.loose_version_sort(self.chroms):
            self.logger.info('Merging variants in chrom %s', chrom)
            hap_of = {}
            intervals = []
            for hap, vcf in enumerate(self.vcfs, 1):
                for v in vcf.fetch(ref_name=chrom):
                    hap_of[id(v)] = hap
                    intervals.append((v.pos, v.pos + len(v.ref), v))
            intervals.sort(key=lambda iv: (iv[0], iv[1]))
            # merge overlapping (or adjacent) intervals
            merged = []
            for s, e, v in intervals:
                joins = bool(merged) and (
                    s < merged[-1][1] if self.only_overlapping
                    else s <= merged[-1][1])
                if joins:
                    merged[-1][1] = max(merged[-1][1], e)
                    merged[-1][2].append(v)
                else:
                    merged.append([s, e, [v]])
            ref_seq = self.fasta.fetch(chrom).upper()
            out = [
                _merge_variants(
                    tuple(iv), hap_of, ref_seq,
                    detailed_info=self.detailed_info,
                    discard_phase=self.discard_phase)
                for iv in merged]
            out = [v for v in out if v is not None]
            yield from sorted(out, key=lambda x: x.pos)

    @property
    def meta_info(self):
        """Meta info lines for the merged VCF."""
        m = []
        for h in (1, 2):
            m.append(MetaInfo(
                'INFO', 'pos{}'.format(h), '.', 'Integer',
                'POS of incorporated variants from haplotype '
                '{}'.format(h)))
            m.append(MetaInfo(
                'INFO', 'q{}'.format(h), 1, 'Float',
                'Combined qual score for haplotype {}'.format(h)))
        if self.detailed_info:
            for h in (1, 2):
                m.append(MetaInfo(
                    'INFO', 'ref{}'.format(h), '2', 'String',
                    'ref alleles of incorporated variants from '
                    'haplotype {}'.format(h)))
                m.append(MetaInfo(
                    'INFO', 'alt{}'.format(h), '2', 'String',
                    'alt alleles of incorporated variants from '
                    'haplotype {}'.format(h)))
        m.append(MetaInfo('FORMAT', 'GT', 'G', 'String', 'Genotype'))
        m.append(MetaInfo(
            'FORMAT', 'GQ', 'G', 'Integer', 'Genotype quality score'))
        return m


def haploid2diploid(vcf1, vcf2, ref_fasta, vcfout, adjacent=False,
                    discard_phase=False, split_mnp_records=False):
    """Merge two haploid VCFs into a diploid VCF file."""
    from medaka_tpu_torch.io.fastx import FastaReader
    converter = Haploid2DiploidConverter(
        vcf1, vcf2, ref_fasta, only_overlapping=not adjacent,
        discard_phase=discard_phase)
    with FastaReader(ref_fasta) as fa:
        lengths = {r: fa.get_reference_length(r) for r in fa.references}
    contigs = [
        '{},length={}'.format(c, lengths[c]) for c in converter.chroms]
    with VCFWriter(
            vcfout, 'w', version='4.1', contigs=contigs,
            meta_info=converter.meta_info) as writer:
        variants = converter.variants()
        if split_mnp_records:
            variants = (s for v in variants for s in split_mnp(v))
        for v in variants:
            writer.write_variant(v)
    return vcfout


def split_variants(vcf_fp, trim=True):
    """Split a diploid VCF into two haploid VCFs; returns paths."""
    vcf = VCFReader(vcf_fp, cache=False)
    q = collections.defaultdict(list)
    for v in vcf.fetch():
        for k, hv in v.split_haplotypes():
            if hv is not None:
                q[k].append(hv.trim() if trim else hv)
    basename, ext = os.path.splitext(vcf_fp)
    outputs = []
    for k, variants in q.items():
        path = '{}_hap{}{}'.format(basename, k, ext)
        outputs.append(path)
        with VCFWriter(path, meta_info=vcf.meta) as writer:
            writer.write_variants(variants, sort=False)
    return tuple(outputs)


def get_homozygous_regions(vcf_path, region, min_len=1000,
                           suffix='regions.txt'):
    """Find long runs without heterozygous calls in a diploid VCF.

    Reference: ``medaka/vcf.py:1088-1155``. Writes
    ``homozygous_<suffix>`` and ``heterozygous_<suffix>`` region lists.

    :returns: (homozygous regions, heterozygous regions).
    """
    vcf = VCFReader(vcf_path, cache=False)
    reg = region if isinstance(region, common.Region) \
        else common.Region.from_string(region)
    if reg.start is None or reg.end is None:
        raise ValueError('Region start and end must be specified')

    # every reference base covered by a heterozygous call breaks a run
    het_cover = [reg.start]
    for v in vcf.fetch(ref_name=reg.ref_name, start=reg.start, end=reg.end):
        gt = v.gt
        if gt is not None and len(set(gt)) > 1:
            het_cover.extend(range(v.pos, v.pos + len(v.ref)))
    het_cover.append(reg.end)
    het_cover.sort()

    homo_regions = [
        common.Region(reg.ref_name, a, b)
        for a, b in zip(het_cover[:-1], het_cover[1:])
        if b - a >= min_len]

    # the complement of the homozygous runs, keeping only long pieces
    hetero_regions = []
    cursor = reg.start
    for lo, hi in [(r.start, r.end) for r in homo_regions] + [
            (reg.end, reg.end)]:
        if lo - cursor > min_len:
            hetero_regions.append(common.Region(reg.ref_name, cursor, lo))
        cursor = hi

    for prefix, regions in (('homozygous_', homo_regions),
                            ('heterozygous_', hetero_regions)):
        with open(prefix + suffix, 'w') as fh:
            fh.write('\n'.join(r.name for r in regions))
    return homo_regions, hetero_regions


# ---------------------------------------------------------------------------
# VCF annotation with read depth / supporting reads
# (reference ``vcf.py:1158-1403``)
# ---------------------------------------------------------------------------

# parasail.dnafull equivalents: match 5, mismatch -4; parasail gap cost
# open=5/extend=3 means cost(L) = 5 + 3(L-1) = 2 + 3L, i.e. our
# (gap_open=2, gap_extend=3)
_ANN_MATCH = 5
_ANN_MISMATCH = 4
_ANN_GAP_OPEN = 2
_ANN_GAP_EXTEND = 3


def get_padded_haplotypes(var, ref_seq, pad):
    """Padded (ref, alt...) haplotype sequences around a variant."""
    ref_seq_var = ref_seq[var.pos:var.pos + len(var.ref)].upper()
    if var.ref != ref_seq_var:
        raise ValueError(
            'Ref sequences {} and {} differ at {}:{}, check your '
            'files.'.format(var.ref, ref_seq_var, var.chrom, var.pos))
    left_start = max(0, var.pos - pad)
    right_start = var.pos + len(var.ref)
    right_end = min(len(ref_seq), right_start + pad)
    pad_left = ref_seq[left_start:var.pos]
    pad_right = ref_seq[right_start:right_end]
    padded = tuple(
        pad_left + hap + pad_right for hap in [var.ref] + var.alt)
    region = common.Region(var.chrom, left_start, right_end)
    return padded, region


def _spanning_reads(bam, region, read_group):
    from medaka_tpu_torch.features import get_trimmed_reads
    try:
        _reg, reads = next(get_trimmed_reads(
            region, bam, partial=False, read_group=read_group,
            region_split=2 * region.size))
    except StopIteration:
        return []
    return reads[1:]  # drop the reference placeholder


def align_read_to_haps(read, haps):
    """SW score of a read against each padded haplotype."""
    from medaka_tpu_torch import native
    return [
        native.align(
            read, hap, mode='sw', match=_ANN_MATCH,
            mismatch=_ANN_MISMATCH, gap_open=_ANN_GAP_OPEN,
            gap_extend=_ANN_GAP_EXTEND).score
        for hap in haps]


def align_reads_to_haps(reads, haps):
    """Count best-haplotype support and summed scores by strand."""
    hap_counts = collections.Counter()
    total_scores = collections.Counter()
    for read in reads:
        is_rev, _name, read_seq = read[0], read[1], read[2]
        scores = align_read_to_haps(read_seq, haps)
        best_hap = None if len(set(scores)) == 1 else int(
            np.argmax(scores))
        hap_counts[(is_rev, best_hap)] += 1
        for hap, score in enumerate(scores):
            total_scores[(is_rev, hap)] += score
    return hap_counts, total_scores


def annotate_vcf_n_reads(
        vcf_path, ref_fasta, bam, vcfout, read_group=None,
        chunk_size=100000, pad=25, dpsp=True):
    """Annotate a VCF with read depth and allele support.

    Adds DP/DPS from pileup counts and (when ``dpsp``) DPSP/SR/SC/AR
    from SW alignment of region-spanning reads against padded ref/alt
    haplotypes (reference ``vcf.py:1158-1301``).
    """
    from medaka_tpu_torch.features import CountsFeatureEncoder, FEATLEN
    from medaka_tpu_torch.io.fastx import FastaReader

    logger = common.get_named_logger('Annotate')
    vcf = VCFReader(vcf_path)
    vcf.index()
    fasta = FastaReader(ref_fasta)

    ann_meta = [
        MetaInfo('INFO', 'DP', 1, 'Integer',
                 'Depth of reads at position, calculated from read '
                 'pileup, capped to ~8000.'),
        MetaInfo('INFO', 'DPS', 2, 'Integer',
                 'Depth of reads at position by strand (fwd, rev), '
                 'calculated from read pileup, capped to ~8000 total.'),
        MetaInfo('INFO', 'DPSP', 1, 'Integer',
                 'Depth of reads spanning pos +-{}. '.format(pad) +
                 'This is not capped as in the case of DP and DPS.'),
        MetaInfo('INFO', 'SR', '.', 'Integer',
                 'Depth of spanning reads by strand which best align to '
                 'each allele (ref fwd, ref rev, alt1 fwd, alt1 rev, '
                 'etc.). This is not capped as in the case of DP and '
                 'DPS.'),
        MetaInfo('INFO', 'AR', 2, 'Integer',
                 'Depth of ambiguous spanning reads by strand which '
                 'align equally well to all alleles (fwd, rev). '
                 'This is not capped as in the case of DP and DPS.'),
        MetaInfo('INFO', 'SC', '.', 'Integer',
                 'Total alignment score to each allele of spanning reads '
                 'by strand (ref fwd, ref rev, alt1 fwd, alt1 rev, etc.) '
                 'aligned with match {}, mismatch -{}, open {}, '
                 'extend {}'.format(
                     _ANN_MATCH, _ANN_MISMATCH,
                     _ANN_GAP_OPEN + _ANN_GAP_EXTEND, _ANN_GAP_EXTEND)),
    ]
    encoder = CountsFeatureEncoder(
        read_group=read_group, normalise='fwd_rev')
    feature_indices = encoder.feature_indices.items()

    chrom_regions = []
    for chrom in vcf.chroms:
        chr_var = list(vcf.fetch(ref_name=chrom))
        chrom_regions.append(common.Region(
            chrom, chr_var[0].pos, chr_var[-1].pos + 1))

    meta_info = vcf.meta + [str(m) for m in ann_meta]
    with VCFWriter(
            vcfout, 'w', version='4.1', contigs=vcf.chroms,
            meta_info=meta_info) as writer:
        chunks = itertools.chain.from_iterable(
            # fixed_size would re-anchor the final chunk to overlap its
            # neighbour, double-writing every variant in the overlap
            r.split(size=chunk_size, overlap=0, fixed_size=False)
            for r in chrom_regions)
        ref_seq = None
        ref_chrom = None
        for chunk in chunks:
            variants = [
                v for v in vcf.fetch(chunk.ref_name, chunk.start, chunk.end)
                # overlap-semantics fetch returns a boundary-spanning
                # record in both chunks; its START assigns it uniquely
                if chunk.start <= v.pos < chunk.end]
            if not variants:
                continue
            logger.info('Processing %s.', chunk)
            chrom = variants[0].chrom
            if chrom != ref_chrom:  # fetch each chromosome once
                ref_seq = fasta.fetch(chunk.ref_name).upper()
                ref_chrom = chrom
            trimmed = common.Region(
                chrom, variants[0].pos, variants[-1].pos + 1)
            pileup = encoder._pileup_function(trimmed, bam)

            # merge discontiguous pileup blocks, padding gaps with zeros
            merged = []
            prev_pos = variants[0].pos - 1
            for counts, positions in pileup:
                if len(positions) == 0:
                    continue
                next_pos = positions['major'][0]
                if next_pos != prev_pos + 1:
                    merged.append(np.zeros(
                        (next_pos - prev_pos - 1, FEATLEN), dtype=int))
                merged.append(counts[positions['minor'] == 0])
                prev_pos = positions['major'][-1]
            tail = variants[-1].pos - prev_pos
            if tail > 0:
                merged.append(np.zeros((tail, FEATLEN), dtype=int))
            merged = np.concatenate(merged) if merged else np.zeros(
                (trimmed.size, FEATLEN), dtype=int)

            first_pos = variants[0].pos
            for v in variants:
                count = merged[v.pos - first_pos]
                dt_depth = {False: 0, True: 0}
                for (_dt, is_rev), inds in feature_indices:
                    # accumulate over datatypes (one per (dt, strand))
                    dt_depth[is_rev] += int(np.sum(count[inds]))
                v.info['DP'] = int(np.sum(count))
                v.info['DPS'] = '{},{}'.format(
                    dt_depth[False], dt_depth[True])
                if dpsp:
                    padded_haps, pad_reg = get_padded_haplotypes(
                        v, ref_seq, pad)
                    reads = _spanning_reads(bam, pad_reg, read_group)
                    counts, scores = align_reads_to_haps(
                        reads, padded_haps)
                    v.info['DPSP'] = sum(counts.values())
                    sr, sc = [], []
                    for hap in range(1 + len(v.alt)):
                        for is_rev in (False, True):
                            sr.append(counts[(is_rev, hap)])
                            sc.append(scores[(is_rev, hap)])
                    v.info['SR'] = ','.join(map(str, sr))
                    v.info['SC'] = ','.join(map(str, sc))
                    v.info['AR'] = '{},{}'.format(
                        counts[(False, None)], counts[(True, None)])
                writer.write_variant(v)
    return vcfout
