"""Deterministic synthetic BAM + draft for tests and on-card runs.

A copy of ``simulate_synth_read``, ``simulate_dwell_read`` and
``create_synth_bam`` from ``tests/mock_data.py`` that writes through the
port's own ``io``. ``create_synth_bam(move_tables=True)`` writes reads
with dwell-correlated errors and their ``mv`` move tables, for the
read-level models that take dwells. :func:`create_truth_bam` writes the
truth-to-draft BAM of the synthetic genome that labelled ``features``
need (the counterpart of ``tests/mock_data.create_truth_bam``).
:func:`create_variant_bam` writes reads of a genome with planted
variants (haploid, or two haplotypes), aligned to the reference without
a mapper, with the truth VCF; :func:`score_vcf` scores a called VCF
against it (``plant_variants`` and ``score_vcf`` are copies of
``tests/perf/train_campaign.py``'s). :func:`write_reads_fastq` writes the
reads of either BAM as FASTQ in basecalled orientation, for the paths
that start from reads and map them (``align``, ``consensus``,
``variant``), and :func:`placement` holds a mapped BAM to the reads' true
starts. :func:`write_basecaller_fastq` and :func:`write_basecaller_bam`
write the basecaller metadata ``models.model_from_basecaller`` reads
(FASTQ comments in both of dorado's forms, ``@RG`` ``DS`` fields). For
the workflows: :func:`write_subreads_fasta` writes the grouped subreads
of random molecules that ``smolecule`` reads, and :func:`create_str_bam`
the reads of a diploid genome with planted tandem repeats (HP/PS-tagged
or not, some below ``tandem``'s MAPQ floor), whose ``tandem`` VCF
:func:`str_genotypes` scores.

The reference's file formats, written without h5py or medaka (the stub
``medaka.*`` classes they pickle are those of
``tests/test_models.py``'s reference checkpoint):
:func:`write_reference_checkpoint` (``weights.pt`` and a pickled
``meta.pkl``, modern or with the legacy ``build_model_torch`` partial),
:func:`write_reference_probabilities` (gzip-1 samples and pickled
``meta/``, the layout ``tests/crossstack/run_reference.py`` prepares),
and :func:`create_mock_fast5` with :func:`plant_fast5_tables` (fast5
run-length tables, gzip-chunked compound datasets as ONT writes them)
and :func:`write_sam`.
"""
from __future__ import annotations

import contextlib
import functools
import io
import os
import pickle
import sys
import tarfile
import types
from typing import Dict, Optional

import numpy as np

from medaka_tpu_torch import common
from medaka_tpu_torch import vcf as vcf_mod
from medaka_tpu_torch.io.bam import BamReader, BamRecord, write_bam
from medaka_tpu_torch.io.fastx import FastaReader, FastaWriter

_SYNTH_BASES = np.frombuffer(b"ACGT", np.uint8)


def _synth_read_ops(ref_arr, start, length, rng, error=None):
    """The read of :func:`simulate_synth_read` as (uint8 bases, op stream
    of its alignment: one op a step, 0 '=', 1 'X', 2 'D', 3 'I').
    ``error``: the share of reference bases with an event (half of them
    substitutions, a quarter each insertions and deletions); 4% when
    None."""
    piece = ref_arr[start:start + length]
    p = ([0.96, 0.02, 0.01, 0.01] if error is None
         else [1 - error, error / 2, error / 4, error / 4])
    ev = rng.choice(4, size=len(piece), p=p)
    is_ins = ev == 2
    # bases emitted per event: ins -> 2 (insert + ref), del -> 0, else 1
    n_out = np.where(is_ins, 2, np.where(ev == 3, 0, 1))
    slot = np.concatenate(([0], np.cumsum(n_out)[:-1]))
    out = np.empty(int(n_out.sum()), np.uint8)
    keeps = ev != 3
    out[slot[keeps] + is_ins[keeps]] = piece[keeps]
    subs = np.flatnonzero(ev == 1)
    if subs.size:
        out[slot[subs]] = _SYNTH_BASES[
            (np.searchsorted(_SYNTH_BASES, piece[subs])
             + rng.integers(1, 4, subs.size)) % 4]
    ins = np.flatnonzero(is_ins)
    if ins.size:
        out[slot[ins]] = _SYNTH_BASES[rng.integers(0, 4, ins.size)]

    # op stream: 0 '=', 1 'X', 2 'D', 3 'I' (ins expands to I,=)
    n_ops = np.where(is_ins, 2, 1)
    opslot = np.concatenate(([0], np.cumsum(n_ops)[:-1]))
    opstream = np.empty(int(n_ops.sum()), np.int8)
    opstream[opslot] = np.where(
        is_ins, 3, np.where(ev == 1, 1, np.where(ev == 3, 2, 0)))
    opstream[opslot[is_ins] + 1] = 0
    return out, opstream


def _cigar_text(opstream) -> str:
    """=/X/D/I cigar text of an op stream (0 '=', 1 'X', 2 'D', 3 'I')."""
    run_starts = np.concatenate(
        ([0], np.flatnonzero(np.diff(opstream)) + 1))
    run_lens = np.diff(np.concatenate((run_starts, [opstream.size])))
    sym = "=XDI"
    return "".join(
        "{}{}".format(ln, sym[opstream[s]])
        for ln, s in zip(run_lens, run_starts))


def simulate_synth_read(ref_arr, start, length, rng):
    """Vectorised ~96%-identity long-read simulation.

    Events per reference base: 96% match, 2% substitution, 1% insertion
    (inserted base precedes the kept reference base), 1% deletion.
    Returns ``(seq, cigar)`` with an exact =/X/I/D cigar.
    """
    out, opstream = _synth_read_ops(ref_arr, start, length, rng)
    return out.tobytes().decode(), _cigar_text(opstream)


def _move_table(dwells, stride: int) -> np.ndarray:
    """``mv`` tag values: [stride, one flag per stride, 1 starting each
    base]."""
    mv = np.zeros(1 + int(np.sum(dwells)), np.int8)
    mv[0] = stride
    mv[1 + np.cumsum([0] + list(dwells[:-1]))] = 1
    return mv


def simulate_dwell_read(ref_arr, start, length, rng, stride=5):
    """ONT-like read whose errors are dwell-correlated, plus its mv tag.

    A copy of ``tests/mock_data.simulate_dwell_read`` (the same random
    draws in the same order) that also returns the read's exact cigar:
    per-base dwell ~ 1 + Geometric(0.45) capped at 12; substitution
    probability 10% at dwell 1, 4% at dwell 2, else 0.6%; deletions 4% at
    dwell 1; insertions 0.4% with dwell 1.

    :returns: (seq str, mv int8 ndarray, =/X/I/D cigar str) in the
        reference's orientation.
    """
    piece = ref_arr[start:start + length]
    dwell = np.minimum(1 + rng.geometric(0.45, len(piece)), 12)
    fast = dwell == 1
    mid = dwell == 2
    p_sub = np.where(fast, 0.10, np.where(mid, 0.04, 0.006))
    p_del = np.where(fast, 0.04, 0.0)
    p_ins = 0.004
    u = rng.random(len(piece))
    ev = np.zeros(len(piece), np.int8)          # 0 match
    ev[u < p_sub + p_del + p_ins] = 2           # 2 ins (after base)
    ev[u < p_sub + p_del] = 3                   # 3 del
    ev[u < p_sub] = 1                           # 1 sub
    out_bases = []
    out_dwell = []
    ops = []
    for i in range(len(piece)):
        e = ev[i]
        if e == 3:
            ops.append("D")
            continue
        base = piece[i]
        if e == 1:
            base = _SYNTH_BASES[
                (np.searchsorted(_SYNTH_BASES, base)
                 + rng.integers(1, 4)) % 4]
        ops.append("X" if e == 1 else "=")
        out_bases.append(base)
        out_dwell.append(dwell[i])
        if e == 2:
            out_bases.append(_SYNTH_BASES[rng.integers(0, 4)])
            out_dwell.append(1)
            ops.append("I")
    seq = np.asarray(out_bases, np.uint8).tobytes().decode()
    cigar, run = [], 0
    for k, op in enumerate(ops):
        run += 1
        if k + 1 == len(ops) or ops[k + 1] != op:
            cigar.append("{}{}".format(run, op))
            run = 0
    return seq, _move_table(out_dwell, stride), "".join(cigar)


def create_synth_bam(path, ref_mb=2.0, depth=30, seed=42, read_len=20000,
                     move_tables=False):
    """Write a deterministic synthetic long-read BAM + draft fasta.

    Byte-identical to ``tests/mock_data.create_synth_bam`` for the same
    arguments when ``move_tables`` is False. With ``move_tables`` the
    reads come from :func:`simulate_dwell_read` and carry ``mv`` tags in
    basecalled orientation (reversed for reverse-strand reads). Returns
    ``(bam_path, ref_fasta_path)``.
    """
    rng = np.random.default_rng(seed)
    ref_len = int(ref_mb * 1e6)
    ref_arr = _SYNTH_BASES[rng.integers(0, 4, ref_len)]
    ref_fasta = path + ".ref.fasta"
    with FastaWriter(ref_fasta) as fw:
        fw.write("synth", ref_arr.tobytes().decode())
    n_reads = int(ref_len * depth / read_len)
    records = []
    for i in range(n_reads):
        start = int(rng.integers(0, ref_len - read_len))
        tags = None
        if move_tables:
            seq, mv, cigar = simulate_dwell_read(ref_arr, start, read_len,
                                                 rng)
            if i % 2:
                moves = np.append(np.flatnonzero(mv[1:] == 1), len(mv) - 1)
                mv = _move_table(np.diff(moves)[::-1], int(mv[0]))
            tags = {"mv": mv}
        else:
            seq, cigar = simulate_synth_read(ref_arr, start, read_len, rng)
        records.append(BamRecord.build(
            query_name="r{}".format(i), ref_id=0, pos=start, seq=seq,
            qual=np.full(len(seq), 20, np.uint8), cigar=cigar,
            flag=16 if i % 2 else 0, mapq=60, tags=tags))
    write_bam(path, records, [("synth", ref_len)])
    return path, ref_fasta


def md_tag(truth: str, draft: str) -> str:
    """The MD tag of ``truth`` aligned gaplessly to ``draft`` (same length):
    match runs, with the draft's base named at each mismatch."""
    if len(truth) != len(draft):
        raise ValueError("truth and draft differ in length")
    t = np.frombuffer(truth.encode(), np.uint8)
    d = np.frombuffer(draft.encode(), np.uint8)
    parts, last = [], 0
    for pos in np.flatnonzero(t != d):
        parts.append("{}{}".format(pos - last, draft[pos]))
        last = pos + 1
    parts.append(str(len(draft) - last))
    return "".join(parts)


def create_truth_bam(path, ref_fasta,
                     substitutions: Optional[Dict[str, Dict[int, str]]] = None,
                     draft_fasta: Optional[str] = None):
    """Write a truth-to-draft BAM for the synthetic genome in ``ref_fasta``.

    One primary record per contig: the genome as SEQ, CIGAR ``<L>M`` at
    position 0, mapping quality 60 and an MD tag. ``substitutions`` plants
    draft errors ({contig: {position: draft base}}): the draft then
    differs from the truth there, the MD tag names the draft's bases, and
    ``draft_fasta`` (when given) receives the planted draft. Reads
    simulated from the genome stay aligned to the same coordinates.

    :returns: ``path``.
    """
    substitutions = substitutions or {}
    records, refs, drafts = [], [], []
    with FastaReader(ref_fasta) as fr:
        for tid, name in enumerate(fr.references):
            truth = fr.fetch(name)
            draft = bytearray(truth.encode())
            for pos, base in substitutions.get(name, {}).items():
                if base == truth[pos]:
                    raise ValueError(
                        "substitution at {}:{} keeps the base {}".format(
                            name, pos, base))
                draft[pos] = ord(base)
            draft = draft.decode()
            refs.append((name, len(truth)))
            drafts.append((name, draft))
            records.append(BamRecord.build(
                query_name="truth_{}".format(name), ref_id=tid, pos=0,
                seq=truth, qual=np.full(len(truth), 60, np.uint8),
                cigar="{}M".format(len(truth)), mapq=60,
                tags={"MD": md_tag(truth, draft)}))
    write_bam(path, records, refs)
    if draft_fasta is not None:
        with FastaWriter(draft_fasta) as fw:
            for name, seq in drafts:
                fw.write(name, seq)
    return path


def greedy_edit_count(a, b, look: int = 16, reach: int = 8) -> int:
    """An upper bound on the edit distance of two similar sequences.

    A greedy walk builds one alignment: at each mismatch it takes the
    smallest skip (up to ``reach`` positions in either sequence) after
    which ``look`` characters agree (else 4, where edits crowd), counting
    the larger of the two skips, and otherwise counts a substitution.
    Every step is a valid alignment step, so the count bounds the edit
    distance from above; it is exact where edits are isolated.
    """
    i = j = n = 0
    skips = sorted(((di, dj) for di in range(reach + 1)
                    for dj in range(reach + 1) if di or dj),
                   key=lambda s: (max(s), s[0] + s[1]))
    while i < len(a) and j < len(b):
        if a[i] == b[j]:
            i, j = i + 1, j + 1
            continue
        step = next(
            ((di, dj) for width in (look, 4) for di, dj in skips
             if a[i + di:i + di + width] == b[j + dj:j + dj + width]),
            (1, 1))
        n += max(step)
        i, j = i + step[0], j + step[1]
    return n + (len(a) - i) + (len(b) - j)


def apply_edits(ref_seq, edits):
    """Apply non-overlapping (pos, ref, alt) edits (VCF-style anchors)."""
    out, cur = [], 0
    for pos, ref, alt in sorted(edits):
        out.append(ref_seq[cur:pos])
        out.append(alt)
        cur = pos + len(ref)
    out.append(ref_seq[cur:])
    return "".join(out)


def plant_variants(ref_seq, rng, diploid=False, spacing=250):
    """Plant isolated variants; returns (hap_seqs, records).

    Records are dicts {pos (0-based), ref, alt, gt}: SNPs and 1-3 bp
    insertions and deletions when haploid (GT 1), het (0/1, on one
    haplotype) and hom (1/1) SNPs when diploid. A minimum separation of 60
    bp keeps truth records independent, so normalized exact-match scoring
    is unambiguous.
    """
    L = len(ref_seq)
    records = []
    p = 100
    while True:
        p += 60 + int(rng.integers(0, max(1, 2 * spacing - 60)))
        if p >= L - 120:
            break
        base = ref_seq[p]
        r = rng.random()
        if diploid or r < 0.6:  # SNV
            alt = str(rng.choice([b for b in "ACGT" if b != base]))
            ref, altseq = base, alt
        elif r < 0.8:  # insertion, 1-3 bp
            ins = "".join(rng.choice(list("ACGT"),
                                     size=int(rng.integers(1, 4))))
            ref, altseq = base, base + ins
        else:  # deletion, 1-3 bp
            dlen = int(rng.integers(1, 4))
            ref, altseq = ref_seq[p:p + 1 + dlen], base
        if diploid:
            gt = "0/1" if rng.random() < 0.5 else "1/1"
        else:
            gt = "1"
        records.append({"pos": p, "ref": ref, "alt": altseq, "gt": gt})
    if diploid:
        # assign each het record to one haplotype
        het_hap = {
            id(rec): int(rng.integers(0, 2))
            for rec in records if rec["gt"] == "0/1"}
        haps = []
        for h in (0, 1):
            edits = [
                (rec["pos"], rec["ref"], rec["alt"]) for rec in records
                if rec["gt"] == "1/1" or het_hap[id(rec)] == h]
            haps.append(apply_edits(ref_seq, edits))
    else:
        haps = [apply_edits(
            ref_seq, [(r["pos"], r["ref"], r["alt"]) for r in records])]
    return haps, records


def _hap_columns(ref_len, edits):
    """The alignment of a haplotype to the reference as columns (ref
    position, haplotype position), -1 where a side has no base: matched
    runs, a planted SNP's mismatch, an insertion's haplotype-only columns
    after its anchor and a deletion's reference-only ones. Returns (ref
    positions, haplotype positions, the column of each haplotype
    position)."""
    refs, haps = [], []
    r = h = 0
    for pos, ref, alt in sorted(edits):
        run = pos + 1 - r                 # up to and including the anchor
        refs.append(np.arange(r, r + run))
        haps.append(np.arange(h, h + run))
        r, h = r + run, h + run
        ins, dels = len(alt) - 1, len(ref) - 1
        if ins:
            refs.append(np.full(ins, -1))
            haps.append(np.arange(h, h + ins))
            h += ins
        if dels:
            refs.append(np.arange(r, r + dels))
            haps.append(np.full(dels, -1))
            r += dels
    refs.append(np.arange(r, ref_len))
    haps.append(np.arange(h, h + ref_len - r))
    col_hap = np.concatenate(haps)
    return np.concatenate(refs), col_hap, np.flatnonzero(col_hap >= 0)


def lift_read(columns, ref_arr, start, bases, ops):
    """A read simulated from a haplotype aligned to the reference instead.

    ``bases`` (uint8) and ``ops`` (its alignment to the haplotype from
    haplotype position ``start``, one op a step: 0 '=', 1 'X', 2 'D', 3
    'I') are composed with the haplotype's alignment to the reference
    (``columns``, :func:`_hap_columns`): a read base on a planted
    insertion's haplotype-only column becomes ``I``, a planted deletion's
    reference-only column ``D``. Read bases before the first and after the
    last aligned base are dropped.

    :returns: (reference start, uint8 read bases, =/X/I/D cigar text).
    """
    col_ref, col_hap, col_of_hap = columns
    ops = np.asarray(ops)
    on_read = ops != 2
    on_hap = ops != 3
    q = np.cumsum(on_read) - on_read          # read index of each op
    h = np.cumsum(on_hap) - on_hap            # haplotype index (from start)
    # along the haplotype: the read base at each position (-1: deleted in
    # the read), and the read bases inserted just before it
    at = np.where(ops[on_hap] == 2, -1, q[on_hap])
    n_hap = len(at)
    is_ins = ops == 3
    before = np.bincount(h[is_ins], minlength=n_hap + 1)[:n_hap]
    first_ins = np.full(n_hap + 1, -1)
    ins_at = h[is_ins]
    # the first inserted read base of each run (the ops are in read order)
    runs = np.flatnonzero(np.r_[True, ins_at[1:] != ins_at[:-1]]) \
        if ins_at.size else np.zeros(0, np.int64)
    first_ins[ins_at[runs]] = q[is_ins][runs]
    # the columns of the read's haplotype span
    lo = int(col_of_hap[start])
    hi = int(col_of_hap[start + n_hap - 1]) + 1
    cref, chap = col_ref[lo:hi], col_hap[lo:hi]
    has_hap = chap >= 0
    idx = chap[has_hap] - start
    read = np.full(len(chap), -1)
    read[has_hap] = at[idx]
    n_before = np.zeros(len(chap), np.int64)
    n_before[has_hap] = before[idx]
    ins_first = np.full(len(chap), -1)
    ins_first[has_hap] = first_ins[idx]
    # each column expands to its inserted read bases, then itself
    width = n_before + 1
    first = np.cumsum(width) - width
    n = int(width.sum())
    out_ref = np.full(n, -1)
    out_read = np.full(n, -1)
    own = first + n_before
    out_ref[own] = cref
    out_read[own] = read
    grp = np.flatnonzero(n_before)
    k = n_before[grp]
    offs = np.arange(int(k.sum())) - np.repeat(np.cumsum(k) - k, k)
    out_read[np.repeat(first[grp], k) + offs] = np.repeat(
        ins_first[grp], k) + offs
    keep = (out_ref >= 0) | (out_read >= 0)
    out_ref, out_read = out_ref[keep], out_read[keep]
    both = np.flatnonzero((out_ref >= 0) & (out_read >= 0))
    out_ref = out_ref[both[0]:both[-1] + 1]
    out_read = out_read[both[0]:both[-1] + 1]
    bases = np.asarray(bases)
    new_ops = np.where(out_read < 0, 2, np.where(out_ref < 0, 3, 0))
    aligned = new_ops == 0
    new_ops[aligned] = np.where(
        bases[out_read[aligned]] == ref_arr[out_ref[aligned]], 0, 1)
    return (int(out_ref[0]), bases[out_read[0]:out_read[-1] + 1],
            _cigar_text(new_ops))


def write_truth_vcf(path, contig, contig_len, records):
    """The planted records as a VCF (QUAL 70, PASS, their GT)."""
    variants = [
        vcf_mod.Variant(
            contig, rec["pos"], rec["ref"], rec["alt"], qual=70.0,
            filt="PASS", genotype_data={"GT": rec["gt"]})
        for rec in records]
    with vcf_mod.VCFWriter(
            path, "w", version="4.1",
            contigs=["{},length={}".format(contig, contig_len)]) as vw:
        vw.write_variants(variants, sort=True)


def create_variant_bam(path, ref_mb=0.5, depth=30, seed=0, diploid=False,
                       read_len=3000, contig="synth"):
    """Reads of a genome with planted variants, aligned to the reference.

    A random reference of ``ref_mb`` Mb gets isolated variants
    (:func:`plant_variants`: SNPs and 1-3 bp indels, or het and hom SNPs
    on two haplotypes when ``diploid``); reads of ``read_len`` bases are
    simulated from the haplotypes with :func:`simulate_synth_read`, split
    evenly between them (and, apart from that, between the strands), and
    written sorted with their alignments lifted onto the reference
    (:func:`lift_read`).

    :returns: (bam path, reference FASTA, truth VCF, planted records).
    """
    rng = np.random.default_rng(seed)
    ref_len = int(ref_mb * 1e6)
    ref_arr = _SYNTH_BASES[rng.integers(0, 4, ref_len)]
    ref_seq = ref_arr.tobytes().decode()
    haps, records = plant_variants(ref_seq, rng, diploid=diploid)
    # the records each haplotype carries: all of them when haploid; the
    # diploid ones are SNPs, so a haplotype carries those whose alt it
    # holds at the record's own position
    columns = [_hap_columns(ref_len, [
        (r["pos"], r["ref"], r["alt"]) for r in records
        if not diploid or hap[r["pos"]] == r["alt"]]) for hap in haps]
    ref_fasta = path + ".ref.fasta"
    with FastaWriter(ref_fasta) as fw:
        fw.write(contig, ref_seq)
    truth_vcf = path + ".truth.vcf"
    write_truth_vcf(truth_vcf, contig, ref_len, records)
    n_reads = int(ref_len * depth / read_len)
    reads = []
    for i in range(n_reads):
        h = (i // 2) % len(haps)
        hap_arr = np.frombuffer(haps[h].encode(), np.uint8)
        length = min(read_len, len(hap_arr) - 1)
        start = int(rng.integers(0, len(hap_arr) - length))
        bases, ops = _synth_read_ops(hap_arr, start, length, rng)
        pos, bases, cigar = lift_read(columns[h], ref_arr, start, bases, ops)
        reads.append((pos, i, bases.tobytes().decode(), cigar))
    records_out = [BamRecord.build(
        query_name="r{}".format(i), ref_id=0, pos=pos, seq=seq,
        qual=np.full(len(seq), 20, np.uint8), cigar=cigar,
        flag=16 if i % 2 else 0, mapq=60) for pos, i, seq, cigar
        in sorted(reads)]
    write_bam(path, records_out, [(contig, ref_len)])
    return path, ref_fasta, truth_vcf, records


def write_subreads_fasta(path, n_molecules=64, length=1500, n_subreads=10,
                         error=0.08, seed=0):
    """Grouped subreads of random molecules, as the ``smolecule`` workflow
    reads them: records ``mol<m>_<i>``, the subreads of one molecule
    together, every other one reverse-complemented, each with errors at
    a share ``error`` of the molecule's bases (half substitutions, a
    quarter each insertions and deletions). Molecule lengths vary by up
    to 10% around ``length``.

    :returns: {molecule name: true sequence}.
    """
    rng = np.random.default_rng(seed)
    truth = {}
    with open(path, "w") as fh:
        for m in range(n_molecules):
            size = int(length * rng.uniform(0.9, 1.1))
            mol = _SYNTH_BASES[rng.integers(0, 4, size)]
            name = "mol{}".format(m)
            truth[name] = mol.tobytes().decode()
            for i in range(n_subreads):
                bases, _ops = _synth_read_ops(mol, 0, size, rng, error)
                seq = bases.tobytes().decode()
                if i % 2:
                    seq = common.reverse_complement(seq)
                fh.write(">{}_{}\n{}\n".format(name, i, seq))
    return truth


#: the kinds of locus :func:`create_str_bam` plants, in turn: the alleles
#: of haplotypes 1 and 2 in repeat units added to (+) or taken from (-)
#: the reference's array; "del" takes the whole array from both
STR_KINDS = (("hom_ref", (0, 0)), ("hom_exp", (6, 6)),
             ("het_exp", (0, 8)), ("het_con", (-5, 0)), ("del", None))


def create_str_bam(path, n_loci=24, depth=20, seed=0, read_len=3000,
                   spacing=1500, error=0.02, low_mapq=0.1, contig="chr1"):
    """Reads of a diploid genome with short tandem repeats, aligned to the
    reference, for the ``tandem`` workflow.

    Every ``spacing`` bases a locus holds an array of 10-16 copies of a
    random 2-4 base motif. Each locus gets the next kind of
    :data:`STR_KINDS`: homozygous reference, homozygous expansion, a
    heterozygous expansion, a heterozygous contraction, or the array
    deleted on both haplotypes. Reads of ``read_len`` bases come from
    both haplotypes (``depth`` a haplotype) with errors at a share
    ``error`` (:func:`_synth_read_ops`), on both strands, their alignments
    lifted onto the reference (:func:`lift_read`). Reads that start in
    the first half of the genome carry ``HP`` (their haplotype) and ``PS``
    tags; the others carry none, so ``--phasing hybrid`` takes its
    prephased branch on the first half's loci and falls back to de-novo
    clustering on the last loci. A share ``low_mapq`` of the reads has
    MAPQ 2, below ``tandem``'s default ``--min_mapq`` 5.

    :returns: (bam path, reference FASTA, loci): each locus a dict of its
        ``region`` (``common.Region`` of the reference's array), ``kind``,
        ``ref`` (the array), ``alleles`` (the two haplotypes' arrays),
        ``gt`` (``"0/0"``, ``"1/1"`` or ``"0/1"``) and ``phased``: True
        when every read over the locus is tagged, False when none is,
        None when some are.
    """
    rng = np.random.default_rng(seed)
    ref_len = (n_loci + 1) * spacing
    ref_arr = _SYNTH_BASES[rng.integers(0, 4, ref_len)].copy()
    loci, edits = [], ([], [])
    for k in range(n_loci):
        kind, units = STR_KINDS[k % len(STR_KINDS)]
        motif = _SYNTH_BASES[rng.integers(0, 4, int(rng.integers(2, 5)))]
        while len(set(motif.tolist())) == 1:
            motif = _SYNTH_BASES[rng.integers(0, 4, len(motif))]
        copies = int(rng.integers(10, 17))
        start = (k + 1) * spacing
        array = np.tile(motif, copies)
        ref_arr[start:start + len(array)] = array
        # the bases either side of the array must not extend it
        while ref_arr[start + len(array)] == motif[0]:
            ref_arr[start + len(array)] = _SYNTH_BASES[rng.integers(0, 4)]
        while ref_arr[start - 1] == motif[-1]:
            ref_arr[start - 1] = _SYNTH_BASES[rng.integers(0, 4)]
        ref = array.tobytes().decode()
        mseq = motif.tobytes().decode()
        alleles = []
        for h in (0, 1):
            n = 0 if units is None else copies + units[h]
            alleles.append(mseq * n)
        loci.append({"region": common.Region(contig, start,
                                             start + len(array)),
                     "kind": kind, "ref": ref, "alleles": tuple(alleles),
                     "gt": ("0/0" if alleles == [ref, ref]
                            else "1/1" if alleles[0] == alleles[1]
                            else "0/1"),
                     "phased": (True if start < ref_len // 2 else
                                False if start >= ref_len // 2
                                + 1.2 * read_len else None)})
    ref_seq = ref_arr.tobytes().decode()
    for locus in loci:
        start = locus["region"].start
        anchor = ref_seq[start - 1]
        for h in (0, 1):
            allele = locus["alleles"][h]
            if allele == locus["ref"]:
                continue
            # VCF-style: the base before the array anchors the edit
            if len(allele) > len(locus["ref"]):
                grow = allele[:len(allele) - len(locus["ref"])]
                edits[h].append((start - 1, anchor, anchor + grow))
            else:
                cut = len(locus["ref"]) - len(allele)
                edits[h].append((start - 1, anchor + ref_seq[
                    start:start + cut], anchor))
    haps = [apply_edits(ref_seq, e) for e in edits]
    columns = [_hap_columns(ref_len, e) for e in edits]
    ref_fasta = path + ".ref.fasta"
    with FastaWriter(ref_fasta) as fw:
        fw.write(contig, ref_seq)
    n_reads = int(ref_len * depth / read_len)
    reads = []
    for i in range(2 * n_reads):
        h = i % 2
        hap_arr = np.frombuffer(haps[h].encode(), np.uint8)
        length = min(read_len, len(hap_arr) - 1)
        hstart = int(rng.integers(0, len(hap_arr) - length))
        bases, ops = _synth_read_ops(hap_arr, hstart, length, rng, error)
        pos, bases, cigar = lift_read(columns[h], ref_arr, hstart, bases,
                                      ops)
        tags = {"HP": h + 1, "PS": 1000} if pos < ref_len // 2 else {}
        mapq = 2 if rng.random() < low_mapq else 60
        flag = 16 if (i // 2) % 2 else 0
        reads.append((pos, i, bases.tobytes().decode(), cigar, tags, mapq,
                      flag))
    records = [BamRecord.build(
        query_name="r{}".format(i), ref_id=0, pos=pos, seq=seq,
        qual=np.full(len(seq), 20, np.uint8), cigar=cigar, flag=flag,
        mapq=mapq, tags=tags)
        for pos, i, seq, cigar, tags, mapq, flag in sorted(
            reads, key=lambda r: (r[0], r[1]))]
    write_bam(path, records, [(contig, ref_len)])
    return path, ref_fasta, loci


def str_genotypes(vcf_path, loci):
    """How the records of a ``tandem`` VCF (replacement style) recover
    :func:`create_str_bam`'s loci: {locus index: (planted gt, called gt,
    planted alleles' lengths, called alleles' lengths)} over the loci
    with a record; a called gt is unphased ("1|0" reads "0/1")."""
    from medaka_tpu_torch.vcf import VCFReader
    by_pos = {locus["region"].start: (i, locus)
              for i, locus in enumerate(loci)}
    out = {}
    for var in VCFReader(vcf_path, cache=False).fetch():
        if var.pos not in by_pos:
            continue
        i, locus = by_pos[var.pos]
        gt = var.genotype_data["GT"].replace("|", "/").split("/")
        alts = var.alt if isinstance(var.alt, list) else [var.alt]
        seqs = [var.ref] + alts
        # "." (no alt) and a missing haplotype read as the reference;
        # "<DEL>" as the array deleted
        called = sorted(
            len(var.ref) if g == "." or seqs[int(g)] == "."
            else 0 if seqs[int(g)] == "<DEL>" else len(seqs[int(g)])
            for g in gt)
        norm = "/".join(sorted("0" if g in ("0", ".") else "1"
                               for g in gt))
        out[i] = (locus["gt"], norm,
                  sorted(len(a) for a in locus["alleles"]), called)
    return out


def write_reads_fastq(bam, fastq):
    """Write the reads of a BAM of :func:`create_synth_bam` or
    :func:`create_variant_bam` as FASTQ, in the order of the BAM, each in
    its basecalled orientation (reverse-strand reads reverse-complemented
    back, their qualities reversed).

    :param fastq: a path, or a list of paths to deal the reads over in
        turn (read sets of one genome, as ``consensus_joint`` takes).
    :returns: {read name: (true reference start, is reverse)}.
    """
    paths = [fastq] if isinstance(fastq, str) else list(fastq)
    truth = {}
    handles = [open(path, "w") for path in paths]
    try:
        with BamReader(bam) as reader:
            for i, rec in enumerate(reader):
                seq = rec.query_sequence
                qual = rec.query_qualities
                if rec.is_reverse:
                    seq = common.reverse_complement(seq)
                    qual = qual[::-1]
                handles[i % len(handles)].write("@{}\n{}\n+\n{}\n".format(
                    rec.query_name, seq, (qual + 33).tobytes().decode()))
                truth[rec.query_name] = (rec.pos, rec.is_reverse)
    finally:
        for fh in handles:
            fh.close()
    return truth


def write_basecaller_fastq(path, basecallers, n_reads=8, read_len=200,
                           seed=0, fmt="version_id"):
    """Write a FASTQ of random reads whose comments name basecaller
    models, for ``models.model_from_basecaller``: read i names
    ``basecallers[i % len(basecallers)]`` as dorado writes it, either
    ``basecall_model_version_id=<model>`` (``fmt="version_id"``) or in a
    read-group tag ``RG:Z:<runid>_<model>_<barcode>`` (``fmt="rg"``).
    An empty ``basecallers`` writes comments that name none."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as fh:
        for i in range(n_reads):
            seq = _SYNTH_BASES[rng.integers(0, 4, read_len)].tobytes()
            comment = "runid=4f2e{:04d}".format(seed)
            if basecallers:
                name = basecallers[i % len(basecallers)]
                comment += (
                    " basecall_model_version_id={}".format(name)
                    if fmt == "version_id" else
                    " RG:Z:4f2e{:04d}_{}_barcode{:02d}".format(
                        seed, name, i % 4))
            fh.write("@read{} {}\n{}\n+\n{}\n".format(
                i, comment, seq.decode(), "5" * read_len))
    return path


def write_basecaller_bam(src, dst, basecallers, max_records=200):
    """Write a BAM of the first ``max_records`` records of ``src`` whose
    header has one ``@RG`` line a basecaller model, its ``DS`` field
    ``runid=... basecall_model=<model>`` as dorado writes it (an empty
    ``basecallers`` writes one ``@RG`` without a model), each record
    tagged with the first read group."""
    with BamReader(src) as reader:
        references = list(zip(reader.references, reader.lengths))
        records = []
        for rec in reader:
            if len(records) >= max_records:
                break
            records.append(rec)
    lines = ["@HD\tVN:1.6\tSO:coordinate"] + [
        "@SQ\tSN:{}\tLN:{}".format(n, l) for n, l in references]
    groups = []
    for i, name in enumerate(basecallers or [None]):
        rg = "4f2e_rg{}".format(i)
        groups.append(rg)
        ds = "runid=4f2e" + (
            " basecall_model={}".format(name) if name else "")
        lines.append("@RG\tID:{}\tDS:{}\tSM:sample".format(rg, ds))
    from medaka_tpu_torch.io.bam import record_with_tag
    write_bam(dst, [record_with_tag(r, "RG", groups[0]) for r in records],
              references, header_text="\n".join(lines) + "\n")
    return dst


def placement(bam, truth, slack=50):
    """How a mapped BAM places the reads of :func:`write_reads_fastq`.

    :returns: (share of the reads of ``truth`` with a primary record,
        [(name, true start and strand, mapped start and strand)] of the
        primaries more than ``slack`` bases from the true start or on the
        other strand).
    """
    primaries = {}
    with BamReader(bam) as reader:
        for rec in reader:
            if rec.query_name in truth and not rec.flag & (4 | 256 | 2048):
                primaries[rec.query_name] = (rec.pos, rec.is_reverse)
    wrong = [(name, truth[name], got) for name, got in primaries.items()
             if got[1] != truth[name][1]
             or abs(got[0] - truth[name][0]) > slack]
    return len(primaries) / len(truth), wrong


def _norm_vcf(path, ref_seqs):
    """{(chrom, pos, ref, alt): zygosity} of normalized records."""
    out = {}
    for var in vcf_mod.VCFReader(path).fetch():
        norm = var.normalize(ref_seqs[var.chrom])
        gt = norm.gt
        zyg = "hom"
        if gt is not None and len(set(gt)) > 1:
            zyg = "het"
        for alt in norm.alt:
            if alt in (".", norm.ref):
                continue
            out[(norm.chrom, norm.pos, norm.ref, alt)] = zyg
    return out


def score_vcf(truth_vcf, called_vcf, ref_fasta):
    """SNP/indel precision/recall/F1 + genotype concordance of the
    normalized records of ``called_vcf`` against ``truth_vcf``."""
    with FastaReader(ref_fasta) as fa:
        ref_seqs = {name: fa.fetch(name).upper() for name in fa.references}
    truth = _norm_vcf(truth_vcf, ref_seqs)
    called = _norm_vcf(called_vcf, ref_seqs)

    def kind(key):
        _, _, ref, alt = key
        return "snp" if len(ref) == 1 and len(alt) == 1 else "indel"

    res = {}
    for k in ("snp", "indel"):
        t = {key for key in truth if kind(key) == k}
        c = {key for key in called if kind(key) == k}
        if not t and not c:
            continue
        tp, fp, fn = len(t & c), len(c - t), len(t - c)
        prec = tp / max(1, tp + fp)
        rec = tp / max(1, tp + fn)
        f1 = 2 * prec * rec / max(1e-9, prec + rec)
        res[k] = {"tp": tp, "fp": fp, "fn": fn,
                  "precision": round(prec, 4), "recall": round(rec, 4),
                  "f1": round(f1, 4)}
    matched = set(truth) & set(called)
    gt_truth_known = [k for k in matched if truth[k] in ("het", "hom")]
    if gt_truth_known and any(called[k] for k in gt_truth_known):
        agree = sum(
            1 for k in gt_truth_known if called[k] == truth[k])
        res["gt_concordance"] = round(agree / len(gt_truth_known), 4)
    return res


#: the least P/R/F1 (and genotype concordance) that variant and SNP calling
#: must reach on :func:`create_variant_bam` genomes at depth 30 with the
#: bundled models (``gru256_variant_demo`` and ``vcf``;
#: ``gru256_diploid_snp_demo`` and ``snp``, then ``snp --het_rescue 0.1``),
#: fixed on the CPU path (tests/test_torch_variant.py) and held on the card
#: by ``chip_smoke.py``
VARIANT_FLOORS = {
    "haploid": {"snp": {"precision": 0.90, "recall": 0.95, "f1": 0.93},
                "indel": {"precision": 0.85, "recall": 0.95, "f1": 0.90}},
    "diploid": {"snp": {"precision": 0.90, "recall": 0.85, "f1": 0.88},
                "gt_concordance": 0.80},
    "diploid_rescue": {"snp": {"precision": 0.88, "recall": 0.93,
                               "f1": 0.90}},
}


#: the least P/R/F1 of the paths from reads, on :func:`create_variant_bam`
#: haploid genomes at depth 30 whose reads (:func:`write_reads_fastq`) are
#: mapped by the port: ``variant --model gru256_variant_demo`` (the
#: annotated VCF), and ``consensus --model gru256_variant_demo`` on the same
#: mapped reads followed by ``tools consensus2vcf --mode NW``; fixed on the
#: CPU path (tests/test_torch_consensus.py) and held on the card by
#: ``chip_smoke.py`` phase 21
FROM_READS_FLOORS = {
    "variant": {"snp": {"precision": 0.90, "recall": 0.95, "f1": 0.93},
                "indel": {"precision": 0.85, "recall": 0.95, "f1": 0.90}},
    "consensus2vcf": {"snp": {"precision": 0.90, "recall": 0.95, "f1": 0.93},
                      "indel": {"precision": 0.85, "recall": 0.95,
                                "f1": 0.90}},
}


def below_floors(score, floors):
    """[(metric, value, floor)] of a :func:`score_vcf` result that fall
    below ``floors`` (an entry of :data:`VARIANT_FLOORS`); a kind with no
    record at all falls below every floor of its kind."""
    out = []
    for key, floor in floors.items():
        if isinstance(floor, dict):
            for metric, least in floor.items():
                value = score.get(key, {}).get(metric, 0.0)
                if value < least:
                    out.append(("{}.{}".format(key, metric), value, least))
        elif score.get(key, 0.0) < floor:
            out.append((key, score.get(key, 0.0), floor))
    return out


# ---------------------------------------------------------------------------
# The reference's file formats
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _fake_medaka():
    """``medaka``, ``medaka.features``, ``medaka.labels`` and
    ``medaka.models`` as empty modules in ``sys.modules`` (restored
    after), so that pickling stand-ins names them as medaka does."""
    names = ("medaka", "medaka.features", "medaka.labels", "medaka.models")
    saved = {n: sys.modules.get(n) for n in names}
    for n in names:
        sys.modules[n] = types.ModuleType(n)
    try:
        yield {n: sys.modules[n] for n in names}
    finally:
        for n, mod in saved.items():
            if mod is None:
                del sys.modules[n]
            else:
                sys.modules[n] = mod


def _medaka_object(module, obj):
    """A stand-in for reference medaka's ``obj`` (a feature encoder or
    label scheme of the port): an instance of a class of ``module`` with
    the same name whose ``__dict__`` holds ``obj``'s constructor
    arguments, as a pickled medaka object carries them."""
    name = type(obj).__name__
    cls = getattr(module, name, None)
    if cls is None:
        cls = type(name, (), {"__module__": module.__name__})
        cls.__qualname__ = name
        setattr(module, name, cls)
    inst = cls.__new__(cls)
    inst.__dict__.update(obj.to_dict().get("kwargs", {}))
    return inst


def _medaka_function(module, name):
    def fn(*args, **kwargs):
        raise AssertionError("a stand-in of medaka." + name)
    fn.__module__, fn.__qualname__, fn.__name__ = module.__name__, name, name
    setattr(module, name, fn)
    return fn


def reference_meta_pickle(model=None, feature_encoder=None,
                          label_scheme=None, legacy=False) -> bytes:
    """The pickled meta {model_function, feature_encoder, label_scheme}
    of a reference checkpoint, or of one ``meta/`` item when only
    ``label_scheme`` or ``feature_encoder`` is given with no model:
    the modern ``partial(model_from_dict, model.to_dict())`` or, with
    ``legacy``, ``partial(build_model_torch, num_features, num_classes,
    gru_size)`` (a 2-layer bidirectional ``GRUModel`` only)."""
    with _fake_medaka() as mods:
        meta = {}
        if model is not None:
            d = model.to_dict()
            if legacy:
                kw = d["kwargs"]
                if d["type"] != "GRUModel" or kw.get("n_layers", 2) != 2 \
                        or not kw.get("bidirectional", True):
                    raise ValueError("the legacy build_model_torch partial "
                                     "builds a 2-layer bidirectional "
                                     "GRUModel, not {}".format(d))
                meta["model_function"] = functools.partial(
                    _medaka_function(mods["medaka.models"],
                                     "build_model_torch"),
                    kw["num_features"], kw["num_classes"], kw["gru_size"])
            else:
                meta["model_function"] = functools.partial(
                    _medaka_function(mods["medaka.models"],
                                     "model_from_dict"), d)
        if feature_encoder is not None:
            meta["feature_encoder"] = _medaka_object(
                mods["medaka.features"], feature_encoder)
        if label_scheme is not None:
            meta["label_scheme"] = _medaka_object(
                mods["medaka.labels"], label_scheme)
        if model is None and len(meta) == 1:
            meta = next(iter(meta.values()))
        return pickle.dumps(meta)


def write_reference_checkpoint(bundle, path: str, legacy: bool = False):
    """Write ``bundle`` (a ``models.ModelBundle``) as a reference medaka
    checkpoint: ``model/weights.pt`` (the torch state dict,
    ``model.torch_state()``) and ``model/meta.pkl``
    (:func:`reference_meta_pickle`). Returns ``path``."""
    import torch

    meta = reference_meta_pickle(bundle.model, bundle.feature_encoder,
                                 bundle.label_scheme, legacy=legacy)
    weights = io.BytesIO()
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in bundle.model.torch_state().items()}, weights)
    with tarfile.open(path, "w:gz") as tar:
        for name, data in (("model/weights.pt", weights.getvalue()),
                           ("model/meta.pkl", meta)):
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))
    return path


def write_reference_probabilities(src: str, dst: str) -> str:
    """Rewrite the probability (or feature) file ``src`` as reference
    medaka stores one: every sample's arrays gzip-1, the metadata only
    as pickles under ``meta/`` (its label scheme and feature encoder), no
    JSON metadata and no registry. Returns ``dst``."""
    from medaka_tpu_torch import datastore
    from medaka_tpu_torch.io import hdf5

    with datastore.DataStore(src) as ds:
        names = sorted(ds.sample_registry)
        meta = dict(ds.meta)
        with datastore.DataStore(dst, "w", compression="gzip") as out:
            for name in names:
                out.write_sample(ds.load_sample(name))
    with hdf5.File(dst, "a") as fh:
        for key in ("label_scheme", "feature_encoder"):
            if meta.get(key) is not None:
                fh["meta/" + key] = np.bytes_(
                    reference_meta_pickle(**{key: meta[key]}))
    return dst


#: the fast5 dataset of a read's run-length basecall
FAST5_TABLE = ("read_{}/Analyses/{}/BaseCalled_template/"
               "RunlengthBasecall")


def create_mock_fast5(path: str, reads, analysis: str = "Basecall_1D_000"):
    """Write a multi-read fast5 of run-length tables.

    :param reads: (read_id, compact basecall, shape, scale) each, in read
        (basecalled) orientation.
    :returns: ``path``.

    Each table is a compound ``(base S1, shape f4, scale f4)`` dataset,
    gzip-1 chunked, under ``read_<id>/Analyses/<analysis>/
    BaseCalled_template/RunlengthBasecall``.
    """
    from medaka_tpu_torch.io import hdf5

    with hdf5.File(path, "w") as fh:
        for read_id, call, shape, scale in reads:
            table = np.zeros(len(call), dtype=[("base", "S1"), ("shape",
                                                "<f4"), ("scale", "<f4")])
            table["base"] = np.frombuffer(call.encode(), "S1")
            table["shape"] = shape
            table["scale"] = scale
            fh.create_dataset(FAST5_TABLE.format(read_id, analysis), table,
                              compression="gzip")
    return path


def plant_fast5_tables(bam: str, fast5: str, summary: str, seed: int = 0,
                       region=None) -> Dict[str, tuple]:
    """Plant random Weibull (shape, scale) tables for the primary reads
    of ``bam`` (in ``region``, a ``common.Region``, or all) in the fast5
    ``fast5`` and a sequencing summary naming it.

    :returns: read id -> (shape, scale) as ``compress_bam
        --use_fast5_info`` should tag the read: WL the shape, WK the
        scale, in alignment orientation.
    """
    from medaka_tpu_torch.rle import RLEConverter

    rng = np.random.default_rng(seed)
    reads, planted = [], {}
    with BamReader(bam) as reader:
        records = reader.fetch(region.ref_name, region.start, region.end) \
            if region is not None else iter(reader)
        for rec in records:
            if rec.flag & (4 | 256 | 2048) or rec.query_name in planted:
                continue
            call = RLEConverter(rec.query_sequence).compact_basecall
            shape = rng.uniform(0.5, 8.0, len(call)).astype(np.float32)
            scale = rng.uniform(0.5, 3.0, len(call)).astype(np.float32)
            planted[rec.query_name] = (shape, scale)
            if rec.flag & 16:
                call = common.reverse_complement(call)
                shape, scale = shape[::-1], scale[::-1]
            reads.append((rec.query_name, call, shape, scale))
    create_mock_fast5(fast5, reads)
    with open(summary, "w") as fh:
        fh.write("read_id\tfilename\n")
        for read_id, *_ in reads:
            fh.write("{}\t{}\n".format(read_id, os.path.basename(fast5)))
    return planted


def write_sam(bam: str, sam: str, region=None) -> str:
    """The records of ``bam`` (in ``region`` or all) as SAM text with its
    @SQ header lines; returns ``sam``."""
    with BamReader(bam) as reader, open(sam, "w") as out:
        for name, length in zip(reader.references, reader.lengths):
            out.write("@SQ\tSN:{}\tLN:{}\n".format(name, length))
        records = reader.fetch(region.ref_name, region.start, region.end) \
            if region is not None else iter(reader)
        for rec in records:
            quals = rec.query_qualities
            out.write("\t".join(map(str, (
                rec.query_name, rec.flag, reader.references[rec.ref_id],
                rec.pos + 1, rec.mapq, rec.cigarstring, "*", 0, 0,
                rec.query_sequence, "*" if quals is None else
                "".join(chr(q + 33) for q in quals)))) + "\n")
    return sam
