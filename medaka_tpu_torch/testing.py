"""Deterministic synthetic BAM + draft for tests and on-card runs.

A copy of ``simulate_synth_read``, ``simulate_dwell_read`` and
``create_synth_bam`` from ``tests/mock_data.py`` that writes through the
port's own ``io``. ``create_synth_bam(move_tables=True)`` writes reads
with dwell-correlated errors and their ``mv`` move tables, for the
read-level models that take dwells. :func:`create_truth_bam` writes the
truth-to-draft BAM of the synthetic genome that labelled ``features``
need (the counterpart of ``tests/mock_data.create_truth_bam``).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from medaka_tpu_torch.io.bam import BamRecord, write_bam
from medaka_tpu_torch.io.fastx import FastaReader, FastaWriter

_SYNTH_BASES = np.frombuffer(b"ACGT", np.uint8)


def simulate_synth_read(ref_arr, start, length, rng):
    """Vectorised ~96%-identity long-read simulation.

    Events per reference base: 96% match, 2% substitution, 1% insertion
    (inserted base precedes the kept reference base), 1% deletion.
    Returns ``(seq, cigar)`` with an exact =/X/I/D cigar.
    """
    piece = ref_arr[start:start + length]
    ev = rng.choice(4, size=len(piece), p=[0.96, 0.02, 0.01, 0.01])
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

    # cigar op stream: 0 '=', 1 'X', 2 'D', 3 'I' (ins expands to I,=)
    n_ops = np.where(is_ins, 2, 1)
    opslot = np.concatenate(([0], np.cumsum(n_ops)[:-1]))
    opstream = np.empty(int(n_ops.sum()), np.int8)
    opstream[opslot] = np.where(
        is_ins, 3, np.where(ev == 1, 1, np.where(ev == 3, 2, 0)))
    opstream[opslot[is_ins] + 1] = 0
    run_starts = np.concatenate(
        ([0], np.flatnonzero(np.diff(opstream)) + 1))
    run_lens = np.diff(np.concatenate((run_starts, [opstream.size])))
    sym = "=XDI"
    cigar = "".join(
        "{}{}".format(ln, sym[opstream[s]])
        for ln, s in zip(run_lens, run_starts))
    return out.tobytes().decode(), cigar


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
