"""Deterministic synthetic BAM + draft for tests and on-card runs.

A copy of ``simulate_synth_read``/``create_synth_bam`` from
``tests/mock_data.py`` that writes through the port's own ``io``.
"""
from __future__ import annotations

import numpy as np

from medaka_tpu_torch.io.bam import BamRecord, write_bam
from medaka_tpu_torch.io.fastx import FastaWriter

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


def create_synth_bam(path, ref_mb=2.0, depth=30, seed=42, read_len=20000):
    """Write a deterministic synthetic long-read BAM + draft fasta.

    Byte-identical to ``tests/mock_data.create_synth_bam`` for the same
    arguments. Returns ``(bam_path, ref_fasta_path)``.
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
        seq, cigar = simulate_synth_read(ref_arr, start, read_len, rng)
        records.append(BamRecord.build(
            query_name="r{}".format(i), ref_id=0, pos=start, seq=seq,
            qual=np.full(len(seq), 20, np.uint8), cigar=cigar,
            flag=16 if i % 2 else 0, mapq=60))
    write_bam(path, records, [("synth", ref_len)])
    return path, ref_fasta


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
