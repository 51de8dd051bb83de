"""Shared inputs of the read-level test files (no JAX): the synthetic
BAMs both ``test_torch_read_level.py`` and
``test_torch_read_level_model.py`` read."""
import numpy as np

from medaka_tpu_torch import testing
from medaka_tpu_torch.io.bam import BamReader, BamRecord, write_bam


def make_bams(d):
    """A plain synthetic BAM, one with mv move tables, one whose first
    read carries its cigar in a CG tag (the long-cigar convention), in
    the directory ``d``."""
    plain = testing.create_synth_bam(str(d / "plain.bam"), ref_mb=0.01,
                                     depth=10, read_len=2000)
    moves = testing.create_synth_bam(str(d / "moves.bam"), ref_mb=0.01,
                                     depth=10, read_len=2000,
                                     move_tables=True)
    with BamReader(plain[0]) as reader:
        refs = list(zip(reader.references, reader.lengths))
        records = list(reader.fetch("synth", 0, 10000))
    first = records[0]
    seq = "".join("=ACMGRSVTWYHKDBN"[c] for c in first.seq_nt16)
    records[0] = BamRecord.build(
        query_name=first.query_name, ref_id=0, pos=first.pos, seq=seq,
        qual=first.query_qualities,
        cigar="{}S{}N".format(len(seq), first.reference_length),
        flag=first.flag, mapq=first.mapq,
        tags={"CG": (first.cigar_array[:, 1] << 4
                     | first.cigar_array[:, 0]).astype(np.uint32)})
    assert records[0].has_long_cigar
    long_bam = str(d / "long.bam")
    write_bam(long_bam, records, refs)
    return {"plain": plain[0], "moves": moves[0], "long_cigar": long_bam}
