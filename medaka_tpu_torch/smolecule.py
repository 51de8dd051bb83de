"""Single-molecule (repetitive subread) consensus.

Counterpart of ``medaka_tpu/smolecule.py`` (the reference's ``medaka
smolecule``, ``medaka/smolecule.py``): subreads of each molecule are
oriented by local-alignment score, assembled twice with POA (interleaving
+ and - subreads) by the native ``poa.cpp``, re-aligned to their consensus,
and the per-molecule pileups polished with the network (``prediction.predict``
+ ``stitch.stitch_to_fasta`` with gap filling off). The network runs on the
GPU unless ``device="cpu"`` is given: at the default ``batch_size=32``
every batch is padded to 32 rows, so a 2-layer bi-GRU bundle takes the
split kernels in mode "rows" (``ops/gru_split.split_mode``).
"""
from __future__ import annotations

import concurrent.futures
import os
from collections import namedtuple
from timeit import default_timer as now
from typing import Iterator, List, Optional

import numpy as np

from medaka_tpu_torch import align as align_mod
from medaka_tpu_torch import common, native
from medaka_tpu_torch.io.bam import write_bam
from medaka_tpu_torch.io.fastx import read_fastx

Subread = namedtuple("Subread", "name seq")
Alignment = namedtuple("Alignment", "rname qname flag rstart seq cigar")


class Read:
    """Subread container for one molecule (reference
    ``smolecule.py:23-321``)."""

    def __init__(self, name: str, subreads: List[Subread]):
        """:param subreads: at least one subread."""
        if not subreads:
            raise ValueError("Cannot create a read with no subreads.")
        self.name = name
        self.subreads = subreads
        self.consensus = subreads[0].seq
        self._orient: Optional[List[bool]] = None
        self._initialized = False
        self.consensus_run = False

    @classmethod
    def from_fastx(cls, fastx: str, name: Optional[str] = None) -> "Read":
        """One Read from all records of a fasta/q file."""
        try:
            return next(cls.multi_from_fastx(
                fastx, take_all=True, read_id=name))
        except StopIteration:
            raise IOError(
                "Could not create Read from file {}.".format(fastx))

    @classmethod
    def multi_from_fastx(
            cls, fastx: str, take_all: bool = False,
            read_id: Optional[str] = None, depth_filter: int = 1,
            length_filter: int = 0) -> Iterator["Read"]:
        """Reads from a fasta/q; subreads named ``<read>_<subread>``."""
        logger = common.get_named_logger("FastReader")
        depth_filter = max(1, depth_filter)
        if take_all and read_id is None:
            read_id = os.path.splitext(os.path.basename(fastx))[0]
        elif not take_all:
            read_id = None
        subreads: List[Subread] = []

        def flush():
            if len(subreads) >= depth_filter:
                med = np.median([len(s.seq) for s in subreads])
                if med > length_filter:
                    return cls(read_id, list(subreads))
                logger.debug("Read %s has too short subreads.", read_id)
            else:
                logger.debug("Read %s has too few subreads.", read_id)
            return None

        for entry in read_fastx(fastx):
            if not take_all:
                cur = entry.name.split("_")[0]
                if read_id is None:
                    read_id = cur
                elif cur != read_id:
                    out = flush()
                    if out is not None:
                        yield out
                    read_id = cur
                    subreads = []
            if entry.sequence:
                subreads.append(Subread(entry.name, entry.sequence))
        out = flush()
        if out is not None:
            yield out

    @property
    def seqs(self) -> List[str]:
        """Subread sequences."""
        return [s.seq for s in self.subreads]

    @property
    def nseqs(self) -> int:
        """Number of subreads."""
        return len(self.subreads)

    @property
    def interleaved_subreads(self):
        """(orientations, subreads) with +/- strands interleaved."""
        self.initialize()
        fwd, rev = [], []
        for orient, subread in zip(self._orient, self.subreads):
            (fwd if orient else rev).append([subread, orient, 0.0])
        for group in (fwd, rev):
            if group:
                rate = 1.0 / len(group)
                for i, item in enumerate(group):
                    item[2] = rate * i
        ordered = sorted(fwd + rev, key=lambda x: x[2])
        reads, orients, _keys = zip(*ordered)
        return orients, reads

    def initialize(self):
        """Determine subread orientations against the scaffold."""
        if not self._initialized:
            self.orient_subreads()
            self._initialized = True

    @staticmethod
    def _sw(query, ref):
        return native.align(
            query, ref, mode="sw", match=2, mismatch=4, gap_open=8,
            gap_extend=4)

    def orient_subreads(self) -> List[Alignment]:
        """Orient subreads by forward/reverse SW score
        (reference ``smolecule.py:228-256``)."""
        self._orient = []
        alignments = []
        for sr in self.subreads:
            rc = common.reverse_complement(sr.seq)
            fwd = self._sw(sr.seq, self.consensus)
            bwd = self._sw(rc, self.consensus)
            is_fwd = fwd.score > bwd.score
            self._orient.append(is_fwd)
            result = fwd if is_fwd else bwd
            seq = sr.seq if is_fwd else rc
            if (result.ref_start >= result.ref_end
                    or result.query_start >= result.query_end):
                continue
            rstart, cigar = align_mod.local_to_sam(result, seq)
            alignments.append(Alignment(
                "consensus_{}".format(self.name), sr.name,
                0 if is_fwd else 16, rstart, seq, cigar))
        return alignments

    def poa_consensus(self) -> str:
        """One POA round over oriented, interleaved subreads."""
        self.initialize()
        seqs = []
        if self.consensus_run:
            seqs.append(self.consensus)
        for orient, subread in zip(*self.interleaved_subreads):
            seqs.append(
                subread.seq if orient
                else common.reverse_complement(subread.seq))
        self.consensus = native.poa_consensus(seqs)
        self.consensus_run = True
        return self.consensus

    def align_to_template(self, template: str,
                          template_name: str) -> List[Alignment]:
        """SW-align subreads to a template (reference
        ``smolecule.py:258-285``)."""
        self.initialize()
        alignments = []
        for orient, sr in zip(self._orient, self.subreads):
            seq = sr.seq if orient else common.reverse_complement(sr.seq)
            result = self._sw(seq, template)
            if (result.ref_start >= result.ref_end
                    or result.query_start >= result.query_end):
                continue
            rstart, cigar = align_mod.local_to_sam(result, seq)
            alignments.append(Alignment(
                template_name, sr.name, 0 if orient else 16, rstart, seq,
                cigar))
        return alignments


def write_alignments_bam(fname, alignments, references):
    """Write molecule alignments (list-of-lists) to a sorted BAM."""
    ref_ids = {name: i for i, (name, _len) in enumerate(references)}
    records = []
    for group in alignments:
        if group is None:
            continue
        for aln in group:
            records.append(align_mod.initialise_alignment(
                aln.qname, ref_ids[aln.rname], aln.rstart, aln.seq,
                aln.cigar, aln.flag))
    return write_bam(fname, records, references)


def _read_worker(read: Read):
    read.initialize()
    if read.nseqs > 2:
        for _ in range(2):
            read.poa_consensus()
    aligns = read.align_to_template(read.consensus, read.name)
    return read.name, read.consensus, aligns


def poa_workflow(reads, threads: int = 1):
    """POA all molecules; returns (references, consensuses, alignments)."""
    logger = common.get_named_logger("POAManager")
    references = []
    consensuses = []
    alignments = []

    def safe_worker(read):
        try:
            return _read_worker(read)
        except Exception as e:  # pragma: no cover - per-read resilience
            logger.warning("Read failed: %s", e)
            return None

    with concurrent.futures.ThreadPoolExecutor(threads) as ex:
        for res in ex.map(safe_worker, reads):
            if res is None:
                continue
            rname, consensus, aligns = res
            if consensus:
                references.append((rname, len(consensus)))
                consensuses.append((rname, consensus))
                alignments.append(aligns)
    logger.info(
        "Created %d consensus with %d alignments.",
        len(consensuses), len(alignments))
    return references, consensuses, alignments


def smolecule(
        fastx_inputs, output_dir: str, model=None, feature_encoder=None,
        label_scheme=None, model_path=None, threads: int = 1,
        depth: int = 3, length: int = 400, chunk_len: int = 1000,
        chunk_ovlp: int = 500, batch_size: int = 32,
        qualities: bool = False, save_features: bool = False,
        check_output: bool = False, device=None, devices=None):
    """Run the full smolecule workflow (reference
    ``smolecule.py:432-516``).

    :param fastx_inputs: one file of grouped subreads, or many files of
        one molecule each.
    :param model: a model holding its weights, with its
        ``feature_encoder`` and ``label_scheme``; or ``model_path``.
    :param device: "cuda" (every visible GPU, the default), "cuda:i" or
        "cpu", when ``devices`` is None; resolved before any host stage,
        so that a run without a GPU raises at once.
    :param devices: one model replica an entry (``prediction.predict``).
    :returns: path of the consensus fasta/fastq written.
    """
    from medaka_tpu_torch import datastore, parallel, prediction, stitch

    logger = common.get_named_logger("Smolecule")
    if chunk_ovlp >= chunk_len:
        raise ValueError(
            "chunk_ovlp {} must be smaller than chunk_len {}".format(
                chunk_ovlp, chunk_len))
    devices = parallel.resolve_devices(devices, device)
    os.makedirs(output_dir, exist_ok=True)
    if isinstance(fastx_inputs, str):
        fastx_inputs = [fastx_inputs]
    if len(fastx_inputs) > 1:
        logger.info("Assuming one molecule per input file.")

        def reads():
            for fname in fastx_inputs:
                try:
                    yield Read.from_fastx(fname)
                except Exception as e:
                    logger.warning(
                        "Skipping input %s: %s", fname, e)
        read_iter = reads()
    else:
        read_iter = Read.multi_from_fastx(
            fastx_inputs[0], depth_filter=depth, length_filter=length)

    t0 = now()
    references, consensuses, alignments = poa_workflow(
        read_iter, threads)
    t1 = now()

    bam_file = os.path.join(output_dir, "subreads_to_poa.bam")
    write_alignments_bam(bam_file, alignments, references)
    poa_file = os.path.join(output_dir, "poa.fasta")
    with open(poa_file, "w") as fh:
        for rname, cons in consensuses:
            fh.write(">{}\n{}\n".format(rname, cons))

    logger.info("Running neural consensus.")
    t2 = now()
    probs_file = os.path.join(output_dir, "consensus.hdf")
    prediction.predict(
        bam_file, probs_file, model=model, model_path=model_path,
        feature_encoder=feature_encoder, label_scheme=label_scheme,
        chunk_len=chunk_len, chunk_overlap=chunk_ovlp,
        batch_size=batch_size, save_features=save_features,
        devices=devices)
    if check_output and not datastore.DataIndex(probs_file).samples:
        raise RuntimeError(
            "Probability file {} contains no samples.".format(probs_file))
    t3 = now()

    out_ext = "fastq" if qualities else "fasta"
    out_file = os.path.join(output_dir, "consensus." + out_ext)
    stitch.stitch_to_fasta(
        probs_file, poa_file, out_file, fillgaps=False,
        qualities=qualities)
    logger.info("Consensus sequences written to %s.", out_file)
    logger.info(
        "POA time: %.0fs, neural time: %.0fs", t1 - t0, t3 - t2)
    return out_file
