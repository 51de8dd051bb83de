"""Per-region consensus generation for tandem genotyping.

Counterpart of ``medaka_tpu/tandem/generator.py`` (the reference's
``medaka/tandem/consensus_generator.py`` + ``polisher.py`` +
``alignment.py``): spanning reads are clustered into
haplotypes, each haplotype gets a POA consensus, subreads are re-aligned
(global) to their consensus into ``trimmed_reads_to_poa.bam``, the POA
drafts are polished with the neural network, and the polished consensus
is globally re-aligned to the reference into ``medaka_to_ref.bam``.

Parallelism: thread pool over regions (the hot work is native
POA/alignment which releases the GIL), replacing the reference's
``multiprocessing.Pool(maxtasksperchild=1)`` + temp-dir file merge
(``consensus_generator.py:474-727``).
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import os
import threading
from typing import Dict, List, Optional, Tuple

from medaka_tpu_torch import align as align_mod
from medaka_tpu_torch import common, native
from medaka_tpu_torch.io.bam import write_bam
from medaka_tpu_torch.io.fastx import FastaReader, read_fastx
from medaka_tpu_torch.smolecule import Alignment, Subread
from medaka_tpu_torch.tandem.clustering import SpanningReadClusterer
from medaka_tpu_torch.tandem.io_utils import SpanningReadsExtractor
from medaka_tpu_torch.tandem.record_name import RecordName


class InsufficientCoverage(Exception):
    """Raised for regions with too few reads."""


@dataclasses.dataclass
class ConsensusResult:
    """A per-haplotype POA consensus with subread alignments."""

    rec: RecordName
    subreads: tuple
    consensus_seq: str = ""
    consensus_alignments: tuple = dataclasses.field(default_factory=tuple)
    exception: Optional[Exception] = None


class ConsensusGenerator:
    """Drive spanning reads -> clusters -> POA -> polish -> ref bam."""

    def __init__(self, regions: List[RecordName], bam: str, ref: str,
                 reads_clusterer: SpanningReadClusterer, min_depth: int,
                 reads_filter: Dict, output_prefix: str,
                 process_large_regions: bool = False, model=None,
                 model_bundle=None, workers: int = 1, devices=None):
        """See the reference constructor for parameter meanings."""
        self.regions = regions
        self.bam_reader = SpanningReadsExtractor(bam, reads_filter)
        self.ref = ref
        self.reads_clusterer = reads_clusterer
        self.min_depth = min_depth
        self.process_large_regions = process_large_regions
        self.output_prefix = output_prefix
        self.max_region_size = 10000
        self.workers = max(1, workers)
        self.logger = common.get_named_logger("ConsensusGenerator")
        self.min_mapq = reads_filter.get("min_mapq", 0)
        self.model = model
        self.model_bundle = model_bundle
        self.devices = devices
        self._lock = threading.Lock()

        op = output_prefix
        self.poa_file = os.path.join(op, "poa.fasta")
        self.trimmed_reads_file = os.path.join(op, "trimmed_reads.fasta")
        self.skipped_bed_file = os.path.join(op, "skipped.bed")
        self.skipped_large_file = os.path.join(op, "skipped_large.bed")
        self.trimmed_to_poa_bam = os.path.join(
            op, "trimmed_reads_to_poa.bam")
        self.cons_to_ref_bam = os.path.join(op, "medaka_to_ref.bam")
        self.polished_consensus = os.path.join(op, "consensus.fasta")
        self.metrics: Dict[str, List[dict]] = {
            "prephased": [], "abpoa": [], "unphased": []}
        self._poa_records: List[Tuple[str, str]] = []
        self._subread_records: List[Subread] = []
        self._alignments: List[List[Alignment]] = []
        self._skipped: List[str] = []
        self._skipped_large: List[str] = []

    # -- per-region work ---------------------------------------------------

    def get_subreads(self, rec: RecordName) -> List[Subread]:
        """Spanning subreads, honouring depth/size skips."""
        sub_reads = self.bam_reader.get_subreads(rec)
        if len(sub_reads) < self.min_depth:
            self.logger.info(
                "%s: Retrieved too few reads (%d < %d).", rec,
                len(sub_reads), self.min_depth)
            self._skipped.append("{}\t{}\t{}\t{}".format(
                rec.ref_name, rec.ref_start, rec.ref_end, rec))
            return []
        if not self.process_large_regions:
            longest = max(len(r.seq) for r in sub_reads)
            if longest > self.max_region_size:
                self.logger.info(
                    "%s: region of length %d > %d skipped.", rec,
                    longest, self.max_region_size)
                self._skipped_large.append("{}\t{}\t{}\t{}".format(
                    rec.ref_name, rec.ref_start, rec.ref_end, rec))
                return []
        return sub_reads

    def consensus_from_reads(self, rec: RecordName,
                             subreads: List[Subread]) -> ConsensusResult:
        """POA consensus + global subread re-alignments for one hap."""
        non_empty = [s for s in subreads if s.seq != "N"]
        if len(non_empty) < self.min_depth:
            # reads support full deletion of the array
            res = ConsensusResult(rec, tuple(subreads), "N")
            res.consensus_alignments = tuple(
                Alignment(str(rec), s.name, 0, 0, "N", "1M")
                for s in subreads)
            return res
        non_empty.sort(key=lambda r: (len(r.seq), r.name), reverse=True)
        res = ConsensusResult(rec, tuple(non_empty))
        seqs = []
        for s in res.subreads:
            rn = RecordName.from_str(s.name)
            seqs.append(
                s.seq if rn.strand == "fwd"
                else common.reverse_complement(s.seq))
        res.consensus_seq = native.poa_consensus(seqs)
        # global alignments of subreads to the consensus
        alignments = []
        for s, seq in zip(res.subreads, seqs):
            rn = RecordName.from_str(s.name)
            aln = native.align(
                seq, res.consensus_seq, mode="nw", match=2, mismatch=4,
                gap_open=6, gap_extend=2)
            alignments.append(Alignment(
                str(rec), s.name, 0 if rn.strand == "fwd" else 16,
                0, seq, aln.cigar))
        res.consensus_alignments = tuple(alignments)
        return res

    def _process_region(self, rec: RecordName) -> bool:
        sub_reads = self.get_subreads(rec)
        if not sub_reads:
            return False
        metrics, clustered = self.reads_clusterer.cluster_spanningreads(
            rec, sub_reads)
        method = metrics.get("phasing_method", "unphased")
        row = {"record": str(rec)}
        row.update(metrics)
        results = []
        for record, reads in clustered.items():
            if record.hap == 0:
                continue
            if record.hap == 2 and "_HOM" in record.query_name:
                continue
            if len(reads) < self.min_depth:
                with self._lock:
                    self._skipped.append("{}\t{}\t{}\t{}".format(
                        record.ref_name, record.ref_start,
                        record.ref_end, record))
                continue
            results.append(self.consensus_from_reads(record, reads))
        with self._lock:
            self.metrics.setdefault(method, []).append(row)
            for res in results:
                if not res.consensus_seq:
                    continue
                self._poa_records.append(
                    (str(res.rec), res.consensus_seq))
                self._subread_records.extend(res.subreads)
                self._alignments.append(list(res.consensus_alignments))
        return True

    # -- outputs -----------------------------------------------------------

    def _write_intermediate_outputs(self):
        with open(self.poa_file, "w") as fh:
            for name, seq in self._poa_records:
                fh.write(">{}\n{}\n".format(name, seq))
        with open(self.trimmed_reads_file, "w") as fh:
            for s in self._subread_records:
                fh.write(">{}\n{}\n".format(s.name, s.seq))
        with open(self.skipped_bed_file, "w") as fh:
            fh.write("".join(line + "\n" for line in self._skipped))
        with open(self.skipped_large_file, "w") as fh:
            fh.write("".join(line + "\n" for line in self._skipped_large))
        for method, rows in self.metrics.items():
            path = os.path.join(
                self.output_prefix,
                "{}_region_metrics.txt".format(method))
            with open(path, "w") as fh:
                if not rows:
                    continue
                cols = sorted({k for row in rows for k in row})
                fh.write("\t".join(cols) + "\n")
                for row in rows:
                    fh.write("\t".join(
                        str(row.get(c, "")) for c in cols) + "\n")
        # subreads -> POA bam
        references = [
            (name, len(seq)) for name, seq in self._poa_records]
        records = []
        ref_ids = {name: i for i, (name, _l) in enumerate(references)}
        for group in self._alignments:
            for aln in group:
                if aln.rname not in ref_ids:
                    continue
                records.append(align_mod.initialise_alignment(
                    aln.qname, ref_ids[aln.rname], aln.rstart, aln.seq,
                    aln.cigar, aln.flag))
        write_bam(self.trimmed_to_poa_bam, records, references)

    def polish(self):
        """Neural-polish the POA drafts (reference ``polisher.py``), in
        full precision: the float32 scan, off the kernels, as in
        ``medaka_tpu`` (``models/gru.py`` runs them in bf16 only)."""
        from medaka_tpu_torch import prediction, stitch

        probs = os.path.join(self.output_prefix, "consensus_probs.hdf")
        kwargs = dict(
            batch_size=32, chunk_len=1000, chunk_overlap=250,
            full_precision=True, devices=self.devices)
        if self.model_bundle is not None:
            b = self.model_bundle
            prediction.predict(
                self.trimmed_to_poa_bam, probs, model=b.model,
                feature_encoder=b.feature_encoder,
                label_scheme=b.label_scheme, **kwargs)
        else:
            prediction.predict(
                self.trimmed_to_poa_bam, probs,
                model_path=self.model, **kwargs)
        stitch.stitch_to_fasta(
            probs, self.poa_file, self.polished_consensus,
            fillgaps=True, min_depth=0)

    def align_consensus_to_ref(self):
        """Globally align polished haplotype consensus to the reference
        (reference ``alignment.py:87-114``)."""
        fasta = FastaReader(self.ref)
        references = [
            (name, fasta.get_reference_length(name))
            for name in fasta.references]
        ref_ids = {name: i for i, (name, _l) in enumerate(references)}
        records = []
        for rec in read_fastx(self.polished_consensus):
            rn = RecordName.from_str(rec.name, known_refs=ref_ids)
            # .upper(): soft-masked (RepeatMasker-lowercased) repeat
            # regions would otherwise mismatch every consensus base
            ref_seq = fasta.fetch(rn.ref_name)[
                rn.ref_start_padded:rn.ref_end_padded].upper()
            aln = native.align(
                rec.sequence, ref_seq, mode="nw", match=2, mismatch=4,
                gap_open=6, gap_extend=2)
            if aln.ref_start > 0:
                self.logger.warning(
                    "rstart not 0 for global alignment of %s; consider "
                    "more padding.", rec.name)
            records.append(align_mod.initialise_alignment(
                rec.name, ref_ids[rn.ref_name],
                rn.ref_start_padded + aln.ref_start, rec.sequence,
                aln.cigar, 0, tags={"HP": rn.hap}))
        write_bam(self.cons_to_ref_bam, records, references)

    def process(self) -> int:
        """Process all regions; returns the number processed.

        Regions fail independently (logged and recorded in
        ``self.failed_regions``) — one bad region must not discard the
        completed work of thousands of others (reference collects
        per-job errors the same way,
        ``consensus_generator.py:553-566``).
        """
        self.failed_regions = []

        def isolated(rec):
            try:
                self._process_region(rec)
            except Exception as e:
                self.logger.error("Region %s failed: %s", rec, e)
                self.failed_regions.append((rec, str(e)))

        if self.workers > 1:
            with concurrent.futures.ThreadPoolExecutor(
                    self.workers) as ex:
                list(ex.map(isolated, self.regions))
        else:
            for rec in self.regions:
                isolated(rec)
        if self.failed_regions:
            self.logger.warning(
                "%d of %d regions failed and are absent from the "
                "output.", len(self.failed_regions), len(self.regions))
        self._write_intermediate_outputs()
        if self._poa_records:
            self.polish()
            self.align_consensus_to_ref()
        return len(self.regions) - len(self.failed_regions)
