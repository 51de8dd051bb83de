"""Spanning-read clustering into haplotypes.

Counterpart of ``medaka_tpu/tandem/clustering.py`` (the reference's
``medaka/tandem/spanning_read_clusterer.py``). Three strategies behind
the same factory keys:

- ``prephased``/``unphased``: HP/PS BAM tags with dominant-phase-set
  filtering and IQR read-length outlier removal (reference
  ``spanning_read_clusterer.py:104-260``).
- ``abpoa``: de-novo diploid clustering. The reference delegates to
  abPOA's multi-consensus mode; here EM (cluster -> native POA
  consensus -> nearest-consensus reassignment) runs on RLE-compressed
  reads from two initialisations, with abPOA's ``min_freq``-style
  minimum cluster fraction for the het call.
- ``hybrid``: prephased, falling back to de-novo when any haplotype is
  under the depth threshold.
"""
from __future__ import annotations

import abc
import collections
from typing import Dict

import numpy as np

from medaka_tpu_torch import common, native
from medaka_tpu_torch.smolecule import Subread
from medaka_tpu_torch.tandem.record_name import RecordName


class SpanningReadClusterer(abc.ABC):
    """Base class: dispatch on ploidy, delegate diploid clustering."""

    def cluster_spanningreads(self, rec: RecordName, spanning_reads):
        """Cluster reads; returns (metrics dict, {RecordName: reads})."""
        if rec.ploidy == 1:
            new_rec = rec.copy()
            new_rec.hap = 1
            d = self.summarize_reads(
                [s.name for s in spanning_reads], prefix="hap1_")
            d["phasing_method"] = "unphased"
            return d, {new_rec: spanning_reads}
        if rec.ploidy == 2:
            return self._cluster_spanningreads(rec, spanning_reads)
        raise ValueError("Unsupported ploidy: {}".format(rec.ploidy))

    @abc.abstractmethod
    def _cluster_spanningreads(self, rec, spanning_reads):
        ...

    @staticmethod
    def summarize_reads(names, prefix="") -> Dict[str, int]:
        """Counts of reads by strand."""
        records = [RecordName.from_str(n) for n in names]
        counts = collections.Counter()
        for strand in ("fwd", "rev"):
            counts["{}n_reads_{}".format(prefix, strand)] = 0
        counts.update(
            "{}n_reads_{}".format(prefix, r.strand) for r in records)
        counts["{}n_reads".format(prefix)] = len(names)
        return dict(counts)


class PrephasedClusterer(SpanningReadClusterer):
    """Cluster by HP/PS BAM tags."""

    def __init__(self, remove_outliers: bool = True,
                 min_depth_for_outliers: int = 5):
        """:param remove_outliers: IQR read-length filtering."""
        self.remove_outliers = remove_outliers
        self.min_depth_for_outliers = min_depth_for_outliers

    def _cluster_spanningreads(self, rec, spanning_reads):
        spanning_reads, filtered_ps = \
            self._filter_reads_by_dominant_phased_set(spanning_reads)
        by_hap = collections.defaultdict(list)
        ps_by_hap = collections.defaultdict(int)
        for s in spanning_reads:
            rn = RecordName.from_str(s.name)
            by_hap[rn.hap].append(s)
            ps_by_hap[rn.hap] = rn.phased_set

        clustered = {}
        d = {}
        filtered = by_hap[0] + filtered_ps
        for h in (1, 2):
            new_rec = rec.copy()
            new_rec.hap = h
            new_rec.phased_set = ps_by_hap[h]
            reads, outliers = self._remove_outlier_reads(by_hap[h])
            clustered[new_rec] = reads
            filtered += outliers
            d.update(self.summarize_reads(
                [s.name for s in reads], prefix="hap{}_".format(h)))
        new_rec = rec.copy()
        new_rec.hap = 0
        clustered[new_rec] = filtered
        d.update(self.summarize_reads(
            [s.name for s in filtered], prefix="hap0_"))
        d["phasing_method"] = "prephased"
        return d, clustered

    def _remove_outlier_reads(self, reads, multiplier=2):
        if (not self.remove_outliers
                or len(reads) <= self.min_depth_for_outliers):
            return reads, []
        lengths = np.array([len(r.seq) for r in reads])
        q1, q3 = np.percentile(lengths, (25, 75))
        iqr = q3 - q1
        lo, hi = q1 - multiplier * iqr, q3 + multiplier * iqr
        keep = [r for r in reads if lo <= len(r.seq) <= hi]
        drop = [r for r in reads if not lo <= len(r.seq) <= hi]
        return keep, drop

    @staticmethod
    def _filter_reads_by_dominant_phased_set(reads):
        parsed = [RecordName.from_str(r.name) for r in reads]
        counts = collections.Counter(
            rn.phased_set for rn in parsed if rn.hap != 0)
        if not counts:
            return [], []
        dominant = counts.most_common(1)[0][0]
        keep, drop = [], []
        for read, rn in zip(reads, parsed):
            (keep if rn.phased_set == dominant else drop).append(read)
        return keep, drop


class DeNovoClusterer(SpanningReadClusterer):
    """De-novo diploid clustering: EM over POA consensus models.

    Fulfils the role of the reference's ABPOAClusterer
    (``spanning_read_clusterer.py:263-551``), re-expressed for this
    stack: instead of abPOA's order-dependent 2-consensus mode, reads
    are clustered by iterative cluster -> native-POA consensus ->
    nearest-consensus reassignment (EM) on RLE-compressed sequences.
    The reference probes abPOA's read-order dependence by running both
    length orderings and reconciling; here the analogous stability
    probe is running EM from two independent initialisations (central/
    farthest medoid seeds vs farthest-pair seeds) and reconciling the
    fixpoints — reads that change cluster between runs are ambiguous,
    and ``diag_edits``/``edits_ratio`` measure consensus disagreement
    between runs exactly as the reference's asc/dsc comparison does.
    The output metric keys match the reference's TSVs.
    """

    def __init__(self, put_bam_hp_in_name: bool = True,
                 homozygous_frac: float = 0.02, max_em_iters: int = 8,
                 min_cluster_frac: float = 0.3):
        """:param homozygous_frac: consensus separation (fraction of
        length) below which the two clusters merge as homozygous.
        :param min_cluster_frac: minimum fraction of reads a second
        cluster must hold to call heterozygous (the reference passes
        the same ``min_freq=0.3`` to abPOA; without it a single outlier
        read forms a spurious singleton haplotype)."""
        self.put_bam_hp_in_name = put_bam_hp_in_name
        self.homozygous_frac = homozygous_frac
        self.max_em_iters = max_em_iters
        self.min_cluster_frac = min_cluster_frac

    @staticmethod
    def rle_seq(seq: str) -> str:
        """Homopolymer-compress a sequence."""
        return "".join(common.rle(seq)["value"])

    def _cluster_spanningreads(self, rec, subreads):
        d = self._run_clustering(subreads, rec)
        clustered = self._process_clusters(rec, subreads, d)
        d["phasing_method"] = "abpoa"
        return d, clustered

    @staticmethod
    def _cluster_consensus(seqs, members):
        """POA consensus of one cluster ('' for an empty cluster)."""
        picked = [seqs[i] for i in members]
        if not picked:
            return ""
        if len(picked) == 1:
            return picked[0]
        return native.poa_consensus(picked)

    def _em(self, seqs, assign):
        """cluster -> consensus -> reassign until the fixpoint.

        :returns: (assign, (cons0, cons1), d0, d1) with per-read edit
            distances to each cluster consensus.
        """
        n = len(seqs)
        cons = ["", ""]
        d0 = np.zeros(n, dtype=np.int64)
        d1 = np.zeros(n, dtype=np.int64)
        for _ in range(self.max_em_iters):
            for c in (0, 1):
                cons[c] = self._cluster_consensus(
                    seqs, np.flatnonzero(assign == c))
            for i, s in enumerate(seqs):
                d0[i] = native.edit_distance(s, cons[0])
                d1[i] = native.edit_distance(s, cons[1])
            new_assign = np.where(d0 <= d1, 0, 1)
            if np.array_equal(new_assign, assign):
                break
            assign = new_assign
        return assign, tuple(cons), d0.copy(), d1.copy()

    def _run_clustering(self, subreads, rec):
        # oriented, RLE-compressed sequences
        seqs = []
        for s in subreads:
            rn = RecordName.from_str(s.name)
            seq = s.seq if rn.strand == "fwd" else \
                common.reverse_complement(s.seq)
            seqs.append(self.rle_seq(seq))
        n = len(seqs)
        names = [s.name for s in subreads]

        if n < 4:
            # too few for meaningful de-novo split: call homozygous
            return {
                "n_reads": n, "hap1_reads": set(names),
                "hap2_reads": set(), "hap0_reads": set(),
                "is_homozygous": True, "empty_second_cluster": False,
                "n_ambig_reads": 0, "n_unasign_reads": 0,
                "edits_ratio": 0.0, "diag_edits": 0,
                "nreads_cluster_phasing_matches_bhp": None,
                "nreads_cluster_phasing_switched_wrt_bhp": None}

        dist = np.zeros((n, n), dtype=np.int32)
        for i in range(n):
            for j in range(i + 1, n):
                dij = native.edit_distance(seqs[i], seqs[j])
                dist[i, j] = dist[j, i] = dij

        # two independent EM initialisations (stability probe)
        total = dist.sum(1)
        central = int(np.argmin(total))
        far_of_central = int(np.argmax(dist[central]))
        init_a = np.where(
            dist[:, central] <= dist[:, far_of_central], 0, 1)
        fp = int(np.argmax(dist.max(1)))
        fq = int(np.argmax(dist[fp]))
        init_b = np.where(dist[:, fp] <= dist[:, fq], 0, 1)

        assign_a, cons_a, d0, d1 = self._em(seqs, init_a)
        assign_b, cons_b, _, _ = self._em(seqs, init_b)

        # reconcile run B against run A (the reference's asc/dsc
        # flip-detection via consensus edit distances)
        cluster_edits = np.zeros((2, 2), dtype=np.int64)
        for a in (0, 1):
            for b in (0, 1):
                cluster_edits[a, b] = native.edit_distance(
                    cons_a[a], cons_b[b])
        diag_edits = int(cluster_edits.trace())
        off_diag = int(cluster_edits.sum() - diag_edits)
        if off_diag < diag_edits:  # run B converged with labels flipped
            assign_b = 1 - assign_b
            diag_edits, off_diag = off_diag, diag_edits
        edits_ratio = round(diag_edits / off_diag, 3) if diag_edits \
            else 0.0

        # homozygosity: the two consensus models barely differ, or the
        # split collapsed
        sep = native.edit_distance(cons_a[0], cons_a[1])
        mean_len = float(np.mean([len(s) for s in seqs]))
        threshold = max(2.0, self.homozygous_frac * mean_len)
        counts = [int((assign_a == c).sum()) for c in (0, 1)]
        is_homozygous = (
            sep <= threshold
            or min(counts) < self.min_cluster_frac * n)

        empty_second_cluster = False
        if is_homozygous:
            hap1, hap2, ambig = set(names), set(), set()
        else:
            hap1, hap2, ambig = set(), set(), set()
            for i, name in enumerate(names):
                unstable = assign_a[i] != assign_b[i]
                equidistant = abs(int(d0[i]) - int(d1[i])) <= 1
                if unstable or equidistant:
                    ambig.add(name)
                elif assign_a[i] == 0:
                    hap1.add(name)
                else:
                    hap2.add(name)
            if min(len(hap1), len(hap2)) == 0:
                # all of one cluster was ambiguous: call homozygous
                # (reference's empty_second_cluster handling)
                is_homozygous = True
                empty_second_cluster = True
                hap1 = hap1 | hap2 | ambig
                hap2, ambig = set(), set()

        n_same = n_switched = None
        if not is_homozygous:
            # orient cluster ids to agree with SNP-based HP tags
            ovl = np.zeros((2, 2), dtype=int)
            by_bhp = {1: set(), 2: set()}
            for name in hap1 | hap2:
                rn = RecordName.from_str(name)
                if rn.hap in by_bhp:
                    by_bhp[rn.hap].add(name)
            for cid, cluster in enumerate((hap1, hap2)):
                for bhp, bnames in by_bhp.items():
                    ovl[cid, bhp - 1] = len(cluster & bnames)
            n_same = int(ovl.trace())
            n_switched = int(ovl.sum() - n_same)
            if n_switched > n_same:
                hap1, hap2 = hap2, hap1
                n_same, n_switched = n_switched, n_same

        return {
            "n_reads": n,
            "hap1_reads": hap1,
            "hap2_reads": hap2,
            "hap0_reads": ambig,
            "is_homozygous": is_homozygous,
            "empty_second_cluster": empty_second_cluster,
            "n_ambig_reads": len(ambig),
            "n_unasign_reads": 0,
            "edits_ratio": edits_ratio,
            "diag_edits": diag_edits,
            "nreads_cluster_phasing_matches_bhp": n_same,
            "nreads_cluster_phasing_switched_wrt_bhp": n_switched}

    def _process_clusters(self, rec, subreads, d):
        clustered = {}
        by_name = {s.name: s for s in subreads}
        for h in range(rec.ploidy + 1):
            reads = d["hap{}_reads".format(h)]
            d.update(self.summarize_reads(
                list(reads), prefix="hap{}_".format(h)))
            new_rec = rec.copy()
            new_rec.hap = h
            new_rec.query_name += "_HOM" if d["is_homozygous"] else "_HET"
            clustered[new_rec] = []
            for name in reads:
                s = by_name[name]
                rn = RecordName.from_str(name)
                if self.put_bam_hp_in_name:
                    rn.query_name += "_BHP{}".format(rn.hap)
                rn.hap = h
                clustered[new_rec].append(Subread(str(rn), s.seq))
            del d["hap{}_reads".format(h)]
        return clustered


class HybridClusterer(SpanningReadClusterer):
    """Prephased with de-novo fallback on low per-haplotype depth."""

    def __init__(self, min_depth: int, remove_outliers: bool = True):
        """:param min_depth: fallback threshold."""
        self.min_depth = min_depth
        self.prephased = PrephasedClusterer(remove_outliers=remove_outliers)
        self.denovo = DeNovoClusterer()

    def _cluster_spanningreads(self, rec, spanning_reads):
        d, clusters = self.prephased.cluster_spanningreads(
            rec, spanning_reads)
        for record, cluster in clusters.items():
            if record.hap != 0 and len(cluster) < self.min_depth:
                return self.denovo.cluster_spanningreads(
                    rec, spanning_reads)
        return d, clusters


class SpanningReadClusterFactory:
    """Factory mirroring the reference's strategy keys."""

    clustering_techniques = ["prephased", "hybrid", "abpoa", "unphased"]

    @staticmethod
    def create_clusterer(method: str, **kwargs) -> SpanningReadClusterer:
        """Create a clusterer for a phasing method."""
        if method in ("prephased", "unphased"):
            return PrephasedClusterer(
                remove_outliers=kwargs.get("remove_outliers", True))
        if method == "abpoa":
            return DeNovoClusterer(
                put_bam_hp_in_name=kwargs.get("put_bam_hp_in_name", True))
        if method == "hybrid":
            min_depth = kwargs.get("min_depth")
            if min_depth is None:
                raise ValueError(
                    "Hybrid clustering requires 'min_depth'.")
            return HybridClusterer(
                min_depth=min_depth,
                remove_outliers=kwargs.get("remove_outliers", True))
        raise ValueError("Unknown clustering method: {}".format(method))
