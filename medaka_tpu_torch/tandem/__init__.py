"""Targeted tandem-repeat genotyping.

Counterpart of ``medaka_tpu/tandem/__init__.py`` (the reference's
``medaka/tandem/``): per-region spanning-read extraction, haplotype
clustering (prephased / de-novo / hybrid), POA + neural polish per
haplotype, and replacement-style or decomposed VCF output. The polish
runs the network in full precision (the float32 scan, as in
``medaka_tpu``) on the GPU unless ``device="cpu"`` is given.
"""
from __future__ import annotations

import os
from typing import List, Optional

from medaka_tpu_torch import common
from medaka_tpu_torch.tandem.clustering import SpanningReadClusterFactory
from medaka_tpu_torch.tandem.generator import ConsensusGenerator
from medaka_tpu_torch.tandem.io_utils import bam_to_vcfs
from medaka_tpu_torch.tandem.record_name import RecordName


def determine_ploidy(record, phasing, sex, sex_chromosomes,
                     par_regions) -> int:
    """Ploidy of a region given sex and PAR regions.

    Reference: ``medaka/tandem/tandem.py:24-57``.
    """
    if phasing == "unphased":
        return 1
    if record.ref_name not in sex_chromosomes:
        return 2
    if sex == "female":
        _, chr_y = sex_chromosomes
        if record.ref_name == chr_y:
            raise ValueError(
                "Can't determine ploidy for {} for female "
                "samples".format(chr_y))
        return 2
    if sex == "male":
        if any(record.overlaps(par) for par in par_regions):
            common.get_named_logger("TR").debug(
                "%s is PAR, treating as diploid", record)
            return 2
        return 1
    raise ValueError("Unknown sex: {}".format(sex))


def main(
        bam: str, ref_fasta: str, regions: List[common.Region],
        output: str, model=None, model_bundle=None,
        phasing: str = "hybrid", sex: str = "female",
        sex_chrs=("chrX", "chrY"), par_regions=("chrX:10000-2781479",
                                                "chrX:155701382-156030895"),
        padding: int = 10, min_depth: int = 3, min_mapq: int = 5,
        process_large_regions: bool = False, workers: int = 1,
        decompose: bool = False, add_read_names: bool = False,
        sample_name: str = "SAMPLE",
        disable_outlier_filter: bool = False, device=None,
        devices=None) -> Optional[str]:
    """Run tandem-repeat genotyping (reference ``tandem.py:102-207``).

    :param model: a model path; or ``model_bundle``, a
        ``models.ModelBundle`` (its model holds its weights).
    :param device: "cuda" (every visible GPU, the default), "cuda:i" or
        "cpu", when ``devices`` is None; resolved before any host stage.
    :param devices: one model replica an entry (``prediction.predict``).
    :returns: path of the TR VCF, or None on failure.
    """
    from medaka_tpu_torch import parallel
    from medaka_tpu_torch.io.fastx import FastaReader

    logger = common.get_named_logger("TR")
    devices = parallel.resolve_devices(devices, device)
    os.makedirs(output, exist_ok=True)

    with FastaReader(ref_fasta) as fa:
        contig_lengths = {
            name: fa.get_reference_length(name)
            for name in fa.references}

    clusterer = SpanningReadClusterFactory.create_clusterer(
        phasing, min_depth=min_depth,
        remove_outliers=not disable_outlier_filter)

    if sex == "female":
        _, chr_y = sex_chrs
        regions = [r for r in regions if r.ref_name != chr_y]
    regions = [
        common.Region.from_string(s)
        for s in sorted({str(r) for r in regions})]
    pars = [common.Region.from_string(r) if isinstance(r, str) else r
            for r in par_regions]
    records = [
        RecordName(
            query_name="tr", ref_name=r.ref_name, ref_start=r.start,
            ref_end=r.end,
            ref_start_padded=max(r.start - padding, 0),
            ref_end_padded=min(
                r.end + padding, contig_lengths[r.ref_name]),
            hap=0,
            ploidy=determine_ploidy(r, phasing, sex, sex_chrs, pars))
        for r in regions]

    generator = ConsensusGenerator(
        regions=records, bam=bam, ref=ref_fasta,
        reads_clusterer=clusterer, min_depth=min_depth,
        reads_filter={"min_mapq": min_mapq},
        process_large_regions=process_large_regions,
        output_prefix=output, model=model, model_bundle=model_bundle,
        workers=workers, devices=devices)
    generator.process()

    poa_file = os.path.join(output, "poa.fasta")
    consensus = os.path.join(output, "consensus.fasta")
    if (not os.path.exists(poa_file) or os.path.getsize(poa_file) == 0
            or not os.path.exists(consensus)
            or os.path.getsize(consensus) == 0):
        logger.error(
            "Failed to generate a consensus for the input regions.")
        return None

    medaka_bam = os.path.join(output, "medaka_to_ref.bam")
    return bam_to_vcfs(
        medaka_bam, ref_fasta,
        trimmed_reads_to_poa=os.path.join(
            output, "trimmed_reads_to_poa.bam"),
        replacement_style=not decompose,
        add_read_names=add_read_names, sample_name=sample_name)
