"""Command line: ``python -m medaka_tpu_torch {inference,
consensus_from_features,sequence,vcf,snp,features,train,consensus,
consensus_joint,align,variant,fastrle,compress_bam,smolecule,tandem,
tools}``.

Counterpart of the ``inference``, ``consensus_from_features``,
``sequence``, ``vcf``, ``snp``, ``features``, ``train``, ``consensus``,
``consensus_joint``, ``align``, ``variant``, ``fastrle``,
``compress_bam``, ``smolecule`` and ``tandem`` subcommands of
``medaka_tpu/cli.py`` and of all its ``tools`` (``list_models``,
``rlebam``, ``resolve_model``, ``export``, ``hdf_to_bed``, ``vcf2fasta``,
``prepare_tagged_bam``, ``is_rle_model``, ``get_alignment_params``,
``get_model_dtypes``, ``download_models``, ``pileup_counts``,
``annotate``, ``haploid2diploid``, ``diploid2haploid``,
``classify_variants``, ``vcf2tsv``, ``homozygous_regions``,
``consensus2vcf``, ``is_compatible``), with the same flags and defaults;
the port adds ``--cpu`` to the subcommands that run a model. The console
scripts ``counts_entry``, ``version_report`` and ``data_path`` are
``medaka_tpu``'s, under ``medaka_tpu_torch_*`` names. ``--model`` takes a path
or a model name (``models.resolve_model``; ``smolecule`` takes a path,
as ``medaka_tpu``'s does). ``inference``, ``consensus_from_features``,
``train``, ``consensus``, ``consensus_joint``, ``variant``,
``smolecule`` and ``tandem`` run on the GPU unless ``--cpu`` is
given, over every visible GPU (``inference --num_processes N
--process_id i [--coordinator host:port]`` splits the work over
processes instead); ``vcf``, ``snp``, ``align``, ``fastrle``,
``compress_bam`` and the tools run on the host. ``variant`` and
``consensus_joint`` shard their probability file over ``max(1, min(4,
threads // 2))`` files, as ``medaka_tpu`` does.
"""
from __future__ import annotations

import argparse
import contextlib
import logging
import os
import sys

from medaka_tpu_torch import __version__, common


class StoreDict(argparse.Action):
    """Parse KEY=VAL pairs into a dict (as ``medaka_tpu``'s CLI does)."""

    def __call__(self, parser, namespace, values, option_string=None):
        out = {}
        for item in values:
            if "=" not in item:
                raise argparse.ArgumentTypeError(
                    "Expected KEY=VALUE, got {!r}".format(item))
            key, value = item.split("=", 1)
            out[key] = self._autocast(value)
        setattr(namespace, self.dest, out)

    @staticmethod
    def _autocast(value):
        for cast in (int, float):
            try:
                return cast(value)
            except ValueError:
                pass
        if value.lower() in ("true", "false"):
            return value.lower() == "true"
        if value.lower() in ("none", "null"):
            return None
        return value


def _regions_arg(values):
    out = []
    for v in values:
        if os.path.isfile(v):  # bed file
            with open(v) as fh:
                for line in fh:
                    if not line.strip() or line.startswith(
                            ("#", "track", "browser")):
                        continue
                    parts = line.split("\t")
                    out.append(common.Region(
                        parts[0], int(parts[1]), int(parts[2])))
        else:
            out.append(common.Region.from_string(v))
    return out


def _log_parser():
    parser = argparse.ArgumentParser(add_help=False)
    group = parser.add_mutually_exclusive_group()
    group.add_argument(
        "--debug", action="store_true", help="Verbose logging.")
    group.add_argument(
        "--quiet", action="store_true", help="Minimal logging.")
    return parser


def _chunking_parser():
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument(
        "--regions", nargs="+", default=None,
        help="Genomic regions or .bed files.")
    parser.add_argument(
        "--chunk_len", type=int, default=10000,
        help="Chunk length of samples (pileup columns).")
    parser.add_argument(
        "--chunk_ovlp", type=int, default=1000,
        help="Overlap of chunks.")
    return parser


def build_parser() -> argparse.ArgumentParser:
    """The argument parser of :func:`main`."""
    parser = argparse.ArgumentParser(
        prog="medaka_tpu_torch",
        description="Consensus polishing with PyTorch and CUDA kernels.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument(
        "--version", action="version",
        version="medaka_tpu_torch {}".format(__version__))
    subparsers = parser.add_subparsers(title="subcommands", dest="command")
    subparsers.required = True
    log_parent = _log_parser()

    p = subparsers.add_parser(
        "inference", parents=[log_parent, _chunking_parser()],
        help="Run inference over a BAM, writing probabilities to HDF5.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("bam", help="Input alignments (sorted, indexed BAM).")
    p.add_argument("output", help="Output probabilities file (HDF5).")
    p.add_argument(
        "--model", required=True,
        help="Model bundle (tar.gz) or the name of one "
             "(models.resolve_model).")
    p.add_argument(
        "--batch_size", type=int, default=None,
        help="Batch size (default: auto, see prediction.auto_batch_size).")
    p.add_argument("--bam_workers", type=int, default=2)
    p.add_argument(
        "--output_shards", type=int, default=1,
        help="Write probability samples round-robin across this many "
             "shard files from writer processes; the named output keeps "
             "the metadata and the shard manifest, which every downstream "
             "command reads unchanged.")
    p.add_argument(
        "--feature_processes", type=int, default=0,
        help="Featurize regions in this many worker processes instead "
             "of threads.")
    p.add_argument("--bam_chunk", type=int, default=1_000_000)
    p.add_argument(
        "--full_precision", action="store_true",
        help="Run float32 instead of bfloat16.")
    p.add_argument(
        "--cpu", action="store_true", help="Run the model on the CPU.")
    p.add_argument(
        "--save_features", action="store_true",
        help="Save features with consensus probabilities.")
    p.add_argument(
        "--check_output", action="store_true",
        help="Verify integrity of the output file after inference.")
    p.add_argument(
        "--profile_dir", default=None,
        help="Capture a torch.profiler trace of the run (CPU and, on the "
             "GPU, CUDA activities) into this directory as "
             "trace.json (Chrome trace format); an empty trace is an "
             "error.")
    tg = p.add_argument_group(
        "read filters",
        "Override the model's feature-encoder alignment filters.")
    tg.add_argument("--RG", default=None, help="Read group filter.")
    tg.add_argument("--min_mapq", type=int, default=None,
                    help="Minimum mapping quality.")
    tg.add_argument("--tag_name", default=None,
                    help="Two-letter tag name to filter by.")
    tg.add_argument("--tag_value", type=int, default=None,
                    help="Value of tag.")
    tg.add_argument("--tag_keep_missing", action="store_true",
                    help="Keep alignments missing the tag.")
    mh = p.add_argument_group(
        "multi-process",
        "Split the work over processes, each writing <output>_host<id>; "
        "sequence merges the files.")
    mh.add_argument("--coordinator", default=None,
                    help="host:port of process 0 (torch.distributed).")
    mh.add_argument("--num_processes", type=int, default=None)
    mh.add_argument("--process_id", type=int, default=None)
    p.set_defaults(func=_cmd_inference)

    p = subparsers.add_parser(
        "consensus_from_features", parents=[log_parent],
        help="Run inference over precomputed feature HDF5s.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("inputs", nargs="+", help="Feature HDF5 file(s).")
    p.add_argument("output", help="Output probabilities file.")
    p.add_argument("--model", required=True)
    p.add_argument(
        "--batch_size", type=int, default=None,
        help="Batch size (default: auto, see prediction.auto_batch_size).")
    p.add_argument("--full_precision", action="store_true")
    p.add_argument(
        "--cpu", action="store_true", help="Run the model on the CPU.")
    p.set_defaults(func=_cmd_consensus_from_features)

    p = subparsers.add_parser(
        "sequence", parents=[log_parent],
        help="Stitch probabilities into consensus fasta/fastq.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("inputs", nargs="+", help="Probability HDF5 file(s).")
    p.add_argument("draft", help="Draft FASTA that was polished.")
    p.add_argument("output", help="Output consensus file.")
    p.add_argument("--regions", nargs="+", default=None)
    p.add_argument("--threads", type=int, default=1)
    p.add_argument("--min_depth", type=int, default=0)
    p.add_argument(
        "--no-fillgaps", dest="fillgaps", action="store_false",
        help="Don't fill coverage gaps from the draft.")
    p.add_argument("--fill_char", default=None)
    p.add_argument(
        "--qualities", action="store_true", help="Write fastq.")
    p.set_defaults(func=_cmd_sequence)

    p = subparsers.add_parser(
        "vcf", parents=[log_parent],
        help="Decode variants from probabilities against a reference.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("inputs", nargs="+", help="Probability HDF5 file(s).")
    p.add_argument("ref_fasta", help="Reference FASTA.")
    p.add_argument("output", help="Output VCF.")
    p.add_argument("--regions", nargs="+", default=None)
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--ambig_ref", action="store_true")
    p.add_argument("--gvcf", action="store_true")
    p.add_argument(
        "--min_qual", type=float, default=None, metavar="Q",
        help="Drop variant records with QUAL below this (default: emit "
             "all; gVCF reference rows are kept).")
    p.set_defaults(func=_cmd_vcf)

    p = subparsers.add_parser(
        "snp", parents=[log_parent],
        help="Decode SNPs (single-locus) from probabilities.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("inputs", nargs="+")
    p.add_argument("ref_fasta")
    p.add_argument("output")
    p.add_argument("--regions", nargs="+", default=None)
    p.add_argument("--threshold", type=float, default=0.04)
    p.add_argument(
        "--het_rescue", type=float, default=None, metavar="PROB",
        help="Diploid models only: call a het genotype when the argmax "
             "is hom-ref but the best (ref, X) class carries at least "
             "this probability. Default off: the argmax.")
    p.add_argument("--verbose", action="store_true")
    p.set_defaults(func=_cmd_snp)

    p = subparsers.add_parser(
        "features", parents=[log_parent],
        help="Create training/inference features from BAM(s).",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("bam")
    p.add_argument("output")
    p.add_argument("--truth", default=None, help="Truth-to-draft BAM.")
    p.add_argument("--truth_haplotag", default=None)
    p.add_argument("--regions", nargs="+", default=None)
    p.add_argument("--feature_encoder", default="CountsFeatureEncoder")
    p.add_argument(
        "--feature_encoder_args", nargs="+", action=StoreDict, default={},
        metavar="KEY=VAL")
    p.add_argument("--label_scheme", default="HaploidLabelScheme")
    p.add_argument(
        "--label_scheme_args", nargs="+", action=StoreDict, default={},
        metavar="KEY=VAL")
    p.add_argument("--chunk_len", type=int, default=1000)
    p.add_argument("--chunk_ovlp", type=int, default=0)
    p.add_argument("--threads", type=int, default=1)
    p.add_argument("--min_region_size", type=int, default=0)
    p.set_defaults(func=_cmd_features)

    p = subparsers.add_parser(
        "train", parents=[log_parent],
        help="Train a model from feature files.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("features", nargs="+", help="Feature HDF5 file(s).")
    p.add_argument("--train_name", default="training")
    p.add_argument("--model", default=None,
                   help="Initial model bundle, reference checkpoint or name "
                        "(warm start), or an architecture .toml (random "
                        "init).")
    p.add_argument("--epochs", type=int, default=5000)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--validation_split", type=float, default=0.2)
    p.add_argument("--validation_features", nargs="+", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--optimizer", default="nadam",
                   choices=["nadam", "adam", "rmsprop", "sgd"])
    p.add_argument(
        "--optim_args", nargs="+", action=StoreDict, default={},
        metavar="KEY=VAL")
    p.add_argument("--max_samples", type=int, default=None)
    p.add_argument("--max_valid_samples", type=int, default=None)
    p.add_argument(
        "--samples_per_training_epoch", type=int, default=None,
        help="Truncate each training epoch at this many samples.")
    p.add_argument(
        "--use_lr_schedule", action=argparse.BooleanOptionalAction,
        default=True,
        help="Warmup+cosine LR schedule (constant LR when disabled).")
    p.add_argument(
        "--amp", action=argparse.BooleanOptionalAction, default=None,
        help="Mixed precision (bf16 compute), already the default; "
             "--no-amp is equivalent to --full_precision.")
    p.add_argument(
        "--full_precision", action="store_true",
        help="Train in float32 throughout (disables bf16 compute).")
    p.add_argument(
        "--model_parallel", type=int, default=1,
        help="Tensor-parallel mesh axis over the recurrent gate rows. "
             "Values > 1 run the plain scan instead of the kernels (the "
             "kernels are validated unsharded only) and need as many "
             "devices; data parallelism over every GPU is the default.")
    p.add_argument(
        "--validate_only", action="store_true",
        help="Evaluate --model on the validation split (all samples "
             "when there is none) and print its loss and accuracy.")
    p.add_argument(
        "--resume", action="store_true",
        help="Continue a killed run from the resume snapshot in "
             "--train_name.")
    p.add_argument(
        "--cpu", action="store_true", help="Train on the CPU.")
    p.set_defaults(func=_cmd_train)

    _add_from_reads_parsers(subparsers, log_parent)
    return parser


def _add_from_reads_parsers(subparsers, log_parent):
    """The subcommands that start from reads: ``variant``, ``consensus``,
    ``consensus_joint``, ``align`` and the ``tools`` group."""
    def batch_size(p):
        p.add_argument(
            "--batch_size", "-b", type=int, default=None,
            help="Batch size (default: auto, see "
                 "prediction.auto_batch_size).")

    def cpu(p):
        p.add_argument(
            "--cpu", action="store_true", help="Run the model on the CPU.")

    p = subparsers.add_parser(
        "variant", parents=[log_parent],
        help="Full variant-calling pipeline: reads + reference -> VCF "
             "(map, inference, vcf decode, annotate).",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("reads", help="Reads fasta/q (may be gzipped).")
    p.add_argument("ref_fasta", help="Reference FASTA.")
    p.add_argument("--output", "-o", default="medaka_tpu_variant")
    p.add_argument("--model", "-m", required=True,
                   help="Variant-calling model.")
    p.add_argument("--threads", "-t", type=int, default=1)
    batch_size(p)
    p.add_argument("--chunk_len", type=int, default=10000)
    p.add_argument("--chunk_ovlp", type=int, default=1000)
    p.add_argument("--no-annotate", dest="annotate",
                   action="store_false",
                   help="Skip depth/support annotation.")
    cpu(p)
    p.set_defaults(func=_cmd_variant_pipeline)

    p = subparsers.add_parser(
        "consensus", parents=[log_parent],
        help="Full polishing pipeline: reads + draft -> polished fasta "
             "(map, inference, stitch).",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("reads", help="Reads fasta/q (may be gzipped).")
    p.add_argument("draft", help="Draft assembly fasta.")
    p.add_argument("--output", "-o", default="medaka_tpu_consensus")
    p.add_argument("--model", "-m", required=True)
    p.add_argument("--threads", "-t", type=int, default=1)
    batch_size(p)
    p.add_argument("--chunk_len", type=int, default=10000)
    p.add_argument("--chunk_ovlp", type=int, default=1000)
    p.add_argument("--qualities", "-q", action="store_true")
    p.add_argument(
        "--direct", action="store_true",
        help="Decode argmax+quality on the device and stitch in-process: "
             "no probability HDF5 round trip. Byte-identical output; the "
             "inference stage is not resumable and no probability file "
             "remains for 'vcf'.")
    cpu(p)
    p.set_defaults(func=_cmd_consensus)

    p = subparsers.add_parser(
        "consensus_joint", parents=[log_parent],
        help="Joint polishing from multiple read datatypes: each read set "
             "is mapped, DT-tagged, merged and polished with a "
             "multi-datatype model.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument(
        "-i", dest="reads", action="append", required=True,
        help="Reads fasta/q; repeat per datatype.")
    p.add_argument(
        "-v", dest="values", action="append", required=True,
        help="DT tag value per -i input (e.g. r9, r10).")
    p.add_argument("-d", dest="draft", required=True)
    p.add_argument("--output", "-o", default="medaka_tpu_joint")
    p.add_argument("--model", "-m", required=True)
    p.add_argument("--threads", "-t", type=int, default=1)
    batch_size(p)
    p.add_argument("--chunk_len", type=int, default=10000)
    p.add_argument("--chunk_ovlp", type=int, default=1000)
    p.add_argument("--qualities", "-q", action="store_true")
    cpu(p)
    p.set_defaults(func=_cmd_consensus_joint)

    p = subparsers.add_parser(
        "fastrle", parents=[log_parent],
        help="Create run-length-encoded fastq (lengths in quals).",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("input", help="Input fasta/q (may be gzipped).")
    p.add_argument("--output", default=None,
                   help="Output fastq (default stdout).")
    p.add_argument("--block_size", type=int, default=94)
    p.set_defaults(func=_cmd_fastrle)

    p = subparsers.add_parser(
        "compress_bam", parents=[log_parent],
        help="Re-express a BAM in run-length-encoded coordinates.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("bam_input")
    p.add_argument("bam_output")
    p.add_argument("ref_fname")
    p.add_argument("--regions", nargs="+", default=None)
    p.add_argument("--threads", type=int, default=1)
    p.add_argument(
        "--use_fast5_info", nargs=2, default=None,
        metavar=("FAST5_DIR", "SUMMARY"),
        help="Add WL/WK Weibull tags from fast5 files (their directory "
             "and a sequencing summary naming each read's file).")
    p.set_defaults(func=_cmd_compress_bam)

    p = subparsers.add_parser(
        "align", parents=[log_parent],
        help="Map reads to a draft, writing a sorted indexed BAM.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("reads")
    p.add_argument("draft")
    p.add_argument("output", help="Output BAM path.")
    p.add_argument("--threads", "-t", type=int, default=1)
    p.add_argument("--band", type=int, default=500)
    p.set_defaults(func=_cmd_align)

    _add_workflow_parsers(subparsers, log_parent)

    toolparser = subparsers.add_parser(
        "tools", parents=[log_parent], help="tools sub-commands",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    toolsub = toolparser.add_subparsers(title="tools", dest="tool_command")
    toolsub.required = True

    tp = toolsub.add_parser(
        "list_models", help="List models bundled or cached locally.")
    tp.set_defaults(func=_cmd_list_models)

    tp = toolsub.add_parser(
        "rlebam",
        help="Add run-length (WL/WK) tags to a SAM stream (stdin to "
             "stdout) from fast5s.")
    tp.add_argument(
        "read_index",
        help="Two-column TSV mapping read_ids to fast5 filepaths.")
    tp.add_argument("--workers", type=int, default=4)
    tp.set_defaults(func=_cmd_rlebam)

    tp = toolsub.add_parser(
        "resolve_model", help="Resolve a model name to a file path.")
    tp.add_argument("--model", required=True)
    tp.add_argument(
        "--auto_model", choices=["consensus", "variant"], default=None,
        help="Treat --model as a basecaller output file and choose the "
             "model from its metadata.")
    tp.add_argument("--bacteria", action="store_true")
    tp.set_defaults(func=_cmd_resolve_model)

    tp = toolsub.add_parser(
        "export",
        help="Export a model as config.toml + torch weights.pt.")
    tp.add_argument("model")
    tp.add_argument("--output", default=None)
    tp.add_argument(
        "--supported_basecallers", nargs="+", default=[])
    tp.add_argument(
        "--force", action="store_true",
        help="Overwrite an existing export archive.")
    tp.set_defaults(func=_cmd_export)

    tp = toolsub.add_parser(
        "hdf_to_bed", help="Write covered intervals of sample files.")
    tp.add_argument("inputs", nargs="+")
    tp.add_argument("output")
    tp.set_defaults(func=_cmd_hdf_to_bed)

    tp = toolsub.add_parser(
        "vcf2fasta",
        help="Apply VCF variants to a reference FASTA (one haplotype).")
    tp.add_argument("vcf")
    tp.add_argument("ref_fasta")
    tp.add_argument("output")
    tp.set_defaults(func=_cmd_vcf2fasta)

    tp = toolsub.add_parser(
        "prepare_tagged_bam",
        help="Tag reads of several BAMs and merge them.")
    tp.add_argument("input_bams", nargs="+")
    tp.add_argument("--values", nargs="+", type=int, required=True)
    tp.add_argument("--tag", default="HP")
    tp.add_argument("--output", required=True)
    tp.add_argument("--threads", type=int, default=1)
    tp.set_defaults(func=_cmd_prepare_tagged_bam)

    tp = toolsub.add_parser(
        "is_rle_model", help="Report whether a model is an RLE model.")
    tp.add_argument("model")
    tp.set_defaults(func=_cmd_is_rle_model)

    tp = toolsub.add_parser(
        "get_alignment_params",
        help="Print alignment parameters appropriate for a model.")
    tp.add_argument("model")
    tp.set_defaults(func=_cmd_get_alignment_params)

    tp = toolsub.add_parser(
        "get_model_dtypes",
        help="Print the datatypes a model's encoder splits counts by.")
    tp.add_argument("model")
    tp.set_defaults(func=_cmd_get_model_dtypes)

    tp = toolsub.add_parser(
        "download_models",
        help="Download reference model files (requires network egress).")
    tp.add_argument("--models", nargs="+", default=None)
    tp.set_defaults(func=_cmd_download_models)

    tp = toolsub.add_parser(
        "pileup_counts",
        help="Print/benchmark pileup counts for a region "
             "(medaka_counts equivalent).")
    tp.add_argument("bam")
    tp.add_argument("region")
    tp.add_argument("--dtypes", nargs="+", default=None)
    tp.add_argument("--num_qstrat", type=int, default=1)
    tp.add_argument("--print", dest="print_rows", action="store_true")
    tp.set_defaults(func=_cmd_pileup_counts)

    tp = toolsub.add_parser(
        "annotate", help="Annotate a VCF with read depth/allele support.")
    tp.add_argument("vcf")
    tp.add_argument("ref_fasta")
    tp.add_argument("bam")
    tp.add_argument("vcfout")
    tp.add_argument("--RG", default=None, help="Read group filter.")
    tp.add_argument("--chunk_size", type=int, default=100000)
    tp.add_argument("--pad", type=int, default=25)
    tp.add_argument(
        "--no-dpsp", dest="dpsp", action="store_false",
        help="Skip spanning-read annotations.")
    tp.set_defaults(func=_cmd_annotate)

    tp = toolsub.add_parser(
        "haploid2diploid",
        help="Merge two haploid VCFs into a diploid VCF.")
    tp.add_argument("vcf1")
    tp.add_argument("vcf2")
    tp.add_argument("ref_fasta")
    tp.add_argument("vcfout")
    tp.add_argument("--adjacent", action="store_true",
                    help="Merge adjacent (not just overlapping) variants.")
    tp.add_argument("--discard_phase", action="store_true")
    tp.add_argument("--split_mnp", action="store_true")
    tp.set_defaults(func=_cmd_haploid2diploid)

    tp = toolsub.add_parser(
        "diploid2haploid",
        help="Split a diploid VCF into two haploid VCFs.")
    tp.add_argument("vcf")
    tp.add_argument("--notrim", action="store_true")
    tp.set_defaults(func=_cmd_diploid2haploid)

    tp = toolsub.add_parser(
        "classify_variants",
        help="Classify variants by type, writing one VCF per class.")
    tp.add_argument("vcf")
    tp.add_argument("--replace_info", action="store_true")
    tp.set_defaults(func=_cmd_classify_variants)

    tp = toolsub.add_parser(
        "vcf2tsv", help="Flatten a VCF into a tab-separated table.")
    tp.add_argument("vcf")
    tp.set_defaults(func=_cmd_vcf2tsv)

    tp = toolsub.add_parser(
        "homozygous_regions",
        help="Find homozygous regions of a diploid VCF.")
    tp.add_argument("vcf")
    tp.add_argument("region")
    tp.add_argument("--min_len", type=int, default=1000)
    tp.add_argument("--suffix", default="regions.txt")
    tp.set_defaults(func=_cmd_homozygous_regions)

    tp = toolsub.add_parser(
        "consensus2vcf",
        help="Call variants by aligning a consensus FASTA to a reference.")
    tp.add_argument("consensus")
    tp.add_argument("ref_fasta")
    tp.add_argument("--out_prefix", default="consensus2vcf")
    tp.add_argument("--regions", nargs="+", default=None)
    tp.add_argument("--chunk_size", type=int, default=100000)
    tp.add_argument("--pad", type=int, default=10000)
    tp.add_argument("--mode", default="NW", choices=["NW", "HW", "HWT"])
    tp.set_defaults(func=_cmd_consensus2vcf)

    tp = toolsub.add_parser(
        "is_compatible",
        help="Check a model/feature-encoder pair against a BAM.")
    tp.add_argument("--model", required=True)
    tp.add_argument("bam")
    tp.set_defaults(func=_cmd_is_compatible)


def _add_workflow_parsers(subparsers, log_parent):
    """``smolecule`` and ``tandem`` (``medaka_tpu/cli.py:437-499``)."""
    p = subparsers.add_parser(
        "smolecule", parents=[log_parent],
        help="Consensus from single-molecule repetitive subreads.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("output", help="Output directory.")
    p.add_argument(
        "fasta", nargs="+",
        help="Grouped-subread fasta (or one file per molecule).")
    p.add_argument("--model", required=True, help="Model bundle path.")
    p.add_argument("--threads", type=int, default=1)
    p.add_argument("--depth", type=int, default=3,
                   help="Minimum subread count.")
    p.add_argument("--length", type=int, default=400,
                   help="Minimum median subread length.")
    p.add_argument("--chunk_len", type=int, default=1000)
    p.add_argument("--chunk_ovlp", type=int, default=500)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--qualities", action="store_true")
    p.add_argument(
        "--method", choices=["spoa"], default="spoa",
        help="Pre-polish consensus method (built-in POA).")
    p.add_argument(
        "--save_features", action="store_true",
        help="Save features with consensus probabilities.")
    p.add_argument(
        "--check_output", action="store_true",
        help="Verify integrity of the probabilities file.")
    p.add_argument(
        "--cpu", action="store_true", help="Run the model on the CPU.")
    p.set_defaults(func=_cmd_smolecule)

    p = subparsers.add_parser(
        "tandem", parents=[log_parent],
        help="Targeted tandem-repeat genotyping.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("bam")
    p.add_argument("ref_fasta")
    p.add_argument("output", help="Output directory.")
    p.add_argument(
        "--regions", nargs="+", required=True,
        help="Repeat regions or .bed files.")
    p.add_argument("--model", required=True)
    p.add_argument(
        "--phasing", default="hybrid",
        choices=["prephased", "hybrid", "abpoa", "unphased"])
    p.add_argument("--sex", default="female",
                   choices=["male", "female"])
    p.add_argument("--sex_chrs", nargs=2, default=["chrX", "chrY"])
    p.add_argument(
        "--par_regions", nargs="+",
        default=["chrX:10000-2781479", "chrX:155701382-156030895"])
    p.add_argument("--padding", type=int, default=10)
    p.add_argument("--min_depth", type=int, default=3)
    p.add_argument("--min_mapq", type=int, default=5)
    p.add_argument("--workers", type=int, default=1)
    p.add_argument("--process_large_regions", action="store_true")
    p.add_argument("--decompose", action="store_true",
                   help="Emit decomposed variants instead of "
                        "replacement-style records.")
    p.add_argument("--add_read_names", action="store_true")
    p.add_argument("--sample_name", default="SAMPLE")
    p.add_argument("--disable_outlier_filter", action="store_true")
    p.add_argument(
        "--cpu", action="store_true", help="Run the model on the CPU.")
    p.set_defaults(func=_cmd_tandem)


def main(argv=None):
    """CLI entry."""
    args = build_parser().parse_args(argv)
    level = logging.INFO
    if args.debug:
        level = logging.DEBUG
    elif args.quiet:
        level = logging.WARNING
    logging.basicConfig(
        level=level, format="[%(asctime)s - %(name)s] %(message)s",
        datefmt="%H:%M:%S")
    return args.func(args)


def _cmd_inference(args):
    from medaka_tpu_torch import datastore, parallel, prediction
    if (args.tag_name is None) != (args.tag_value is None):
        raise ValueError(
            "--tag_name and --tag_value must be given together "
            "(one alone would filter out every read).")
    device = _device(args)
    regions = _regions_arg(args.regions) if args.regions else None
    if args.num_processes and args.num_processes > 1:
        if args.process_id is None or not (
                0 <= args.process_id < args.num_processes):
            raise ValueError(
                "--num_processes requires --process_id in [0, {})".format(
                    args.num_processes))
        # this process's share of the work list, divided at bam_chunk
        # granularity (a single-contig genome divides too)
        parallel.initialize_distributed(
            args.coordinator, args.num_processes, args.process_id)
        regions = parallel.shard_regions(
            prediction.plan_work(
                regions, args.bam, bam_chunk=args.bam_chunk,
                chunk_overlap=args.chunk_ovlp),
            args.num_processes, args.process_id)
        base, ext = os.path.splitext(args.output)
        args.output = "{}_host{}{}".format(base, args.process_id, ext)
    overrides = {
        k: v for k, v in (
            ("read_group", args.RG),
            ("min_mapq", args.min_mapq),
            ("tag_name", args.tag_name),
            ("tag_value", args.tag_value),
            ("tag_keep_missing", args.tag_keep_missing or None))
        if v is not None}
    ctx = profiled(args.profile_dir, device) if args.profile_dir else \
        contextlib.nullcontext()
    with ctx:
        prediction.predict(
            args.bam, args.output, model_path=args.model, regions=regions,
            batch_size=args.batch_size, chunk_len=args.chunk_len,
            chunk_overlap=args.chunk_ovlp, bam_workers=args.bam_workers,
            bam_chunk=args.bam_chunk, full_precision=args.full_precision,
            encoder_overrides=overrides or None,
            save_features=args.save_features, device=device,
            feature_processes=args.feature_processes,
            output_shards=args.output_shards)
    if args.check_output and not datastore.DataIndex(args.output).samples:
        common.get_named_logger("CheckOutput").warning(
            "Output %s contains no samples.", args.output)
    return 0


#: the trace file ``--profile_dir`` writes
PROFILE_TRACE = "trace.json"


@contextlib.contextmanager
def profiled(directory: str, device):
    """A ``torch.profiler`` trace of the block (the counterpart of
    ``jax.profiler.trace``): CPU activities and, on a CUDA ``device``,
    CUDA ones, written as ``directory/trace.json`` (Chrome trace format).
    Raises if the profiler recorded no event, or on the GPU no device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    on_card = torch.device(device).type == "cuda"
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(directory, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if on_card:
            torch.cuda.synchronize()
    events = prof.key_averages()
    if not len(events):
        raise RuntimeError("torch.profiler recorded no event")
    if on_card and not any(
            getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0))
            > 0 for e in events):
        raise RuntimeError("torch.profiler recorded no device time")
    prof.export_chrome_trace(os.path.join(directory, PROFILE_TRACE))


def _cmd_consensus_from_features(args):
    from medaka_tpu_torch import prediction
    prediction.predict_from_features(
        args.inputs, args.output, model_path=args.model,
        batch_size=args.batch_size, full_precision=args.full_precision,
        device=_device(args))
    return 0


def _cmd_sequence(args):
    from medaka_tpu_torch import stitch
    args.regions = _regions_arg(args.regions) if args.regions else None
    stitch.stitch(args)
    return 0


def _cmd_vcf(args):
    from medaka_tpu_torch import variant
    variant.variants_from_hdf(
        args.inputs, args.ref_fasta, args.output,
        regions=_regions_arg(args.regions) if args.regions else None,
        verbose=args.verbose, ambig_ref=args.ambig_ref, gvcf=args.gvcf,
        min_qual=args.min_qual)
    return 0


def _cmd_snp(args):
    from medaka_tpu_torch import variant
    variant.snps_from_hdf(
        args.inputs, args.ref_fasta, args.output,
        regions=_regions_arg(args.regions) if args.regions else None,
        threshold=args.threshold, verbose=args.verbose,
        het_rescue=args.het_rescue)
    return 0


def _cmd_features(args):
    from medaka_tpu_torch import features
    features.create_samples(
        args.bam, args.output, truth_bam=args.truth,
        regions=_regions_arg(args.regions) if args.regions else None,
        feature_encoder_name=args.feature_encoder,
        feature_encoder_args=args.feature_encoder_args,
        label_scheme_name=args.label_scheme,
        label_scheme_args=args.label_scheme_args,
        truth_haplotag=args.truth_haplotag, chunk_len=args.chunk_len,
        chunk_ovlp=args.chunk_ovlp, threads=args.threads,
        min_region_size=args.min_region_size)
    return 0


def _cmd_train(args):
    from medaka_tpu_torch import training
    out = training.train(args)
    if args.validate_only:
        print("validation loss {!r} accuracy {!r}".format(*out))
    return 0


def _device(args):
    """The device of a subcommand that runs the model, resolved before
    any host stage (without a GPU and without ``--cpu`` this raises)."""
    return common.resolve_device("cpu" if args.cpu else "cuda")


def _cmd_variant_pipeline(args):
    from medaka_tpu_torch import mapping, prediction, variant
    from medaka_tpu_torch import vcf as vcf_mod
    device = _device(args)
    os.makedirs(args.output, exist_ok=True)
    bam = os.path.join(args.output, "calls_to_ref.bam")
    if not os.path.exists(bam):
        mapping.align_reads(
            args.reads, args.ref_fasta, bam, threads=args.threads)
    probs = os.path.join(args.output, "consensus_probs.hdf")
    if not os.path.exists(probs):
        prediction.predict(
            bam, probs, model_path=args.model,
            batch_size=args.batch_size, chunk_len=args.chunk_len,
            chunk_overlap=args.chunk_ovlp,
            bam_workers=max(1, args.threads // 2), device=device,
            output_shards=max(1, min(4, args.threads // 2)))
    vcf_raw = os.path.join(args.output, "medaka.vcf")
    variant.variants_from_hdf(probs, args.ref_fasta, vcf_raw)
    if args.annotate:
        vcf_out = os.path.join(args.output, "medaka.annotated.vcf")
        vcf_mod.annotate_vcf_n_reads(
            vcf_raw, args.ref_fasta, bam, vcf_out)
        print(vcf_out)
    else:
        print(vcf_raw)
    return 0


def _cmd_consensus(args):
    from medaka_tpu_torch import mapping
    mapping.consensus_workflow(
        args.reads, args.draft, args.output, model_path=args.model,
        threads=args.threads, batch_size=args.batch_size,
        chunk_len=args.chunk_len, chunk_ovlp=args.chunk_ovlp,
        qualities=args.qualities, direct=args.direct,
        device=_device(args))
    return 0


def _cmd_consensus_joint(args):
    from medaka_tpu_torch import mapping, prediction, stitch
    if len(args.reads) != len(args.values):
        raise ValueError("Provide one -v value per -i input.")
    device = _device(args)
    os.makedirs(args.output, exist_ok=True)
    tagged_bams = []
    for i, reads in enumerate(args.reads):
        bam = os.path.join(args.output, "calls_{}.bam".format(i))
        if not os.path.exists(bam):
            mapping.align_reads(
                reads, args.draft, bam, threads=args.threads)
        tagged_bams.append(bam)
    merged = os.path.join(args.output, "calls_to_draft.bam")
    if not os.path.exists(merged):
        common.tag_merge_bams(tagged_bams, args.values, "DT", merged)
    probs = os.path.join(args.output, "consensus_probs.hdf")
    if not os.path.exists(probs):
        prediction.predict(
            merged, probs, model_path=args.model,
            batch_size=args.batch_size, chunk_len=args.chunk_len,
            chunk_overlap=args.chunk_ovlp,
            bam_workers=max(1, args.threads // 2), device=device,
            output_shards=max(1, min(4, args.threads // 2)))
    ext = "fastq" if args.qualities else "fasta"
    out = os.path.join(args.output, "consensus." + ext)
    stitch.stitch_to_fasta(
        probs, args.draft, out, threads=args.threads,
        qualities=args.qualities)
    print(out)
    return 0


def _cmd_align(args):
    from medaka_tpu_torch import mapping
    mapping.align_reads(
        args.reads, args.draft, args.output, threads=args.threads,
        band=args.band)
    return 0


def _cmd_smolecule(args):
    from medaka_tpu_torch import smolecule
    smolecule.smolecule(
        args.fasta, args.output, model_path=args.model,
        threads=args.threads, depth=args.depth, length=args.length,
        chunk_len=args.chunk_len, chunk_ovlp=args.chunk_ovlp,
        batch_size=args.batch_size, qualities=args.qualities,
        save_features=args.save_features,
        check_output=args.check_output, device=_device(args))
    return 0


def _cmd_tandem(args):
    from medaka_tpu_torch import models, tandem
    device = _device(args)
    tandem.main(
        args.bam, args.ref_fasta, _regions_arg(args.regions),
        args.output, model=models.resolve_model(args.model),
        phasing=args.phasing, sex=args.sex,
        sex_chrs=tuple(args.sex_chrs), par_regions=args.par_regions,
        padding=args.padding, min_depth=args.min_depth,
        min_mapq=args.min_mapq, workers=args.workers,
        process_large_regions=args.process_large_regions,
        decompose=args.decompose, add_read_names=args.add_read_names,
        sample_name=args.sample_name,
        disable_outlier_filter=args.disable_outlier_filter,
        device=device)
    return 0


def _cmd_fastrle(args):
    from medaka_tpu_torch import rle
    rle.fastrle(args.input, args.output or sys.stdout,
                block_size=args.block_size)
    return 0


def _cmd_compress_bam(args):
    from medaka_tpu_torch import rle
    rle.compress_bam(
        args.bam_input, args.bam_output, args.ref_fname,
        regions=_regions_arg(args.regions) if args.regions else None,
        threads=args.threads, use_fast5_info=args.use_fast5_info)
    return 0


def _cmd_rlebam(args):
    from medaka_tpu_torch import rle
    rle.rlebam(args.read_index, workers=args.workers)
    return 0


def _cmd_export(args):
    from medaka_tpu_torch import models
    print(models.export_model(
        models.resolve_model(args.model), args.output,
        supported_basecallers=args.supported_basecallers, force=args.force))
    return 0


def _cmd_is_rle_model(args):
    from medaka_tpu_torch import models
    print(_is_rle(models.open_model(models.resolve_model(args.model))))
    return 0


def _cmd_annotate(args):
    from medaka_tpu_torch import vcf as vcf_mod
    vcf_mod.annotate_vcf_n_reads(
        args.vcf, args.ref_fasta, args.bam, args.vcfout,
        read_group=args.RG, chunk_size=args.chunk_size, pad=args.pad,
        dpsp=args.dpsp)
    return 0


def _cmd_consensus2vcf(args):
    from medaka_tpu_torch import variant
    regions = _regions_arg(args.regions) if args.regions else None
    variant.vcf_from_fasta(
        args.consensus, args.ref_fasta, args.out_prefix, regions=regions,
        chunk_size=args.chunk_size, pad=args.pad, mode=args.mode)
    return 0


def _cmd_list_models(args):
    from medaka_tpu_torch import models
    data_dirs = [
        models.DATA_DIR,
        os.path.join(os.path.expanduser("~"), ".medaka_tpu", "data")]
    found = []
    for d in data_dirs:
        if os.path.isdir(d):
            found.extend(sorted(os.listdir(d)))
    print("Locally cached models:")
    for name in found:
        print("  " + name)
    if not found:
        print("  (none)")
    return 0


def _cmd_resolve_model(args):
    from medaka_tpu_torch import models
    if args.auto_model:
        print(models.model_from_basecaller(
            args.model, variant=args.auto_model == "variant",
            bacteria=args.bacteria))
        return 0
    print(models.resolve_model(args.model))
    return 0


def _cmd_hdf_to_bed(args):
    from medaka_tpu_torch import variant
    variant.samples_to_bed(args.inputs, args.output)
    return 0


def _cmd_vcf2fasta(args):
    from medaka_tpu_torch import variant
    from medaka_tpu_torch.io.fastx import FastaReader, FastaWriter
    from medaka_tpu_torch.vcf import VCFReader
    reader = VCFReader(args.vcf)
    reader.index()
    with FastaReader(args.ref_fasta) as fa, \
            FastaWriter(args.output) as out:
        for name in fa.references:
            variants = sorted(
                reader.fetch(ref_name=name), key=lambda v: v.pos)
            out.write(name, variant.apply_variants(variants, fa.fetch(name)))
    return 0


def _cmd_prepare_tagged_bam(args):
    common.tag_merge_bams(
        args.input_bams, args.values, args.tag, args.output,
        threads=args.threads)
    return 0


def _is_rle(bundle) -> bool:
    from medaka_tpu_torch.features import HardRLEFeatureEncoder
    return isinstance(bundle.feature_encoder, HardRLEFeatureEncoder)


def _cmd_get_alignment_params(args):
    from medaka_tpu_torch import models, options
    bundle = models.open_model(models.resolve_model(args.model))
    print(options.alignment_params["rle" if _is_rle(bundle) else "non-rle"])
    return 0


def _cmd_get_model_dtypes(args):
    from medaka_tpu_torch import models
    bundle = models.open_model(models.resolve_model(args.model))
    print(list(getattr(bundle.feature_encoder, "dtypes", ("",))))
    return 0


def _cmd_download_models(args):
    from medaka_tpu_torch import models, options
    rc = 0
    for name in (args.models or options.current_models):
        try:
            print(models.download_model(name))
        except models.DownloadError as e:
            print("FAILED {}: {}".format(name, e))
            rc = 1
    return rc


def _cmd_pileup_counts(args):
    from timeit import default_timer as now

    from medaka_tpu_torch.features import pileup_counts
    region = common.Region.from_string(args.region)
    t0 = now()
    results = pileup_counts(
        region, args.bam, dtype_prefixes=args.dtypes,
        num_qstrat=args.num_qstrat)
    t1 = now()
    n_cols = sum(len(p) for _c, p in results)
    print("pileup time: {:.3f}s ({} columns, {} blocks)".format(
        t1 - t0, n_cols, len(results)))
    if args.print_rows:
        for counts, positions in results:
            for pos, row in zip(positions, counts):
                print("(%d, %d)\t" % (pos["major"], pos["minor"])
                      + "\t".join(str(x) for x in row))
    return 0


def _cmd_haploid2diploid(args):
    from medaka_tpu_torch import vcf as vcf_mod
    vcf_mod.haploid2diploid(
        args.vcf1, args.vcf2, args.ref_fasta, args.vcfout,
        adjacent=args.adjacent, discard_phase=args.discard_phase,
        split_mnp_records=args.split_mnp)
    return 0


def _cmd_diploid2haploid(args):
    from medaka_tpu_torch import vcf as vcf_mod
    print("\n".join(vcf_mod.split_variants(args.vcf, trim=not args.notrim)))
    return 0


def _cmd_classify_variants(args):
    from medaka_tpu_torch import vcf as vcf_mod
    vcf_mod.classify_variants(args)
    return 0


def _cmd_vcf2tsv(args):
    from medaka_tpu_torch import vcf as vcf_mod
    print(vcf_mod.vcf2tsv(args))
    return 0


def _cmd_homozygous_regions(args):
    from medaka_tpu_torch import vcf as vcf_mod
    vcf_mod.get_homozygous_regions(
        args.vcf, args.region, min_len=args.min_len, suffix=args.suffix)
    return 0


def _cmd_is_compatible(args):
    from medaka_tpu_torch import models
    from medaka_tpu_torch.io.bam import BamReader
    bundle = models.open_model(models.resolve_model(args.model))
    fenc = bundle.feature_encoder
    bundle.model.check_feature_encoder_compatibility(fenc)
    # a model reading dwells needs the BAM's reads to carry move tables
    if getattr(fenc, "include_dwells", False):
        with BamReader(args.bam) as br:
            for rec in br.fetch(br.references[0]):
                if "mv" not in rec.tags:
                    print("Model requires dwells but BAM reads lack mv "
                          "tags.", file=sys.stderr)
                    return 1
                break
    print("Compatible.")
    return 0


def counts_entry(argv=None):
    """``medaka_tpu_torch_counts`` console script: ``tools pileup_counts
    BAM REGION [--print ...]``."""
    return main(["tools", "pileup_counts"] + list(
        sys.argv[1:] if argv is None else argv))


def version_report(argv=None):
    """``medaka_tpu_torch_version_report`` console script: the port's,
    torch's and CUDA's versions, each visible GPU (or that CUDA is
    unavailable), whether the native library loads and whether ``nvcc``
    is on the path. A report: it launches nothing."""
    del argv
    import torch

    from medaka_tpu_torch import native
    from medaka_tpu_torch.ops import cuda_build
    print("medaka_tpu_torch {}".format(__version__))
    print("torch {} cuda {}".format(torch.__version__, torch.version.cuda))
    if torch.cuda.is_available():
        names = [torch.cuda.get_device_name(i)
                 for i in range(torch.cuda.device_count())]
        for name in sorted(set(names)):
            print("device: {} x{}".format(name, names.count(name)))
    else:
        print("device: CUDA unavailable")
    print("native library: {}".format(
        "ok" if native.available() else "UNAVAILABLE (g++ missing?)"))
    try:
        nvcc = cuda_build.find_nvcc()
    except RuntimeError:
        nvcc = "not found"
    print("nvcc: {}".format(nvcc))
    return 0


def data_path(argv=None):
    """``medaka_tpu_torch_data_path`` console script: the bundled model
    store (``options.model_stores[0]``)."""
    del argv
    from medaka_tpu_torch import options
    print(options.model_stores[0])
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
