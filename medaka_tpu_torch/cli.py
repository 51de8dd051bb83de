"""Command line: ``python -m medaka_tpu_torch {inference,sequence}``.

Counterpart of the ``inference`` and ``sequence`` subcommands of
``medaka_tpu/cli.py``, with the same flags for the parts that are
ported. ``inference`` runs on the GPU unless ``--cpu`` is given.
"""
from __future__ import annotations

import argparse
import logging
import os
import sys

from medaka_tpu_torch import __version__, common


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
    p.add_argument("--model", required=True, help="Model bundle (tar.gz).")
    p.add_argument(
        "--batch_size", type=int, default=None,
        help="Batch size (default: auto, see prediction.auto_batch_size).")
    p.add_argument("--bam_workers", type=int, default=2)
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
    p.set_defaults(func=_cmd_inference)

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
    return parser


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
    from medaka_tpu_torch import datastore, prediction
    if (args.tag_name is None) != (args.tag_value is None):
        raise ValueError(
            "--tag_name and --tag_value must be given together "
            "(one alone would filter out every read).")
    overrides = {
        k: v for k, v in (
            ("read_group", args.RG),
            ("min_mapq", args.min_mapq),
            ("tag_name", args.tag_name),
            ("tag_value", args.tag_value),
            ("tag_keep_missing", args.tag_keep_missing or None))
        if v is not None}
    prediction.predict(
        args.bam, args.output, model_path=args.model,
        regions=_regions_arg(args.regions) if args.regions else None,
        batch_size=args.batch_size, chunk_len=args.chunk_len,
        chunk_overlap=args.chunk_ovlp, bam_workers=args.bam_workers,
        bam_chunk=args.bam_chunk, full_precision=args.full_precision,
        encoder_overrides=overrides or None,
        save_features=args.save_features,
        device="cpu" if args.cpu else "cuda")
    if args.check_output and not datastore.DataIndex(args.output).samples:
        common.get_named_logger("CheckOutput").warning(
            "Output %s contains no samples.", args.output)
    return 0


def _cmd_sequence(args):
    from medaka_tpu_torch import stitch
    stitch.stitch_to_fasta(
        args.inputs, args.draft, args.output,
        regions=_regions_arg(args.regions) if args.regions else None,
        threads=args.threads, min_depth=args.min_depth,
        fillgaps=args.fillgaps, fill_char=args.fill_char,
        qualities=args.qualities)
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
