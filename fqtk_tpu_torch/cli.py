"""Flag-compatible command line: ``fqtk-tpu-torch <demux|subsample|concat-shards>``.

The same subcommands, flags, defaults and help as ``fqtk_tpu/cli.py`` (the
parser is the port's own copy, so that the JAX package's flag surface still
parses), plus ``demux --device {cuda,cpu}``.  ``demux`` runs this package's
runtime (``--engine jax|pallas|numpy``: its Python-IO engine, with the
chunked scan, the Hopper kernels or the NumPy spec as the matcher);
``subsample`` and ``concat-shards`` run its host functions, which never
touch a device.  Flags whose machinery is not ported yet (``--devices N>1``,
the multi-host flags) fail with one collected error naming the ROADMAP
item; they never run something else instead.
"""

from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path
from typing import List, Optional

from . import __version__

PROG = "fqtk-tpu-torch"


def _build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog=PROG, description="FASTQ toolkit on PyTorch / CUDA (Hopper)"
    )
    parser.add_argument("--version", action="version", version=f"{PROG} {__version__}")
    sub = parser.add_subparsers(dest="command", required=True)

    demux = sub.add_parser(
        "demux",
        help="Performs sample demultiplexing on FASTQs.",
        description=(
            "Performs sample demultiplexing on FASTQs. The sample barcode for "
            "each sample in the metadata TSV is compared against the sample "
            "barcode bases extracted from the FASTQs to assign each read to a "
            "sample; reads that do not match any sample within the given "
            "error tolerance are placed in the unmatched-prefix files."
        ),
    )
    demux.add_argument(
        "--inputs", "-i", nargs="+", required=True, type=Path,
        help="One or more input FASTQ files each corresponding to a "
        "sequencing read (e.g. R1, I1).",
    )
    demux.add_argument(
        "--read-structures", "-r", nargs="+", required=True,
        help="The read structures, one per input FASTQ in the same order.",
    )
    demux.add_argument(
        "--output-types", "-b", nargs="+", default=["T"],
        help="The read structure types to write to their own files (one of "
        "T, B, M, or C for template, sample barcode, molecular barcode, or "
        "cellular barcode reads).",
    )
    demux.add_argument(
        "--sample-metadata", "-s", required=True, type=Path,
        help="A file containing the metadata about the samples (headered "
        "TSV with sample_id and barcode columns).",
    )
    demux.add_argument(
        "--output", "-o", required=True, type=Path,
        help="The output directory into which to write per-sample FASTQs.",
    )
    demux.add_argument(
        "--unmatched-prefix", "-u", default="unmatched",
        help="Output prefix for FASTQ file(s) for reads that cannot be "
        "matched to a sample.",
    )
    demux.add_argument(
        "--max-mismatches", type=int, default=1,
        help="Maximum mismatches for a barcode to be considered a match.",
    )
    demux.add_argument(
        "--min-mismatch-delta", "-d", type=int, default=2,
        help="Minimum difference between number of mismatches in the best "
        "and second best barcodes for a barcode to be considered a match.",
    )
    demux.add_argument(
        "--threads", "-t", type=int, default=8,
        help="The number of threads to use. Cannot be less than 5.",
    )
    demux.add_argument(
        "--compression-level", "-c", type=int, default=5,
        help="The level of compression to use to compress outputs.",
    )
    demux.add_argument(
        # nargs="+": a bare -S must be a parse error like clap's
        # Vec<SkipReason> (an empty list would silently disable skipping)
        "--skip-reasons", "-S", nargs="+", default=[],
        help="Skip demultiplexing reads for any of the following reasons, "
        "otherwise panic: 'too-few-bases' (too few bases/qualities to "
        "extract given the read structures).",
    )
    # engine extensions (not in the reference CLI)
    demux.add_argument(
        "--batch-size", type=int, default=1 << 17,
        help="Reads per device batch (engine extension).",
    )
    demux.add_argument(
        "--engine",
        choices=["auto", "native", "jax", "pallas", "numpy"],
        default="auto",
        help="Compute engine: auto = C++ host I/O + JAX matcher when "
        "available (engine extension).",
    )
    demux.add_argument(
        "--matcher",
        choices=["auto", "host", "device"],
        default="auto",
        help="Assignment placement: auto measures one host window against "
        "one device round-trip at the production batch and picks the "
        "faster side (decision cached on disk; FQTK_HOST_MATCHER_MAX_K "
        "pins a static whitelist-size crossover instead), huge whitelists "
        "use the host pigeonhole matcher (engine extension).",
    )
    # per-subcommand --version, as clap's #[command(version)] provides
    demux.add_argument(
        "--version", action="version", version=f"{PROG} demux {__version__}"
    )
    demux.add_argument(
        "--devices",
        type=int,
        default=None,
        help="Device-mesh size for the matcher: default all local devices "
        "(batch-parallel; whitelist-sharded for huge sample sets), 1 forces "
        "single-device (engine extension).",
    )
    demux.add_argument(
        "--distributed-coordinator",
        default=None,
        metavar="HOST:PORT",
        help="Multi-host mode: jax.distributed coordinator address.  Each "
        "process demuxes its own --inputs shard into "
        "{output}/shard-{process_id}/ and the global demux-metrics.txt is "
        "merged exactly across hosts (engine extension).",
    )
    demux.add_argument(
        "--num-processes", type=int, default=None,
        help="Multi-host mode: total process count.",
    )
    demux.add_argument(
        "--process-id", type=int, default=None,
        help="Multi-host mode: this process's id (0-based).",
    )
    demux.add_argument(
        "--merge-output", action="store_true",
        help="Multi-host mode: after all hosts finish, process 0 merges the "
        "shard-N directories into single per-sample files at the output "
        "root (BGZF block concatenation; also available offline as the "
        "concat-shards subcommand) (engine extension).",
    )

    cs = sub.add_parser(
        "concat-shards",
        help="Merges a multi-host demux output's shard-N directories into "
        "single per-sample FASTQs.",
        description=(
            "Merges {output}/shard-N/*.fq.gz (written by demux "
            "--distributed-coordinator) into single per-sample files at the "
            "output root. BGZF blocks are concatenated without "
            "recompression; the merged files' decompressed contents are "
            "identical to a single-process run over the concatenated "
            "inputs."
        ),
    )
    cs.add_argument(
        "--output", "-o", required=True, type=Path,
        help="The demux output directory containing shard-N subdirectories.",
    )
    cs.add_argument(
        "--remove-shards", action="store_true",
        help="Delete the shard-N directories after a successful merge.",
    )
    cs.add_argument(
        "--version", action="version",
        version=f"{PROG} concat-shards {__version__}",
    )

    ss = sub.add_parser(
        "subsample", help="Subsamples reads from one or more synchronized FASTQ files."
    )
    ss.add_argument(
        "--inputs", "-i", nargs="+", required=True, type=Path,
        help="One or more input FASTQ files (may be gzipped). All files must "
        "have the same number of reads in the same order.",
    )
    ss.add_argument(
        "--output", "-o", required=True, type=Path,
        help="Output path prefix. Files will be named {output}.R1.fq.gz, etc.",
    )
    ss.add_argument(
        "--fraction", "-f", type=float, required=True,
        help="Fraction of reads to retain, in the range [0.0, 1.0].",
    )
    ss.add_argument(
        "--threads", "-t", type=int, default=8,
        help="Number of threads for compression. Minimum 2.",
    )
    ss.add_argument(
        "--compression-level", "-c", type=int, default=5,
        help="BGZF compression level for output files.",
    )
    ss.add_argument(
        "--seed",
        "-s",
        type=int,
        default=None,
        help=(
            "Explicit RNG seed for reproducibility; with a seed the keep/drop "
            "mask matches fqtk bit-for-bit.  When omitted a deterministic "
            "seed is derived from all other parameters via the reference's "
            "DefaultHasher (SipHash-1-3) derivation."
        ),
    )
    ss.add_argument(
        "--version", action="version", version=f"{PROG} subsample {__version__}"
    )
    ss.add_argument(
        "--disable-read-name-checking", action="store_true",
        help="Disable checking that read names are in sync across input files.",
    )
    demux.add_argument(
        "--device",
        choices=["cuda", "cpu"],
        default="cuda",
        help="Where device-placed assignment runs: cuda (the Hopper kernel; "
        "fails without a card) or cpu (its plain PyTorch version) (engine "
        "extension).",
    )
    return parser


def _unported(args) -> List[str]:
    """Collected errors for demux flags whose machinery is not ported."""
    errors = []
    multihost = [
        flag
        for flag, value in (
            ("--distributed-coordinator", args.distributed_coordinator),
            ("--num-processes", args.num_processes),
            ("--process-id", args.process_id),
            ("--merge-output", args.merge_output or None),
        )
        if value is not None
    ]
    if multihost:
        errors.append(
            f"{', '.join(multihost)}: multi-process demux on "
            "torch.distributed is not ported yet (ROADMAP.md)"
        )
    if args.devices is not None and args.devices > 1:
        errors.append(
            f"--devices {args.devices}: the multi-GPU mesh is not ported yet "
            "(ROADMAP.md)"
        )
    return errors


def main(argv: Optional[List[str]] = None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="[%(asctime)s] %(levelname)s %(name)s: %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S",
    )
    args = _build_parser().parse_args(argv)
    try:
        return _dispatch(args)
    except Exception as e:  # clean operator-facing errors, like the reference CLI
        print(f"Error: {e}", file=sys.stderr)
        return 1


def _dispatch(args) -> int:
    if args.command == "demux":
        errors = _unported(args)
        if errors:
            raise ValueError(
                "Unsupported options for fqtk-tpu-torch demux:\n"
                + "".join(f"    - {e}\n" for e in errors)
            )
        from .runtime.demux import DemuxConfig, run_demux

        cfg = DemuxConfig(
            inputs=list(args.inputs),
            read_structures=list(args.read_structures),
            sample_metadata=args.sample_metadata,
            output=args.output,
            output_types=list(args.output_types),
            unmatched_prefix=args.unmatched_prefix,
            max_mismatches=args.max_mismatches,
            min_mismatch_delta=args.min_mismatch_delta,
            threads=args.threads,
            compression_level=args.compression_level,
            skip_reasons=list(args.skip_reasons),
            batch_size=args.batch_size,
            engine=args.engine,
            devices=args.devices,
            matcher=args.matcher,
            device=args.device,
        )
        run_demux(cfg)
        return 0
    if args.command == "concat-shards":
        from .parallel.merge import concat_shards

        concat_shards(args.output, remove_shards=args.remove_shards)
        return 0
    if args.command == "subsample":
        from .runtime.subsample import SubsampleConfig, run_subsample

        cfg = SubsampleConfig(
            inputs=list(args.inputs),
            output=args.output,
            fraction=args.fraction,
            threads=args.threads,
            compression_level=args.compression_level,
            seed=args.seed,
            disable_read_name_checking=args.disable_read_name_checking,
        )
        run_subsample(cfg)
        return 0
    return 2  # pragma: no cover


if __name__ == "__main__":
    sys.exit(main())
