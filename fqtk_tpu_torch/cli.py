"""Flag-compatible command line: ``fqtk-tpu-torch <demux|subsample|concat-shards>``.

The same subcommands and flags as :mod:`fqtk_tpu.cli` (its parser is
reused and relabelled), plus ``demux --device {cuda,cpu}``.  ``demux`` runs
this package's runtime; ``subsample`` and ``concat-shards`` run the shared
host functions of ``fqtk_tpu``, which never touch a device.  Flags whose
machinery is not ported yet fail with one collected error naming the
ROADMAP item; they never run something else instead.
"""

from __future__ import annotations

import argparse
import logging
import sys
from typing import List, Optional

from . import __version__

PROG = "fqtk-tpu-torch"


def _build_parser() -> argparse.ArgumentParser:
    from fqtk_tpu.cli import _build_parser as _jax_parser

    parser = _jax_parser()
    parser.prog = PROG
    parser.description = "FASTQ toolkit on PyTorch / CUDA (Hopper)"
    subs = next(
        a for a in parser._actions if isinstance(a, argparse._SubParsersAction)
    )
    for name, sub in subs.choices.items():
        sub.prog = f"{PROG} {name}"
        for action in sub._actions:
            if isinstance(action, argparse._VersionAction):
                action.version = f"{PROG} {name} {__version__}"
    for action in parser._actions:
        if isinstance(action, argparse._VersionAction):
            action.version = f"{PROG} {__version__}"
    subs.choices["demux"].add_argument(
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
    if args.engine not in ("auto", "native"):
        errors.append(
            f"--engine {args.engine}: the Python-IO engine and its JAX/NumPy "
            "matchers are not ported yet (ROADMAP.md); use native"
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
        from fqtk_tpu.parallel.merge import concat_shards

        concat_shards(args.output, remove_shards=args.remove_shards)
        return 0
    if args.command == "subsample":
        from fqtk_tpu.runtime.subsample import SubsampleConfig, run_subsample

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
