"""Multi-host output merge: ``shard-{pid}/`` directories -> single files.

The port's own copy of ``fqtk_tpu/parallel/merge.py`` (host code, no device library):
the two packages share no Python module.

The multi-process runtime (:mod:`fqtk_tpu_torch.parallel.distributed`, the
``torch.distributed`` counterpart of ``fqtk_tpu/parallel/distributed.py``)
writes each process's per-sample FASTQs under ``{output}/shard-{pid}/``; the
global view
is the in-order concatenation of shards (the same contract the reference's
documented "concatenate lanes before demuxing" workflow implies for lane
shards — ``README.md:85-98``).  This module realizes that
view: it concatenates each sample's shard files into one **valid BGZF** file
per sample at the output root.

BGZF makes this exact and cheap: a BGZF file is a sequence of independent
gzip members terminated by a fixed 28-byte empty EOF block, so stripping
every shard's trailing EOF block(s) and appending one final EOF yields a
spec-valid BGZF file whose *decompressed* bytes are exactly the shard
contents in order — i.e. identical to a single-process run over the
concatenated inputs (compressed-level identity is not meaningful across
different block boundaries).  No recompression happens; the merge is pure
I/O at disk bandwidth.
"""

from __future__ import annotations

import logging
import shutil
from pathlib import Path
from typing import List

from ..io.fastq import _BGZF_EOF

logger = logging.getLogger("fqtk")


class MergeError(RuntimeError):
    pass


def _shard_dirs(output: Path, expected_shards: int = None) -> List[Path]:
    """``shard-{pid}`` subdirectories in pid order; error on gaps.

    ``expected_shards`` (when the caller knows the process count) guards
    against a silently-partial merge: a contiguous prefix ``[0..m]`` of a
    larger run (lagging shared-filesystem visibility, a failed host) is an
    error, not a smaller merge."""
    if not output.is_dir():
        raise MergeError(f'Output path "{output}" is not a directory')
    shards = []
    for p in output.iterdir():
        if p.is_dir() and p.name.startswith("shard-"):
            try:
                pid = int(p.name[len("shard-"):])
            except ValueError:
                continue
            shards.append((pid, p))
    shards.sort()
    if not shards:
        raise MergeError(f'No shard-N directories under "{output}"')
    pids = [pid for pid, _ in shards]
    if pids != list(range(len(pids))):
        raise MergeError(
            f"Shard directories are not contiguous from 0: found {pids}"
        )
    if expected_shards is not None and len(pids) != expected_shards:
        raise MergeError(
            f"Expected {expected_shards} shard directories, found "
            f"{len(pids)} under \"{output}\" (missing shards would merge "
            "a partial view)"
        )
    return [p for _, p in shards]


def _strip_trailing_eof(data: bytes) -> bytes:
    """Drop trailing empty BGZF EOF block(s); mid-file blocks untouched."""
    while data.endswith(_BGZF_EOF):
        data = data[: -len(_BGZF_EOF)]
    return data


def concat_shards(
    output: Path,
    remove_shards: bool = False,
    buffer_bytes: int = 8 << 20,
    expected_shards: int = None,
) -> List[Path]:
    """Merge ``{output}/shard-{pid}/*.fq.gz`` into ``{output}/*.fq.gz``.

    Every shard must contain the same set of ``.fq.gz`` file names (each
    process creates the full per-sample writer set from the shared sample
    metadata, so a missing name means a failed or foreign shard — error out
    rather than silently merging a partial view).  Returns the merged paths.
    """
    output = Path(output)
    # the streaming loop below must keep >= one EOF block (28B) plus slack
    # in the inspected tail; tiny buffers would make `remaining - 64` < 0
    buffer_bytes = max(buffer_bytes, 128)
    shards = _shard_dirs(output, expected_shards=expected_shards)
    names = sorted(p.name for p in shards[0].glob("*.fq.gz"))
    if not names:
        raise MergeError(f'No .fq.gz outputs in "{shards[0]}"')
    for sd in shards[1:]:
        got = sorted(p.name for p in sd.glob("*.fq.gz"))
        if got != names:
            missing = sorted(set(names) ^ set(got))
            raise MergeError(
                f'Shard "{sd.name}" output set differs from '
                f'"{shards[0].name}": {missing}'
            )

    merged: List[Path] = []
    for name in names:
        dst = output / name
        with open(dst, "wb") as out:
            for i, sd in enumerate(shards):
                src = sd / name
                size = src.stat().st_size
                with open(src, "rb") as fh:
                    # stream all but the final buffer straight through; only
                    # the tail needs EOF-block inspection
                    remaining = size
                    while remaining > buffer_bytes:
                        # never stream the last 64 bytes: an EOF block (28B)
                        # must land wholly inside the inspected tail
                        chunk = fh.read(min(buffer_bytes, remaining - 64))
                        if not chunk:
                            break  # file shrank under us; tail read decides
                        out.write(chunk)
                        remaining -= len(chunk)
                    tail = fh.read()
                out.write(_strip_trailing_eof(tail))
            out.write(_BGZF_EOF)
        merged.append(dst)
    logger.info(
        "Merged %d shard(s) into %d per-sample file(s) under %s",
        len(shards),
        len(merged),
        output,
    )
    if remove_shards:
        for sd in shards:
            shutil.rmtree(sd)
    return merged
