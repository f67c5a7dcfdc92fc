"""What the measuring tools share: where their records go, the host they ran
on, env-knob arms, and a digest of a demux run's outputs."""

from __future__ import annotations

import contextlib
import gzip
import hashlib
import json
import os
from pathlib import Path
from typing import Dict, Iterator

#: every tool's record lands here, beside the harness's (``build/`` is
#: git-ignored); the JAX round's JSON files at the repository's root are
#: never written
RECORD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "fqtk_tpu_torch"

# torch is imported only where a function needs it: a pinned child that runs
# a host-only leg skips its import (seconds on one core)


def host(device: str) -> Dict[str, object]:
    """The machine a record was taken on: the card as ``nvidia-smi`` names
    it with its power limit (``cuda``; raises without a card) or ``cpu``,
    and ``os.cpu_count()``."""
    from ..bench import host_info
    from ..ops.matcher import resolve_device

    return host_info(resolve_device(device))


def init_device(device: str) -> None:
    """Start the device before a timed run: on ``cuda`` the runtime and its
    context (raises without a card); its one-off cost is not the
    pipeline's."""
    import torch

    from ..ops.matcher import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.zeros(1, device=dev)
        torch.cuda.synchronize(dev)


def pin_enforced(cpu_per_wall: float, cores: int) -> bool:
    """Whether a process pinned to ``cores`` CPUs stayed on them: its CPU
    time over its wall time can exceed ``cores`` only where the pin does not
    bind (10% and 0.1 core of slack for the clocks).  One-sided: a process
    with no more work than its cores cannot show an unenforced pin."""
    return cpu_per_wall <= cores * 1.1 + 0.1


def write_record(path: Path, record: dict) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(record, indent=1) + "\n")


def parse_arm(arm: str) -> Dict[str, str]:
    """``KEY=V[,KEY=V]`` as a dict (``""``: no variable)."""
    out = {}
    for kv in filter(None, arm.split(",")):
        key, sep, value = kv.partition("=")
        if not sep or not key:
            raise ValueError(f"an arm is KEY=V[,KEY=V], got {arm!r}")
        out[key] = value
    return out


@contextlib.contextmanager
def arm_env(arm: str) -> Iterator[None]:
    """Set an arm's variables for the ``with`` body, then restore them."""
    env = parse_arm(arm)
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def outputs_digest(out_dir: Path) -> str:
    """SHA-256 over a demux output directory: each file's relative path and
    its bytes, decompressed for ``.gz`` (BGZF blocks may differ where the
    records do not)."""
    h = hashlib.sha256()
    root = Path(out_dir)
    for p in sorted(q for q in root.rglob("*") if q.is_file()):
        data = p.read_bytes()
        if p.suffix == ".gz":
            data = gzip.decompress(data)
        name = str(p.relative_to(root)).encode()
        h.update(b"%d:%s%d:" % (len(name), name, len(data)))
        h.update(data)
    return h.hexdigest()
