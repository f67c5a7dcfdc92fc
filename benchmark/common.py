"""Pieces every driver shares: the registry that finds a cell's files by
name, seed streams, the card's description, the import guard and
host-clock spans."""

from __future__ import annotations

import contextlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Dict, Iterator, List, Optional

import numpy as np

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent

#: top-level module names that may not be loaded in a run, compared whole
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "fqtk_tpu")


# --------------------------------------------------------------------------
# registry: every piece found by its name
# --------------------------------------------------------------------------

def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as fh:
        return json.load(fh)


def load_module(path: Path, tag: str) -> ModuleType:
    """Import the file ``path`` as a module of its own (names with dots, as
    a metric's, are not importable by name)."""
    if not path.is_file():
        raise FileNotFoundError(f"{path} does not exist")
    name = f"_bm_{tag}_" + "".join(c if c.isalnum() else "_" for c in path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path} does not exist")
    with open(path) as fh:
        return json.load(fh)


def resolve_cell(bench: dict, workload: str, root: Path = ROOT) -> dict:
    """The files of cell ``workload``: its entry, its configuration, its
    traffic mix, its driver and generator modules' paths, and the names of
    the metrics it reports (end-to-end, per-layer)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[cell["config"]]
    config = load_json(root / entry["file"])
    bench_dir = root / BENCH_DIR.name
    traffic = load_json(bench_dir / "traffic" / f"{cell['traffic']}.json")

    def reports(metric: dict) -> bool:
        return workload in metric.get("workloads", [workload])

    return {
        "cell": cell,
        "config_entry": entry,
        "config": config,
        "traffic": traffic,
        "driver": bench_dir / "drivers" / f"{config['driver']}.py",
        "generator": bench_dir / "generators" / f"{traffic['generator']}.py",
        "end_to_end": [m for m in bench["end_to_end"] if reports(m)],
        "per_layer": [m for m in bench["per_layer"] if reports(m)],
    }


def metric_path(name: str, root: Path = ROOT) -> Path:
    """The reader of per-layer metric ``name``: ``metrics/<name>.py``, or
    else the reader of the quantity it splits, ``metrics/<stem>.py`` for
    the name before its first dot (``dispatch_ms.uniform`` ->
    ``dispatch_ms.py``)."""
    metrics = root / BENCH_DIR.name / "metrics"
    own = metrics / f"{name}.py"
    return own if own.is_file() else metrics / f"{name.split('.', 1)[0]}.py"


# --------------------------------------------------------------------------
# seeds
# --------------------------------------------------------------------------

def seed_streams(seed: int, n: int) -> List[int]:
    """``n`` independent 63-bit seeds from the run's ``--seed`` (any whole
    number, also beyond 32 bits)."""
    state = np.random.SeedSequence(int(seed) % (1 << 64)).generate_state(n, np.uint64)
    return [int(s) & ((1 << 63) - 1) for s in state]


# --------------------------------------------------------------------------
# the card
# --------------------------------------------------------------------------

def smi_query(fields: str = "name,power.limit") -> str:
    """``nvidia-smi --query-gpu=<fields>`` of the first card, or ``""``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else ""


def power_limit_w() -> Optional[float]:
    line = smi_query("power.limit")
    try:
        return float(line.split()[0])
    except (IndexError, ValueError):
        return None


# --------------------------------------------------------------------------
# import guard
# --------------------------------------------------------------------------

def forbidden_loaded(modules=None) -> List[str]:
    """Loaded modules whose top-level name (before the first dot) equals
    one of :data:`FORBIDDEN_MODULES` exactly (``fqtk_tpu_torch`` is not
    ``fqtk_tpu``)."""
    names = sys.modules if modules is None else modules
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN_MODULES})


# --------------------------------------------------------------------------
# spans
# --------------------------------------------------------------------------

class Spans:
    """Host-clock spans from the benchmark's own files, around the calls
    into each layer: ``durations[name]`` lists each span's seconds.  Under
    a trace each span is also a ``torch.profiler.record_function`` range,
    so the trace's idle gaps can be named by it."""

    def __init__(self, annotate: bool = False) -> None:
        self.annotate = annotate
        self.durations: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        ctx = contextlib.nullcontext()
        if self.annotate:
            import torch

            ctx = torch.profiler.record_function(name)
        t0 = time.perf_counter()
        with ctx:
            try:
                yield
            finally:
                self.durations.setdefault(name, []).append(time.perf_counter() - t0)
