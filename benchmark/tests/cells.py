"""The cells of ``BENCHMARK.json`` and each cell's size for the CPU tests.

A cell's CPU size is the data file ``sizes/<cell>.json`` beside this
module: the ``overrides`` that :func:`benchmark.run.run_cell` takes
(``{"deployment": {...}, "traffic": {...}}``) under ``tiny``, for every
per-cell test, and under ``faults``, for the sound run, the faults and the
control, where those need another size (the control fails only where
rivals lie at distance 2); ``why`` says which behaviour of the full cell
the size keeps.  A new cell brings its own file, and every per-cell test
picks it up by the name in ``BENCHMARK.json``."""

from __future__ import annotations

from pathlib import Path
from typing import List

from benchmark import common

#: the sizes a size file may hold; ``tiny`` is required
KINDS = ("tiny", "faults")


def cells(root: Path = common.ROOT) -> List[str]:
    """The names of the cells in ``root``'s ``BENCHMARK.json``."""
    return [w["name"] for w in common.load_benchmark(root)["workloads"]]


def sizes_dir(root: Path = common.ROOT) -> Path:
    return root / common.BENCH_DIR.name / "tests" / "sizes"


def cpu_size(cell: str, kind: str = "tiny", root: Path = common.ROOT) -> dict:
    """The overrides of ``cell`` at its ``kind`` of CPU size (``faults``
    falls back to ``tiny`` where the file has none)."""
    if kind not in KINDS:
        raise ValueError(f"no CPU size {kind!r}: one of {KINDS}")
    path = sizes_dir(root) / f"{cell}.json"
    if not path.is_file():
        raise FileNotFoundError(
            f"cell {cell!r} has no CPU size: add {path.relative_to(root)} "
            f"(its overrides under {' and '.join(KINDS)}, as {__name__} says)")
    size = common.load_json(path)
    return size[kind] if kind in size else size["tiny"]
