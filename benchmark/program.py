"""The program's own spans and counts of a traced run, as its tracer kept
them (``program_record`` and ``setup_seconds`` of
``fqtk_tpu_torch.utils.profiling``).

:func:`record` gives the record of the run a reader reads, or ``None``: when
the program was not loaded, has no tracer (a checkout from before it), or
its newest record is not this run's (its windows are not the driver's)."""

from __future__ import annotations

import statistics
import sys
from typing import List, Optional


PROFILING = "fqtk_tpu_torch.utils.profiling"


def record(ctx: dict):
    profiling = sys.modules.get(PROFILING)
    read = getattr(profiling, "program_record", None)
    rec = read() if read is not None else None
    if rec is None or len(rec.windows) != ctx["records"].get("windows"):
        return None
    return rec


def per_window(rec, *names: str) -> List[float]:
    """Seconds of the spans named ``names``, summed per window, for each
    window with at least one of them."""
    sums: dict = {}
    for s in rec.spans:
        if s.name in names and s.window is not None:
            sums[s.window] = sums.get(s.window, 0.0) + (s.end - s.start)
    return list(sums.values())


def median_ms(ctx: dict, *names: str) -> Optional[float]:
    """Median over the run's windows of :func:`per_window`, in ms."""
    rec = record(ctx)
    times = per_window(rec, *names) if rec is not None else []
    return statistics.median(times) * 1e3 if times else None


def setup_s(ctx: dict, name: str) -> Optional[float]:
    """Seconds of the run's set-up spans ``name`` (the program's newest,
    summed within one set-up), where the run's record is this run's."""
    if record(ctx) is None:
        return None
    read = getattr(sys.modules[PROFILING], "setup_seconds", None)
    return read(name) if read is not None else None
