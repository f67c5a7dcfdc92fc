"""Per-stage pipeline timing + optional device traces.

- :class:`StageTimers` — cumulative wall-clock per pipeline stage, logged at
  the end of a run and returned in ``DemuxResult.timings`` (the port's copy
  of ``fqtk_tpu/utils/profiling.py``'s, without its ``jax.profiler`` half).
- ``FQTK_PROFILE_DIR`` — when set, wraps the run in a ``torch.profiler``
  trace (CPU and, where a card is present, CUDA activity), written to that
  directory as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import defaultdict
from typing import Dict, Iterator

__all__ = ["StageTimers", "maybe_device_trace"]

logger = logging.getLogger("fqtk")


class StageTimers:
    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def time(self, stage: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[stage] += time.perf_counter() - t0
            self.counts[stage] += 1

    def summary(self) -> Dict[str, float]:
        return dict(self.totals)

    def log(self, total_records: int) -> None:
        if not self.totals:
            return
        parts = []
        for stage, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            rate = total_records / t if t > 0 else float("inf")
            parts.append(f"{stage}={t:.2f}s ({rate / 1e6:.2f}M/s)")
        logger.info("pipeline stage times (wall, overlapped): %s", ", ".join(parts))


@contextlib.contextmanager
def maybe_device_trace() -> Iterator[None]:
    """``torch.profiler`` trace when FQTK_PROFILE_DIR is set."""
    trace_dir = os.environ.get("FQTK_PROFILE_DIR")
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(trace_dir, f"fqtk_trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    logger.info("device trace written to %s", path)
