"""Per-stage pipeline timing + optional device traces.

- :class:`StageTimers` is shared with the JAX package (it has no JAX in it).
- ``FQTK_PROFILE_DIR`` — when set, wraps the run in a ``torch.profiler``
  trace (CPU and, where a card is present, CUDA activity), written to that
  directory as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import logging
import os
from typing import Iterator

from fqtk_tpu.utils.profiling import StageTimers

__all__ = ["StageTimers", "maybe_device_trace"]

logger = logging.getLogger("fqtk")


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
