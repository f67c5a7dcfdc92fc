"""Per-stage pipeline timing, program spans and optional device traces.

- :class:`StageTimers` — cumulative wall-clock per pipeline stage, logged at
  the end of a run and returned in ``DemuxResult.timings`` (the port's copy
  of ``fqtk_tpu/utils/profiling.py``'s, without its ``jax.profiler`` half).
  While a profiler records, each stage is also a ``fqtk.stage.<stage>``
  span.
- ``FQTK_PROFILE_DIR`` — when set, wraps the run in a ``torch.profiler``
  trace (CPU and, where a card is present, CUDA activity), written to that
  directory as a Chrome trace.
- :data:`TRACER` — the program's spans (:class:`Tracer`).  A window's spans
  record only while a ``torch.profiler`` session records: each is then a
  ``record_function`` range, on the trace's clock beside the kernels and
  copies, and is kept in memory with the window dedup's counts over the
  session (:meth:`Tracer.program_record`).  With no profiler recording a
  span site costs one flag test: no range is entered and no clock read.
  Set-up spans (:meth:`Tracer.setup_span`) record always, in memory; the
  demux logs its run's (:meth:`Tracer.log_setup`).

Span names (``fqtk.`` + layer + part):

======================= ======================================================
``fqtk.dedup.unique``   the window dedup's key build, the sort that finds the
                        distinct keys (packed, or ``np.unique`` for wide
                        rows) and, where it engages, the inverse map
``fqtk.dedup.gather``   the distinct rows written to the bucket and padded
``fqtk.matcher``        the device matcher's call, whatever the route
``fqtk.matcher.h2d``    ``HopperAssignFn``: rows to the device
``fqtk.matcher.launch`` ``HopperAssignFn``: the kernel's top-2
``fqtk.matcher.gate``   ``HopperAssignFn``: the assignment gates
``fqtk.fetch.own``      ``_Pending.fetch``: wait for the window's own work
                        and, on a card, its D2H copy to pinned memory
``fqtk.fetch.copy``     ``_Pending.fetch``: the result handed to the host
                        after that (on the CPU, ``.numpy()``)
``fqtk.dedup.scatter``  the results scattered back through the inverse map
``fqtk.setup.expected`` ``ExpectedSet.from_barcodes`` (children ``.empty``,
                        ``.encode``, ``.lengths``, ``.nocalls``, ``.masks``)
``fqtk.setup.table``    ``hopper_state_from_numpy``, or a mesh's shards
                        (children ``.compat``, ``.upload``, ``.pack``)
``fqtk.setup.kernels``  the first ``load_kernel``; counts ``built``/``reused``
======================= ======================================================
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import os
import time
from collections import defaultdict
from dataclasses import asdict, dataclass, field
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler

__all__ = [
    "ProgramRecord",
    "SetupSpan",
    "Span",
    "StageTimers",
    "TRACER",
    "Tracer",
    "maybe_device_trace",
    "program_record",
    "setup_seconds",
    "tracing",
]

logger = logging.getLogger("fqtk")


def tracing() -> bool:
    """Whether a ``torch.profiler`` session records now (the profiler's own
    flag: one attribute read)."""
    return _autograd_profiler._is_profiler_enabled


class Span(NamedTuple):
    """A window span's name, window id (``None`` for work outside a window)
    and host ``perf_counter`` start and end."""

    name: str
    window: Optional[int]
    start: float
    end: float


class SetupSpan:
    """The set-up spans of one name within one outermost set-up span,
    summed (a mesh's shards each build their table's parts inside its
    ``fqtk.setup.table``): the first one's host start, their number, their
    summed counts (``fqtk.setup.kernels``: ``built``, ``reused``) and
    :attr:`seconds`."""

    __slots__ = ("name", "scope", "start", "calls", "counts", "_parts")

    def __init__(self, name: str, scope: int, start: float) -> None:
        self.name = name
        self.scope = scope
        self.start = start
        self.calls = 0
        self.counts: Dict[str, int] = {}
        self._parts: List[Tuple[float, Optional[tuple]]] = []

    def add(self, host_s: float, events: Optional[tuple], counts: Dict[str, int]) -> None:
        self.calls += 1
        self._parts.append((host_s, events))
        for key, value in counts.items():
            self.counts[key] = self.counts.get(key, 0) + value

    @property
    def seconds(self) -> float:
        """The spans' summed seconds, each to the later of its host end and
        the end of the device work queued in it (its CUDA events, waited on
        here: the program itself does not wait for them)."""
        total = 0.0
        for host_s, events in self._parts:
            if events is not None:
                events[1].synchronize()
                host_s = max(host_s, events[0].elapsed_time(events[1]) / 1e3)
            total += host_s
        return total


@dataclass
class ProgramRecord:
    """What one profiling session recorded: the windows dispatched in it
    (ids in order), their spans, and the window dedup's counts over them
    (:meth:`dedup`)."""

    windows: List[int] = field(default_factory=list)
    spans: List[Span] = field(default_factory=list)
    closed: bool = False
    #: the dedup's cumulative counts (a dataclass), their values at the
    #: session's first window and when the record closed
    counts: object = None
    counts_open: Optional[Dict[str, int]] = None
    counts_close: Optional[Dict[str, int]] = None

    def close(self) -> None:
        self.closed = True
        if self.counts is not None and self.counts_close is None:
            self.counts_close = asdict(self.counts)

    def dedup(self) -> Optional[Dict[str, int]]:
        """The window dedup's counts over the session's windows (the fields
        of ``runtime.demux.DedupCounts``), or ``None`` where none ran."""
        if self.counts_open is None:
            return None
        end = self.counts_close if self.counts_close is not None else asdict(self.counts)
        return {key: end[key] - value for key, value in self.counts_open.items()}


class _NullSpan:
    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_NULL = _NullSpan()


class _Span:
    """A span while a profiler records: a ``record_function`` range and an
    entry in the tracer's record."""

    __slots__ = ("tracer", "name", "window", "rf", "t0")

    def __init__(self, tracer: "Tracer", name: str, window: Optional[int]) -> None:
        self.tracer = tracer
        self.name = name
        self.window = window

    def __enter__(self) -> None:
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter()
        self.rf.__exit__(*exc)
        self.tracer._live().spans.append(Span(self.name, self.window, self.t0, t1))
        return False


class Tracer:
    """The program's window spans, per profiling session, and its set-up
    spans.

    A record opens at the first span or window of a profiling session and
    closes at the first window dispatched, or the first read of the record,
    after it; so each session reads only its own spans."""

    def __init__(self) -> None:
        self.record: Optional[ProgramRecord] = None
        #: set-up spans, profiling or not: of each name, those of the newest
        #: outermost set-up span that holds one (:class:`SetupSpan`)
        self.setup: Dict[str, SetupSpan] = {}
        self.window: Optional[int] = None
        self._ids = itertools.count(1)
        self._open: List[str] = []
        self._scope = 0

    def _live(self) -> ProgramRecord:
        rec = self.record
        if rec is None or rec.closed:
            rec = self.record = ProgramRecord()
        return rec

    def span(self, name: str, window: Optional[int] = None):
        """``with tracer.span(name):`` — a span of ``window`` (default: the
        window being dispatched) while a profiler records, else nothing."""
        if not _autograd_profiler._is_profiler_enabled:
            return _NULL
        return _Span(self, name, self.window if window is None else window)

    @contextlib.contextmanager
    def setup_span(self, name: str, device: Optional[torch.device] = None
                   ) -> Iterator[Dict[str, int]]:
        """A one-off set-up span, recorded always (also a ``record_function``
        range while a profiler records); yields a dict for its counts.  On a
        CUDA ``device`` it also holds the device work queued in it (two
        events, read only by :attr:`SetupSpan.seconds`).  Inside a span of
        its own name it records nothing (that span holds it); a block that
        raises records nothing."""
        counts: Dict[str, int] = {}
        if name in self._open:
            yield counts
            return
        if not self._open:
            self._scope += 1
        events = None
        if device is not None and device.type == "cuda":
            stream = torch.cuda.current_stream(device)
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record(stream)
        rf = (torch.profiler.record_function(name) if tracing()
              else contextlib.nullcontext())
        self._open.append(name)
        t0 = time.perf_counter()
        try:
            with rf:
                yield counts
        finally:
            self._open.pop()
        if events is not None:
            events[1].record(stream)
        host_s = time.perf_counter() - t0
        span = self.setup.get(name)
        if span is None or span.scope != self._scope:
            span = self.setup[name] = SetupSpan(name, self._scope, t0)
        span.add(host_s, events, counts)

    def setup_seconds(self, name: str) -> Optional[float]:
        """:attr:`SetupSpan.seconds` of the newest set-up spans ``name``."""
        span = self.setup.get(name)
        return span.seconds if span is not None else None

    def log_setup(self, since: float) -> None:
        """Log, in one line, the set-up spans that started at ``since``
        (``perf_counter``) or later, in the order they started: each
        outermost one's seconds with its children's and its counts."""
        spans = sorted((s for s in self.setup.values() if s.start >= since),
                       key=lambda s: s.start)
        parts = []
        for span in spans:
            if any(span.name.startswith(f"{p.name}.") for p in spans):
                continue  # a child, given with its parent
            inner = [f"{c.name[len(span.name) + 1:]} {c.seconds:.3f}" for c in spans
                     if c.name.startswith(f"{span.name}.")]
            inner += [f"{key} {value}" for key, value in span.counts.items()]
            parts.append(f"{span.name} {span.seconds:.3f} s"
                         + (f" ({', '.join(inner)})" if inner else ""))
        if parts:
            logger.info("set-up spans: %s", "; ".join(parts))

    def begin_window(self, counts=None) -> Optional[int]:
        """A new window's id while a profiler records (the current window of
        the spans until :meth:`end_window`), else ``None``, closing the
        record of an ended session.  ``counts`` are the window dedup's
        cumulative counts (a dataclass), read at the session's first window
        and when its record closes (:meth:`ProgramRecord.dedup`)."""
        if not _autograd_profiler._is_profiler_enabled:
            rec = self.record
            if rec is not None and not rec.closed:
                rec.close()
            return None
        rec = self._live()
        if rec.counts is None and counts is not None:
            rec.counts, rec.counts_open = counts, asdict(counts)
        self.window = next(self._ids)
        rec.windows.append(self.window)
        return self.window

    def end_window(self) -> None:
        self.window = None

    def program_record(self) -> Optional[ProgramRecord]:
        """The newest session's record (closed if its session has ended), or
        ``None`` when no session recorded a span."""
        if self.record is not None and not tracing():
            self.record.close()
        return self.record


#: the process's tracer (the profiler, which gates it, is process-wide too)
TRACER = Tracer()
program_record = TRACER.program_record
setup_seconds = TRACER.setup_seconds


class StageTimers:
    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def time(self, stage: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            with TRACER.span(f"fqtk.stage.{stage}"):
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
