"""The device trace of a measured window: ``torch.profiler`` (CPU and CUDA
activity) over the window, exported as a Chrome trace and read here.

Device activity is every kernel, copy and memset; the window is the
``bench.window`` range the benchmark records around it.  Idle gaps are
named by the innermost benchmark span (a ``record_function`` range of
:class:`benchmark.common.Spans`) that holds the gap's middle."""

from __future__ import annotations

import contextlib
import json
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

WINDOW_SPAN = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    #: summed device time of kernels (copies and memsets left out)
    kernel_s: float
    #: device operation name -> summed seconds
    device_ops: Dict[str, float] = field(default_factory=dict)
    #: host span name -> idle device seconds while it was innermost
    idle_by_span: Dict[str, float] = field(default_factory=dict)

    def breakdown(self, top: int = 10) -> dict:
        def head(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

        return {"device_ops": head(self.device_ops), "idle_gaps": head(self.idle_by_span)}


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def summarize(events: List[dict]) -> Optional[TraceSummary]:
    """Read Chrome-trace events (``ts``/``dur`` in microseconds); ``None``
    when the window range is missing."""
    wins = [e for e in events if e.get("cat") == "user_annotation" and e.get("name") == WINDOW_SPAN]
    if not wins:
        return None
    w0 = float(wins[0]["ts"])
    w1 = w0 + float(wins[0]["dur"])
    dev: List[Tuple[float, float]] = []
    ops: Dict[str, float] = {}
    kernel_us = 0.0
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e.get("dur", 0)), w1)
        if b <= a:
            continue
        dev.append((a, b))
        ops[e["name"]] = ops.get(e["name"], 0.0) + (b - a) * 1e-6
        if e["cat"] == "kernel":
            kernel_us += b - a
    busy = _union(dev)
    spans = sorted(
        ((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
         if e.get("cat") == "user_annotation" and e.get("name") != WINDOW_SPAN),
    )
    idle: Dict[str, float] = {}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        inner = [s for s in spans if s[0] <= mid <= s[1]]
        name = min(inner, key=lambda s: s[1] - s[0])[2] if inner else "outside spans"
        idle[name] = idle.get(name, 0.0) + (b - a) * 1e-6
    return TraceSummary(
        window_s=(w1 - w0) * 1e-6,
        busy_s=sum(b - a for a, b in busy) * 1e-6,
        kernel_s=kernel_us * 1e-6,
        device_ops=ops,
        idle_by_span=idle,
    )


class WindowTrace:
    """``with trace.window(): ...`` profiles the measured window when
    enabled; :attr:`summary` holds what was read."""

    def __init__(self, enabled: bool, workdir: Path) -> None:
        self.enabled = enabled
        self.workdir = workdir
        self.summary: Optional[TraceSummary] = None

    @contextlib.contextmanager
    def window(self) -> Iterator[None]:
        import torch

        if not self.enabled:
            yield
            return
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            with record_function(WINDOW_SPAN):
                yield
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
        path = self.workdir / "window_trace.json"
        prof.export_chrome_trace(str(path))
        with open(path) as fh:
            events = json.load(fh).get("traceEvents", [])
        os.unlink(path)
        self.summary = summarize(events)
