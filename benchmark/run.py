"""One run of one cell of ``BENCHMARK.json``::

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It makes the cell's inputs from the seed,
sets up and warms the program (``fqtk_tpu_torch`` in this checkout),
measures for ``--seconds``, checks what the timed path produced against the
plain reference, and prints one JSON object as its last line of standard
output: with ``--trace 0`` the cell's end-to-end metrics, with ``--trace 1``
its per-layer metrics read from the device trace of the window.  The
numbers compared, each beside its limit, are the last lines of standard
error and the last key of the result.

It exits 2 without a result where CUDA is unavailable or there are fewer
cards than the cell asks for, and 3 where the process has loaded JAX, the
JAX package or Flax by the end of the window."""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import logging  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, Optional  # noqa: E402

from benchmark import common  # noqa: E402
from benchmark.trace import WindowTrace  # noqa: E402


def _log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def _prepare_env(root: Path) -> None:
    """Clear the program's tuning knobs, and keep every compile cache
    inside the checkout, at fixed paths."""
    for key in list(os.environ):
        if key.startswith("FQTK_"):
            del os.environ[key]
    cache = root / "build" / "benchmark"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda_cache")


class Context:
    """What a driver gets: the cell's pieces, the seed, the window length,
    the device, a work directory under ``TMPDIR``, spans and the window's
    trace.  A driver sets up, enters :meth:`window` around its measured
    loop, and returns its records and checks."""

    def __init__(self, resolved: dict, seed: int, seconds: float, trace: bool,
                 device: str, workdir: Path, control: bool = False) -> None:
        self.cell = resolved["cell"]
        self.config = resolved["config"]
        self.traffic = resolved["traffic"]
        self.generator = common.load_module(resolved["generator"], "generator")
        self.seed = seed
        self.seconds = seconds
        self.device = device
        self.workdir = workdir
        self.control = control
        self.spans = common.Spans(annotate=trace)
        self.tracer = WindowTrace(trace, workdir)
        self.setup_s: Optional[float] = None

    @contextlib.contextmanager
    def window(self):
        """The measured window: set-up ends here (its spans are logged and
        cleared), and under ``--trace 1`` the profiler runs over it."""
        self.setup_s = time.perf_counter() - T0
        parts = ", ".join(f"{k[6:]} {sum(v):.3f}" for k, v in self.spans.durations.items()
                          if k.startswith("setup."))
        _log(f"set-up {self.setup_s:.3f} s ({parts}; the rest is start-up and imports)")
        self.spans.durations.clear()
        with self.tracer.window():
            yield

    def log(self, msg: str) -> None:
        _log(msg)


def _device_info(device: str, count: int) -> dict:
    import torch

    if device == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
                "power_limit_w": common.power_limit_w()}
    return {"platform": "cpu", "kind": "cpu", "count": count}


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", root: Path = common.ROOT, overrides: Optional[dict] = None,
             control: bool = False) -> dict:
    """Run the cell and return the result object (without printing it).
    ``overrides`` replaces keys of the configuration's ``deployment`` and
    of the traffic mix (``{"deployment": {...}, "traffic": {...}}``), for
    tests at a size a CPU holds; ``control`` puts the driver's control in
    the program's place."""
    resolved = common.resolve_cell(common.load_benchmark(root), workload, root)
    for part, key in (("deployment", "config"), ("traffic", "traffic")):
        if overrides and part in overrides:
            target = resolved[key]["deployment"] if part == "deployment" else resolved[key]
            target.update(overrides[part])
    driver = common.load_module(resolved["driver"], "driver")
    workdir = Path(tempfile.mkdtemp(prefix="fqtk-bench-", dir=tempfile.gettempdir()))
    # the placement probe's decision file: each run decides anew
    os.environ["FQTK_CACHE_DIR"] = str(workdir / "fqtk_cache")
    try:
        ctx = Context(resolved, seed, seconds, trace, device, workdir, control=control)
        out = driver.run(ctx)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    records = out["records"]
    dev = {**_device_info(device, resolved["cell"]["chips"]),
           "memory_peak_bytes": int(out["memory_peak_bytes"])}
    metrics: Dict[str, dict] = {}
    result = {"correct": None, "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics, "device": dev}
    if not trace:
        e2e = {**out["end_to_end"], "setup_s": ctx.setup_s}
        for m in resolved["end_to_end"]:
            # a metric split by cell (``window_p95_ms.uniform``, a bound of
            # its own) reads the driver's quantity of the name before the dot
            key = m["name"] if m["name"] in e2e else m["name"].split(".", 1)[0]
            if key not in e2e:
                raise KeyError(f"driver {ctx.config['driver']} gives no {m['name']}")
            metrics[m["name"]] = {"value": float(e2e[key]), "unit": m["unit"]}
    else:
        summary = ctx.tracer.summary
        if summary is not None:
            dev["busy_s"] = summary.busy_s
            dev["window_s"] = summary.window_s
            result["breakdown"] = summary.breakdown()
        reader_ctx = {"records": records, "trace": summary, "device": dev}
        for m in resolved["per_layer"]:
            value = common.load_module(common.metric_path(m["name"], root), "metric").read(reader_ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    checks = out["checks"]
    result["correct"] = bool(checks) and all(c["value"] <= c["limit"] for c in checks.values())
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _prepare_env(common.ROOT)
    import torch

    chips = {w["name"]: w for w in common.load_benchmark()["workloads"]}[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        _log(f"needs {chips} CUDA device(s): available {torch.cuda.is_available()}, "
             f"count {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    import fqtk_tpu_torch

    if Path(fqtk_tpu_torch.__file__).resolve().parent.parent != common.ROOT:
        _log(f"fqtk_tpu_torch loaded from {fqtk_tpu_torch.__file__}, not this checkout")
        return 2
    _log(f"card: {common.smi_query('name,power.limit,clocks.sm,clocks.max.sm,temperature.gpu')}")
    # the program's own log lines (placement, dedup, stage times) on stderr
    logging.basicConfig(level=logging.INFO, stream=sys.stderr, format="[fqtk] %(message)s")
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = common.forbidden_loaded()
    if bad:
        _log(f"forbidden modules loaded: {', '.join(bad)}")
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
