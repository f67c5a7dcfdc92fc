"""Measure the Rust-fqtk baseline proxy on this host, the counterpart of
``scripts/measure_baseline.py``.

There is no Rust toolchain here, so this measures the closest defensible
proxy, as there: the C++ re-creation of the reference's own pipeline
architecture (``native/fqtk_io.cpp`` ``refproxy_run``: read-ahead threads,
ONE main thread with the scalar branch-and-bound matcher and its memo
cache, the remaining threads compressing BGZF at level 5), through
``fqtk_tpu_torch.bench.run_refproxy`` on the harness's dual-index
paired-end inputs, best of ``--trials``.

The record is ``build/fqtk_tpu_torch/baseline_measured.json`` (never the
root ``BASELINE_MEASURED.json``), with ``host`` the card's name and power
limit (``--device cuda``; raises without a card) and ``os.cpu_count()``.
The pin is the BEST proxy ever recorded in that file: a re-measure in a
noisy window never lowers it, and the record's metadata (threads, host)
stays that of the pinned measurement.  ``fqtk_tpu_torch.bench`` reads it for
``vs_pinned_best_proxy`` when present.

Run: python -m fqtk_tpu_torch.scripts.measure_baseline [--threads 16]
         [--reads 2000000] [--trials 3] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path
from typing import Optional

from .. import bench
from .common import host, write_record


def run(threads: int = 16, reads: int = 2_000_000, trials: int = 3, device: str = "cuda",
        record_path: Optional[Path] = None) -> dict:
    """Measure, pin the best ever, write the record (default
    :data:`fqtk_tpu_torch.bench.BASELINE_PATH`) and return it."""
    machine = host(device)
    barcodes = bench.make_whitelist(bench.K, bench.L)
    with tempfile.TemporaryDirectory() as td:
        tmp = Path(td)
        paths, _meta = bench.write_inputs(tmp, barcodes, n_reads=reads)
        inputs = [paths["i1"], paths["r1"], paths["r2"], paths["i2"]]
        # the harness's proxy: reference thread budget (1 main + 2 readers
        # reserved, the remainder compresses), best of N
        best = bench.run_refproxy(tmp, inputs, ["8B", "100T", "100T", "9B"], barcodes, reads,
                                  "baseline", trials=trials, threads=threads)
    print(f"best: {best/1e6:.3f}M reads/s over {trials} trial(s)")

    pin_path = Path(record_path) if record_path is not None else bench.BASELINE_PATH
    pinned = {"threads": threads, "reads": reads, "host": machine}
    if pin_path.exists():
        prev = json.loads(pin_path.read_text())
        if prev.get("value", 0) > best:
            print(f"keeping pinned best {prev['value']/1e6:.3f}M reads/s "
                  f"(> this window's {best/1e6:.3f}M)")
            best = prev["value"]
            # the metadata must describe the PINNED measurement
            pinned = {k: prev.get(k, v) for k, v in pinned.items()}
    out = {
        "metric": "rust_fqtk_demux_baseline_proxy_reads_per_sec",
        "value": round(best, 1),
        "threads": pinned["threads"],
        "method": (
            "C++ re-creation of the reference pipeline architecture "
            "(read-ahead threads + single scalar-matcher main thread + "
            "libdeflate BGZF writer pool), generous-to-baseline deltas "
            "documented in scripts/measure_baseline.py; value = best of "
            "repeated measurement sessions; conservative for vs_baseline"
        ),
        "config": "dual-index PE, 96 samples, 8B+9B, max_mm=1, delta=2",
        "reads": pinned["reads"],
        "host": pinned["host"],
    }
    write_record(pin_path, out)
    print(json.dumps(out))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--threads", type=int, default=16)
    ap.add_argument("--reads", type=int, default=2_000_000)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    run(args.threads, args.reads, args.trials, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
