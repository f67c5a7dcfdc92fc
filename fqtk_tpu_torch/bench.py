"""Benchmark harness of the port on a GPU: prints ONE JSON line with the
headline metric, then a compact summary line.  Counterpart of the
repository's ``bench.py``, with the same configurations, sizes, seeds,
config names and JSON keys, measured through ``fqtk_tpu_torch``.

    python -m fqtk_tpu_torch.bench

Headline: end-to-end ``demux`` reads/sec on the dual-index paired-end config
(I1+I2+R1+R2, 8B+9B, 96 samples, max-mismatches=1, min-delta=2) with the
native engine (C++ pipelined host I/O + the placed matcher: the measured
placement picks the host matcher or the card).  The ``configs`` array
covers the same configs as ``bench.py``:

1. single-end inline index (17B+T, 16 samples, 0 mismatches)
2. dual-index paired-end (the headline)
3. IUPAC/N expected barcodes (17B+T, 16 samples)
4. single-cell 16B-style 737K-barcode whitelist — matcher-level: the
   product's pigeonhole host matcher vs the reference-architecture scalar
   matcher, and the device leg ``device_pallas`` (``colmerge_top2`` on the
   card, its device-only rate and MFU, and the clustered window through the
   window dedup)
5. variable-length ``+`` read structures, paired-end
6. mid-K (K 8,192): ``colmerge_top2`` on the card, the demux path's
   auto-choice for a mid-sized whitelist
7. subsample (PE pair, fraction 0.3)

The kernel entry (``kernel_assign_reads_per_sec``, ``kernel_device``) times
the port's ``make_assign_fn`` at K 96 on raw-byte rows.  Device timings end
every call with ``torch.cuda.synchronize()`` and a fetched reduction; the
device-only rate is the two-point slope over batch sizes.  MFU divides by
the card's published dense peak (:data:`_PEAK_OPS`, keyed by
``torch.cuda.get_device_name()``) for the precision that ran.

The full record is also written to ``build/fqtk_tpu_torch/bench_torch.json``
(:data:`RECORD_PATH`).  The run exits non-zero when any config recorded an
error.  ``FQTK_BENCH_THREADS`` sets the demux threads (default 8).
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import List, Optional, Union

import numpy as np
import torch

RUST_BASELINE_READS_PER_SEC_ESTIMATE = 1.5e6

# Run lengths: long enough that the fixed per-run bubbles (process setup,
# thread spawn, first-window fill, end-of-run flush) amortize to a few
# percent of wall, so e2e rates and frac_of_ceiling reflect the
# steady-state pipeline.  Both sides of every A/B (product and reference
# proxy) run the same lengths, so the ratios are unaffected either way.
N_READS = 8_000_000
N_READS_SECONDARY = 6_000_000
WARMUP_READS = 2_000
K = 96
BC1, BC2 = 8, 9
L = BC1 + BC2
TEMPLATE_LEN = 100
BATCH = 1 << 17

_REPO_ROOT = Path(__file__).resolve().parent.parent
#: where the full record is written (``build/`` is git-ignored)
RECORD_PATH = _REPO_ROOT / "build" / "fqtk_tpu_torch" / "bench_torch.json"

Device = Union[str, torch.device]


def rust_baseline() -> tuple:
    """(reads_per_sec, note) — the pinned proxy of ``BASELINE_MEASURED.json``
    (read only) when present."""
    p = _REPO_ROOT / "BASELINE_MEASURED.json"
    if p.exists():
        d = json.loads(p.read_text())
        return float(d["value"]), (
            "vs measured reference-architecture proxy on identical inputs in "
            "the same run (interleaved trials both sides); pinned best-ever "
            f"proxy {d['value']/1e6:.2f}M reads/s, {d['threads']}-thread "
            "config, under vs_pinned_best_proxy, was measured on another "
            f"host ({d.get('host', 'unnamed')}), not on this card's host"
        )
    return RUST_BASELINE_READS_PER_SEC_ESTIMATE, (
        "vs est. 1.5M reads/s 16-thread Rust fqtk (unmeasured; no Rust "
        "toolchain in image)"
    )


def make_whitelist(k, length, seed=7, alphabet="ACGT"):
    rng = np.random.default_rng(seed)
    out, seen = [], set()
    while len(out) < k:
        bc = "".join(rng.choice(list(alphabet), size=length))
        if bc not in seen:
            seen.add(bc)
            out.append(bc)
    return out


def _writers(paths):
    """BGZF writers of the native engine (built where the committed binary
    does not load; an unavailable engine raises)."""
    from .io import native as native_io
    from .ops._build import ensure_native_engine

    ensure_native_engine()
    return {
        n: native_io.NativeBgzfWriter(p, 1, threads=3)
        for n, p in paths.items()
    }


def write_metadata(tmp, barcodes, name="metadata.tsv"):
    meta = tmp / name
    with open(meta, "w") as fh:
        fh.write("sample_id\tbarcode\n")
        for i, b in enumerate(barcodes):
            fh.write(f"S{i:04d}\t{b}\n")
    return meta


def write_inputs(tmp: Path, barcodes, n_reads=N_READS, name=""):
    """Dual-index PE inputs (headline config).  BGZF-compressed — the
    reference's documented input workflow (``... | bgzip -c``)."""
    rng = np.random.default_rng(11)
    meta = write_metadata(tmp, barcodes, f"{name}metadata.tsv")
    choices = rng.integers(0, K, size=n_reads)
    mism = rng.integers(0, 10, size=n_reads) == 0
    tmpl = ("ACGT" * 25).encode()
    qual = b"I" * TEMPLATE_LEN
    qb1, qb2 = b"I" * BC1, b"I" * BC2
    paths = {n: tmp / f"{name}{n}.fq.gz" for n in ("i1", "r1", "r2", "i2")}
    fhs = _writers(paths)
    bcs = [barcodes[c].encode() for c in range(K)]
    chunk = 100_000
    for lo in range(0, n_reads, chunk):
        hi = min(lo + chunk, n_reads)
        p1, p2, pr = [], [], []
        for i in range(lo, hi):
            bc = bcs[choices[i]]
            b1, b2 = bc[:BC1], bc[BC1:]
            if mism[i]:
                b1 = (b"T" if b1[:1] != b"T" else b"G") + b1[1:]
            # formatted per chunk: a 2M-element header list up front is a
            # ~200MB transient for nothing
            h = b"@inst:1:AB:1:2:%d:3 1:N:0:0" % i
            p1.append(h + b"\n" + b1 + b"\n+\n" + qb1 + b"\n")
            p2.append(h + b"\n" + b2 + b"\n+\n" + qb2 + b"\n")
            pr.append(h + b"\n" + tmpl + b"\n+\n" + qual + b"\n")
        fhs["i1"].write(b"".join(p1))
        fhs["i2"].write(b"".join(p2))
        block = b"".join(pr)
        fhs["r1"].write(block)
        fhs["r2"].write(block)
    for fh in fhs.values():
        fh.close()
    return paths, meta


def write_single_end_inputs(tmp, barcodes, n_reads, name, var_template=False):
    """One FASTQ with an inline index: ``{L}B`` + template (config #1/#3);
    ``var_template=True`` varies template length (config #5 inputs)."""
    rng = np.random.default_rng(13)
    length = len(barcodes[0])
    choices = rng.integers(0, len(barcodes), size=n_reads)
    path = tmp / f"{name}.fq.gz"
    fh = _writers({"x": path})["x"]
    tmpl_full = ("ACGT" * 40).encode()
    chunk = 100_000
    for lo in range(0, n_reads, chunk):
        hi = min(lo + chunk, n_reads)
        parts = []
        for i in range(lo, hi):
            bc = barcodes[choices[i]].encode()
            tl = 100 if not var_template else 60 + (i % 81)
            seq = bc + tmpl_full[:tl]
            parts.append(
                b"@inst:1:AB:1:2:%d:3 1:N:0:0\n%s\n+\n%s\n"
                % (i, seq, b"I" * len(seq))
            )
        fh.write(b"".join(parts))
    fh.close()
    return path, length


# --------------------------------------------------------------------------
# the card: peaks, precision, timing
# --------------------------------------------------------------------------

#: published dense per-card peaks for MFU accounting (ops/s, FMA = 2 ops),
#: keyed by ``torch.cuda.get_device_name()``: the H100 SXM5 datasheet's
#: FP32 (CUDA cores) and the tensor cores' TF32, BF16 and INT8 without
#: sparsity
_PEAK_OPS = {
    "NVIDIA H100 80GB HBM3": {
        "fp32": 66.9e12,
        "tf32": 494.7e12,
        "bf16": 989.4e12,
        "int8": 1978.9e12,
    },
}


def _device_kind(device: Device) -> str:
    """The card's name for a CUDA device, ``"cpu"`` otherwise."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type


def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` as it prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return out.stdout.strip() if out.returncode == 0 else f"nvidia-smi exit {out.returncode}"


def _matmul_precision(device: Device) -> str:
    """The precision a float32 ``torch.matmul`` runs in on ``device``:
    ``"tf32"`` where cuBLAS may use the tensor cores' TF32
    (``torch.backends.cuda.matmul.allow_tf32``, which
    ``torch.set_float32_matmul_precision("high")`` or ``"medium"`` sets),
    else ``"fp32"``."""
    if torch.device(device).type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        return "tf32"
    return "fp32"


def _peak_ops(dtype: str, device: Device = "cuda"):
    """``(peak ops/s of dtype, card name)``; the peak is None for a card
    not in :data:`_PEAK_OPS` (and off the card).  Prints the card's name,
    and on the card its ``nvidia-smi`` name and power limit, to stderr."""
    kind = _device_kind(device)
    peaks = _PEAK_OPS.get(kind)
    smi = f"; nvidia-smi: {card_line()}" if torch.device(device).type == "cuda" else ""
    peak = None if peaks is None else peaks[dtype]
    print(f"[bench] {dtype} peak of {kind}: {peak}{smi}", file=sys.stderr, flush=True)
    return peak, kind


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _finish(out, dev: torch.device) -> int:
    """End a timed call: a reduction of its first output, the device
    synchronized, the value fetched."""
    total = torch.sum(out[0].to(torch.int32))
    _sync(dev)
    return int(total)


def _device_only_rate(call, make_input, batches, iters=3, device: Device = "cuda"):
    """Marginal device-compute rate (rows/s) via a two-point fit over batch
    sizes: inputs device-resident (``make_input(b)`` is copied to
    ``device`` before the clock starts), every call ended by
    :func:`_finish`; the fixed per-call cost (launches, the fetch) cancels
    in the slope."""
    dev = torch.device(device)
    times = []
    for b in batches:
        ins = [torch.from_numpy(make_input(b)).to(dev) for _ in range(iters + 1)]
        _finish(call(ins[-1]), dev)  # build + warm
        t0 = time.perf_counter()
        for i in range(iters):
            _finish(call(ins[i]), dev)
        times.append((time.perf_counter() - t0) / iters)
    (b1, b2), (t1, t2) = batches, times
    slope = (t2 - t1) / (b2 - b1)
    if slope <= 0:
        # a noise phase flipped mid-fit (t2 <= t1): report the call-level
        # rate of the large batch as a lower bound rather than Infinity
        # (bare Infinity is invalid JSON and would break the output line)
        return b2 / t2 if t2 > 0 else 0.0
    return 1.0 / slope


def bench_kernel(barcodes, device: Device = "cuda", batch=1 << 22,
                 batches=(1 << 21, 1 << 22), iters=5):
    """Device-side assignment at K 96 through the port's ``make_assign_fn``
    (raw-byte rows, float32 ``torch.matmul`` per K chunk): e2e call
    throughput (reads/s) on resident data, plus the device-only rate and
    MFU against the peak of the precision the matmul ran in."""
    from .ops.matcher import ExpectedSet, make_assign_fn, resolve_device

    dev = resolve_device(device)
    expected = ExpectedSet.from_barcodes(barcodes)
    assign = make_assign_fn(expected, 1, 2, device=dev)
    rng = np.random.default_rng(3)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    inputs = [
        torch.from_numpy(rng.choice(bases, size=(batch, L)).astype(np.uint8)).to(dev)
        for _ in range(iters)
    ]
    warm = torch.from_numpy(rng.choice(bases, size=(batch, L)).astype(np.uint8)).to(dev)
    _finish(assign(warm), dev)  # build + warm
    del warm
    t0 = time.perf_counter()
    for i in range(iters):
        _finish(assign(inputs[i]), dev)
    dt = time.perf_counter() - t0
    call_rate = batch * iters / dt
    del inputs

    dev_rate = _device_only_rate(
        assign,
        lambda b: rng.choice(bases, size=(b, L)).astype(np.uint8),
        batches=batches,
        device=dev,
    )
    precision = _matmul_precision(dev)
    peak, kind = _peak_ops(precision, dev)
    ops = 2.0 * assign.macs_per_row * dev_rate
    device_entry = {
        "kind": kind,
        "device_only_reads_per_sec": round(dev_rate, 1),
        "achieved_tops": round(ops / 1e12, 2),
        "device_mfu": round(ops / peak, 4) if peak else None,
        "matmul_precision": precision,
        "float32_matmul_precision": torch.get_float32_matmul_precision(),
        "note": "two-point batch fit on resident inputs; the fixed per-call "
        "cost cancels in the slope.  make_assign_fn is plain PyTorch (no "
        "kernel): a float32 torch.matmul of the 16-class one-hot [B, 16*L] "
        "per K chunk, MFU against the peak of matmul_precision (K=96 keeps "
        "the product tiny by design — the big-K device leg is the "
        "tensor-core datapoint).  The one-hot of 2^22 rows x 272 float32 "
        "is about 4.6 GB a call",
    }
    return call_rate, device_entry


# --------------------------------------------------------------------------
# e2e legs
# --------------------------------------------------------------------------


def _demux_cfg(inputs, structures, meta, out_dir, max_mm=1, delta=2,
               device: Device = "cuda"):
    from .runtime.demux import DemuxConfig

    return DemuxConfig(
        inputs=list(inputs),
        read_structures=list(structures),
        sample_metadata=meta,
        output=out_dir,
        max_mismatches=max_mm,
        min_mismatch_delta=delta,
        batch_size=BATCH,
        engine="auto",
        # experiment knob for A/B arms (pool size = threads-2)
        threads=int(os.environ.get("FQTK_BENCH_THREADS", "8")),
        device=str(device),
    )


def host_speed_of_light(e2e_rps, n_reads, stage_timings, inputs=None):
    """E2e "speed-of-light" on THIS host: every demux architecture (ours and
    the reference's) must inflate, scan, reformat, and re-deflate the same
    bytes.  Those irreducible stages' measured thread-CPU, spread perfectly
    over all cores with a zero-cost matcher, bound any implementation's
    throughput here; report that bound and our fraction of it.

    The flat-spread ceiling is OPTIMISTIC for single-input configs: the
    bench inputs are single-member gzip streams, and inflate within one
    deflate member is inherently serial (each block's dictionary is the
    previous output), so no implementation can spread the slowest input's
    inflate CPU across cores.  When `inputs` is given, a decompress-only
    calibration pass measures that serial bound and the report includes
    the tighter min(ceiling, serial bound) plus our fraction of it."""
    io_keys = ("native_parse", "native_gate_pack", "native_route",
               "native_compress")
    io_core_s = sum(stage_timings.get(k, 0.0) for k in io_keys)
    if io_core_s <= 0:
        return None
    cores = os.cpu_count() or 1
    ceiling = n_reads * cores / io_core_s
    out = {
        "cores": cores,
        "io_core_seconds": round(io_core_s, 3),
        "assign_free_ceiling_reads_per_sec": round(ceiling, 1),
        "frac_of_ceiling": round(e2e_rps / ceiling, 3),
        "note": "ceiling = measured inflate+parse+route+deflate thread-CPU "
        "(paid by ANY implementation at this gzip level) spread over all "
        "cores with a free matcher",
    }
    # Hypervisor steal during the measured run: stolen vCPU time stretches
    # wall without adding thread-CPU, so it depresses frac_of_ceiling
    # through no fault of the pipeline.  Report the frac against the cores
    # the VM actually got (the honest pipeline-quality number; raw frac
    # above stays the conservative headline).
    steal = stage_timings.get("steal_frac", 0.0)
    if steal > 0:
        avail_ceiling = n_reads * cores * (1.0 - steal) / io_core_s
        out["steal_frac_during_run"] = steal
        out["frac_of_available_ceiling"] = round(e2e_rps / avail_ceiling, 3)
    # Per-input serial floor: record framing + extraction within one FASTQ
    # stream is sequential, so for n_inputs < cores the flat spread is
    # optimistic and the slowest input's parse CPU caps any implementation
    # (same accounting as the subsample entry; assumes symmetric inputs).
    parse_s = stage_timings.get("native_parse", 0.0)
    if inputs and parse_s > 0 and len(inputs) < cores:
        serial_bound = n_reads * len(inputs) / parse_s
        achievable = min(ceiling, serial_bound)
        out.setdefault(
            "per_input_serial_parse_bound_reads_per_sec", round(serial_bound, 1)
        )
        out["achievable_ceiling_reads_per_sec"] = round(achievable, 1)
        out["frac_of_achievable"] = round(e2e_rps / achievable, 3)
    if inputs:
        try:
            from .io import native as native_io

            if native_io.available():
                results = [native_io.inflate_bench(p) for p in inputs]
                # the serial bound only exists for single-member gzip
                # inputs; multi-member/BGZF streams are block-parallel
                # decodable in principle, so no implementation-independent
                # serial cap can be claimed for them
                serial = [cpu for _, cpu, kind in results if kind == "gzip"]
                if serial:
                    serial_s = max(serial)
                    serial_bound = n_reads / serial_s
                    achievable = min(ceiling, serial_bound)
                    out.update(
                        serial_inflate_s_max=round(serial_s, 3),
                        serial_inflate_bound_reads_per_sec=round(
                            serial_bound, 1
                        ),
                        achievable_ceiling_reads_per_sec=round(achievable, 1),
                        frac_of_achievable=round(e2e_rps / achievable, 3),
                        serial_note="single-member gzip input(s): the "
                        "slowest one's measured serial inflate CPU caps ANY "
                        "implementation; achievable = min(flat-spread "
                        "ceiling, serial bound)",
                    )
                else:
                    out["input_kind"] = results[0][2] if results else None
        except Exception:
            pass  # calibration is advisory; never fail the bench over it
    return out


def _read_steal_ticks():
    """(steal_ticks, wall_s) from /proc/stat — field 8 of the aggregate cpu
    line is core-ticks stolen by the hypervisor (other tenants running on
    our vCPUs).  Stolen cores stretch wall time without adding thread-CPU,
    so they depress frac_of_ceiling through no fault of the pipeline."""
    try:
        with open("/proc/stat") as f:
            parts = f.readline().split()
        return int(parts[8]), time.perf_counter()
    except Exception:
        return 0, time.perf_counter()


def run_e2e(tmp, inputs, structures, meta, n_reads, tag, trials=2,
            max_mm=1, delta=2, warm_inputs=None, device: Device = "cuda"):
    """Best-of-N e2e run; returns (reads_per_sec, timings of best).  Each
    run's outputs are deleted once it is measured."""
    from .runtime.demux import run_demux

    if warm_inputs is not None:
        warm_out = tmp / f"warm_{tag}"
        run_demux(
            _demux_cfg(
                warm_inputs, structures, meta, warm_out,
                max_mm=max_mm, delta=delta, device=device,
            )
        )
        shutil.rmtree(warm_out, ignore_errors=True)
    best, best_t = 0.0, {}
    for trial in range(trials):
        out_dir = tmp / f"out_{tag}{trial}"
        s0, w0 = _read_steal_ticks()
        t0 = time.perf_counter()
        result = run_demux(
            _demux_cfg(
                inputs, structures, meta, out_dir,
                max_mm=max_mm, delta=delta, device=device,
            )
        )
        dt = time.perf_counter() - t0
        s1, w1 = _read_steal_ticks()
        shutil.rmtree(out_dir, ignore_errors=True)
        if result.total_templates != n_reads:  # checked under -O too
            raise AssertionError((result.total_templates, n_reads))
        if n_reads / dt > best:
            best = n_reads / dt
            best_t = {k: round(v, 3) for k, v in result.timings.items()}
            # USER_HZ=100; steal is summed over all vCPUs already
            avail = (os.cpu_count() or 1) * (w1 - w0) * 100.0
            best_t["steal_frac"] = round((s1 - s0) / avail, 4) if avail else 0.0
    return best, best_t


def run_refproxy(tmp, inputs, structures, barcodes, n_reads, tag,
                 max_mm=1, delta=2, trials=2, threads=16):
    """Reference-architecture proxy on the same inputs; best-of-N reads/s."""
    from .core.read_structure import ReadStructure, SegmentType
    from .io import native as native_io
    from .ops._build import ensure_native_engine

    ensure_native_engine()
    rss = [ReadStructure.from_str(s) for s in structures]
    bc_len = len(barcodes[0])
    best = 0.0
    for trial in range(trials):
        out_dir = tmp / f"proxy_{tag}{trial}"
        out_dir.mkdir()
        engine = native_io.NativeDemuxEngine(
            threads=max(1, threads - 3), compression_level=5
        )
        try:
            for path, rs in zip(inputs, rss):
                engine.add_input(
                    str(path),
                    str(rs),
                    [(s.offset, s.length, s.kind.value) for s in rs],
                )
            n_t = sum(len(rs.segments_by_type(SegmentType.Template)) for rs in rss)
            names = [f"S{i:04d}" for i in range(len(barcodes))] + ["unmatched"]
            for name in names:
                engine.add_sample(
                    [str(out_dir / f"{name}.R{i}.fq.gz") for i in range(1, n_t + 1)]
                )
            engine.configure(
                bc_len=bc_len,
                nocall_budget=max_mm,
                skip_too_few=False,
                first_sample_id="S0000",
                first_barcode=barcodes[0],
                out_types="T",
            )
            t0 = time.perf_counter()
            total = engine.refproxy_run(barcodes, max_mm, delta)
            dt = time.perf_counter() - t0
        finally:
            engine.close()
        shutil.rmtree(out_dir, ignore_errors=True)
        if total != n_reads:
            raise AssertionError((total, n_reads))
        best = max(best, n_reads / dt)
    return best


def run_config_ab(
    tmp, inputs, structures, meta, barcodes, n_reads, tag, trials=2,
    max_mm=1, delta=2, warm_inputs=None, proxy_threads=16, device: Device = "cuda",
):
    """Interleaved A/B: alternate product and proxy trials so a noise phase
    that flips mid-config hits BOTH sides instead of skewing the ratio
    (sequential best-of-N blocks pair badly across a phase edge).
    Returns (best_e2e, timings_of_best, best_proxy)."""
    best_e2e, best_t, best_proxy = 0.0, {}, 0.0
    for trial in range(trials):
        rps, t = run_e2e(
            tmp, inputs, structures, meta, n_reads, f"{tag}{trial}",
            trials=1, max_mm=max_mm, delta=delta,
            warm_inputs=warm_inputs if trial == 0 else None, device=device,
        )
        if rps > best_e2e:
            best_e2e, best_t = rps, t
        p = run_refproxy(
            tmp, inputs, structures, barcodes, n_reads, f"{tag}{trial}",
            max_mm=max_mm, delta=delta, trials=1, threads=proxy_threads,
        )
        if p:
            best_proxy = max(best_proxy, p)
    return best_e2e, best_t, best_proxy


# --------------------------------------------------------------------------
# matcher-level legs
# --------------------------------------------------------------------------


def _codes_to_bytes(vals: np.ndarray, length: int) -> np.ndarray:
    """``[len(vals), length]`` ACGT bytes: the 2-bit digits of ``vals``,
    lowest first."""
    codes = np.zeros((len(vals), length), dtype=np.uint8)
    v = vals.copy()
    for j in range(length):
        codes[:, j] = v & 3
        v >>= 2
    return np.frombuffer(b"ACGT", dtype=np.uint8)[codes]


def _refproxy_matcher_rps(bc_bytes: np.ndarray, obs: np.ndarray, n_proxy: int) -> float:
    """The reference's scalar branch-and-bound matcher (+ cache) over the
    first ``n_proxy`` reads, reads/s: ``fqtk_refproxy_matcher_bench`` of the
    native library, bound here as ``bench.py`` binds it."""
    from .io import native as native_io
    from .ops._build import ensure_native_engine

    ensure_native_engine()
    lib = native_io.get_lib()
    # idempotent: the midk and bigk legs each declare it (wrong marshaling
    # segfaults)
    lib.fqtk_refproxy_matcher_bench.restype = ctypes.c_double
    lib.fqtk_refproxy_matcher_bench.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
    ]
    k, length = bc_bytes.shape
    concat = bc_bytes.tobytes()
    cbuf = (ctypes.c_uint8 * len(concat)).from_buffer_copy(concat)
    obs_c = np.ascontiguousarray(obs[:n_proxy])
    return float(
        lib.fqtk_refproxy_matcher_bench(
            cbuf, k, length, 1, 2,
            obs_c.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(obs_c),
        )
    )


def bench_midk_config(device: Device = "cuda", k=8192, b=1 << 17,
                      batches=(1 << 18, 1 << 19), iters=4, n_proxy=4000):
    """Mid-K (host-matcher cap < K < pigeonhole threshold): the device path
    is the production auto-choice — brute force is too big for the host but
    the [B, K] contraction is tensor-core food.  The engine is
    ``colmerge_top2`` (bit2 transfer, int8 ``wgmma``), the demux driver's
    single-device branch, through ``make_hopper_assign_fn``.  Matcher-level,
    proxy measured on identical reads (reference scalar branch-and-bound)."""
    from .ops.device_encoding import pack_bit2
    from .ops.hopper_matcher import make_hopper_assign_fn
    from .ops.matcher import ExpectedSet, resolve_device

    dev = resolve_device(device)
    length = 16
    rng = np.random.default_rng(11)
    vals = rng.choice(1 << 28, size=k + 64, replace=False)[:k].astype(np.uint32)
    bc_bytes = _codes_to_bytes(vals, length)
    letters = np.frombuffer(b"ACGT", dtype=np.uint8)
    barcodes = [bytes(r).decode() for r in bc_bytes]

    choice = rng.integers(0, k, size=b)
    obs = bc_bytes[choice].copy()
    mut = rng.integers(0, 10, size=b) == 0
    pos = rng.integers(0, length, size=b)
    obs[mut, pos[mut]] = letters[rng.integers(0, 4, size=int(mut.sum()))]

    expected = ExpectedSet.from_barcodes(barcodes)
    # production engine: the demux driver's single-device device branch
    # (runtime/demux.py _build_device_side)
    fn = make_hopper_assign_fn(
        expected, 1, 2, device=dev, packed2=True, compact_output=True,
    )
    if fn.scheme != "colmerge_top2":
        raise RuntimeError(f"mid-K picked {fn.scheme}, not colmerge_top2")
    print(f"[bench] mid-K MACs per row {fn.macs_per_row} = k_pad {fn.state.k_pad} x "
          f"{fn.state.classes} classes x L {length} (K {k})", file=sys.stderr, flush=True)

    inputs = [
        torch.from_numpy(pack_bit2(bc_bytes[rng.integers(0, k, size=b)])).to(dev)
        for _ in range(iters)
    ]
    _finish(fn(torch.from_numpy(pack_bit2(obs)).to(dev)), dev)  # build + warm
    t0 = time.perf_counter()
    for x in inputs:
        _finish(fn(x), dev)
    call_rate = b * iters / (time.perf_counter() - t0)

    dev_rate = _device_only_rate(
        fn,
        lambda n: pack_bit2(bc_bytes[rng.integers(0, k, size=n)]),
        batches=batches,
        device=dev,
    )
    peak, kind = _peak_ops("int8", dev)
    ops = 2.0 * fn.macs_per_row * dev_rate

    result = {
        "name": "mid_K_8192_16bp_mm1_d2",
        "level": "matcher",
        "engine": "colmerge_top2, int8 wgmma on bit2 rows (product "
        "auto-path for 4096 < K < 65536 on one card)",
        "reads_per_sec": round(call_rate, 1),
        "device_only_reads_per_sec": round(dev_rate, 1),
        "device_kind": kind,
        "achieved_tops": round(ops / 1e12, 2),
        "device_mfu": round(ops / peak, 4) if peak else None,
        "note": "call-level rate includes the fixed per-call cost (H2D of "
        "nothing: inputs resident; launch, fetch) at the production batch "
        "(2^17); device-only is the two-point fit; MACs count K padded to "
        "128 columns (k_counted)",
        "k_counted": fn.state.k_pad,
        "scheme": fn.scheme,
        "launches": fn.launches,
        "plain_calls": fn.plain_calls,
    }

    proxy_rps = _refproxy_matcher_rps(bc_bytes, obs, n_proxy)
    if proxy_rps > 0:
        result["proxy_reads_per_sec"] = round(proxy_rps, 1)
        result["vs_config_baseline"] = round(call_rate / proxy_rps, 1)
    return result


def bench_bigk_config(device: Device = "cuda", k=737_280, b=1 << 17, n_proxy=2000,
                      device_batches=(1 << 17, 1 << 18), window=1 << 17):
    """Config #4: 737K-barcode whitelist, matcher-level (see module doc),
    host side and the device leg ``device_pallas``.  A failure of the device
    leg is recorded as its ``error`` (and fails the run: :func:`main`)."""
    from .core.encoding import ENCODE_LUT
    from .io import native as native_io
    from .ops._build import ensure_native_engine

    ensure_native_engine()
    rng = np.random.default_rng(1)
    length = 16
    vals = rng.choice(
        np.iinfo(np.uint32).max, size=k + 1000, replace=False
    )[:k].astype(np.uint32)
    bc_bytes = _codes_to_bytes(vals, length)
    letters = np.frombuffer(b"ACGT", dtype=np.uint8)
    barcodes = [bytes(r).decode() for r in bc_bytes]

    choice = rng.integers(0, k, size=b)
    obs = bc_bytes[choice].copy()
    mut = rng.integers(0, 10, size=b) == 0
    pos = rng.integers(0, length, size=b)
    obs[mut, pos[mut]] = letters[rng.integers(0, 4, size=int(mut.sum()))]
    masks = ENCODE_LUT[obs].astype(np.uint8)
    packed = (masks[:, 0::2] | (masks[:, 1::2] << 4)).astype(np.uint8)

    # product path: pigeonhole matcher (auto-selected for K >= 65536)
    m = native_io.NativeBigKMatcher(barcodes, 1, 2, threads=4)
    m.assign(packed[:1024])  # warm
    t0 = time.perf_counter()
    out = m.assign(packed)
    dt = time.perf_counter() - t0
    pigeonhole_rps = b / dt
    matched = float((out < k).mean())

    # realistic single-cell distribution: reads cluster on ~8K cells
    # (thousands of reads per cell barcode), where the memo cache engages;
    # the uniform draw above stays the headline (conservative)
    cells = rng.integers(0, k, size=8000)
    obs_sc = bc_bytes[cells[rng.integers(0, 8000, size=b)]].copy()
    mut = rng.integers(0, 10, size=b) == 0
    pos = rng.integers(0, length, size=b)
    obs_sc[mut, pos[mut]] = letters[rng.integers(0, 4, size=int(mut.sum()))]
    masks_sc = ENCODE_LUT[obs_sc].astype(np.uint8)
    packed_sc = (masks_sc[:, 0::2] | (masks_sc[:, 1::2] << 4)).astype(np.uint8)
    m.assign(packed_sc[:4096])  # warm the cache
    t0 = time.perf_counter()
    m.assign(packed_sc)
    clustered_rps = b / (time.perf_counter() - t0)
    m.close()

    # degenerate-whitelist variant: one expected N per barcode exercises
    # the expanded-table path (BigKMatcher iupac mode)
    bc_n = bc_bytes.copy()
    bc_n[np.arange(k), rng.integers(0, length, size=k)] = ord("N")
    mi = native_io.NativeBigKMatcher(
        [bytes(r).decode() for r in bc_n], 1, 2, threads=4
    )
    mi.assign(packed[:1024])
    t0 = time.perf_counter()
    mi.assign(packed)
    iupac_rps = b / (time.perf_counter() - t0)
    mi.close()

    # baseline proxy: the reference's scalar branch-and-bound + cache
    # (scalar scan is slow; extrapolating from n_proxy reads)
    proxy_rps = _refproxy_matcher_rps(bc_bytes, obs, n_proxy)
    result = {
        "name": "single_cell_737K_whitelist_16B",
        "level": "matcher",
        "reads_per_sec": round(pigeonhole_rps, 1),
        "engine": "pigeonhole (product auto-path for K>=65536)",
        "matched_frac": round(matched, 4),
        "clustered_8k_cells_reads_per_sec": round(clustered_rps, 1),
        "iupac_whitelist_reads_per_sec": round(iupac_rps, 1),
        "proxy_reads_per_sec": round(proxy_rps, 1),
        "vs_config_baseline": round(pigeonhole_rps / proxy_rps, 1)
        if proxy_rps > 0
        else None,
        "note": "737K-sample demux e2e impossible for any implementation "
        "(fd limits); both sides measured matcher-level on identical reads",
    }
    try:
        result["device_pallas"] = _bench_bigk_device(
            barcodes, obs, device, batches=device_batches, window=window
        )
    except Exception as e:  # recorded, and main() exits non-zero over it
        result["device_pallas"] = {"error": f"{type(e).__name__}: {e}"[:200]}
    return result


def _bench_bigk_device(barcodes, obs, device: Device = "cuda",
                       batches=(1 << 17, 1 << 18), window=1 << 17, iters=4):
    """The device matcher on the same 737K whitelist (the big-K device
    path, and the tensor-core MFU datapoint): ``make_hopper_assign_fn`` on
    bit2 rows, which picks ``colmerge_top2`` up to 4,194,304 columns;
    device-only rate via the two-point fit, then the clustered window
    through the demux's window dedup."""
    from .ops.device_encoding import pack_bit2
    from .ops.hopper_matcher import make_hopper_assign_fn
    from .ops.matcher import ExpectedSet, resolve_device
    from .runtime.demux import _Pending, _wrap_window_dedup

    dev = resolve_device(device)
    expected = ExpectedSet.from_barcodes(barcodes)
    fn = make_hopper_assign_fn(
        expected, 1, 2, device=dev, packed2=True, compact_output=True,
    )
    packed = pack_bit2(obs)
    rng = np.random.default_rng(9)

    def make_input(b):
        reps = -(-b // packed.shape[0])
        tiled = np.tile(packed, (reps, 1))[:b]
        # perturb so every buffer is distinct
        tiled[rng.integers(0, b, size=64), 0] ^= 3
        return tiled

    rate = _device_only_rate(fn, make_input, batches=batches, device=dev)
    peak, kind = _peak_ops("int8", dev)
    ops = 2.0 * fn.macs_per_row * rate

    # clustered single-cell distribution through the production dedup
    # front-end (_wrap_window_dedup): thousands of reads per cell barcode
    # shrink the device batch by the duplication factor — call-level rate
    # including the np.unique + scatter host work; each call's _Pending is
    # fetched as the demux driver fetches it
    cells = rng.integers(0, packed.shape[0], size=8192)
    ded = _wrap_window_dedup(lambda o: _Pending(fn(o)[0], keep=o))
    for _ in range(2):  # warm
        ded(packed[cells[rng.integers(0, 8192, size=window)]]).fetch()
    t0 = time.perf_counter()
    for _ in range(iters):
        ded(packed[cells[rng.integers(0, 8192, size=window)]]).fetch()
    clustered_rate = window * iters / (time.perf_counter() - t0)

    return {
        "kind": kind,
        "mode": f"int8 wgmma, bit2-packed obs, {fn.scheme} (K split across "
        "CTAs by plan_chunks)",
        "device_only_reads_per_sec": round(rate, 1),
        "achieved_tops": round(ops / 1e12, 2),
        "device_mfu": round(ops / peak, 4) if peak else None,
        "clustered_8k_cells_dedup_reads_per_sec": round(clustered_rate, 1),
        "note_dedup": "call-level rate on the clustered distribution "
        "through the window-dedup front-end (unique rows -> pow2 bucket "
        "-> device -> scatter); uniform-draw device_only rate above is "
        "the dedup-free worst case",
        "k_counted": fn.state.k_pad,
        "scheme": fn.scheme,
        "launches": fn.launches,
        "plain_calls": fn.plain_calls,
    }


def bench_subsample_config(tmp: Path, paths, trials=2):
    """Subsample e2e (PE pair, fraction 0.3) vs the reference-architecture
    proxy: the identical engine forced into the serial record-at-a-time
    lockstep loop with per-record draws folded in (``subsample.rs:175-304``:
    one reader thread + pooled BGZF writers).  The product path adds one
    reader thread per input (the keep mask is pre-drawn, so inputs
    decouple)."""
    from .io import native as native_io
    from .ops._build import ensure_native_engine
    from .runtime.subsample import SubsampleConfig, run_subsample
    from .utils.chacha import ChaCha8Rng

    ensure_native_engine()
    inputs = [paths["r1"], paths["r2"]]

    # interleaved A/B (see run_config_ab): a noise-phase flip mid-config
    # hits both sides instead of skewing the ratio
    best = 0.0
    proxy_best = 0.0
    best_stats = None
    for trial in range(trials):
        cfg = SubsampleConfig(
            inputs=inputs,
            output=tmp / f"sub{trial}",
            fraction=0.3,
            threads=8,
            seed=42,
        )
        t0 = time.perf_counter()
        res = run_subsample(cfg)
        dt = time.perf_counter() - t0
        if res.total_read / dt > best:
            best = res.total_read / dt
            best_stats = res.stage_seconds
        n_subsample_reads = res.total_read

        # generous-to-baseline: the proxy's mask stream uses the fast
        # native ChaCha (~13ns/draw, close to Rust's inline per-record
        # draw) rather than charging it the NumPy stream's ~50ns inside
        # its timed serial loop
        try:
            rng = native_io.NativeChaChaMask(42)
            draw = lambda m: rng.keep_mask(m, 0.3)  # noqa: E731
        except native_io.NativeDemuxError:  # stale .so
            rng = ChaCha8Rng(42)
            draw = lambda m: (  # noqa: E731
                rng.random_f64_batch(m) < 0.3
            ).astype("uint8")
        eng = native_io.NativeSubsampleEngine(threads=7, compression_level=5)
        try:
            for i, p in enumerate(inputs):
                eng.add_input(p, tmp / f"subproxy{trial}.R{i + 1}.fq.gz")
            eng.configure(check_names=True, parallel=False)
            t0 = time.perf_counter()
            total = 0
            while True:
                mask = draw(1 << 16)
                c, _ = eng.process_chunk(mask)
                total += c
                if c < len(mask):
                    break
            eng.finish()
        finally:
            eng.close()
        dt = time.perf_counter() - t0
        proxy_best = max(proxy_best, total / dt)

    entry = {
        "name": "subsample_PE_fraction0.3",
        "level": "e2e",
        "reads_per_sec": round(best, 1),
        "proxy_reads_per_sec": round(proxy_best, 1),
        "vs_config_baseline": round(best / proxy_best, 2) if proxy_best else None,
    }
    # Host-ceiling accounting: subsample's irreducible work is
    # inflate+scan+name-check+record-copy plus BGZF re-deflate of the kept
    # records — measured thread-CPU, spread over all cores.
    if best_stats:
        io_core_s = best_stats["native_work"] + best_stats["native_compress"]
        if io_core_s > 0:
            cores = os.cpu_count() or 1
            ceiling = n_subsample_reads * cores / io_core_s
            entry["host_speed_of_light"] = {
                "cores": cores,
                "io_core_seconds": round(io_core_s, 3),
                "assign_free_ceiling_reads_per_sec": round(ceiling, 1),
                "frac_of_ceiling": round(best / ceiling, 3),
                "note": "ceiling = measured inflate+scan+name-check+copy + "
                "BGZF deflate thread-CPU (paid by ANY implementation at this "
                "gzip level) spread over all cores",
            }
            # The flat spread is unattainable for n_inputs < cores: record
            # framing within one FASTQ stream is inherently sequential, so
            # the slowest input's scan thread-CPU is a serial floor ANY
            # implementation pays.
            work = best_stats["native_work"]
            if work > 0 and len(inputs) < cores:
                serial_bound = n_subsample_reads * len(inputs) / work
                achievable = min(ceiling, serial_bound)
                entry["host_speed_of_light"].update(
                    per_input_serial_bound_reads_per_sec=round(
                        serial_bound, 1
                    ),
                    achievable_ceiling_reads_per_sec=round(achievable, 1),
                    frac_of_achievable=round(best / achievable, 3),
                    serial_note="per-input record framing is sequential; "
                    "bound = n * n_inputs / scan thread-CPU (assumes "
                    "symmetric inputs)",
                )
    return entry


# --------------------------------------------------------------------------
# the run
# --------------------------------------------------------------------------


def failed_configs(full: dict) -> List[str]:
    """Names of the configs (``name.key`` for a nested entry) that recorded
    an ``error``."""
    failed = []

    def walk(entry: dict, where: str) -> None:
        if "error" in entry:
            failed.append(where)
        for key, value in entry.items():
            if isinstance(value, dict):
                walk(value, f"{where}.{key}")

    for c in full["configs"]:
        walk(c, c.get("name", "?"))
    return failed


def run_bench(device: Device = "cuda", n_reads: int = N_READS,
              n_reads_secondary: int = N_READS_SECONDARY, headline_trials: int = 4,
              secondary_trials: int = 3, subsample_trials: int = 2) -> dict:
    """Every config in ``bench.py``'s order; the full record.  The read
    counts and trials are the only sizes to cut: whitelists and kernel
    shapes stay whole."""
    from .ops._build import ensure_native_engine

    t_run = time.perf_counter()
    ensure_native_engine()
    barcodes = make_whitelist(K, L)
    t0 = time.perf_counter()
    kernel_rps, kernel_device = bench_kernel(barcodes, device=device)
    kernel_device["wall_s"] = round(time.perf_counter() - t0, 3)
    configs = []
    with tempfile.TemporaryDirectory() as td:
        tmp = Path(td)

        # ---- headline: dual-index PE, 96 samples ----
        t0 = time.perf_counter()
        wpaths, wmeta = write_inputs(tmp, barcodes, n_reads=WARMUP_READS, name="w_")
        paths, meta = write_inputs(tmp, barcodes, n_reads=n_reads)
        di_inputs = [paths["i1"], paths["r1"], paths["r2"], paths["i2"]]
        di_structs = ["8B", "100T", "100T", "9B"]
        e2e_rps, stage_timings, proxy_di = run_config_ab(
            tmp, di_inputs, di_structs, meta, barcodes, n_reads, "headline",
            trials=headline_trials,
            warm_inputs=[wpaths["i1"], wpaths["r1"], wpaths["r2"], wpaths["i2"]],
            device=device,
        )
        configs.append(
            {
                "name": "dual_index_PE_96samples_8B9B_mm1_d2",
                "level": "e2e",
                "reads_per_sec": round(e2e_rps, 1),
                "proxy_reads_per_sec": round(proxy_di, 1) if proxy_di else None,
                "vs_config_baseline": round(e2e_rps / proxy_di, 2) if proxy_di else None,
                "host_speed_of_light": host_speed_of_light(
                    e2e_rps, n_reads, stage_timings, inputs=di_inputs
                ),
                "wall_s": round(time.perf_counter() - t0, 3),
            }
        )

        # never lose the whole bench (and the headline line) to one
        # secondary config: record the failure as that config's entry instead
        def guarded(name, fn, *a):
            t0 = time.perf_counter()
            try:
                entry = fn(*a)
            except Exception as e:
                entry = {"name": name, "error": f"{type(e).__name__}: {e}"[:200]}
            if entry:
                entry["wall_s"] = round(time.perf_counter() - t0, 3)
                configs.append(entry)

        # ---- config 1: single-end inline 17B+T, 16 samples, mm=0 ----
        def bench_single_end_config():
            se_bcs = make_whitelist(16, 17, seed=21)
            se_meta = write_metadata(tmp, se_bcs, "se_meta.tsv")
            wse, _ = write_single_end_inputs(tmp, se_bcs, WARMUP_READS, "w_se")
            se_path, _ = write_single_end_inputs(
                tmp, se_bcs, n_reads_secondary, "se"
            )
            se_rps, se_t, proxy_se = run_config_ab(
                tmp, [se_path], ["17B+T"], se_meta, se_bcs, n_reads_secondary,
                "se", trials=secondary_trials, max_mm=0, delta=2, warm_inputs=[wse],
                device=device,
            )
            return {
                "name": "single_end_inline_17B+T_16samples_mm0",
                "level": "e2e",
                "reads_per_sec": round(se_rps, 1),
                "proxy_reads_per_sec": round(proxy_se, 1) if proxy_se else None,
                "vs_config_baseline": round(se_rps / proxy_se, 2) if proxy_se else None,
                "host_speed_of_light": host_speed_of_light(
                    se_rps, n_reads_secondary, se_t, inputs=[se_path]
                ),
            }

        guarded("single_end_inline_17B+T_16samples_mm0", bench_single_end_config)

        # ---- config 3: IUPAC/N expected barcodes (same shape as #1) ----
        def bench_iupac_config():
            iupac_bcs = make_whitelist(16, 17, seed=23)
            iupac_bcs = [
                b[:4] + "N" + b[5:10] + "RY"[i % 2] + b[11:]
                for i, b in enumerate(iupac_bcs)
            ]
            iu_meta = write_metadata(tmp, iupac_bcs, "iu_meta.tsv")
            iu_reads = [b.replace("N", "A").replace("R", "G").replace("Y", "C")
                        for b in iupac_bcs]
            iu_path, _ = write_single_end_inputs(
                tmp, iu_reads, n_reads_secondary, "iu"
            )
            iu_rps, iu_t, proxy_iu = run_config_ab(
                tmp, [iu_path], ["17B+T"], iu_meta, iupac_bcs, n_reads_secondary,
                "iu", trials=secondary_trials, max_mm=1, delta=2, device=device,
            )
            return {
                "name": "iupac_N_expected_barcodes_17B+T_16samples",
                "level": "e2e",
                "reads_per_sec": round(iu_rps, 1),
                "proxy_reads_per_sec": round(proxy_iu, 1) if proxy_iu else None,
                "vs_config_baseline": round(iu_rps / proxy_iu, 2) if proxy_iu else None,
                "host_speed_of_light": host_speed_of_light(
                    iu_rps, n_reads_secondary, iu_t, inputs=[iu_path]
                ),
            }

        guarded("iupac_N_expected_barcodes_17B+T_16samples", bench_iupac_config)

        # ---- config 5: variable-length '+' structures, PE (headline shape) ----
        def bench_varlen_config():
            v1, _ = write_single_end_inputs(
                tmp, [b[:BC1] for b in barcodes], n_reads_secondary, "v1",
                var_template=True,
            )
            v2, _ = write_single_end_inputs(
                tmp, [b[BC1:] for b in barcodes], n_reads_secondary, "v2",
                var_template=True,
            )
            var_rps, var_t, proxy_var = run_config_ab(
                tmp, [v1, v2], ["8B+T", "9B+T"], meta, barcodes,
                n_reads_secondary, "var", trials=secondary_trials, device=device,
            )
            return {
                "name": "variable_length_plus_structures_PE_96samples",
                "level": "e2e",
                "reads_per_sec": round(var_rps, 1),
                "proxy_reads_per_sec": round(proxy_var, 1) if proxy_var else None,
                "vs_config_baseline": round(var_rps / proxy_var, 2) if proxy_var else None,
                "host_speed_of_light": host_speed_of_light(
                    var_rps, n_reads_secondary, var_t, inputs=[v1, v2]
                ),
                "note": "multi-process demux validated separately "
                "(tests/test_torch_multiprocess.py on a 2-process gloo run)",
            }

        guarded("variable_length_plus_structures_PE_96samples", bench_varlen_config)

        # ---- config 4: 737K single-cell whitelist (matcher-level) ----
        guarded("single_cell_737K_whitelist_16B", bench_bigk_config, device)

        # ---- mid-K: the device path is the production auto-choice ----
        guarded("mid_K_8192_16bp_mm1_d2", bench_midk_config, device)

        # ---- subsample: the other half of the CLI surface ----
        guarded("subsample_PE_fraction0.3", bench_subsample_config, tmp, paths,
                subsample_trials)

    baseline_rps, baseline_note = rust_baseline()
    return {
        "metric": "demux_e2e_reads_per_sec",
        "value": round(e2e_rps, 1),
        "unit": "reads/s",
        # vs_baseline is the CONTROLLED comparison: product and
        # reference-architecture proxy measured back-to-back on the same
        # inputs in the same run.  The best-ever-observed pinned proxy
        # (another host) is kept alongside.
        "vs_baseline": round(e2e_rps / proxy_di, 4)
        if proxy_di
        else round(e2e_rps / baseline_rps, 4),
        "vs_pinned_best_proxy": round(e2e_rps / baseline_rps, 4),
        "kernel_assign_reads_per_sec": round(kernel_rps, 1),
        "kernel_device": kernel_device,
        "stage_seconds": stage_timings,
        "config": "dual-index PE, 96 samples, 8B+9B, max_mm=1, delta=2, native engine",
        "baseline_note": baseline_note,
        "configs": configs,
        "card": card_line() if torch.device(device).type == "cuda" else str(device),
        "torch": torch.__version__,
        "read_counts": {"headline": n_reads, "secondary": n_reads_secondary},
        "wall_s": round(time.perf_counter() - t_run, 3),
    }


def summary(full: dict) -> dict:
    """The compact headline-last line."""
    return {
        "metric": "demux_e2e_reads_per_sec",
        "headline_reads_per_sec": full["value"],
        "unit": "reads/s",
        "vs_baseline": full["vs_baseline"],
        "configs_vs_baseline": {
            c["name"]: c.get("vs_config_baseline")
            for c in full["configs"]
        },
        "value": full["value"],
    }


def main(record_path: Optional[Path] = None, **sizes) -> int:
    """Run every config (``sizes``: :func:`run_bench`'s keywords), print
    the full record and the summary as two JSON lines, write the record to
    ``record_path`` (default :data:`RECORD_PATH`); 1 when any config
    recorded an error (named on stderr), else 0."""
    full = run_bench(**sizes)
    print(json.dumps(full), flush=True)
    # The tail of a captured output may lose the big line's headline fields
    # to truncation: persist the full record and re-print a compact
    # headline-last summary.
    path = Path(record_path) if record_path is not None else RECORD_PATH
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as fh:
        json.dump(full, fh, indent=1)
        fh.write("\n")
    print(json.dumps(summary(full)), flush=True)
    failed = failed_configs(full)
    if failed:
        print(f"fqtk_tpu_torch.bench: {len(failed)} config(s) recorded an error: "
              + ", ".join(failed), file=sys.stderr, flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
