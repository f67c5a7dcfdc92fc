"""Smoke run of fqtk_tpu_torch on one NVIDIA GPU: builds the CUDA kernels,
holds each against its plain PyTorch version at the main path's shapes, and
drives device-placed ``demux`` end to end through the CLI.

    python3 chip_smoke.py

Phases (any failure is an uncaught exception and a non-zero exit):

1. device  — the card's name and power limit; no CUDA device raises.
2. build   — the host I/O engine (when the committed binary does not load)
             and the CUDA kernels from ``fqtk_tpu_torch/csrc/``.
3. kernels — ``colmerge_top2`` against ``colmerge_top2_reference`` bit for
             bit at K = 96 / 8,192 / 737,280, with median times of both.
4. demux   — a 2,000,000-read dual-index paired-end run with 96 samples
             through ``python -m fqtk_tpu_torch.cli demux --matcher device
             --device cuda``; the kernel must have been launched, and every
             decompressed output and ``demux-metrics.txt`` must equal the C++
             host matcher's run (``--matcher host``) byte for byte; the
             per-sample counts must equal those implied by the generator.

The second-to-last line is the card as ``nvidia-smi`` names it, preceded by
a ``{"kernels": [...]}`` line; the last line is
``{"ok": true, "device": {...}}``.  Logs of the demux runs go to
``build/fqtk_tpu_torch/smoke_logs/``.
"""

from __future__ import annotations

import gzip
import json
import re
import shutil
import statistics
import struct
import subprocess
import sys
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "fqtk_tpu_torch" / "smoke"
LOGS = ROOT / "build" / "fqtk_tpu_torch" / "smoke_logs"

KERNEL_SOURCE = "fqtk_tpu_torch/csrc/colmerge_top2.cu"
REPLACES = "fqtk_tpu/ops/pallas_matcher.py:373"  # kernel_colmerge (run_kernel :444)

#: phase 3 shapes (K, L, B): at 96 samples the window dedup's bucket (what
#: phase 4 launches: ~4.7K unique rows per 131,072-read window -> 8,192) and
#: a full window; the mid-K and single-cell whitelist sizes
KERNEL_SHAPES = [
    (96, 17, 8192),
    (96, 17, 131_072),
    (8192, 16, 131_072),
    (737_280, 16, 16_384),
]
MAIN_PATH_SHAPE = (96, 17, 8192)

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# phase 3: kernel against plain
# --------------------------------------------------------------------------


def kernel_case(k: int, length: int, b: int, seed: int):
    """Seeded whitelist (IUPAC N/R entries, duplicates in far K ranges) and
    reads (a quarter planted exact matches, an eighth one mismatch away)."""
    from fqtk_tpu_torch.ops.device_encoding import pack_bit2
    from fqtk_tpu_torch.ops.matcher import ExpectedSet

    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(k, length), dtype=np.uint8)
    wl = ACGT[codes]
    if k >= 16:  # the same barcode in distant K ranges: cross-range ties
        wl[k - 1] = wl[1]
        wl[k // 2] = wl[2]
        wl[k // 3] = wl[1]
    planted = wl.copy()
    if k >= 8:
        wl[3, length // 2] = ord("N")
        wl[7, 0] = ord("R")  # A|G; planted reads keep the original base
    es = ExpectedSet.from_barcodes([bytes(r).decode() for r in wl])
    obs = ACGT[rng.integers(0, 4, size=(b, length), dtype=np.uint8)]
    rows = rng.integers(0, k, size=b)
    exact = rng.random(b) < 0.25
    obs[exact] = planted[rows[exact]]
    one = (~exact) & (rng.random(b) < 0.125)
    obs[one] = planted[rows[one]]
    pos = rng.integers(0, length, size=b)
    idx = np.nonzero(one)[0]
    obs[idx, pos[idx]] = ACGT[(np.searchsorted(ACGT, obs[idx, pos[idx]]) + 1) % 4]
    return es, pack_bit2(obs)


def cuda_median_ms(fn, reps: int) -> float:
    fn()  # warm
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def phase_kernels(card: str) -> dict:
    from fqtk_tpu_torch.ops.hopper_matcher import (
        ColmergeTop2,
        colmerge_top2_reference,
        hopper_state_from_numpy,
    )

    kern = ColmergeTop2()  # its own counter: these launches are not the main path's
    results = []
    max_err = 0
    for i, (k, length, b) in enumerate(KERNEL_SHAPES):
        es, packed = kernel_case(k, length, b, seed=1000 + i)
        state = hopper_state_from_numpy(es, "cuda")
        obs = torch.from_numpy(packed).cuda()
        # a ragged B (not a multiple of any row tile) for exactness too
        for rows in (b, b - 37):
            o = obs[:rows].contiguous()
            got = kern(o, state.compat, k, length)
            want = colmerge_top2_reference(o, state.compat, k, length)
            torch.cuda.synchronize()
            for name, g, w in zip(("best", "idx", "next"), got, want):
                err = int((g.long() - w.long()).abs().max().item())
                max_err = max(max_err, err)
                if not torch.equal(g, w):
                    bad = int((g != w).nonzero()[0, 0])
                    raise AssertionError(
                        f"colmerge_top2 != plain at K={k} L={length} B={rows}: "
                        f"{name}[{bad}] kernel {int(g[bad])} plain {int(w[bad])}"
                    )
        reps = 5 if k > 10_000 else 20
        ms = cuda_median_ms(lambda: kern(obs, state.compat, k, length), reps)
        plain_ms = cuda_median_ms(
            lambda: colmerge_top2_reference(obs, state.compat, k, length), reps
        )
        results.append(dict(k=k, length=length, b=b, ms=ms, plain_ms=plain_ms))
        log(
            f"[kernels] K={k} L={length} B={b}: colmerge_top2 {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms (median of {reps}; {card}); "
            f"{b / ms / 1e3:.1f}M rows/s kernel, {b / plain_ms / 1e3:.1f}M rows/s plain"
        )
        del state, obs
        torch.cuda.empty_cache()
    return dict(shapes=results, max_abs_err=max_err)


# --------------------------------------------------------------------------
# phase 4: the slice end to end
# --------------------------------------------------------------------------

N_READS = 2_000_000
N_SAMPLES = 96
BC1, BC2 = 8, 9
STRUCTURES = ["8B", "100T", "100T", "9B"]
BGZF_EOF = bytes.fromhex("1f8b08040000000000ff0600424302001b0003000000000000000000")


def _bgzf_block(data: bytes) -> bytes:
    comp = zlib.compressobj(1, zlib.DEFLATED, -15)
    cdata = comp.compress(data) + comp.flush()
    header = struct.pack(
        "<BBBBIBBHBBHH", 31, 139, 8, 4, 0, 0, 255, 6, 66, 67, 2, len(cdata) + 25
    )
    return header + cdata + struct.pack("<II", zlib.crc32(data), len(data))


def write_bgzf(path: Path, data: bytes, pool: ThreadPoolExecutor) -> None:
    step = 65280
    blocks = pool.map(_bgzf_block, (data[i:i + step] for i in range(0, len(data), step)))
    with open(path, "wb") as fh:
        for blk in blocks:
            fh.write(blk)
        fh.write(BGZF_EOF)


def make_whitelist(rng, k: int, length: int, min_dist: int) -> list:
    out = []
    while len(out) < k:
        cand = ACGT[rng.integers(0, 4, size=length)]
        if all(int((cand != o).sum()) >= min_dist for o in out):
            out.append(cand)
    return [bytes(o).decode() for o in out]


def make_run(work: Path, n_reads: int, seed: int = 11):
    """Dual-index paired-end BGZF inputs (the bench.py layout): 10% of the
    reads carry one index mismatch and 0.5% an N.  Returns the input paths,
    the metadata file and the per-sample template counts the demux must
    produce (max mismatches 1, min delta 2; barcodes >= 5 apart, so a read is
    assigned iff its index differs from its sample's in at most one
    position)."""
    rng = np.random.default_rng(seed)
    barcodes = make_whitelist(rng, N_SAMPLES, BC1 + BC2, min_dist=5)
    meta = work / "metadata.tsv"
    meta.write_text(
        "sample_id\tbarcode\n"
        + "".join(f"S{i:04d}\t{b}\n" for i, b in enumerate(barcodes))
    )
    choice = rng.integers(0, N_SAMPLES, size=n_reads)
    idx = np.frombuffer("".join(barcodes).encode(), dtype=np.uint8).reshape(N_SAMPLES, -1)
    obs = idx[choice].copy()
    mism = rng.random(n_reads) < 0.10
    mpos = rng.integers(0, BC1 + BC2, size=n_reads)
    rows = np.nonzero(mism)[0]
    obs[rows, mpos[rows]] = ACGT[
        (np.searchsorted(ACGT, obs[rows, mpos[rows]]) + rng.integers(1, 4, size=len(rows))) % 4
    ]
    has_n = rng.random(n_reads) < 0.005
    npos = rng.integers(0, BC1 + BC2, size=n_reads)
    rows = np.nonzero(has_n)[0]
    obs[rows, npos[rows]] = ord("N")
    diffs = (obs != idx[choice]).sum(axis=1)
    assigned = np.where(diffs <= 1, choice, N_SAMPLES)
    expect = np.bincount(assigned, minlength=N_SAMPLES + 1)

    r1 = b"ACGT" * 25
    r2 = b"TTGA" * 25
    q100 = b"I" * 100
    parts = {n: [] for n in ("i1", "r1", "r2", "i2")}
    for i in range(n_reads):
        h = b"@inst:1:AB:1:2:%d:3 1:N:0:0\n" % i
        bc = obs[i].tobytes()
        parts["i1"].append(h + bc[:BC1] + b"\n+\nIIIIIIII\n")
        parts["i2"].append(h + bc[BC1:] + b"\n+\nIIIIIIIII\n")
        parts["r1"].append(h + r1 + b"\n+\n" + q100 + b"\n")
        parts["r2"].append(h + r2 + b"\n+\n" + q100 + b"\n")
    paths = []
    with ThreadPoolExecutor(max_workers=8) as pool:
        for name in ("i1", "r1", "r2", "i2"):
            p = work / f"{name}.fq.gz"
            write_bgzf(p, b"".join(parts[name]), pool)
            parts[name] = None
            paths.append(p)
    return paths, meta, expect


def run_cli(paths, meta, out: Path, matcher: str, device: str, log_path: Path):
    cmd = [
        sys.executable, "-m", "fqtk_tpu_torch.cli", "demux",
        "-i", *map(str, paths), "-r", *STRUCTURES, "-s", str(meta),
        "-o", str(out), "--matcher", matcher, "--device", device,
    ]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
    wall = time.perf_counter() - t0
    log_path.write_text(f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    if proc.returncode != 0:
        raise RuntimeError(
            f"demux --matcher {matcher} exited {proc.returncode}:\n{proc.stderr[-4000:]}"
        )
    return proc.stderr, wall


def same_decompressed(a: Path, b: Path) -> int:
    size = 0
    with gzip.open(a, "rb") as fa, gzip.open(b, "rb") as fb:
        while True:
            x, y = fa.read(1 << 24), fb.read(1 << 24)
            if x != y:
                raise AssertionError(f"{a.name}: decompressed bytes differ near {size}")
            if not x:
                return size
            size += len(x)


def read_templates(metrics: Path) -> np.ndarray:
    lines = metrics.read_text().splitlines()[1:]
    return np.array([int(line.split("\t")[2]) for line in lines])


def phase_demux(card: str, work: Path, n_reads: int, device: str) -> dict:
    if work.exists():
        shutil.rmtree(work)
    work.mkdir(parents=True)
    LOGS.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    paths, meta, expect = make_run(work, n_reads)
    log(f"[demux] wrote {n_reads} dual-index PE reads (BGZF) in {time.perf_counter() - t0:.1f} s")

    err, wall = run_cli(paths, meta, work / "device", "device", device, LOGS / "demux_device.log")
    m = re.search(r"colmerge_top2: (\d+) kernel launches, (\d+) plain-version calls", err)
    if m is None:
        raise AssertionError("the device demux did not report its matcher counts")
    launches, plain = int(m.group(1)), int(m.group(2))
    want_launch = device == "cuda"
    if (launches > 0) != want_launch or (plain > 0) == want_launch:
        raise AssertionError(
            f"device demux on {device}: {launches} kernel launches, {plain} plain calls"
        )
    m = re.search(r"demux pipeline: (\d+) records in ([0-9.]+) s", err)
    records, pipe_s = int(m.group(1)), float(m.group(2))
    if records != n_reads:
        raise AssertionError(f"device demux routed {records} of {n_reads} records")

    _, host_wall = run_cli(paths, meta, work / "host", "host", "cpu", LOGS / "demux_host.log")

    dev_files = sorted(p.name for p in (work / "device").glob("*.fq.gz"))
    host_files = sorted(p.name for p in (work / "host").glob("*.fq.gz"))
    if dev_files != host_files or len(dev_files) != 2 * (N_SAMPLES + 1):
        raise AssertionError(f"output file sets differ: {len(dev_files)} vs {len(host_files)}")
    total = sum(same_decompressed(work / "device" / n, work / "host" / n) for n in dev_files)
    dm = (work / "device" / "demux-metrics.txt").read_bytes()
    if dm != (work / "host" / "demux-metrics.txt").read_bytes():
        raise AssertionError("demux-metrics.txt differs from the host-matcher run")
    got = read_templates(work / "device" / "demux-metrics.txt")
    if not np.array_equal(got, expect):
        raise AssertionError(f"per-sample counts {got.tolist()} != generator's {expect.tolist()}")
    rate = n_reads / pipe_s
    log(
        f"[demux] {n_reads} reads, 96 samples, --matcher device --device {device}: "
        f"{launches} kernel launches; pipeline {pipe_s:.3f} s = {rate:,.0f} reads/s, "
        f"CLI wall {wall:.2f} s incl. start-up ({card}); host-matcher run wall "
        f"{host_wall:.2f} s"
    )
    log(
        f"[demux] {len(dev_files)} outputs ({total:,} decompressed bytes) and "
        f"demux-metrics.txt identical to the host matcher; {int(expect[-1])} unmatched "
        "as the generator implies"
    )
    shutil.rmtree(work)
    return dict(launches=launches, reads_per_s=rate, pipeline_s=pipe_s, wall_s=wall)


def main() -> int:
    # phase 1: device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; needs an NVIDIA GPU")
    name = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"[device] {name} | nvidia-smi: {card} | torch {torch.__version__} CUDA {torch.version.cuda}")

    # phase 2: build
    from fqtk_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.ensure_native_engine()
    log(f"[build] native I/O engine ready in {time.perf_counter() - t0:.1f} s")
    info = _build.build_kernels()
    _build.load_kernels()
    log(
        f"[build] CUDA kernels {'built' if info['built'] else 'reused'} in "
        f"{info['seconds']:.1f} s -> {Path(info['path']).relative_to(ROOT)}"
    )
    for line in str(info["log"]).splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build]   {line.strip()}")

    # phase 3: kernel against plain
    kr = phase_kernels(card)

    # phase 4: the slice end to end (a fresh CLI process: its counts start at 0)
    dr = phase_demux(card, WORK, N_READS, "cuda")

    main_shape = next(s for s in kr["shapes"] if (s["k"], s["length"], s["b"]) == MAIN_PATH_SHAPE)
    print(json.dumps({"kernels": [{
        "name": "colmerge_top2",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": REPLACES,
        "launches": dr["launches"],
        "max_abs_err": kr["max_abs_err"],
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
        "shapes": kr["shapes"],
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
