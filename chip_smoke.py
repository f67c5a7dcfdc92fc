"""Smoke run of fqtk_tpu_torch on one NVIDIA GPU: builds the CUDA kernels,
holds each against its plain PyTorch version at the main paths' shapes, and
drives device-placed ``demux`` end to end through the CLI and the
single-cell whitelist window through the matcher.

    python3 chip_smoke.py

Phases (any failure is an uncaught exception and a non-zero exit):

1. device  — the card's name and power limit; no CUDA device raises.
2. build   — the host I/O engine (when the committed binary does not load)
             and the CUDA kernels from ``fqtk_tpu_torch/csrc/`` (one nvcc
             per source, all started together).
3. kernels — ``colmerge_top2`` and ``tile_top2`` against their plain
             versions bit for bit at K = 96 / 8,192 / 737,280, with median
             times of all four, each kernel's bound (the larger of its int8
             operations over the card's peak and its bytes over the memory
             rate) and, as information, ``torch._int_mm`` for the counts
             alone; each kernel on a state built for it.  Then the 16-class
             input (rows of 4-bit IUPAC masks against a 16-class table, the
             no-call gate on the card): raw bytes and nib4 rows through
             ``make_hopper_assign_fn(packed2=False)`` at K = 96 (L 17,
             B 8,192) and K = 8,192 (L 16, B 131,072), each call launching
             ``colmerge_top2`` with no plain call, its kernel's (best, idx,
             next) equal to the plain version's and its gated result equal
             to the NumPy spec ``assign_batch_np``.  Then one call of
             the route of barcodes longer than 255 bp (``make_assign_fn``,
             plain PyTorch on the card, no kernel) at K = 96, L = 300,
             B = 8,192, equal to the NumPy spec ``assign_batch_np``.
4. demux   — a 2,000,000-read dual-index paired-end run with 96 samples
             through ``python -m fqtk_tpu_torch.cli demux --matcher device
             --device cuda``; ``colmerge_top2`` must have been launched, and
             every decompressed output and ``demux-metrics.txt`` must equal
             the C++ host matcher's run (``--matcher host``) byte for byte;
             the per-sample counts must equal those implied by the generator.
5. single-cell whitelist — a seeded whitelist of 6,794,880 distinct 16-bp
             barcodes (the size of 10x Genomics' 3M-february-2018 list):
             ``tile_top2`` against its plain version bit for bit at
             B = 16,384 and 16,347 (uniform reads, 10% with a random base),
             then one 131,072-read window clustered on 8,000 cells through
             the port's window dedup and ``make_hopper_assign_fn``, which
             must pick ``tile_top2`` on its own and launch it
             (no plain call, no ``colmerge_top2`` launch); ``assigned`` must
             equal the plain version's gated result on the same rows and the
             C++ pigeonhole host matcher's.  Then one raw-byte call at
             B = 16,384 (IUPAC and no-call reads) through the 16-class
             input: ``tile_top2`` launched, equal to its plain version and,
             on its first rows, to the NumPy spec.
6. kernel lab — ``python -m fqtk_tpu_torch.lab.kernel_lab``'s run at its
             full size (K = 737,280 barcodes of L = 16, W = 4): every
             default spec (``DEFAULT_SPECS``: the JAX lab's defaults, plus
             every other ported variant) built, timed by the lab's rate
             slope (B = 65,536 and 131,072) and spot-checked against
             ``colmerge_top2``, with the lab kernels' counts set to 0 just
             before and read just after (each of ``mma_probe``,
             ``lab_probe``, ``clamp16_top2``, ``group_top2``,
             ``clamp8_top2`` launched, no plain call); then each variant
             against its plain version bit for bit at the shapes that run
             gave it — B = 131,072 and 65,536 on the rate slope's own rows —
             and at a ragged B = 15,872 of the spot check's reads, with
             kernel and plain times at B = 16,384 and, for the variants of
             the tensor-core lab kernels, the design's stream bytes per
             (row, column) pair and the shared-memory stream bound beside
             the int8 bound.
7. placement — ``FQTK_CACHE_DIR`` set to a fresh directory; the measured
             placement (``--matcher auto``) at K = 96 (L 17, phase 4's
             whitelist) and K = 8,192 (L 16), per 131,072-read window: host
             matcher, device floor and device matcher times and the choice.
             Then phase 4's dataset twice in one process with ``--matcher
             auto``: the first run reads the disk decision (no probe), the
             second builds nothing (``_ASSIGN_FN_CACHE``); both equal to the
             ``--matcher host`` run byte for byte, each reporting its own
             launches.
8. python-io — 150,000 reads of the same config (one full batch and one
             partial) through ``--engine pallas``, ``jax`` and ``numpy`` on
             the card, each byte-identical to the native run; ``pallas``
             launches ``colmerge_top2`` on the 16-class input and calls no
             plain version; reads/s per engine.
9. scale-out — the card's host has one GPU, so every tile of a mesh and
             both processes use ``cuda:0``.  (a) Phase 5's whitelist as a
             1 x 2 whitelist mesh (``parallel/mesh.py``): each shard of
             3,397,440 barcodes launches ``colmerge_top2`` (no ``tile_top2``
             launch, no plain call); phase 5's window through the dedup and
             the mesh equals phase 5's single-device result and its host
             oracle; one shard's kernel against its plain version bit for
             bit at B = 16,384 and on the window's bucket, with its times
             and bound.  (b) Phase 4's dataset through ``run_demux`` with
             ``local_devices`` giving ``[cuda:0] * 2`` and ``devices=2``,
             as a batch mesh and as a whitelist mesh
             (``PALLAS_K_THRESHOLD`` set low), each byte-identical to the
             ``--matcher host`` run.  (c) Two CLI processes
             (``--distributed-coordinator 127.0.0.1:<port> --num-processes 2
             --process-id i --merge-output``, gloo), each on one half of
             phase 8's reads as a lane: the merged outputs and metrics equal
             phase 8's single-process native run.

10. entry points and harness — ``fqtk_tpu_torch.graft_entry``: ``entry()``
             on the card (equal to its CPU run and to the NumPy spec), then
             ``dryrun_multichip(1)`` and ``dryrun_multichip(2, [cuda:0] * 2)``
             (the sharded small-K step, the product driver over the mesh,
             the big-K whitelist-sharded steps and the forced pigeonhole
             driver, each against the spec or the NumPy engine): every
             sharded step launches ``colmerge_top2`` with no plain call.
             Then ``fqtk_tpu_torch.bench``'s ``main`` in this process with
             only its read counts and trials cut (:data:`BENCH_CUT`):
             every config in ``bench.py``'s order, exit 0 (no config
             recorded an error, every e2e run's ``total_templates`` held),
             the mid-K leg and the 737K device leg each launching
             ``colmerge_top2`` with no plain call; each config's numbers
             and wall time.  Then ``colmerge_top2`` against its plain
             version at the 737K leg's shape (K 737,280, B 131,072).
11. measuring tools — every tool of ``fqtk_tpu_torch/scripts/`` at a cut
             (``FQTK_CACHE_DIR`` under its work directory): ``profile_e2e``
             on ``headline`` at 500,000 reads, one trial, both arms (the
             device arm, ``FQTK_HOST_MATCHER_MAX_K=0``, launches
             ``colmerge_top2`` with no plain call; every run's outputs
             identical); ``ab_e2e midk`` at 300,000 reads over
             ``FQTK_HOST_MATCHER_MAX_K=0`` and ``=100000`` (outputs and
             ``demux-metrics.txt`` identical); ``core_scaling`` at 200,000
             reads on 1 and all cores; ``scaling_bench`` at 200,000 reads a
             shard (rank 0's shard-0 outputs equal the solo run's, the merged
             counts the two shards' sum); ``measure_baseline`` at 500,000
             reads.  ``BASELINE_MEASURED.json``, ``CORE_SCALING_LOCAL.json``
             and ``SCALING_LOCAL.json`` keep their SHA-256.

The build fails the run if a kernel on the tensor-core engine
(``ENGINE_LAB_KERNELS``) spills or ptxas serializes its ``wgmma``.

After the last phase the script fails if ``jax`` or any module of the JAX
package ``fqtk_tpu`` has been imported.  The second-to-last line is the card
as ``nvidia-smi`` names it, preceded by a ``{"kernels": [...]}`` line (per
kernel and input form (``classes`` 4: bit2 rows; 16: nib4 and raw-byte
rows; the 16-class ``colmerge_top2`` row's launches are phase 8's
``--engine pallas`` run's, the shard row's phase 9's window's, two more
``colmerge_top2`` rows phase 10's harness legs', two more phase 11's
device arms'): launches on
its path, max abs error, kernel /
plain / bound / library ms at its main-path shape); the last line is
``{"ok": true, "device": {...}}``.  Logs of the demux runs go to
``build/fqtk_tpu_torch/smoke_logs/``.
"""

from __future__ import annotations

import gzip
import json
import re
import shutil
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

#: name -> (source, the TPU kernel it replaces: the first two are launched by
#: run_kernel's pl.pallas_call at pallas_matcher.py:462, the lab's by the
#: pl.pallas_call named)
KERNELS = {
    "colmerge_top2": ("fqtk_tpu_torch/csrc/colmerge_top2.cu",
                      "fqtk_tpu/ops/pallas_matcher.py:373"),  # kernel_colmerge
    "tile_top2": ("fqtk_tpu_torch/csrc/tile_top2.cu",
                  "fqtk_tpu/ops/pallas_matcher.py:285"),  # kernel (per-step)
    "mma_probe": ("fqtk_tpu_torch/csrc/mma_probe.cu", "scripts/kernel_lab.py:139"),
    "lab_probe": ("fqtk_tpu_torch/csrc/lab_probe.cu", "scripts/kernel_lab.py:222"),
    "clamp16_top2": ("fqtk_tpu_torch/csrc/clamp16_top2.cu", "scripts/kernel_lab.py:314"),
    "group_top2": ("fqtk_tpu_torch/csrc/group_top2.cu", "scripts/kernel_lab.py:419"),
    "clamp8_top2": ("fqtk_tpu_torch/csrc/clamp8_top2.cu", "scripts/kernel_lab.py:515"),
}

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
#: (K, L, B) of the 16-class calls through make_hopper_assign_fn (phase 3);
#: the NumPy spec is held to the first MASK_SPEC_ROWS rows of each
MASK_SHAPES = [(96, 17, 8192), (8192, 16, 131_072)]
MASK_SPEC_ROWS = 8192
#: (K, L, B) of the long-barcode route's call
LONG_SHAPE = (96, 300, 8192)

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
    """Median CUDA-event time of ``fn`` after one warm call (the kernel
    timing script's timer, so that both report the same quantity)."""
    from fqtk_tpu_torch.lab.time_top2 import median_ms

    return median_ms(fn, reps)


#: the card's published peaks (NVIDIA H100 SXM data sheet, dense): int8
#: tensor-core operations per second, device memory bytes per second
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12
#: shared-memory bytes an SM moves per clock (32 banks of 4 bytes)
SMEM_BYTES_PER_CLK_SM = 128


def max_sm_clock_hz() -> float:
    """The card's highest SM clock, as ``nvidia-smi`` reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    )
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def stream_bound(pairs: int, stream_bytes: int, depth: int, sms: int, clock_hz: float) -> float:
    """ms the shared memory of ``sms`` SMs needs for a lab design's streams:
    per (row, column) pair ``stream_bytes`` of the design's own reads and
    writes plus ``depth / 64`` bytes of ``wgmma``'s B reads (a sub-tile of N
    columns x ``depth`` bytes is read once per 64-row warpgroup), at
    ``SMEM_BYTES_PER_CLK_SM`` per SM and clock."""
    per_pair = stream_bytes + depth / 64.0
    return pairs * per_pair / (SMEM_BYTES_PER_CLK_SM * sms * clock_hz) * 1e3


def ptxas_summary(log: str) -> dict:
    """Registers, spills and ``wgmma`` serialization warnings of a kernel's
    build log (``-Xptxas -v``)."""
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
    spills = [int(a) + int(b) for a, b in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)]
    serialized = sum(
        1 for line in log.splitlines() if re.search(r"C7514|C7520|serializ", line))
    return dict(entries=len(regs), regs_min=min(regs, default=0),
                regs_max=max(regs, default=0), spill_bytes=sum(spills),
                serialized=serialized)


def top2_bound(k_counted: int, depth: int, b: int, width: int, table_bytes: int):
    """``(bound_ms, bound_by)`` of a counts-and-top-2 kernel over ``b`` rows
    and ``k_counted`` columns at contraction depth ``depth`` (the ``KP`` or
    ``4L`` the kernel multiplies): the larger of ``2 * b * k_counted *
    depth`` int8 operations at the card's peak and the bytes the function
    must move (rows in, the table once, 12 bytes per row out) at its memory
    rate."""
    ops_ms = 2.0 * b * k_counted * depth / PEAK_INT8_OPS * 1e3
    bytes_ms = (b * width + table_bytes + 12 * b) / PEAK_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def int_mm_counts_ms(obs: torch.Tensor, length: int, cols: int, reps: int = 5,
                     classes: int = 4) -> float:
    """Time of ``torch._int_mm`` for the COUNTS ALONE of ``obs``'s rows
    (bit2 at 4 classes, nib4 at 16) against ``cols`` random 0/1 int8 columns
    at depth ``classes * L`` rounded up to 32 (no top-2: no one PyTorch call
    computes the kernels' function).  A yardstick that the port never
    calls."""
    from fqtk_tpu_torch.ops.hopper_matcher import _onehot_of

    depth = -(-classes * length // 32) * 32
    onehot = torch.zeros((obs.shape[0], depth), dtype=torch.int8, device=obs.device)
    onehot[:, :classes * length] = _onehot_of(obs, length, classes).to(torch.int8)
    table = torch.randint(0, 2, (depth, cols), dtype=torch.int8, device=obs.device)
    return cuda_median_ms(lambda: torch._int_mm(onehot, table), reps)


def compare(name: str, got, want, where: str, fields=("best", "idx", "next")) -> int:
    """Max abs difference of two output tuples (by default (best, idx,
    next)); raises unless they are equal."""
    if len(got) != len(want):
        raise AssertionError(f"{name} at {where}: {len(got)} outputs, plain {len(want)}")
    err = 0
    for field, g, w in zip(fields, got, want):
        err = max(err, int((g.long() - w.long()).abs().max().item()))
        if not torch.equal(g, w):
            bad = int((g != w).nonzero()[0, 0])
            raise AssertionError(
                f"{name} != plain at {where}: {field}[{bad}] kernel "
                f"{int(g[bad])} plain {int(w[bad])}"
            )
    return err


def kernel_runs():
    """name -> (kernel call, plain call), each ``f(obs, state)`` on a state
    built for that kernel (bit2 or nib4 rows, by the state's classes).  The
    wrappers have their own counters: these launches are not a main
    path's."""
    from fqtk_tpu_torch.ops.hopper_matcher import (
        ColmergeTop2,
        TileTop2,
        colmerge_top2_reference,
        tile_top2_reference,
    )

    colm, tile = ColmergeTop2(), TileTop2()
    return {
        "colmerge_top2": (
            lambda o, st: colm(o, st.table, st.k, st.length, st.classes),
            lambda o, st: colmerge_top2_reference(o, st.table, st.k, st.length, st.classes),
        ),
        "tile_top2": (
            lambda o, st: tile(o, st.table, st.k, st.length, st.classes),
            lambda o, st: tile_top2_reference(o, st.table, st.k, st.length, st.classes),
        ),
    }


def shape_row(k: int, length: int, obs: torch.Tensor, state, ms: float,
              plain_ms: float) -> dict:
    """One measured shape of ``colmerge_top2`` / ``tile_top2``: its times,
    its bound over the function's K columns at the function's depth
    ``classes * L`` (the table's pad columns and pad depth are the kernel's
    choice and do not count), and the library yardstick (counts only, on one
    K chunk, scaled to K)."""
    b, wl = obs.shape[0], state.classes * length
    bound_ms, bound_by = top2_bound(k, wl, b, obs.shape[1], k * wl)
    # one K chunk whose [B, cols] int32 counts stay within 1 GiB
    cols = max(128, min(state.k_pad, (1 << 28) // b // 128 * 128))
    library_ms = int_mm_counts_ms(obs, length, cols, classes=state.classes) * (k / cols)
    return dict(k=k, length=length, b=b, classes=state.classes, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


def phase_kernels(card: str) -> dict:
    from fqtk_tpu_torch.lab.time_top2 import queued_ms
    from fqtk_tpu_torch.ops.hopper_matcher import hopper_state_from_numpy

    runs = kernel_runs()
    shapes = {name: [] for name in runs}
    max_err = {name: 0 for name in runs}
    for i, (k, length, b) in enumerate(KERNEL_SHAPES):
        es, packed = kernel_case(k, length, b, seed=1000 + i)
        obs = torch.from_numpy(packed).cuda()
        for name, (kernel, plain) in runs.items():
            state = hopper_state_from_numpy(es, "cuda", name)
            # a ragged B (not a multiple of any row tile) for exactness too
            for rows in (b, b - 37):
                o = obs[:rows].contiguous()
                got = kernel(o, state)
                want = plain(o, state)
                torch.cuda.synchronize()
                err = compare(name, got, want, f"K={k} L={length} B={rows}")
                max_err[name] = max(max_err[name], err)
            reps = 5 if k > 10_000 else 20
            ms = cuda_median_ms(lambda: kernel(obs, state), reps)
            plain_ms = cuda_median_ms(lambda: plain(obs, state), reps)
            row = shape_row(k, length, obs, state, ms, plain_ms)
            if k <= 10_000:  # launch-bound: the device's own time per launch
                row["queued_ms"] = queued_ms(lambda: kernel(obs, state), 200)
            shapes[name].append(row)
            log(
                f"[kernels] K={k} L={length} B={b}: {name} {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms (median of {reps}; {card}); bound "
                f"{row['bound_ms']:.4f} ms by {row['bound_by']} "
                f"({100 * row['bound_ms'] / ms:.1f}% reached); torch._int_mm, counts "
                f"only, {row['library_ms']:.4f} ms"
                + (f"; {row['queued_ms']:.4f} ms per launch behind a full queue"
                   if "queued_ms" in row else "")
            )
            del state
        del obs
        torch.cuda.empty_cache()
    return dict(shapes=shapes, max_abs_err=max_err)


def mask_case(k: int, length: int, b: int, seed: int):
    """:func:`kernel_case`'s whitelist and reads as raw bytes, with IUPAC
    reads: a twentieth get an N (one in fifty rows two or three, at the
    no-call gate's edge of ``max_mismatches + max_ns`` = 1 + 1), one in
    thirty an R, one in nine are lower case.  Returns ``(es, obs_bytes,
    nib4)``."""
    from fqtk_tpu_torch.core.encoding import ENCODE_LUT
    from fqtk_tpu_torch.ops.device_encoding import pack_nib4

    es, packed = kernel_case(k, length, b, seed)
    rng = np.random.default_rng(seed + 1)
    codes = (packed[:, np.arange(length) // 4] >> (2 * (np.arange(length) % 4))) & 3
    obs = ACGT[codes]
    for frac, n_pos, byte in ((20, 1, "N"), (50, 2, "N"), (50, 3, "N"), (30, 1, "R")):
        rows = np.nonzero(rng.integers(0, frac, size=b) == 0)[0]
        for j in range(n_pos):
            obs[rows, (rng.integers(0, length, size=len(rows)) + j) % length] = ord(byte)
    obs[rng.integers(0, 9, size=b) == 0] |= 0x20
    nib4 = pack_nib4(torch.from_numpy(ENCODE_LUT[obs])).numpy()
    return es, obs, nib4


def spec_rows(obs: np.ndarray, es, mm: int, delta: int):
    """The NumPy spec ``assign_batch_np`` on ``obs``'s rows, in blocks that
    keep its ``[rows, K, L]`` intermediate near 64 MB; ``assigned`` K for
    unmatched."""
    from fqtk_tpu_torch.ops.matcher import assign_batch_np

    step = max(1, (1 << 26) // (es.count * es.length))
    parts = [assign_batch_np(obs[r:r + step], es, mm, delta) for r in range(0, len(obs), step)]
    idx, best, nxt = (np.concatenate(f) for f in zip(*parts))
    return np.where(idx < 0, es.count, idx), best, nxt


def check_gated(name: str, got, want, where: str) -> None:
    """``(assigned, best, next)`` on the card against the spec's (numpy)."""
    for field, g, w in zip(("assigned", "best", "next"), got, want):
        g = g.cpu().numpy().astype(np.int64)[: len(w)]
        if not np.array_equal(g, w):
            bad = int(np.nonzero(g != w)[0][0])
            raise AssertionError(f"{name} at {where}: {field}[{bad}] {g[bad]}, spec {w[bad]}")


def phase_mask_inputs(card: str) -> dict:
    """The 16-class input through ``make_hopper_assign_fn`` (raw bytes and
    nib4) at :data:`MASK_SHAPES`: per call one ``colmerge_top2`` launch and
    no plain call (counts from 0 in each fresh function), its gated result
    equal to the spec on the first :data:`MASK_SPEC_ROWS` rows, the kernel's
    (best, idx, next) equal to the plain version's on all rows; then kernel
    and plain times on the nib4 rows."""
    from fqtk_tpu_torch.ops.hopper_matcher import make_hopper_assign_fn

    kernel, plain = kernel_runs()["colmerge_top2"]
    shapes, max_err = [], 0
    for i, (k, length, b) in enumerate(MASK_SHAPES):
        es, obs_bytes, nib4 = mask_case(k, length, b, seed=1400 + i)
        want = spec_rows(obs_bytes[:MASK_SPEC_ROWS], es, 1, 2)
        for form, rows in (("bytes", obs_bytes), ("nib4", nib4)):
            fn = make_hopper_assign_fn(es, 1, 2, device="cuda", packed2=False,
                                       packed_masks=form == "nib4")
            if fn.scheme != "colmerge_top2" or fn.state.classes != 16:
                raise AssertionError(f"K={k}: {fn.scheme}, {fn.state.classes} classes")
            got = fn(rows)
            torch.cuda.synchronize()
            counts = {n: (kern.launches, kern.plain_calls) for n, kern in fn.kernels.items()}
            if counts != {"colmerge_top2": (1, 0), "tile_top2": (0, 0)}:
                raise AssertionError(f"16-class {form} call at K={k}: kernel counts {counts}")
            check_gated(f"16-class {form}", got, want, f"K={k} L={length} B={b}")
            st = fn.state
        o = torch.from_numpy(nib4).cuda()
        for n in (b, b - 37):
            oo = o[:n].contiguous()
            err = compare("colmerge_top2 (16 classes)", kernel(oo, st), plain(oo, st),
                          f"K={k} L={length} B={n}")
            max_err = max(max_err, err)
        reps = 20 if k <= 1000 else 5
        ms = cuda_median_ms(lambda: kernel(o, st), reps)
        plain_ms = cuda_median_ms(lambda: plain(o, st), reps)
        row = shape_row(k, length, o, st, ms, plain_ms)
        shapes.append(row)
        log(f"[kernels] 16 classes, K={k} L={length} B={b}: raw bytes and nib4 through "
            f"make_hopper_assign_fn, one colmerge_top2 launch each, 0 plain calls, equal to "
            f"assign_batch_np ({MASK_SPEC_ROWS} rows) and the plain version; kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms (median of {reps}; {card}); bound "
            f"{row['bound_ms']:.4f} ms by {row['bound_by']} "
            f"({100 * row['bound_ms'] / ms:.1f}% reached); torch._int_mm, counts only, "
            f"{row['library_ms']:.4f} ms")
        del o, st, fn
        torch.cuda.empty_cache()
    return dict(shapes=shapes, max_abs_err=max_err)


def long_barcode_route(card: str) -> float:
    """One call of the matcher of barcodes longer than 255 bp
    (``make_assign_fn``: a float32 ``torch.matmul`` per K chunk, no kernel)
    on the card, equal to the NumPy spec; returns its median ms."""
    from fqtk_tpu_torch.ops.matcher import assign_batch_np, make_assign_fn

    k, length, b = LONG_SHAPE
    es, packed = kernel_case(k, length, b, seed=1300)
    codes = (packed[:, np.arange(length) // 4] >> (2 * (np.arange(length) % 4))) & 3
    fn = make_assign_fn(es, 1, 2, packed2=True, compact_output=True, device="cuda")
    obs = torch.from_numpy(packed).cuda()
    got = [x.cpu().numpy().astype(np.int64) for x in fn(obs)]
    idx, best, nxt = assign_batch_np(ACGT[codes], es, 1, 2)
    for field, g, w in zip(("assigned", "best", "next"), got, (np.where(idx < 0, k, idx), best, nxt)):
        if not np.array_equal(g, w):
            bad = int(np.nonzero(g != w)[0][0])
            raise AssertionError(f"long-barcode route {field}[{bad}]: {g[bad]}, spec {w[bad]}")
    ms = cuda_median_ms(lambda: fn(obs), 5)
    log(f"[kernels] K={k} L={length} B={b}: the long-barcode route ({fn.scheme}, float32 "
        f"torch.matmul per K chunk, no kernel) {ms:.4f} ms (median of 5; {card}), "
        f"equal to assign_batch_np; {int((got[0] < k).sum())} rows assigned")
    return ms


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
    """``k`` seeded barcodes at least ``min_dist`` apart (each candidate
    drawn in turn and kept if it is far enough from every kept one)."""
    out = np.empty((k, length), dtype=np.uint8)
    n = 0
    while n < k:
        cand = ACGT[rng.integers(0, 4, size=length)]
        if n == 0 or int((out[:n] != cand).sum(axis=1).min()) >= min_dist:
            out[n] = cand
            n += 1
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
    shutil.rmtree(work / "device")  # phase 7 reads the inputs and the host run
    return dict(launches=launches, reads_per_s=rate, pipeline_s=pipe_s, wall_s=wall,
                paths=paths, meta=meta, host_out=work / "host")


# --------------------------------------------------------------------------
# phase 5: the single-cell whitelist path
# --------------------------------------------------------------------------

SC_K = 6_794_880  # barcodes in 10x Genomics' 3M-february-2018.txt
SC_L = 16
SC_KERNEL_B = 16_384
SC_WINDOW = 131_072  # one production window (DEFAULT_BATCH_SIZE)
SC_CELLS = 8_000
SC_ORACLE_ROWS = 1_024  # the NumPy spec's rows if the host matcher refuses
SC_SPEC_ROWS = 16  # the NumPy spec's rows of the 16-class call


def single_cell_whitelist(seed: int):
    """``SC_K`` distinct seeded 16-bp ACGT barcodes as 2-bit codes
    ``[K, 16]`` and their ``ExpectedSet``, built from masks (no strings)."""
    from fqtk_tpu_torch.ops.matcher import ExpectedSet

    rng = np.random.default_rng(seed)
    draw = rng.integers(0, 1 << 32, size=SC_K + SC_K // 64, dtype=np.uint64)
    vals = rng.permutation(np.unique(draw))[:SC_K]  # distinct 32-bit values
    if len(vals) != SC_K:
        raise AssertionError(f"only {len(vals)} distinct barcodes drawn")
    codes = np.empty((SC_K, SC_L), dtype=np.uint8)
    for j in range(SC_L):
        codes[:, j] = (vals >> np.uint64(2 * j)) & np.uint64(3)
    masks = np.left_shift(1, codes).astype(np.uint8)  # A,C,G,T -> 1,2,4,8
    es = ExpectedSet(masks=masks, max_ns_in_barcodes=0, length=SC_L, count=SC_K)
    return es, codes


def single_cell_reads(rng, codes, b: int, cells=None) -> np.ndarray:
    """bench.py's recipe (config #4): reads drawn uniformly from the whitelist,
    or from ``cells`` of its barcodes; 10% get a random base at a random
    position.  Returns 2-bit codes ``[b, 16]``."""
    if cells is None:
        rows = rng.integers(0, len(codes), size=b)
    else:
        rows = rng.integers(0, len(codes), size=cells)[rng.integers(0, cells, size=b)]
    obs = codes[rows]
    mut = rng.integers(0, 10, size=b) == 0
    pos = rng.integers(0, SC_L, size=b)
    obs[mut, pos[mut]] = rng.integers(0, 4, size=int(mut.sum()))
    return obs


def host_oracle(codes: np.ndarray, es, window: np.ndarray):
    """The C++ pigeonhole matcher ``--matcher auto`` picks at this K (built as
    bench.py builds it) on the whole window; where it refuses the whitelist,
    the NumPy spec on the first ``SC_ORACLE_ROWS`` rows, one at a time.
    Returns (assigned rows, how many, which oracle)."""
    from fqtk_tpu_torch.ops.matcher import (
        NativeBigKMatcher,
        NativeDemuxError,
        assign_batch_np,
    )

    t0 = time.perf_counter()
    text = ACGT[codes].tobytes().decode()
    barcodes = [text[i * SC_L:(i + 1) * SC_L] for i in range(len(codes))]
    del text
    try:
        matcher = NativeBigKMatcher(barcodes, 1, 2, threads=4)
    except NativeDemuxError as e:
        log(f"[single-cell] NativeBigKMatcher refused the whitelist ({e}); "
            f"NumPy spec on the first {SC_ORACLE_ROWS} rows")
        obs = ACGT[window[:SC_ORACLE_ROWS]]
        out = np.empty(SC_ORACLE_ROWS, dtype=np.int64)
        for i in range(SC_ORACLE_ROWS):
            idx, _, _ = assign_batch_np(obs[i:i + 1], es, 1, 2)
            out[i] = SC_K if idx[0] < 0 else idx[0]
        return out, SC_ORACLE_ROWS, "assign_batch_np"
    build_s = time.perf_counter() - t0
    nib = np.left_shift(1, window).astype(np.uint8)  # ACGT masks 1,2,4,8
    nib4 = np.ascontiguousarray(nib[:, 0::2] | (nib[:, 1::2] << 4))
    t0 = time.perf_counter()
    out = matcher.assign(nib4).astype(np.int64)
    matcher.close()
    log(f"[single-cell] host oracle NativeBigKMatcher: build {build_s:.1f} s "
        f"(strings included), {len(window)} reads in {time.perf_counter() - t0:.3f} s")
    return out, len(window), "NativeBigKMatcher"


def phase_single_cell(card: str) -> dict:
    from fqtk_tpu_torch.ops.device_encoding import pack_bit2
    from fqtk_tpu_torch.ops.hopper_matcher import (
        TileTop2,
        make_hopper_assign_fn,
        tile_top2_reference,
    )
    from fqtk_tpu_torch.runtime.demux import _Pending, _wrap_window_dedup

    t0 = time.perf_counter()
    es, codes = single_cell_whitelist(seed=2018)
    log(f"[single-cell] {SC_K:,} distinct 16-bp barcodes made in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    fn = make_hopper_assign_fn(es, 1, 2, device="cuda")
    torch.cuda.synchronize()
    state_s = time.perf_counter() - t0
    if fn.scheme != "tile_top2":
        raise AssertionError(f"K={SC_K} picked {fn.scheme}, not tile_top2")
    st = fn.state
    log(f"[single-cell] state built in {state_s:.2f} s: table {tuple(st.table.shape)} "
        f"{st.table.dtype} ({st.table.numel() / 1e6:.0f} MB); scheme {fn.scheme}")

    # kernel against plain, bench recipe (uniform draws)
    kernel, plain = kernel_runs()["tile_top2"]
    rng = np.random.default_rng(7)
    obs = torch.from_numpy(pack_bit2(ACGT[single_cell_reads(rng, codes, SC_KERNEL_B)])).cuda()
    err = 0
    for rows in (SC_KERNEL_B, SC_KERNEL_B - 37):
        o = obs[:rows].contiguous()
        got = kernel(o, st)
        want = plain(o, st)
        torch.cuda.synchronize()
        err = max(err, compare("tile_top2", got, want, f"K={SC_K} L={SC_L} B={rows}"))
    ms = cuda_median_ms(lambda: kernel(obs, st), 5)
    plain_ms = cuda_median_ms(lambda: plain(obs, st), 2)
    shapes = [shape_row(SC_K, SC_L, obs, st, ms, plain_ms)]
    log(f"[single-cell] K={SC_K} L={SC_L} B={SC_KERNEL_B}: tile_top2 {ms:.4f} ms "
        f"(median of 5), plain {plain_ms:.4f} ms (median of 2) ({card}); bound "
        f"{shapes[0]['bound_ms']:.4f} ms by {shapes[0]['bound_by']} "
        f"({100 * shapes[0]['bound_ms'] / ms:.1f}% reached); torch._int_mm, counts only, "
        f"{shapes[0]['library_ms']:.4f} ms")
    del obs

    # the path: one production window through the window dedup
    window = single_cell_reads(rng, codes, SC_WINDOW, cells=SC_CELLS)
    packed = pack_bit2(ACGT[window])
    sent = []

    def call(rows):
        sent.append(rows)
        return _Pending(fn(rows)[0], keep=rows)

    assign = _wrap_window_dedup(call)
    for kern in fn.kernels.values():
        kern.launches = kern.plain_calls = 0
    t0 = time.perf_counter()
    assigned = assign(packed).fetch().astype(np.int64)
    call_s = time.perf_counter() - t0
    counts = {name: (kern.launches, kern.plain_calls) for name, kern in fn.kernels.items()}
    launches = counts["tile_top2"][0]
    if launches < 1 or counts["colmerge_top2"] != (0, 0) or fn.plain_calls:
        raise AssertionError(f"single-cell window: kernel counts {counts}")
    if len(sent) != 1 or len(sent[0]) >= SC_WINDOW:
        raise AssertionError("the window dedup did not engage")
    warm_ms = window_call_ms(assign, packed)
    bucket = torch.from_numpy(sent[0]).cuda()
    nb = len(sent[0])
    kms = cuda_median_ms(lambda: kernel(bucket, st), 3)
    log(f"[single-cell] window of {SC_WINDOW} reads ({SC_CELLS} cells): dedup bucket "
        f"{nb} rows, {launches} tile_top2 launch(es), 0 plain calls; call "
        f"{call_s * 1e3:.1f} ms (dedup + H2D + kernel + D2H + scatter, first call), "
        f"{warm_ms:.1f} ms (min of 3 more), kernel alone at B={nb} {kms:.4f} ms ({card})")

    # the plain version's gated result on the same rows
    t0 = time.perf_counter()
    pb, pi, pn = plain(bucket, st)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    err = max(err, compare("tile_top2", kernel(bucket, st), (pb, pi, pn),
                           f"K={SC_K} L={SC_L} B={nb} (the window's bucket)"))
    ok = (pb <= 1) & (pn - pb >= 2)
    plain_bucket = torch.where(ok, pi, SC_K).cpu().numpy().astype(np.int64)
    keys = packed.view("<u4").reshape(-1)
    uniq = np.unique(keys)
    if not np.array_equal(sent[0][: len(uniq)].view("<u4").reshape(-1), uniq):
        raise AssertionError("the bucket's rows are not the window's unique rows")
    want = plain_bucket[: len(uniq)][np.searchsorted(uniq, keys)]
    if not np.array_equal(assigned, want):
        bad = int(np.nonzero(assigned != want)[0][0])
        raise AssertionError(f"window row {bad}: path {assigned[bad]} plain {want[bad]}")
    shapes.append(shape_row(SC_K, SC_L, bucket, st, kms, plain_s * 1e3))
    log(f"[single-cell] the bucket's launch: bound {shapes[-1]['bound_ms']:.4f} ms by "
        f"{shapes[-1]['bound_by']} ({100 * shapes[-1]['bound_ms'] / kms:.1f}% reached)")

    # the C++ host matcher
    host, n, oracle = host_oracle(codes, es, window)
    if not np.array_equal(assigned[:n], host):
        bad = int(np.nonzero(assigned[:n] != host)[0][0])
        raise AssertionError(f"window row {bad}: path {assigned[bad]} {oracle} {host[bad]}")
    matched = float((assigned < SC_K).mean())
    log(f"[single-cell] assigned equal to the plain version's (one call on the "
        f"bucket, {plain_s:.2f} s host clock; all {SC_WINDOW} rows) and to "
        f"{oracle}'s ({n} rows); {matched:.4f} matched")
    del fn, st, bucket
    torch.cuda.empty_cache()
    mask = single_cell_masks(card, es, codes, rng)
    return dict(launches=launches, shapes=shapes, max_abs_err=err, oracle=oracle,
                call_ms=call_s * 1e3, warm_ms=warm_ms, mask=mask,
                # phase 9 runs the same window on a whitelist mesh
                es=es, codes=codes, window=window, assigned=assigned, host=host)


def window_call_ms(assign, packed: np.ndarray, reps: int = 3) -> float:
    """Host-clock ms of ``reps`` more calls of a window through ``assign``
    (a dedup-wrapped matcher) and their fetch: the least."""
    best = None
    for _ in range(reps):
        t0 = time.perf_counter()
        assign(packed).fetch()
        dt = (time.perf_counter() - t0) * 1e3
        best = dt if best is None else min(best, dt)
    return best


def single_cell_masks(card: str, es, codes: np.ndarray, rng) -> dict:
    """One raw-byte call at B = ``SC_KERNEL_B`` through the 16-class input
    of ``make_hopper_assign_fn`` on the single-cell list: ``tile_top2``
    launched once, no plain call; the kernel's (best, idx, next) on the
    call's nib4 rows equal to the plain version's, and the gated result
    equal to the NumPy spec on the first ``SC_SPEC_ROWS`` rows (N and
    lower-case reads among them)."""
    from fqtk_tpu_torch.core.encoding import ENCODE_LUT
    from fqtk_tpu_torch.ops.device_encoding import pack_nib4
    from fqtk_tpu_torch.ops.hopper_matcher import make_hopper_assign_fn

    t0 = time.perf_counter()
    fn = make_hopper_assign_fn(es, 1, 2, device="cuda", packed2=False)
    torch.cuda.synchronize()
    st = fn.state
    if fn.scheme != "tile_top2" or st.classes != 16:
        raise AssertionError(f"16-class single-cell state: {fn.scheme}, {st.classes} classes")
    log(f"[single-cell] 16-class state built in {time.perf_counter() - t0:.2f} s: table "
        f"{tuple(st.table.shape)} ({st.table.numel() / 1e6:.0f} MB)")
    obs = ACGT[single_cell_reads(rng, codes, SC_KERNEL_B)]
    n_rows = rng.integers(0, 20, size=SC_KERNEL_B) == 0
    n_rows[[1, 3, 5]] = True
    obs[n_rows, rng.integers(0, SC_L, size=int(n_rows.sum()))] = ord("N")
    obs[3, (np.arange(2) + 7)] = ord("N")  # two no-calls: over the budget of 1
    obs[2::9] |= 0x20
    got = fn(obs)
    torch.cuda.synchronize()
    counts = {n: (kern.launches, kern.plain_calls) for n, kern in fn.kernels.items()}
    if counts != {"colmerge_top2": (0, 0), "tile_top2": (1, 0)}:
        raise AssertionError(f"16-class single-cell call: kernel counts {counts}")
    check_gated("16-class single-cell", got, spec_rows(obs[:SC_SPEC_ROWS], es, 1, 2),
                f"K={SC_K} L={SC_L}, first {SC_SPEC_ROWS} rows")
    kernel, plain = kernel_runs()["tile_top2"]
    nib4 = pack_nib4(torch.from_numpy(ENCODE_LUT[obs])).cuda()
    t0 = time.perf_counter()
    want = plain(nib4, st)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = compare("tile_top2 (16 classes)", kernel(nib4, st), want,
                  f"K={SC_K} L={SC_L} B={SC_KERNEL_B}")
    for field, g, w in zip(("best", "next"), (got[1], got[2]), (want[0], want[2])):
        if not torch.equal(g, w):
            raise AssertionError(f"16-class single-cell call: {field} differs from plain")
    ms = cuda_median_ms(lambda: kernel(nib4, st), 3)
    row = shape_row(SC_K, SC_L, nib4, st, ms, plain_ms)
    log(f"[single-cell] 16 classes, raw bytes, K={SC_K} L={SC_L} B={SC_KERNEL_B}: one "
        f"tile_top2 launch, 0 plain calls, equal to the plain version and to "
        f"assign_batch_np ({SC_SPEC_ROWS} rows); kernel {ms:.4f} ms (median of 3), plain "
        f"{plain_ms:.1f} ms (one call, host clock) ({card}); bound {row['bound_ms']:.4f} ms "
        f"by {row['bound_by']} ({100 * row['bound_ms'] / ms:.1f}% reached); torch._int_mm, "
        f"counts only, {row['library_ms']:.4f} ms")
    del fn, st, nib4
    torch.cuda.empty_cache()
    return dict(launches=counts["tile_top2"][0], shapes=[row], max_abs_err=err)


# --------------------------------------------------------------------------
# phase 6: the kernel lab
# --------------------------------------------------------------------------

LAB_K, LAB_L = 737_280, 16  # the lab's defaults (FQTK_LAB_K, FQTK_LAB_L)
LAB_B = 16_384
LAB_KERNEL_NAMES = ("mma_probe", "lab_probe", "clamp16_top2", "group_top2", "clamp8_top2")
#: the lab kernels on the tensor-core engine: no spill, no serialized wgmma
ENGINE_LAB_KERNELS = LAB_KERNEL_NAMES


def phase_lab(card: str) -> dict:
    from fqtk_tpu_torch.lab import kernel_lab as lab
    from fqtk_tpu_torch.ops import lab_kernels as lk

    t0 = time.perf_counter()
    codes, masks = lab.lab_inputs(LAB_K, LAB_L)
    log(f"[lab] {LAB_K:,} barcodes of L = {LAB_L} made in {time.perf_counter() - t0:.1f} s; "
        f"v3w_clamp8 runs clamp8_top2 (wgmma's s8 product accumulates in s32 only)")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_hz = max_sm_clock_hz()

    # the path: the lab's run, counts set to 0 just before and read just after
    variants, per = {}, {}
    lk.reset_counts()
    t0 = time.perf_counter()
    for spec in lab.DEFAULT_SPECS:
        name, tb, tk, label = lab.parse_spec(spec)
        go, table, macs = lab.make_lab_variant(
            name, masks, LAB_L, tile_b=tb, tile_k=tk, device="cuda"
        )
        rate, times = lab.rate_of(go, table, codes)
        variants[label] = (go, table)
        kernel = go.params.kernel if go.params else "colmerge_top2"
        per[label] = dict(label=label, kernel=kernel, reads_per_s=rate,
                          equiv_dense_tops=2.0 * macs * rate / 1e12,
                          times_s=dict(zip(("b65536", "b131072"), times)))
        log(f"[lab] {label:24s} {kernel:13s} {rate:14.1f} reads/s (slope, B 65,536 -> "
            f"131,072)  {per[label]['equiv_dense_tops']:6.2f} TOPS of equiv. dense "
            f"MACs  times={['%.4f' % t for t in times]} s ({card})")
    checks = lab.spot_check(variants, codes)
    counts = lk.counts()
    run_s = time.perf_counter() - t0
    for label, res in checks:
        text = " ".join(f"{c}={'OK' if ok else 'MISMATCH'}" for c, ok in res.items())
        log(f"[lab] check {label} against v0_colmerge(512,2048): {text} ({card})")
        if not all(res.values()):
            raise AssertionError(f"lab spot check {label}: {res}")
    if len(checks) != sum(lab_.startswith(("v3", "v5", "v6")) for lab_ in variants):
        raise AssertionError("the lab spot check skipped a variant")
    for kname in LAB_KERNEL_NAMES:
        launches, plain = counts[kname]
        if launches < 1 or plain:
            raise AssertionError(f"lab path: {kname} {launches} launches, {plain} plain calls")
    log(f"[lab] the lab's run took {run_s:.1f} s; counts (launches, plain calls) {counts}")

    # each variant against its plain version: on the first timed rows of each
    # of the rate slope's batch sizes (the largest grids and partials the run
    # launched), and on a ragged B of the spot check's reads
    slope_rows = [torch.from_numpy(rows[0]) for rows in lab.rate_inputs(codes, lab.BATCHES["cuda"])]
    spot = torch.from_numpy(lab.pack_bit2(lab.spot_rows(codes, LAB_B)))
    cases = [*reversed(slope_rows), spot[:LAB_B - 512]]
    obs = spot.cuda()
    max_err = {kname: 0 for kname in LAB_KERNEL_NAMES}
    for label, (go, table) in variants.items():
        row = per[label]
        for rows in cases:
            o = rows.cuda()
            got = go(o, table)
            want = go.plain(o, table)
            torch.cuda.synchronize()
            err = compare(label, got, want, f"K={LAB_K} L={LAB_L} B={len(o)}", go.fields)
            if row["kernel"] in max_err:
                max_err[row["kernel"]] = max(max_err[row["kernel"]], err)
            del o, got, want
        row["ms"] = cuda_median_ms(lambda: go(obs, table), 5)
        row["plain_ms"] = cuda_median_ms(lambda: go.plain(obs, table), 1)
        # the lab's pad columns count: K_counted is the padded K
        k_counted = go.params.k_padded if go.params else LAB_K
        row["bound_ms"], row["bound_by"] = top2_bound(
            k_counted, 4 * LAB_L, LAB_B, obs.shape[1], table.numel() * table.element_size()
        )
        streams = ""
        if go.name in lk.STREAM_BYTES:
            # a model from the card's sheet, for this line only: it is not
            # kept in `row`, whose numbers are this run's measurements
            per_pair = lk.STREAM_BYTES[go.name]
            stream_ms = stream_bound(
                LAB_B * k_counted, per_pair, lk.mma_depth(LAB_L), sms, clock_hz)
            streams = (f"; streams {per_pair} B per pair, shared-memory "
                       f"bound {stream_ms:.4f} ms at {sms} SMs x "
                       f"{clock_hz / 1e6:.0f} MHz "
                       f"({100 * stream_ms / row['ms']:.1f}% reached)")
        log(f"[lab] {label:24s} K={LAB_K} L={LAB_L} B={LAB_B}: kernel {row['ms']:.4f} ms "
            f"(median of 5), plain {row['plain_ms']:.4f} ms (one call after a warm one); "
            f"bound {row['bound_ms']:.4f} ms by {row['bound_by']} "
            f"({100 * row['bound_ms'] / row['ms']:.1f}% reached){streams}; "
            f"bit-identical at B {', '.join(str(len(c)) for c in cases)} ({card})")
    lib_cols = (1 << 28) // LAB_B // 128 * 128
    library_ms = int_mm_counts_ms(obs, LAB_L, lib_cols) * (LAB_K / lib_cols)
    log(f"[lab] torch._int_mm, counts only, K={LAB_K} B={LAB_B} (one chunk of {lib_cols} "
        f"columns, scaled to K): {library_ms:.4f} ms ({card})")
    del variants, obs
    torch.cuda.empty_cache()
    return dict(counts=counts, per=per, max_abs_err=max_err, library_ms=library_ms)


# --------------------------------------------------------------------------
# phase 7: measured placement and the caches
# --------------------------------------------------------------------------

#: (K, L, min distance, seed) of the placement probes: the phase-4
#: whitelist (seed 11, as make_run draws it) and a mid-K one
PLACEMENT_SHAPES = [(N_SAMPLES, BC1 + BC2, 5, 11), (8192, 16, 3, 8192)]


def device_window_parts(dm, cfg, es) -> dict:
    """What the probe's device window spends where, on random bit2 windows
    of its shape (min of 2 after a warm call, host clock): the same device
    matcher without the window dedup (``FQTK_DEVICE_DEDUP=0``), and the
    dedup's unique-row check (``np.unique`` over the row keys) alone."""
    import os

    from fqtk_tpu_torch.ops.device_encoding import pack_bit2

    os.environ["FQTK_DEVICE_DEDUP"] = "0"
    try:
        bare, _, _ = dm._build_device_side(cfg, es)
    finally:
        del os.environ["FQTK_DEVICE_DEDUP"]
    rng = np.random.default_rng(0xF0CC)
    windows = [pack_bit2(ACGT[rng.integers(0, 4, size=(cfg.batch_size, es.length))])
               for _ in range(3)]
    no_dedup_ms = dm._time_device_window(bare, windows) * 1e3
    best = None
    for w in windows:
        full = np.zeros((len(w), 8), dtype=np.uint8)
        full[:, :w.shape[1]] = w
        t0 = time.perf_counter()
        np.unique(full.view(np.uint64).reshape(-1), return_index=True, return_inverse=True)
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return dict(no_dedup_ms=no_dedup_ms, unique_ms=best * 1e3)


def phase_placement(card: str, dr: dict, work: Path) -> dict:
    """The measured placement on the card at :data:`PLACEMENT_SHAPES`
    (``_build_device_assign_fn`` with ``--matcher auto``, a fresh disk cache
    under ``work``), then the phase-4 dataset twice in this process with
    ``--matcher auto``: the first run reads the disk decision (no probe),
    the second hits ``_ASSIGN_FN_CACHE`` (no build), both byte-identical to
    phase 4's ``--matcher host`` run, each reporting its own launches."""
    import os

    from fqtk_tpu_torch.ops.matcher import ExpectedSet
    from fqtk_tpu_torch.runtime import demux as dm

    if work.exists():
        shutil.rmtree(work)
    work.mkdir(parents=True)
    # a decision from an earlier run on this host must not decide
    os.environ["FQTK_CACHE_DIR"] = str(work / "cache")
    for var in ("FQTK_HOST_MATCHER_MAX_K", "FQTK_MEASURE_CROSSOVER", "FQTK_DEVICE_DEDUP"):
        os.environ.pop(var, None)
    dm._ASSIGN_FN_CACHE.clear()
    placements = []
    for k, length, min_dist, seed in PLACEMENT_SHAPES:
        barcodes = make_whitelist(np.random.default_rng(seed), k, length, min_dist)
        es = ExpectedSet.from_barcodes(barcodes)
        cfg = dm.DemuxConfig(inputs=[], read_structures=[], sample_metadata=work / "none",
                             output=work, device="cuda")
        t0 = time.perf_counter()
        assign, pack_mode, host = dm._build_device_assign_fn(cfg, es, barcodes)
        probe_s = time.perf_counter() - t0
        info = getattr(assign, "crossover", None)
        if info is None or "crossover_floor_s" not in info:
            raise AssertionError(f"K={k}: the placement was not measured ({pack_mode})")
        choice = "device" if info["crossover_device_chosen"] else "host"
        if (choice == "host") != bool(host):
            raise AssertionError(f"K={k}: choice {choice} but host_matcher={host}")
        row = dict(k=k, length=length, batch=cfg.batch_size, choice=choice,
                   host_ms=info["crossover_host_s"] * 1e3,
                   floor_ms=info["crossover_floor_s"] * 1e3,
                   device_ms=info.get("crossover_device_s", float("nan")) * 1e3,
                   probe_s=probe_s, **device_window_parts(dm, cfg, es))
        placements.append(row)
        log(f"[placement] K={k} L={length}, {cfg.batch_size}-read window: host "
            f"{row['host_ms']:.3f} ms, device floor {row['floor_ms']:.3f} ms, device "
            f"{row['device_ms']:.3f} ms -> {choice} ({card}); probe {probe_s:.2f} s. "
            f"Parts of the device window: without the dedup's unique-row check "
            f"{row['no_dedup_ms']:.3f} ms, the check's np.unique alone "
            f"{row['unique_ms']:.3f} ms")
        del assign

    # the phase-4 dataset twice, --matcher auto, in this process
    builds, probes = [], []
    real_build, real_host = dm._build_device_assign_fn, dm._time_host_window
    dm._build_device_assign_fn = lambda *a, **k: builds.append(1) or real_build(*a, **k)
    dm._time_host_window = lambda *a, **k: probes.append(1) or real_host(*a, **k)
    runs = []
    try:
        for run in (1, 2):
            out = work / f"auto{run}"
            t0 = time.perf_counter()
            res = dm.run_demux(dm.DemuxConfig(
                inputs=dr["paths"], read_structures=STRUCTURES, sample_metadata=dr["meta"],
                output=out, device="cuda"))
            wall = time.perf_counter() - t0
            names = sorted(p.name for p in out.glob("*.fq.gz"))
            if names != sorted(p.name for p in dr["host_out"].glob("*.fq.gz")):
                raise AssertionError(f"auto run {run}: output file set differs")
            for name in names:
                same_decompressed(out / name, dr["host_out"] / name)
            if (out / "demux-metrics.txt").read_bytes() != (
                    dr["host_out"] / "demux-metrics.txt").read_bytes():
                raise AssertionError(f"auto run {run}: demux-metrics.txt differs")
            runs.append(dict(builds=len(builds), probes=len(probes), matcher=res.matcher,
                             crossover={k_: v for k_, v in res.timings.items()
                                        if k_.startswith("crossover_")},
                             pipeline_s=res.timings["pipeline"], wall_s=wall))
            shutil.rmtree(out)
    finally:
        dm._build_device_assign_fn, dm._time_host_window = real_build, real_host
    first, second = runs
    if (first["builds"], second["builds"]) != (1, 1) or second["probes"]:
        raise AssertionError(f"auto runs: builds {first['builds']}, {second['builds']}; "
                             f"probes {second['probes']} (want 1, 1; 0)")
    if first["matcher"] != second["matcher"]:
        raise AssertionError(f"per-run counts differ: {first['matcher']} {second['matcher']}")
    if first["crossover"]["crossover_device_chosen"] != (placements[0]["choice"] == "device"):
        raise AssertionError(f"auto run took {first['crossover']}, probe {placements[0]}")
    if placements[0]["choice"] == "device" and first["matcher"].get("colmerge_top2_launches", 0) < 1:
        raise AssertionError(f"auto run on the device launched nothing: {first['matcher']}")
    log(f"[placement] {N_READS}-read 96-sample demux, --matcher auto, twice in one process: "
        f"{placements[0]['choice']} from the disk decision (0 probes), 1 matcher build "
        f"(the second run hit _ASSIGN_FN_CACHE); counts per run {first['matcher'] or '{} (host)'}; "
        f"pipelines {first['pipeline_s']:.3f} / {second['pipeline_s']:.3f} s; both "
        f"byte-identical to --matcher host ({card})")
    shutil.rmtree(work)
    return dict(placements=placements, auto_runs=runs)


# --------------------------------------------------------------------------
# phase 8: the Python-IO engine
# --------------------------------------------------------------------------

PY_READS = 150_000  # one full 131,072-row batch and one partial


def phase_python_engine(card: str, work: Path) -> dict:
    """``--engine pallas``, ``jax`` and ``numpy`` on ``cuda`` over
    :data:`PY_READS` reads of the 96-sample dual-index config, each equal
    to the native run byte for byte; ``pallas`` launches ``colmerge_top2``
    on the 16-class input (counts of this run only) and calls no plain
    version; reads/s per engine (host clock, the run's whole call)."""
    from fqtk_tpu_torch.runtime import demux as dm

    if work.exists():
        shutil.rmtree(work)
    work.mkdir(parents=True)
    paths, meta, expect = make_run(work, PY_READS)
    kw = dict(inputs=paths, read_structures=STRUCTURES, sample_metadata=meta, device="cuda")
    t0 = time.perf_counter()
    dm.run_demux(dm.DemuxConfig(output=work / "native", matcher="host", **kw))
    native_s = time.perf_counter() - t0
    if not np.array_equal(read_templates(work / "native" / "demux-metrics.txt"), expect):
        raise AssertionError("native run: per-sample counts differ from the generator's")
    names = sorted(p.name for p in (work / "native").glob("*.fq.gz"))
    rates = {"native (host matcher)": PY_READS / native_s}
    launches = 0
    for engine in ("pallas", "jax", "numpy"):
        out = work / engine
        t0 = time.perf_counter()
        res = dm.run_demux(dm.DemuxConfig(output=out, engine=engine, **kw))
        wall = time.perf_counter() - t0
        if sorted(p.name for p in out.glob("*.fq.gz")) != names:
            raise AssertionError(f"--engine {engine}: output file set differs")
        size = sum(same_decompressed(out / n, work / "native" / n) for n in names)
        if (out / "demux-metrics.txt").read_bytes() != (
                work / "native" / "demux-metrics.txt").read_bytes():
            raise AssertionError(f"--engine {engine}: demux-metrics.txt differs")
        m = res.matcher
        if engine == "pallas":
            if (m.get("scheme") != "colmerge_top2" or m["colmerge_top2_launches"] < 1
                    or m["plain_calls"] or m["tile_top2_launches"]):
                raise AssertionError(f"--engine pallas counts: {m}")
            launches = m["colmerge_top2_launches"]
        elif engine == "jax" and (m.get("scheme") != "xla_scan" or m["calls"] < 1):
            raise AssertionError(f"--engine jax counts: {m}")
        rates[engine] = PY_READS / wall
        log(f"[python-io] --engine {engine} --device cuda: {PY_READS} reads in {wall:.2f} s = "
            f"{rates[engine]:,.0f} reads/s ({card}); {len(names)} outputs ({size:,} bytes) "
            f"and demux-metrics.txt identical to the native run; matcher {m or '{} (spec)'}")
        shutil.rmtree(out)
    log(f"[python-io] native run (--matcher host) {PY_READS / native_s:,.0f} reads/s, "
        f"whole call ({card})")
    # phase 9 splits the inputs into two lanes and compares with the native run
    return dict(rates=rates, launches=launches, paths=paths, meta=meta,
                native_out=work / "native")


# --------------------------------------------------------------------------
# phase 9: scale-out (the device mesh and two processes)
# --------------------------------------------------------------------------

#: shards of the single-cell whitelist mesh, all on cuda:0 (one card)
SC_SHARDS = 2
#: the two-process run's time limit (the rendezvous included)
RANKS_TIMEOUT_S = 300


def one_card(n: int):
    """``n`` tiles of a mesh, all on ``cuda:0``: the card's host has one GPU."""
    return [torch.device("cuda", 0)] * n


def mesh_window(card: str, sc: dict) -> dict:
    """Phase 5's 131,072-read clustered window through the window dedup and
    a 1 x 2 whitelist mesh on ``cuda:0``: each shard of 3,397,440 barcodes
    launches ``colmerge_top2`` (no ``tile_top2`` launch, no plain call);
    ``assigned`` equal to phase 5's single-device result and to its host
    oracle.  One shard's kernel against its plain version bit for bit at
    B = 16,384 and on the window's bucket, with its times and bound."""
    from fqtk_tpu_torch.ops.device_encoding import pack_bit2
    from fqtk_tpu_torch.parallel import mesh
    from fqtk_tpu_torch.runtime.demux import _Pending, _wrap_window_dedup

    es, codes, window = sc["es"], sc["codes"], sc["window"]
    t0 = time.perf_counter()
    fn = mesh.make_sharded_assign_fn(
        es, 1, 2, mesh.make_demux_mesh(1, SC_SHARDS, devices=one_card(SC_SHARDS)),
        packed2=True, compact_output=True, with_counts=False, use_kernels=True)
    torch.cuda.synchronize()
    if fn.scheme != "colmerge_top2" or fn.k_per_shard != -(-SC_K // SC_SHARDS):
        raise AssertionError(f"whitelist mesh: {fn.scheme}, {fn.k_per_shard} columns a shard")
    shard = fn.tiles[0][0].state
    log(f"[scale-out] whitelist mesh 1 x {SC_SHARDS} on cuda:0: {SC_SHARDS} shards of "
        f"{fn.k_per_shard:,} barcodes built in {time.perf_counter() - t0:.2f} s, scheme "
        f"{fn.scheme} (hopper_scheme of a shard)")

    packed = pack_bit2(ACGT[window])
    sent = []

    def call(rows):
        sent.append(rows)
        return _Pending(fn(rows), keep=rows)

    assign = _wrap_window_dedup(call)
    for kern in fn.kernels.values():
        kern.launches = kern.plain_calls = 0
    t0 = time.perf_counter()
    assigned = assign(packed).fetch().astype(np.int64)
    call_ms = (time.perf_counter() - t0) * 1e3
    counts = {name: (kern.launches, kern.plain_calls) for name, kern in fn.kernels.items()}
    if counts != {"colmerge_top2": (SC_SHARDS, 0), "tile_top2": (0, 0)}:
        raise AssertionError(f"whitelist mesh window: kernel counts {counts}")
    warm_ms = window_call_ms(assign, packed)
    if not np.array_equal(assigned, sc["assigned"]):
        bad = int(np.nonzero(assigned != sc["assigned"])[0][0])
        raise AssertionError(f"mesh window row {bad}: {assigned[bad]}, one device "
                             f"{sc['assigned'][bad]}")
    host = sc["host"]
    if not np.array_equal(assigned[:len(host)], host):
        raise AssertionError(f"mesh window differs from {sc['oracle']}")

    kernel, plain = kernel_runs()["colmerge_top2"]
    rng = np.random.default_rng(9)
    obs = torch.from_numpy(pack_bit2(ACGT[single_cell_reads(rng, codes, SC_KERNEL_B)])).cuda()
    bucket = torch.from_numpy(sent[0]).cuda()
    err = 0
    for o, where in ((obs, f"B={SC_KERNEL_B}"), (bucket, f"B={len(bucket)} (the bucket)")):
        t0 = time.perf_counter()
        want = plain(o, shard)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = max(err, compare("colmerge_top2", kernel(o, shard), want,
                               f"shard 0, K={shard.k} L={SC_L} {where}"))
    ms = cuda_median_ms(lambda: kernel(bucket, shard), 5)
    row = shape_row(shard.k, SC_L, bucket, shard, ms, plain_ms)
    log(f"[scale-out] window of {SC_WINDOW} reads ({SC_CELLS} cells) on the mesh: bucket "
        f"{len(bucket)} rows, {SC_SHARDS} colmerge_top2 launches (one a shard), 0 plain "
        f"calls; call {call_ms:.1f} ms first, {warm_ms:.1f} ms min of 3 more, against "
        f"phase 5's one device {sc['call_ms']:.1f} / {sc['warm_ms']:.1f} ms ({card}); "
        f"assigned equal to phase 5's and to {sc['oracle']}'s")
    log(f"[scale-out] shard 0 K={shard.k} L={SC_L} B={len(bucket)}: colmerge_top2 "
        f"{ms:.4f} ms (median of 5), plain {plain_ms:.1f} ms (one call, host clock), equal "
        f"bit for bit (and at B={SC_KERNEL_B}); bound {row['bound_ms']:.4f} ms by "
        f"{row['bound_by']} ({100 * row['bound_ms'] / ms:.1f}% reached); torch._int_mm, "
        f"counts only, {row['library_ms']:.4f} ms ({card})")
    del fn, shard, obs, bucket
    torch.cuda.empty_cache()
    return dict(launches=SC_SHARDS, shapes=[row], max_abs_err=err, call_ms=call_ms,
                warm_ms=warm_ms)


def mesh_demux(card: str, dr: dict, work: Path) -> dict:
    """Phase 4's dataset through ``run_demux`` in this process with
    ``local_devices`` giving ``[cuda:0] * 2``, ``devices=2`` and ``--matcher
    device``: once as a 2 x 1 batch mesh, once as a 1 x 2 whitelist mesh
    (``PALLAS_K_THRESHOLD`` set low); both byte-identical to phase 4's
    ``--matcher host`` run, each launching ``colmerge_top2`` per tile."""
    from fqtk_tpu_torch.parallel import mesh
    from fqtk_tpu_torch.runtime import demux as dm

    real_local, real_threshold = mesh.local_devices, dm.PALLAS_K_THRESHOLD
    mesh.local_devices = lambda device="cuda": one_card(2)
    runs = {}
    try:
        for layout, threshold in (("batch 2 x 1", real_threshold), ("whitelist 1 x 2", 8)):
            dm.PALLAS_K_THRESHOLD = threshold
            dm._ASSIGN_FN_CACHE.clear()
            out = work / "mesh"
            res = dm.run_demux(dm.DemuxConfig(
                inputs=dr["paths"], read_structures=STRUCTURES, sample_metadata=dr["meta"],
                output=out, devices=2, matcher="device", device="cuda"))
            m = res.matcher
            if m.get("scheme") != "colmerge_top2" or m["colmerge_top2_launches"] < 2 or (
                    m["plain_calls"] or m["tile_top2_launches"]):
                raise AssertionError(f"{layout} mesh demux counts: {m}")
            names = sorted(p.name for p in out.glob("*.fq.gz"))
            if names != sorted(p.name for p in dr["host_out"].glob("*.fq.gz")):
                raise AssertionError(f"{layout} mesh demux: output file set differs")
            size = sum(same_decompressed(out / n, dr["host_out"] / n) for n in names)
            if (out / "demux-metrics.txt").read_bytes() != (
                    dr["host_out"] / "demux-metrics.txt").read_bytes():
                raise AssertionError(f"{layout} mesh demux: demux-metrics.txt differs")
            runs[layout] = dict(matcher=m, pipeline_s=res.timings["pipeline"])
            log(f"[scale-out] {N_READS}-read 96-sample demux, devices=2 over cuda:0 x 2, "
                f"{layout} mesh: {m['colmerge_top2_launches']} colmerge_top2 launches, 0 "
                f"plain calls; pipeline {res.timings['pipeline']:.3f} s; {len(names)} outputs "
                f"({size:,} bytes) and demux-metrics.txt identical to --matcher host ({card})")
            shutil.rmtree(out)
    finally:
        mesh.local_devices, dm.PALLAS_K_THRESHOLD = real_local, real_threshold
        dm._ASSIGN_FN_CACHE.clear()
    shutil.rmtree(work)
    return runs


def split_lanes(paths, work: Path, n_reads: int):
    """Phase 8's inputs as two lanes: the first half of the records in each
    file, then the rest, each lane written as BGZF in its own directory."""
    lanes = [work / "lane0", work / "lane1"]
    for lane in lanes:
        lane.mkdir(parents=True)
    with ThreadPoolExecutor(max_workers=8) as pool:
        for p in paths:
            lines = gzip.decompress(p.read_bytes()).split(b"\n")
            cut = 4 * (n_reads // 2)
            for lane, part in zip(lanes, (lines[:cut], lines[cut:])):
                data = b"\n".join(part)
                write_bgzf(lane / p.name, data if data.endswith(b"\n") else data + b"\n", pool)
    return [[lane / p.name for p in paths] for lane in lanes]


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def two_processes(card: str, py: dict, work: Path) -> dict:
    """Two CLI processes, ``--distributed-coordinator 127.0.0.1:<port>
    --num-processes 2 --process-id i --merge-output``, each on one lane (half
    of phase 8's reads), both matching on ``cuda:0`` with ``--matcher device``:
    the merged outputs and ``demux-metrics.txt`` equal phase 8's
    single-process native run over the whole input; each rank launches
    ``colmerge_top2`` and calls no plain version."""
    import os

    lanes = split_lanes(py["paths"], work, PY_READS)
    out = work / "out"
    port = free_port()
    env = dict(os.environ, FQTK_CACHE_DIR=str(work / "cache"))
    procs, logs = [], [LOGS / f"rank{rank}.log" for rank in range(2)]
    t0 = time.perf_counter()
    try:
        for rank, inputs in enumerate(lanes):
            cmd = [sys.executable, "-m", "fqtk_tpu_torch.cli", "demux",
                   "-i", *map(str, inputs), "-r", *STRUCTURES, "-s", str(py["meta"]),
                   "-o", str(out), "--matcher", "device", "--device", "cuda",
                   "--distributed-coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
                   "--process-id", str(rank), "--merge-output"]
            with open(logs[rank], "w") as fh:
                procs.append(subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=fh,
                                              stderr=subprocess.STDOUT))
        for proc in procs:
            proc.wait(timeout=RANKS_TIMEOUT_S)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - t0
    errs = [path.read_text() for path in logs]
    for rank, (proc, err) in enumerate(zip(procs, errs)):
        if proc.returncode != 0:
            raise RuntimeError(f"rank {rank} exited {proc.returncode}:\n{err[-4000:]}")
    launches = []
    for rank, err in enumerate(errs):
        m = re.search(r"colmerge_top2: (\d+) kernel launches, (\d+) plain-version calls", err)
        if m is None or int(m.group(1)) < 1 or int(m.group(2)):
            raise AssertionError(f"rank {rank}: no colmerge_top2 launch or a plain call")
        launches.append(int(m.group(1)))
    native = py["native_out"]
    names = sorted(p.name for p in native.glob("*.fq.gz"))
    if sorted(p.name for p in out.glob("*.fq.gz")) != names:
        raise AssertionError("the merged output file set differs from the single run's")
    size = sum(same_decompressed(out / n, native / n) for n in names)
    if (out / "demux-metrics.txt").read_bytes() != (native / "demux-metrics.txt").read_bytes():
        raise AssertionError("the merged demux-metrics.txt differs from the single run's")
    log(f"[scale-out] two CLI processes (gloo at 127.0.0.1:{port}), {PY_READS // 2} reads "
        f"each, both on cuda:0: colmerge_top2 launches {launches}, 0 plain calls; merged "
        f"{len(names)} outputs ({size:,} bytes) and demux-metrics.txt identical to the "
        f"single-process run over the whole input; wall {wall:.2f} s ({card})")
    return dict(launches=launches, wall_s=wall)


# --------------------------------------------------------------------------
# phase 10: the driver entry points and the benchmark harness
# --------------------------------------------------------------------------

#: the harness's run lengths here: only read counts and trials are cut (its
#: whitelists and kernel shapes stay whole: K 96 / 8,192 / 737,280, B 2^17
#: to 2^22)
BENCH_CUT = dict(n_reads=1_000_000, n_reads_secondary=500_000, headline_trials=1,
                 secondary_trials=1, subsample_trials=1)
#: (K, L, B) of the harness's 737K device leg held to the plain version here
#: (its smaller rate batch)
BIGK_LEG_SHAPE = (737_280, 16, 1 << 17)


def check_colmerge_only(what: str, counts: dict) -> int:
    """``counts`` (``scheme``, ``launches``, ``plain_calls``) of a matcher
    that must have launched ``colmerge_top2`` and called no plain version;
    returns its launches."""
    if counts.get("scheme") != "colmerge_top2" or counts.get("launches", 0) < 1 or (
            counts.get("plain_calls")):
        raise AssertionError(f"{what}: no colmerge_top2 launch or a plain call: {counts}")
    return int(counts["launches"])


def phase_entry_points(card: str, work: Path) -> dict:
    """``graft_entry.entry()`` on the card (its ``(assigned, best, next)``
    equal to the same step on the CPU, ``assigned`` to the NumPy spec), then
    ``dryrun_multichip(1)`` and ``dryrun_multichip(2, [cuda:0] * 2)`` (a
    1 x 2 whitelist mesh on the one card): every sharded step launches
    ``colmerge_top2`` and calls no plain version.  ``FQTK_CACHE_DIR`` is
    set to a fresh ``work / "cache"`` for this phase and the next."""
    import os

    from fqtk_tpu_torch import graft_entry
    from fqtk_tpu_torch.ops.matcher import ExpectedSet, assign_batch_np
    from fqtk_tpu_torch.runtime import demux as dm

    if work.exists():
        shutil.rmtree(work)
    work.mkdir(parents=True)
    os.environ["FQTK_CACHE_DIR"] = str(work / "cache")
    dm._ASSIGN_FN_CACHE.clear()
    t0 = time.perf_counter()
    fn, (obs,) = graft_entry.entry()
    got = [o.cpu().numpy().astype(np.int64) for o in fn(obs)]
    cpu_fn, _ = graft_entry.entry(device="cpu")
    want = [o.numpy().astype(np.int64) for o in cpu_fn(obs)]
    es = ExpectedSet.from_barcodes(graft_entry._whitelist(96, 17))
    idx, _, _ = assign_batch_np(obs, es, 1, 2)
    if got[0].shape != (8192,) or not np.array_equal(got[0], np.where(idx < 0, 96, idx)):
        raise AssertionError("entry(): assigned differs from the NumPy spec")
    for field, g, w in zip(("assigned", "best", "next"), got, want):
        if not np.array_equal(g, w):
            raise AssertionError(f"entry(): {field} on the card differs from the CPU run")
    log(f"[entry] entry() on cuda: K 96, L 17, B 8,192 raw-byte rows through make_assign_fn "
        f"(plain PyTorch, no kernel): {int((got[0] < 96).sum())} assigned, equal to the NumPy "
        f"spec and (assigned, best, next) to the CPU run; {time.perf_counter() - t0:.1f} s "
        f"({card})")
    runs = {}
    for n, devices in ((1, None), (2, one_card(2))):
        t0 = time.perf_counter()
        counts = graft_entry.dryrun_multichip(n, devices=devices)
        wall = time.perf_counter() - t0
        launched = {step: check_colmerge_only(f"dryrun_multichip({n}) {step}", counts[step])
                    for step in ("small_k", "bigk_sharded", "bigk_sharded_kernels")}
        if n > 1:
            launched["driver"] = check_colmerge_only(f"dryrun_multichip({n}) driver",
                                                     counts["driver"])
        runs[n] = dict(launches=launched, wall_s=wall, driver=counts["driver"])
        log(f"[entry] dryrun_multichip({n}{'' if devices is None else ', [cuda:0] * 2'}): "
            f"colmerge_top2 launches per step {launched}, 0 plain calls; the driver's "
            f"matcher {counts['driver'] or 'on the host (placement)'}, the pigeonhole "
            f"driver on the host; {wall:.1f} s ({card})")
    return runs


def phase_bench(card: str, work: Path) -> dict:
    """``python -m fqtk_tpu_torch.bench``'s ``main`` in this process at the
    run lengths of :data:`BENCH_CUT` (its two JSON lines go to stderr, its
    record under ``work``, removed after it): exit 0 (no config recorded an
    error, every e2e run's ``total_templates`` held), and the mid-K leg and
    the 737K device leg each launched ``colmerge_top2`` and called no plain
    version.  Then ``colmerge_top2`` against its plain version at
    :data:`BIGK_LEG_SHAPE`, with its times and bound."""
    import contextlib

    from fqtk_tpu_torch import bench
    from fqtk_tpu_torch.ops.hopper_matcher import hopper_state_from_numpy

    record = work / "bench_torch.json"
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        rc = bench.main(record_path=record, **BENCH_CUT)
    wall = time.perf_counter() - t0
    full = json.loads(record.read_text())
    if rc != 0:
        raise AssertionError(f"the harness exited {rc}: {bench.failed_configs(full)}")
    by_name = {c["name"]: c for c in full["configs"]}
    midk = check_colmerge_only("mid_K_8192_16bp_mm1_d2", by_name["mid_K_8192_16bp_mm1_d2"])
    bigk = check_colmerge_only("single_cell_737K_whitelist_16B.device_pallas",
                               by_name["single_cell_737K_whitelist_16B"]["device_pallas"])
    kd = full["kernel_device"]
    log(f"[bench] harness at {BENCH_CUT}: {wall:.1f} s, exit {rc}; headline "
        f"{full['value']} reads/s (vs_baseline {full['vs_baseline']}); kernel K 96 "
        f"{full['kernel_assign_reads_per_sec']} reads/s, device-only "
        f"{kd['device_only_reads_per_sec']}, MFU {kd['device_mfu']} of {kd['matmul_precision']} "
        f"({kd['wall_s']} s) ({card})")
    for c in full["configs"]:
        nums = {k: v for k, v in c.items() if k not in ("name", "note", "engine", "level")}
        log(f"[bench] {c['name']}: {json.dumps(nums)} ({card})")
    log(f"[bench] colmerge_top2 launches: mid-K leg {midk}, 737K device leg {bigk}, 0 plain "
        "calls")

    # the 737K device leg's kernel against its plain version at its shape
    kernel, plain = kernel_runs()["colmerge_top2"]
    k, length, b = BIGK_LEG_SHAPE
    es, packed = kernel_case(k, length, b, seed=1010)
    obs = torch.from_numpy(packed).cuda()
    state = hopper_state_from_numpy(es, "cuda", "colmerge_top2")
    got = kernel(obs, state)
    t1 = time.perf_counter()
    want = plain(obs, state)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t1) * 1e3
    err = compare("colmerge_top2", got, want, f"K={k} L={length} B={b} (the 737K leg)")
    ms = cuda_median_ms(lambda: kernel(obs, state), 5)
    row = shape_row(k, length, obs, state, ms, plain_ms)
    log(f"[bench] K={k} L={length} B={b}: colmerge_top2 {ms:.4f} ms (median of 5), plain "
        f"{plain_ms:.1f} ms (one call, host clock), equal bit for bit; bound "
        f"{row['bound_ms']:.4f} ms by {row['bound_by']} ({100 * row['bound_ms'] / ms:.1f}% "
        f"reached); torch._int_mm, counts only, {row['library_ms']:.4f} ms ({card})")
    del state, obs
    torch.cuda.empty_cache()
    shutil.rmtree(work)
    return dict(wall_s=wall, midk_launches=midk, bigk_launches=bigk, bigk_row=row,
                bigk_err=err, headline=full["value"],
                configs={c["name"]: c.get("wall_s") for c in full["configs"]})


# --------------------------------------------------------------------------
# phase 11: the host measuring tools
# --------------------------------------------------------------------------

#: the tools' cuts here (reads; one trial each)
PROFILE_READS = 500_000
AB_READS = 300_000
CORE_READS = 200_000
SHARD_READS = 200_000
BASELINE_READS = 500_000
#: ab_e2e's arms at mid-K: the device matcher, then the host matcher
AB_ARMS = ["FQTK_HOST_MATCHER_MAX_K=0", "FQTK_HOST_MATCHER_MAX_K=100000"]
#: the JAX round's records at the root, which no tool may write
ROOT_RECORDS = ("BASELINE_MEASURED.json", "CORE_SCALING_LOCAL.json", "SCALING_LOCAL.json")


def root_record_digests() -> dict:
    import hashlib

    return {n: hashlib.sha256((ROOT / n).read_bytes()).hexdigest() for n in ROOT_RECORDS}


def fmt_split(r: dict) -> str:
    return (f"wall {r['wall_s']:.3f} s, {r['reads_per_sec']:,.0f} reads/s; cores*wall "
            f"{r['cores_x_wall']:.2f} = counted_io {r['counted_io_s']:.2f} + uncounted_cpu "
            f"{r['uncounted_cpu_s']:.2f} + idle {r['idle_s']:.2f} core-s")


def phase_tools(card: str, work: Path) -> dict:
    """Every tool of ``fqtk_tpu_torch/scripts/`` in this process on the card
    (their children pinned), at a cut, each record under ``work``:
    ``profile_e2e`` on ``headline`` (both arms; the device arm launches
    ``colmerge_top2`` with no plain call), ``ab_e2e midk`` over
    :data:`AB_ARMS` (the arms' outputs identical; the device arm launches
    ``colmerge_top2``, the host arm runs no device matcher),
    ``core_scaling`` on 1 and all cores, ``scaling_bench`` (rank 0's shard-0
    outputs equal the solo run's, the merged counts the shards' sum) and
    ``measure_baseline``.  The root records of :data:`ROOT_RECORDS` keep
    their SHA-256.  ``FQTK_CACHE_DIR`` is a fresh ``work / "cache"``."""
    import contextlib
    import os

    from fqtk_tpu_torch.scripts import (
        ab_e2e,
        core_scaling,
        measure_baseline,
        profile_e2e,
        scaling_bench,
    )

    before = root_record_digests()
    if work.exists():
        shutil.rmtree(work)
    work.mkdir(parents=True)
    os.environ["FQTK_CACHE_DIR"] = str(work / "cache")
    for var in ("FQTK_HOST_MATCHER_MAX_K", "FQTK_MEASURE_CROSSOVER"):
        os.environ.pop(var, None)
    walls = {}
    with contextlib.redirect_stdout(sys.stderr):
        t0 = time.perf_counter()
        prof = profile_e2e.run("headline", PROFILE_READS, "cuda", trials=1,
                               record_path=work / "profile_e2e_headline.json")
        walls["profile_e2e"] = time.perf_counter() - t0
        dev = next(r for r in prof["runs"] if r["arm"] == "device")
        prof_launches = check_colmerge_only("profile_e2e device arm", dev["matcher"])
        for r in prof["runs"]:
            log(f"[tools] profile_e2e headline {PROFILE_READS:,} reads [{r['arm']}]: "
                f"{fmt_split(r)}; matcher {r['matcher'] or 'host'} ({card})")

        t0 = time.perf_counter()
        n_saved = ab_e2e.N
        ab_e2e.N = AB_READS
        try:
            ab = ab_e2e.run("midk", 1, AB_ARMS, "cuda", record_path=work / "ab_e2e_midk.json")
        finally:
            ab_e2e.N = n_saved
        walls["ab_e2e"] = time.perf_counter() - t0
        dev_arm, host_arm = (ab["arms"][a] for a in AB_ARMS)
        ab_launches = check_colmerge_only("ab_e2e midk device arm", dev_arm["matcher"])
        if host_arm["matcher"]:
            raise AssertionError(f"ab_e2e midk host arm ran a device matcher: {host_arm}")
        if dev_arm["outputs_sha256"] != host_arm["outputs_sha256"]:
            raise AssertionError("ab_e2e midk: the arms' outputs differ")
        log(f"[tools] ab_e2e midk {AB_READS:,} reads: device arm "
            f"{dev_arm['best_reads_per_sec']:,.0f} reads/s ({ab_launches} colmerge_top2 "
            f"launches, 0 plain), host arm {host_arm['best_reads_per_sec']:,.0f}; outputs "
            f"and demux-metrics.txt identical ({card})")

        t0 = time.perf_counter()
        ncores = len(os.sched_getaffinity(0))
        cs = core_scaling.run(CORE_READS, 1, cores=[1, ncores], device="cuda",
                              record_path=work / "core_scaling.json")
        walls["core_scaling"] = time.perf_counter() - t0
        log(f"[tools] core_scaling {CORE_READS:,} reads, cores 1 and {ncores}: " + "; ".join(
            f"{k} {cs[k]['reads_per_sec_by_cores']} slope "
            f"{cs[k]['slope_reads_per_sec_per_core']}" for k in core_scaling.KINDS)
            + f"; pins_enforced {cs['pins_enforced']}, cpu/wall {cs['cpu_per_wall_max']} ({card})")

        t0 = time.perf_counter()
        sb = scaling_bench.run(SHARD_READS, "cuda", trials=1, record_path=work / "scaling.json")
        walls["scaling_bench"] = time.perf_counter() - t0
        log(f"[tools] scaling_bench {SHARD_READS:,} reads a shard, pins {sb['pins']}: "
            f"coordination_efficiency {sb['coordination_efficiency']}, samebox "
            f"{sb['samebox_2proc_vs_1proc_throughput']}, pins_enforced {sb['pins_enforced']} "
            f"(cpu/wall {sb['cpu_per_wall_max_half']}); rank 0's shard 0 equal to the solo "
            f"run, merged counts the shards' sum ({card})")

        t0 = time.perf_counter()
        mb = measure_baseline.run(threads=16, reads=BASELINE_READS, trials=1, device="cuda",
                                  record_path=work / "baseline_measured.json")
        walls["measure_baseline"] = time.perf_counter() - t0
        log(f"[tools] measure_baseline {BASELINE_READS:,} reads: {mb['value']:,} reads/s "
            f"({mb['host']})")
    after = root_record_digests()
    if after != before:
        raise AssertionError(f"a tool changed a root record: {before} -> {after}")
    log(f"[tools] walls {json.dumps({k: round(v, 1) for k, v in walls.items()})}; "
        f"{', '.join(ROOT_RECORDS)} unchanged")
    return dict(walls=walls, profile_launches=prof_launches, ab_launches=ab_launches,
                profile=[{k: r[k] for k in ("arm", "reads_per_sec", "uncounted_cpu_s", "idle_s")}
                         for r in prof["runs"]],
                coordination_efficiency=sb["coordination_efficiency"],
                pins_enforced=cs["pins_enforced"] and sb["pins_enforced"],
                baseline=mb["value"])


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
    t0 = time.perf_counter()
    built = _build.build_kernels()
    log(f"[build] CUDA kernels ready in {time.perf_counter() - t0:.1f} s (one nvcc each, "
        "started together)")
    for kname, info in built.items():
        ptx = ptxas_summary(str(info["log"]))
        log(f"[build] {kname} {'built' if info['built'] else 'reused'} in "
            f"{info['seconds']:.1f} s -> {Path(info['path']).relative_to(ROOT)}: "
            f"{ptx['entries']} kernels, {ptx['regs_min']}-{ptx['regs_max']} registers, "
            f"{ptx['spill_bytes']} spill bytes, {ptx['serialized']} wgmma serialization "
            "warnings")
        if kname in ENGINE_LAB_KERNELS and (ptx["spill_bytes"] or ptx["serialized"]):
            raise AssertionError(f"{kname}: the build spills or serializes wgmma: {ptx}")

    # phase 3: kernels against plain
    t0 = time.perf_counter()
    kr = phase_kernels(card)
    mr = phase_mask_inputs(card)
    long_ms = long_barcode_route(card)
    log(f"[kernels] phase 3 took {time.perf_counter() - t0:.1f} s")

    # phase 4: the 96-sample slice end to end (a fresh CLI process: its counts
    # start at 0)
    t0 = time.perf_counter()
    dr = phase_demux(card, WORK, N_READS, "cuda")
    log(f"[demux] phase 4 took {time.perf_counter() - t0:.1f} s")

    # phase 5: the single-cell whitelist path (counts set to 0 before it)
    t0 = time.perf_counter()
    sc = phase_single_cell(card)
    log(f"[single-cell] phase 5 took {time.perf_counter() - t0:.1f} s")

    # phase 6: the kernel lab (counts set to 0 before it)
    t0 = time.perf_counter()
    lr = phase_lab(card)
    log(f"[lab] phase 6 took {time.perf_counter() - t0:.1f} s")

    # phase 7: measured placement, the disk decision and _ASSIGN_FN_CACHE
    t0 = time.perf_counter()
    pr = phase_placement(card, dr, WORK.parent / "smoke_placement")
    log(f"[placement] phase 7 took {time.perf_counter() - t0:.1f} s")

    # phase 8: the Python-IO engine (a fresh matcher per run: counts from 0)
    t0 = time.perf_counter()
    py = phase_python_engine(card, WORK.parent / "smoke_python_io")
    log(f"[python-io] phase 8 took {time.perf_counter() - t0:.1f} s")

    # phase 9: scale-out on the one card (fresh matchers: counts from 0)
    t0 = time.perf_counter()
    mw = mesh_window(card, sc)
    md = mesh_demux(card, dr, WORK.parent / "smoke_mesh")
    shutil.rmtree(WORK)  # phase 4's inputs and host run
    tp = two_processes(card, py, WORK.parent / "smoke_ranks")
    shutil.rmtree(WORK.parent / "smoke_python_io")
    shutil.rmtree(WORK.parent / "smoke_ranks")
    log(f"[scale-out] phase 9 took {time.perf_counter() - t0:.1f} s")

    # phase 10: the driver entry points and the harness (each dry-run step
    # and each harness leg builds its own matcher: counts from 0)
    t0 = time.perf_counter()
    er = phase_entry_points(card, WORK.parent / "smoke_bench")
    br = phase_bench(card, WORK.parent / "smoke_bench")
    log(f"[bench] phase 10 took {time.perf_counter() - t0:.1f} s")

    # phase 11: the host measuring tools (each run builds its own matcher:
    # counts from 0)
    t0 = time.perf_counter()
    tr = phase_tools(card, WORK.parent / "smoke_tools")
    log(f"[tools] phase 11 took {time.perf_counter() - t0:.1f} s")

    # a module of the JAX package, or jax itself, must not have been loaded
    loaded = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith("jax.") or m == "fqtk_tpu"
                    or m.startswith("fqtk_tpu."))
    if loaded:
        raise AssertionError(f"the port loaded modules of the JAX package: {loaded[:8]}")

    log("[end to end] " + json.dumps({
        "demux_reads_per_s": dr["reads_per_s"], "demux_cli_wall_s": dr["wall_s"],
        "single_cell_window_call_ms": sc["call_ms"], "long_barcode_route_ms": long_ms,
        "placement": pr["placements"], "python_io_reads_per_s": py["rates"],
        "mesh_window_call_ms": mw["call_ms"], "mesh_window_warm_ms": mw["warm_ms"],
        "single_cell_window_warm_ms": sc["warm_ms"],
        "mesh_demux": md, "two_processes": tp, "entry_points": er,
        "bench_wall_s": br["wall_s"], "bench_config_wall_s": br["configs"],
        "bench_headline_reads_per_s": br["headline"], "tools": tr, "card": card}))

    # per kernel: its main-path shape's numbers, launches on its path
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    main_shape = next(
        s for s in kr["shapes"]["colmerge_top2"]
        if (s["k"], s["length"], s["b"]) == MAIN_PATH_SHAPE
    )
    window_shape = sc["shapes"][-1]  # the single-cell window's dedup bucket
    midk_shape = next(  # phase 3's, at the mid-K leg's call shape
        s for s in kr["shapes"]["colmerge_top2"]
        if (s["k"], s["length"], s["b"]) == (8192, 16, 131_072)
    )
    rows = [
        dict(name="colmerge_top2", launches=dr["launches"],
             launches_per="2,000,000-read 96-sample demux",
             max_abs_err=kr["max_abs_err"]["colmerge_top2"],
             **{key: main_shape[key] for key in keys},
             shapes=kr["shapes"]["colmerge_top2"]),
        dict(name="tile_top2", launches=sc["launches"],
             launches_per="131,072-read single-cell window",
             max_abs_err=max(kr["max_abs_err"]["tile_top2"], sc["max_abs_err"]),
             **{key: window_shape[key] for key in keys},
             shapes=kr["shapes"]["tile_top2"] + sc["shapes"]),
        dict(name="colmerge_top2", classes=16, launches=py["launches"],
             launches_per="150,000-read 96-sample demux, --engine pallas (Python-IO engine)",
             max_abs_err=mr["max_abs_err"], **{key: mr["shapes"][0][key] for key in keys},
             shapes=mr["shapes"]),
        dict(name="colmerge_top2", launches=mw["launches"],
             launches_per=f"131,072-read single-cell window on a 1 x {SC_SHARDS} whitelist "
                          "mesh (one launch a shard of 3,397,440 barcodes, both on cuda:0)",
             max_abs_err=mw["max_abs_err"], **{key: mw["shapes"][0][key] for key in keys},
             shapes=mw["shapes"]),
        dict(name="colmerge_top2", launches=br["midk_launches"],
             launches_per="the harness's mid-K leg (mid_K_8192_16bp_mm1_d2: K 8,192, L 16, "
                          "B 2^17, then 2^18 and 2^19 for the rate)",
             max_abs_err=kr["max_abs_err"]["colmerge_top2"],
             **{key: midk_shape[key] for key in keys}, shapes=[midk_shape]),
        dict(name="colmerge_top2", launches=br["bigk_launches"],
             launches_per="the harness's 737K device leg (K 737,280, L 16, B 2^17 and 2^18 "
                          "for the rate, then the clustered windows' dedup buckets)",
             max_abs_err=br["bigk_err"], **{key: br["bigk_row"][key] for key in keys},
             shapes=[br["bigk_row"]]),
        dict(name="colmerge_top2", launches=tr["profile_launches"],
             launches_per=f"profile_e2e headline's device arm ({PROFILE_READS:,} reads, "
                          "FQTK_HOST_MATCHER_MAX_K=0; numbers at phase 3's K 96 shape)",
             max_abs_err=kr["max_abs_err"]["colmerge_top2"],
             **{key: main_shape[key] for key in keys}, shapes=[main_shape]),
        dict(name="colmerge_top2", launches=tr["ab_launches"],
             launches_per=f"ab_e2e midk's device arm ({AB_READS:,} reads, K 8,192, L 16; "
                          "numbers at phase 3's K 8,192 shape)",
             max_abs_err=kr["max_abs_err"]["colmerge_top2"],
             **{key: midk_shape[key] for key in keys}, shapes=[midk_shape]),
        dict(name="tile_top2", classes=16, launches=sc["mask"]["launches"],
             launches_per="phase 5's 16-class call (raw bytes, B 16,384)",
             max_abs_err=sc["mask"]["max_abs_err"],
             **{key: sc["mask"]["shapes"][0][key] for key in keys},
             shapes=sc["mask"]["shapes"]),
    ]
    for kname in LAB_KERNEL_NAMES:
        runs = [r for r in lr["per"].values() if r["kernel"] == kname]
        rows.append(dict(name=kname, launches=lr["counts"][kname][0],
                         launches_per="kernel lab run (every default spec)",
                         max_abs_err=lr["max_abs_err"][kname], ms=runs[0]["ms"],
                         plain_ms=runs[0]["plain_ms"], bound_ms=runs[0]["bound_ms"],
                         bound_by=runs[0]["bound_by"],
                         # counts only, at the lab's shape (every lab kernel's)
                         library_ms=lr["library_ms"],
                         variant=runs[0]["label"], variants=runs))
    print(json.dumps({"kernels": [
        {"name": r["name"], "route": "cuda", "source": KERNELS[r["name"]][0],
         "replaces": KERNELS[r["name"]][1], "classes": r.get("classes", 4),
         **{k: v for k, v in r.items() if k not in ("name", "classes")}}
        for r in rows
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
