"""Deep differential campaign of the port, the counterpart of
``scripts/deep_campaign.py``: randomized scenarios, each run through two
implementations of the port that must agree, with the Hopper kernels
(``colmerge_top2``, ``tile_top2``) in every device-placed case.

Five legs, in the original's order:

1. demux: the native engine (C++ I/O and the placed matcher) against
   ``engine="numpy"`` (Python I/O, the NumPy spec): outcome, error text,
   skip counts and every decompressed output over the union of both
   listings, on :mod:`.fuzz_scenarios`' randomized scenarios (structures,
   IUPAC whitelists, wildcard and no-call bytes, short and clustered
   reads, batch 5 / 64 / 131,072).  A third force the big-K pigeonhole
   matcher (``PALLAS_K_THRESHOLD`` 1); a quarter of the others force the
   measured placement to the device side, so the Hopper matcher runs
   behind the window dedup through the whole loop; the rest are forced to
   the host side (the placement probe never measures, and its decision
   file lives in the scenario's directory).  ``FQTK_DEVICE_DEDUP`` rotates
   on and off.
2. matcher: ``NativeSmallKMatcher`` and ``NativeBigKMatcher`` against the
   NumPy spec ``assign_batch_np`` over random (K, L, mm, delta, alphabet)
   with wildcard and no-call storms; then the Hopper matcher, built once
   per kernel on the case's whitelist (``hopper_state_from_numpy(...,
   scheme=...)`` and ``HopperAssignFn``), on the rows' raw bytes (16
   classes) and on the rows that are pure ACGT as bit2 (4 classes), held
   to the spec exactly over (assigned, best, next).
3. subsample: native against Python ``run_subsample``: outcome, counts and
   the verbatim kept records.
4. malformed: 8 corruption classes; both demux engines reach the same
   outcome kind, and for the scanner's own classes the same contract
   phrase.
5. dedup: ``_wrap_window_dedup(call)`` against ``call`` over window sizes,
   packed widths and duplication; every fourth case's call is the Hopper
   matcher on bit2 rows (the demux path's call, ``_Pending`` and all),
   whose unwrapped result is also held to the NumPy spec.

Every leg fails when nothing ran in it, and reports each kernel's launches
and plain calls.  On ``cuda`` a plain call, or a device-placed leg that
launched no kernel, is a failure; ``--device cpu`` runs the kernels' plain
versions (there is no fallback from ``cuda``: without a card it raises).
Engine errors are caught only to be compared.

Usage: python -m fqtk_tpu_torch.scripts.deep_campaign [n_demux] [n_matcher]
       [n_subsample] [n_malformed] [n_dedup] [seed_offset] [--device cuda|cpu]

Defaults 150 120 100 64 200; ``seed_offset`` (else ``FQTK_CAMPAIGN_OFFSET``,
else 0) shifts every leg's per-case seed, so a sweep at a new offset sees
fresh scenarios while each class keeps its share.  The first line names
the native library loaded, whether it links libdeflate, and the card with
its power limit; the last is ``deep_campaign: CLEAN`` or ``... N
FAILURES`` (exit 1).
"""

from __future__ import annotations

import argparse
import contextlib
import gzip
import os
import random
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..bench import card_line
from ..core.encoding import ENCODE_LUT
from ..io import native as native_io
from ..ops import hopper_matcher as hm
from ..ops._build import ensure_native_engine
from ..ops.device_encoding import pack_bit2, unpack_bit2
from ..ops.matcher import ExpectedSet, assign_batch_np, resolve_device
from ..runtime import demux as dmx
from ..runtime import subsample as ss
from ..runtime.demux import DemuxConfig, run_demux
from .common import patched_env
from .fuzz_scenarios import _pack, _random_scenario

#: per-leg case counts when none is given (the original's)
DEFAULT_COUNTS = (150, 120, 100, 64, 200)
LEGS = ("demux", "matcher", "subsample", "malformed", "dedup")

Counts = Dict[str, Dict[str, int]]


# --------------------------------------------------------------------------
# what ran: the native library, the kernels' counts
# --------------------------------------------------------------------------


def native_library() -> Dict[str, object]:
    """The host engine's library this process loads (``FQTK_NATIVE_LIB``,
    else the committed ``native/libfqtk_io.so``) and whether it links
    libdeflate: whether loading it mapped a libdeflate into the process
    (Linux ``/proc/self/maps``); call after :func:`ensure_native_engine`."""
    native_io.get_lib()
    path = Path(os.environ.get("FQTK_NATIVE_LIB") or native_io._LIB_PATH)
    return {"path": str(path),
            "libdeflate": "/libdeflate" in Path("/proc/self/maps").read_text()}


def _zero_counts() -> Counts:
    return {k: {"launches": 0, "plain_calls": 0} for k in hm.SCHEMES}


def _add_kernels(counts: Counts, kernels: dict) -> None:
    """Add a matcher's kernel wrappers' counters (``HopperAssignFn.kernels``)."""
    for name, kern in kernels.items():
        counts[name]["launches"] += kern.launches
        counts[name]["plain_calls"] += kern.plain_calls


def _add_run(counts: Counts, matcher: dict) -> None:
    """Add one demux run's counts (``DemuxResult.matcher``)."""
    for name in hm.SCHEMES:
        counts[name]["launches"] += int(matcher.get(f"{name}_launches", 0))
        counts[name]["plain_calls"] += int(matcher.get(f"{name}_plain_calls", 0))


def _fmt_counts(counts: Counts) -> str:
    return ", ".join(f"{k} {v['launches']} launches / {v['plain_calls']} plain calls"
                     for k, v in counts.items())


def _device_failures(leg: str, counts: Counts, device: torch.device,
                     must: Sequence[str]) -> int:
    """Failures of a leg's kernel counts: on ``cuda`` any plain call, or a
    kernel of ``must`` never launched; on the CPU a kernel of ``must``
    whose plain version never ran, or any launch."""
    fails = 0
    for name, c in counts.items():
        if device.type == "cuda":
            bad = c["plain_calls"] > 0 or (name in must and c["launches"] == 0)
        else:
            bad = c["launches"] > 0 or (name in must and c["plain_calls"] == 0)
        if bad:
            print(f"FAIL {leg} leg: {name} on {device.type}: {c['launches']} launches, "
                  f"{c['plain_calls']} plain calls{' (it must run)' if name in must else ''}")
            fails += 1
    return fails


# --------------------------------------------------------------------------
# placement and environment
# --------------------------------------------------------------------------


@contextlib.contextmanager
def forced_placement(tmp: Path, side: str) -> Iterator[None]:
    """Patch the measured-placement probe (``runtime/demux.py``
    ``_probe_allowed``, ``_time_host_window``, ``_device_floor_seconds``,
    ``_time_device_window``) so that ``side`` ("device" or "host") wins
    without measuring, with the decision file under ``tmp``
    (``_CROSSOVER_CACHE_PATH``), never ``$FQTK_CACHE_DIR``; restored on
    exit.  A whitelist the host matcher refuses goes to the device either
    way, as in a real run."""
    names = ("_probe_allowed", "_time_host_window", "_device_floor_seconds",
             "_time_device_window", "_CROSSOVER_CACHE_PATH")
    saved = {n: getattr(dmx, n) for n in names}
    host_s, device_s = (1.0, 1e-6) if side == "device" else (1e-6, 1.0)
    dmx._probe_allowed = lambda device: True
    dmx._time_host_window = lambda matcher, win, reps=2: host_s
    dmx._device_floor_seconds = lambda batch, width, device, reps=2: device_s
    dmx._time_device_window = lambda assign, windows: device_s
    dmx._CROSSOVER_CACHE_PATH = str(tmp / "crossover-torch.json")
    try:
        yield
    finally:
        for n, v in saved.items():
            setattr(dmx, n, v)


@contextlib.contextmanager
def window_rows() -> Iterator[Dict[str, int]]:
    """Count, while the body runs, the rows of the native engine's windows
    (``pipe_acquire``) and of those resolved on the host
    (``pipe_exceptional``: rows that are not pure ACGT, which the engine
    cannot pack as bit2); a device matcher decides the rest."""
    eng = native_io.NativeDemuxEngine
    acquire, exceptional = eng.pipe_acquire, eng.pipe_exceptional
    rows = {"window": 0, "host": 0}

    def counted_acquire(self):
        out = acquire(self)
        rows["window"] += out[0]
        return out

    def counted_exceptional(self, slot):
        idx, raw = exceptional(self, slot)
        rows["host"] += 0 if idx is None else len(idx)
        return idx, raw

    eng.pipe_acquire, eng.pipe_exceptional = counted_acquire, counted_exceptional
    try:
        yield rows
    finally:
        eng.pipe_acquire, eng.pipe_exceptional = acquire, exceptional


def _read_output(path: Path) -> bytes:
    return gzip.open(path, "rb").read() if path.suffix == ".gz" else path.read_bytes()


def _same_dirs(a: Path, b: Path, what: str) -> List[str]:
    """Failure lines for two output directories: a file on one side only, or
    decompressed bytes that differ (over the union of both listings)."""
    out = []
    names = sorted({f.name for f in a.glob("*")} | {g.name for g in b.glob("*")})
    for name in names:
        f, g = a / name, b / name
        if not (f.exists() and g.exists()):
            out.append(f"{what}: {name} only in {(a if f.exists() else b).name}")
        elif _read_output(f) != _read_output(g):
            out.append(f"{what}: {name} differs")
    return out


# --------------------------------------------------------------------------
# 1. demux
# --------------------------------------------------------------------------


def demux_case(sid: int, offset: int, device: str, tmp: Path) -> dict:
    """Scenario ``sid``: both engines into ``tmp / "o_native"`` and
    ``tmp / "o_numpy"`` (left there), compared.  Returns the scenario's
    ``config`` (``DemuxConfig`` fields but output, engine and device),
    classes, ``failures`` (lines), ``ok`` (both engines ran and agree on
    success) and ``matcher`` (the native run's ``DemuxResult.matcher``)."""
    rng = random.Random(31337 + offset + sid)
    info: dict = {}
    inputs, structures, meta = _random_scenario(rng, tmp, sid, info)
    max_mm = rng.choice([0, 1, 2])
    delta = rng.choice([0, 1, 2])
    batch = rng.choice([5, 64, 131072])
    bigk = sid % 3 == 0
    # sid % 4 == 1 are all odd, so the dedup rotation keys on sid // 4
    device_forced = not bigk and sid % 4 == 1
    config = dict(inputs=inputs, read_structures=structures, sample_metadata=meta,
                  output_types=["T", "B", "M", "C"], max_mismatches=max_mm,
                  min_mismatch_delta=delta, skip_reasons=["too-few-bases"], batch_size=batch)
    res = {}
    threshold = dmx.PALLAS_K_THRESHOLD
    with patched_env({"FQTK_DEVICE_DEDUP": "01"[(sid // 4) % 2],
                      "FQTK_HOST_MATCHER_MAX_K": None}), \
            forced_placement(tmp, "device" if device_forced else "host"):
        dmx.PALLAS_K_THRESHOLD = 1 if bigk else threshold
        dmx._ASSIGN_FN_CACHE.clear()
        try:
            # only the native engine runs NativeDemuxEngine: rows counts its windows
            with window_rows() as rows:
                for engine in ("native", "numpy"):
                    try:
                        res[engine] = ("ok", run_demux(DemuxConfig(
                            output=tmp / f"o_{engine}", engine=engine, device=device,
                            **config)))
                    except Exception as e:  # compared, not suppressed
                        res[engine] = ("err", f"{type(e).__name__}: {e}")
        finally:
            # a crashed scenario must not leave the threshold forced
            dmx.PALLAS_K_THRESHOLD = threshold
            dmx._ASSIGN_FN_CACHE.clear()
    out = dict(sid=sid, config=config, bigk=bigk, device_forced=device_forced, **info,
               failures=[], ok=False, matcher={}, window_rows=0, device_rows=0)
    nat, ref = res["native"], res["numpy"]
    if nat[0] == "ok":
        out["matcher"] = nat[1].matcher
        if nat[1].matcher:
            out["window_rows"] = rows["window"]
            out["device_rows"] = rows["window"] - rows["host"]
    if nat[0] != ref[0]:
        out["failures"].append(f"outcome mismatch {res}")
    elif nat[0] == "err":
        if nat[1] != ref[1]:
            out["failures"].append(f"error text {res}")
    elif nat[1].skip_counts != ref[1].skip_counts:
        out["failures"].append("skip counts")
    else:
        out["ok"] = True
        out["failures"] += _same_dirs(tmp / "o_native", tmp / "o_numpy", f"bigk={bigk}")
        if device_forced and not nat[1].matcher:
            out["failures"].append("device placement forced, but no device matcher ran")
    return out


def demux_leg(n: int, offset: int = 0, device: str = "cuda") -> dict:
    dev = resolve_device(device)
    fails = ok = forced = placed = bigk = window = decided = 0
    counts = _zero_counts()
    for sid in range(n):
        with tempfile.TemporaryDirectory() as td:
            case = demux_case(sid, offset, device, Path(td))
        for line in case["failures"]:
            print(f"FAIL demux {sid}: {line}")
        fails += len(case["failures"])
        ok += case["ok"]
        forced += case["device_forced"]
        bigk += case["bigk"]
        placed += bool(case["matcher"])
        window += case["window_rows"]
        decided += case["device_rows"]
        _add_run(counts, case["matcher"])
    if n > 0 and ok == 0:
        print("FAIL demux leg: no scenario completed successfully")
        fails += 1
    fails += _device_failures("demux", counts, dev, ("colmerge_top2",) if forced else ())
    print(f"demux leg: {n} scenarios ({ok} ran ok, {forced} device-placed of which {placed} "
          f"ran the device matcher, deciding {decided} of their {window} window rows (the "
          f"rest are not pure ACGT: the NumPy spec on the host), {bigk} big-K, dedup rotated "
          f"on/off), {fails} failures; {_fmt_counts(counts)}")
    return dict(cases=n, ok=ok, device_placed=forced, device_ran=placed, bigk=bigk,
                window_rows=window, device_rows=decided, failures=fails, counts=counts)


# --------------------------------------------------------------------------
# 2. matcher
# --------------------------------------------------------------------------

#: ACGT bytes by single-base mask (A 1, C 2, G 4, T 8); 0 elsewhere
_BASE_OF_MASK = np.zeros(16, dtype=np.uint8)
_BASE_OF_MASK[[1, 2, 4, 8]] = np.frombuffer(b"ACGT", dtype=np.uint8)


def pure_acgt(obs: np.ndarray) -> np.ndarray:
    """Rows whose every byte is one base (ACGT, acgt, U or u): the rows the
    native engine packs as bit2."""
    return np.isin(ENCODE_LUT[obs], (1, 2, 4, 8)).all(axis=1)


def bit2_rows(obs: np.ndarray) -> np.ndarray:
    """bit2 of :func:`pure_acgt` rows (lower case and U as their base)."""
    return pack_bit2(_BASE_OF_MASK[ENCODE_LUT[obs]])


def matcher_leg(n: int, offset: int = 0, device: str = "cuda") -> dict:
    dev = resolve_device(device)
    fails = compared = 0
    by_form = {"bytes": _zero_counts(), "bit2": _zero_counts()}
    # the Hopper matcher's largest |got - spec| over (assigned, best, next)
    err = {k: {"bytes": 0, "bit2": 0} for k in hm.SCHEMES}
    for case in range(n):
        rng = np.random.default_rng(909000 + offset + case)
        length = int(rng.integers(4, 17))
        # keep K below the unique-string count for short lengths (a draw
        # loop over an exhausted space would never terminate)
        k = min(int(rng.integers(50, 3000)), 4**length // 2)
        max_mm = int(rng.integers(0, 3))
        delta = int(rng.integers(0, 3))
        alpha = ["ACGT", "ACGTN", "ACGTNRYWSKM", "ACGTU."][case % 4]
        seen, bcs = set(), []
        while len(bcs) < k:
            b = "".join(alpha[i] for i in rng.integers(0, len(alpha), size=length))
            if b not in seen:
                seen.add(b)
                bcs.append(b)
        expected = ExpectedSet.from_barcodes(bcs)
        pool_n = int(rng.integers(20, 400))
        rows = []
        weird = np.frombuffer(b"NnRYacgtX-.U", dtype=np.uint8)
        for _ in range(pool_n):
            base = list(bcs[int(rng.integers(0, k))].encode())
            for _ in range(int(rng.integers(0, max_mm + delta + 2))):
                p = int(rng.integers(0, length))
                base[p] = (
                    int(weird[int(rng.integers(0, len(weird)))])
                    if rng.integers(0, 3) == 0
                    else ord("ACGT"[int(rng.integers(0, 4))])
                )
            rows.append(bytes(base))
        pool = np.frombuffer(b"".join(rows), dtype=np.uint8).reshape(pool_n, length)
        obs = pool[rng.integers(0, pool_n, size=4000)]
        want, want_best, want_next = assign_batch_np(obs, expected, max_mm, delta)
        want = np.where(want < 0, k, want).astype(np.int32)
        where = f"mm={max_mm} d={delta} L={length} K={k} alpha={alpha}"
        packed = _pack(obs)
        for cls, name in (
            (native_io.NativeSmallKMatcher, "smallk"),
            (native_io.NativeBigKMatcher, "bigk"),
        ):
            try:
                m = cls(bcs, max_mm, delta, threads=int(rng.integers(1, 5)))
            except native_io.NativeDemuxError:
                continue  # ineligible for this matcher (by design)
            compared += 1
            for lo in range(0, 4000, 1500):  # several batches: warm caches
                got = m.assign(packed[lo : lo + 1500])
                if not np.array_equal(got, want[lo : lo + 1500]):
                    print(f"FAIL matcher {case} {name} {where}")
                    fails += 1
                    break
            m.close()
        # the Hopper matcher, each kernel forced, on both input forms
        spec = np.stack([want, want_best, want_next])
        sel = pure_acgt(obs)
        for scheme in hm.SCHEMES:
            for form, x, w in (("bytes", obs, spec), ("bit2", obs[sel], spec[:, sel])):
                if not len(x):
                    continue
                state = hm.hopper_state_from_numpy(
                    expected, dev, scheme=scheme, classes=4 if form == "bit2" else 16)
                fn = hm.HopperAssignFn(state, max_mm, delta, compact_output=False, form=form)
                got = np.stack([t.cpu().numpy().astype(np.int64)
                                for t in fn(bit2_rows(x) if form == "bit2" else x)])
                _add_kernels(by_form[form], fn.kernels)
                compared += 1
                diff = np.abs(got - w)
                err[scheme][form] = max(err[scheme][form], int(diff.max()))
                if diff.any():
                    what, bad = (int(i[0]) for i in np.nonzero(diff))
                    print(f"FAIL matcher {case} {scheme} {form} {where}: row {bad} "
                          f"{('assigned', 'best', 'next')[what]} got {got[what, bad]} "
                          f"want {w[what, bad]}")
                    fails += 1
    if n > 0 and compared == 0:
        print("FAIL matcher leg: no matcher was compared")
        fails += 1
    counts = _zero_counts()
    for form_counts in by_form.values():
        for name, c in form_counts.items():
            for key, value in c.items():
                counts[name][key] += value
    fails += _device_failures("matcher", counts, dev, hm.SCHEMES if n else ())
    print(f"matcher leg: {n} cases x (2 host matchers + 2 kernels x 2 input forms), "
          f"{compared} comparisons, {fails} failures; {_fmt_counts(counts)}; "
          f"max |kernel - spec| over (assigned, best, next) {err}")
    return dict(cases=n, ok=compared, failures=fails, counts=counts, by_form=by_form,
                max_abs_err=err)


# --------------------------------------------------------------------------
# 3. subsample
# --------------------------------------------------------------------------


def subsample_leg(n: int, offset: int = 0, device: str = "cuda") -> dict:
    """Native against Python ``run_subsample`` (no device work: the device
    is checked, and the kernels' counts are reported as zero)."""
    resolve_device(device)
    fails = 0
    ok_count = 0
    for case in range(n):
        rng = random.Random(77000 + offset + case)
        with tempfile.TemporaryDirectory() as td:
            tmp = Path(td)
            n_in = rng.choice([1, 2, 4])
            n_sets = rng.randint(0, 500)
            frac = rng.choice([0.0, 0.1, 0.37, 0.5, 0.93, 1.0])
            seed = rng.randint(0, 2**62)
            comp = rng.choice([None, "gz"])
            inputs = []
            for i in range(n_in):
                lines = []
                for r in range(n_sets):
                    suffix = rng.choice(["", "/1", "/2"]) if i == 0 else ""
                    comment = rng.choice(["", " some comment", "\textra\ttabs"])
                    sl = rng.randint(0, 40)
                    seq = "".join(rng.choice("ACGTN") for _ in range(sl))
                    lines.append(
                        f"@rec_{r}{suffix}{comment}\n{seq}\n+\n{'J' * sl}\n"
                    )
                p = tmp / (f"in{i}.fq" + (".gz" if comp else ""))
                data = "".join(lines).encode()
                if comp:
                    with gzip.open(p, "wb") as f:
                        f.write(data)
                else:
                    p.write_bytes(data)
                inputs.append(p)
            res = {}
            for engine in ("native", "python"):
                try:
                    r = ss.run_subsample(
                        ss.SubsampleConfig(
                            inputs=inputs,
                            output=tmp / f"o_{engine}",
                            fraction=frac,
                            seed=seed,
                        ),
                        use_native=engine == "native",
                    )
                    res[engine] = ("ok", r.total_read, r.total_kept)
                except Exception as e:  # compared, not suppressed
                    res[engine] = ("err", f"{type(e).__name__}: {e}")
            if res["native"] != res["python"]:
                print(f"FAIL subsample {case}: outcome {res}")
                fails += 1
                continue
            if res["native"][0] == "ok":
                ok_count += 1
                for i in range(1, n_in + 1):
                    a = gzip.open(tmp / f"o_native.R{i}.fq.gz", "rb").read()
                    b = gzip.open(tmp / f"o_python.R{i}.fq.gz", "rb").read()
                    if a != b:
                        print(f"FAIL subsample {case}: R{i} differs")
                        fails += 1
    if n > 0 and ok_count == 0:
        # a systemic failure (e.g. an API drift making both engines raise
        # the same error) must not masquerade as a clean campaign
        print("FAIL subsample leg: no scenario completed successfully")
        fails += 1
    counts = _zero_counts()
    print(f"subsample leg: {n} scenarios ({ok_count} ran ok), {fails} failures; "
          f"{_fmt_counts(counts)}")
    return dict(cases=n, ok=ok_count, failures=fails, counts=counts)


# --------------------------------------------------------------------------
# 4. malformed inputs
# --------------------------------------------------------------------------

CORRUPTIONS = [
    "crlf",           # benign: CR-tolerant scanners, byte-equal outputs
    "no_at",          # header line without '@'
    "no_plus",        # separator line without '+'
    "qual_len",       # quality shorter than sequence
    "truncated",      # EOF mid-record (uncompressed input)
    "gzip_flip",      # bit-flip inside a gzip stream
    "gzip_trunc",     # compressed stream cut short
    "out_of_sync",    # paired inputs with different record counts
]
CONTRACT_PHRASE = {
    "no_at": "FASTQ record header must start with '@'",
    "no_plus": "FASTQ separator line must start with '+'",
    "qual_len": "sequence and quality lengths differ",
    "truncated": "truncated FASTQ record",
    "out_of_sync": "out of sync",
}


def _malformed_inputs(rng: random.Random, tmp: Path, kind: str):
    """``(p1, p2, meta, n_reads)`` of one corrupted paired scenario."""
    n_reads = rng.randint(4, 60)
    bcs = ["GATTACAG", "TTTTCCCC", "AAAAGGGG"]
    meta = tmp / "meta.tsv"
    meta.write_text(
        "sample_id\tbarcode\n" + "".join(f"s{i}\t{b}\n" for i, b in enumerate(bcs))
    )
    eol = b"\r\n" if kind == "crlf" else b"\n"

    def mutate_row_fn(lines):
        if kind == "no_at":
            return [lines[0][1:]] + lines[1:]
        if kind == "no_plus":
            return lines[:2] + [b"*"] + lines[3:]
        if kind == "qual_len":
            return lines[:3] + [lines[3][:-2]]
        return lines

    def fq_bytes(count, mutate_row=None):
        out = bytearray()
        for r in range(count):
            seq = bcs[r % len(bcs)].encode() + b"ACGTACGT"
            lines = [b"@r%d 1:N:0:0" % r, seq, b"+", b"I" * len(seq)]
            if mutate_row is not None and r == mutate_row:
                lines = mutate_row_fn(lines)
            for ln in lines:
                out += ln + eol
        return bytes(out)

    bad_row = rng.randint(0, n_reads - 1)
    mutate = bad_row if kind in ("no_at", "no_plus", "qual_len") else None
    data1 = fq_bytes(n_reads, mutate)
    data2 = fq_bytes(n_reads if kind != "out_of_sync" else n_reads - 2)
    if kind == "truncated":
        # cut mid-record: keep the bad record's header only
        cut = data1.rfind(b"@r%d " % bad_row)
        data1 = data1[: cut + 8]
    p1, p2 = tmp / "in1.fq", tmp / "in2.fq"
    if kind in ("gzip_flip", "gzip_trunc"):
        p1, p2 = tmp / "in1.fq.gz", tmp / "in2.fq.gz"
        z1 = bytearray(gzip.compress(data1))
        if kind == "gzip_flip":
            z1[len(z1) // 2] ^= 0x55
        else:
            z1 = z1[: max(20, len(z1) * 2 // 3)]
        p1.write_bytes(bytes(z1))
        p2.write_bytes(gzip.compress(data2))
    else:
        p1.write_bytes(data1)
        p2.write_bytes(data2)
    return p1, p2, meta, n_reads


def malformed_leg(n: int, offset: int = 0, device: str = "cuda") -> dict:
    """Corrupt a valid scenario one way; both engines must reach the same
    outcome kind: an error for the corruption classes, identical success
    for the benign one (CRLF).  For the scanner's own classes both error
    texts carry the contract phrase; gzip bit-flips and truncated streams
    legitimately give different decoder messages, so there only the kind
    is compared.  The placement is forced to the host, as on the CPU."""
    dev = resolve_device(device)
    fails = 0
    ok_count = 0
    counts = _zero_counts()
    for case in range(n):
        rng = random.Random(555000 + offset + case)
        kind = CORRUPTIONS[case % len(CORRUPTIONS)]
        with tempfile.TemporaryDirectory() as td:
            tmp = Path(td)
            p1, p2, meta, n_reads = _malformed_inputs(rng, tmp, kind)
            res = {}
            with patched_env({"FQTK_HOST_MATCHER_MAX_K": None}), \
                    forced_placement(tmp, "host"):
                dmx._ASSIGN_FN_CACHE.clear()
                for engine in ("native", "numpy"):
                    try:
                        r = run_demux(DemuxConfig(
                            inputs=[p1, p2], read_structures=["8B+T", "+T"],
                            sample_metadata=meta, output=tmp / f"o_{engine}",
                            max_mismatches=1, min_mismatch_delta=2, batch_size=16,
                            engine=engine, device=device))
                        res[engine] = ("ok", r.total_templates)
                        _add_run(counts, r.matcher)
                    except Exception as e:  # compared, not suppressed
                        res[engine] = ("err", f"{type(e).__name__}: {e}")
                dmx._ASSIGN_FN_CACHE.clear()
            if res["native"][0] != res["numpy"][0]:
                print(f"FAIL malformed {case} [{kind}]: outcome mismatch {res}")
                fails += 1
                continue
            if kind == "crlf":
                if res["native"][0] != "ok" or res["native"][1] != n_reads:
                    print(f"FAIL malformed {case} [crlf]: {res}")
                    fails += 1
                    continue
                # the union of both listings: a one-sided file is a divergence
                diff = _same_dirs(tmp / "o_native", tmp / "o_numpy", "crlf")
                for line in diff:
                    print(f"FAIL malformed {case} [{line}]")
                if diff:
                    fails += 1
                    continue
            else:
                if res["native"][0] != "err":
                    print(f"FAIL malformed {case} [{kind}]: both succeeded {res}")
                    fails += 1
                    continue
                phrase = CONTRACT_PHRASE.get(kind)
                if phrase and not (
                    phrase in res["native"][1] and phrase in res["numpy"][1]
                ):
                    print(f"FAIL malformed {case} [{kind}]: contract phrase missing {res}")
                    fails += 1
                    continue
            ok_count += 1
    if n > 0 and ok_count == 0:
        print("FAIL malformed leg: no scenario completed")
        fails += 1
    fails += _device_failures("malformed", counts, dev, ())
    print(f"malformed leg: {n} scenarios ({ok_count} ran ok), {fails} failures; "
          f"{_fmt_counts(counts)}")
    return dict(cases=n, ok=ok_count, failures=fails, counts=counts)


# --------------------------------------------------------------------------
# 5. the window dedup
# --------------------------------------------------------------------------


def _stand_in(obs: np.ndarray) -> dmx._Pending:
    """A deterministic per-row function of the packed row's bytes, as a
    matcher's result: identical rows always score identically."""
    obs = np.asarray(obs, dtype=np.uint8)
    h = obs.astype(np.uint64)
    acc = np.zeros(obs.shape[0], dtype=np.uint64)
    for j in range(obs.shape[1]):
        acc = acc * np.uint64(1099511628211) + h[:, j]
    return dmx._Pending(torch.from_numpy((acc % np.uint64(977)).astype(np.int32)))


_ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


def _bit2_bases(packed: np.ndarray) -> np.ndarray:
    """ACGT bytes of bit2 rows."""
    length = 4 * packed.shape[1]
    return _ACGT[unpack_bit2(torch.from_numpy(np.ascontiguousarray(packed)), length).numpy()]


def _hopper_call(rng: np.random.Generator, pool: np.ndarray, dev: torch.device):
    """The demux path's device call on bit2 rows of ``pool``'s width
    (``make_hopper_assign_fn(packed2=True, compact_output=True)`` behind
    ``_Pending``), on a whitelist of up to 64 of ``pool``'s rows as barcodes
    plus random ones; returns ``(call, matcher, whitelist)``."""
    length = 4 * pool.shape[1]
    bases = _bit2_bases(pool)
    take = rng.permutation(len(pool))[: int(rng.integers(1, 65))]
    barcodes = {bytes(bases[i]).decode() for i in take}
    extra = int(rng.integers(0, 200))
    for row in rng.integers(0, 4, size=(extra, length)):
        barcodes.add(bytes(_ACGT[row]).decode())
    es = ExpectedSet.from_barcodes(sorted(barcodes))
    fn = hm.make_hopper_assign_fn(es, int(rng.integers(0, 3)), int(rng.integers(0, 3)),
                                  device=dev, packed2=True, compact_output=True)

    def call(obs_packed):
        return dmx._Pending(fn(obs_packed)[0], keep=obs_packed)

    return call, fn, es


def _spec_of_bit2(rows: np.ndarray, es: ExpectedSet, fn: hm.HopperAssignFn) -> np.ndarray:
    """``(assigned, best, next)`` of the NumPy spec for bit2 rows, as
    ``fn`` returns them (unmatched is ``K``), in chunks that keep the spec's
    ``[B, K, L]`` temporary small."""
    out = []
    for lo in range(0, len(rows), 2048):
        a, best, nxt = assign_batch_np(_bit2_bases(rows[lo:lo + 2048]), es,
                                       fn.max_mismatches, fn.min_mismatch_delta)
        out.append(np.stack([np.where(a < 0, es.count, a), best, nxt]))
    return np.concatenate(out, axis=1)


def dedup_leg(n: int, offset: int = 0, device: str = "cuda") -> dict:
    """``_wrap_window_dedup(call)`` must be bit-exact against ``call`` for
    any per-row-deterministic matcher, across window sizes, packed widths
    (above 8 bytes it must pass the window through) and duplication
    factors.  Every fourth case's call is the Hopper matcher (widths of at
    most 8 bytes: bit2 barcodes of 4-32 bp), whose unwrapped result is
    also held to the NumPy spec over (assigned, best, next)."""
    dev = resolve_device(device)
    fails = 0
    engaged = 0
    hopper_cases = 0
    schemes = set()
    counts = _zero_counts()
    err = {k: 0 for k in hm.SCHEMES}  # the Hopper call's max |got - spec|
    with patched_env({"FQTK_DEVICE_DEDUP": "1"}):
        for case in range(n):
            rng = np.random.default_rng(424000 + offset + case)
            hopper = case % 4 == 3
            b = int(rng.integers(64, 20000))
            w = int(rng.integers(1, 9 if hopper else 11))  # widths > 8 must bypass
            n_uniq = int(rng.integers(1, max(2, b)))
            pool = rng.integers(0, 256, size=(n_uniq, w), dtype=np.uint8)
            rows = pool[rng.integers(0, n_uniq, size=b)]
            fn = None
            call = _stand_in
            if hopper:
                call, fn, es = _hopper_call(rng, pool, dev)
                hopper_cases += 1
                schemes.add(fn.scheme)
            sizes = []

            def recorded(obs, call=call, sizes=sizes):
                sizes.append(len(obs))
                return call(obs)

            got = np.asarray(dmx._wrap_window_dedup(recorded)(rows).fetch())
            if fn is None:
                want = np.asarray(call(rows).fetch())
            else:
                # the unwrapped call, and its best and next for the spec
                assigned, best, nxt = fn(rows)
                want = dmx._Pending(assigned, keep=rows).fetch()
                diff = np.abs(np.stack([t.cpu().numpy().astype(np.int64)
                                        for t in (assigned, best, nxt)])
                              - _spec_of_bit2(rows, es, fn))
                err[fn.scheme] = max(err[fn.scheme], int(diff.max()))
                if diff.any():
                    print(f"FAIL dedup {case}: b={b} w={w} hopper {fn.scheme} differs "
                          f"from the NumPy spec")
                    fails += 1
                _add_kernels(counts, fn.kernels)
            if not np.array_equal(got, want):
                print(f"FAIL dedup {case}: b={b} w={w} uniq={n_uniq} "
                      f"{'hopper ' + fn.scheme if fn is not None else 'stand-in'}")
                fails += 1
            engaged += sizes != [b]  # the window went to the call shrunk
    if n > 0 and engaged == 0:
        print("FAIL dedup leg: the dedup path never engaged")
        fails += 1
    fails += _device_failures("dedup", counts, dev, sorted(schemes))
    print(f"dedup leg: {n} windows ({engaged} engaged dedup, {hopper_cases} through the "
          f"Hopper matcher), {fails} failures; {_fmt_counts(counts)}; max |Hopper call - "
          f"spec| over (assigned, best, next) {err}")
    return dict(cases=n, ok=engaged, hopper_cases=hopper_cases, failures=fails, counts=counts,
                max_abs_err=err)


# --------------------------------------------------------------------------
# the campaign
# --------------------------------------------------------------------------


def run(n_demux: int = 150, n_matcher: int = 120, n_subsample: int = 100,
        n_malformed: int = 64, n_dedup: int = 200, offset: Optional[int] = None,
        device: str = "cuda") -> dict:
    """Every leg in order on ``device`` (``cuda`` raises without a card);
    ``offset`` defaults to ``FQTK_CAMPAIGN_OFFSET`` (else 0).  Prints each
    leg's lines and the verdict; returns ``{"offset", "device", "card",
    "library", "legs": {leg: {..., "failures", "counts", "wall_s"}},
    "failures", "wall_s"}``."""
    if offset is None:
        offset = int(os.environ.get("FQTK_CAMPAIGN_OFFSET", "0"))
    dev = resolve_device(device)
    t0 = time.perf_counter()
    ensure_native_engine()
    lib = native_library()
    card = card_line() if dev.type == "cuda" else "cpu"
    print(f"deep_campaign: native library {lib['path']} "
          f"({'links' if lib['libdeflate'] else 'does not link'} libdeflate); "
          f"device {dev} ({card}); seed offset {offset}", flush=True)
    legs = {}
    for name, leg, count in zip(LEGS, (demux_leg, matcher_leg, subsample_leg, malformed_leg,
                                       dedup_leg),
                                (n_demux, n_matcher, n_subsample, n_malformed, n_dedup)):
        t = time.perf_counter()
        legs[name] = leg(count, offset, device)
        legs[name]["wall_s"] = round(time.perf_counter() - t, 3)
        sys.stdout.flush()
    fails = sum(r["failures"] for r in legs.values())
    wall = round(time.perf_counter() - t0, 3)
    print(f"deep_campaign: wall {wall} s (" + ", ".join(
        f"{name} {r['wall_s']} s" for name, r in legs.items()) + ")")
    print(f"deep_campaign: {'CLEAN' if fails == 0 else f'{fails} FAILURES'}", flush=True)
    return dict(offset=offset, device=str(dev), card=card, library=lib, legs=legs,
                failures=fails, wall_s=wall)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m fqtk_tpu_torch.scripts.deep_campaign",
        description="Differential campaign of the port (demux, matcher, subsample, "
                    "malformed, dedup legs).")
    p.add_argument("counts", nargs="*", type=int,
                   help="n_demux n_matcher n_subsample n_malformed n_dedup [seed_offset]")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the Hopper kernels run (cpu: their plain versions)")
    args = p.parse_args(argv)
    if len(args.counts) > 6:
        p.error("at most six positional arguments")
    counts = list(args.counts[:5]) + list(DEFAULT_COUNTS[len(args.counts[:5]):])
    offset = args.counts[5] if len(args.counts) > 5 else None
    result = run(*counts, offset=offset, device=args.device)
    return 1 if result["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
