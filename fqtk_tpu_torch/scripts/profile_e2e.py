"""Wall/CPU accounting for one e2e demux config on the port, the counterpart
of ``scripts/profile_e2e.py`` (same configs, same input bytes from the same
seeds).  Each run's gap is decomposed as

    cores * wall = counted_io_cpu (parse+gate+route+compress)
                 + uncounted_cpu  (matcher, python driver, engine misc)
                 + idle           (drain bubbles, serialization)

with ``cores`` the CPUs this process may run on.  Each trial runs two arms
in turns: ``as_is`` (the environment as given; at K 96 the measured
placement picks the host matcher) and ``device``
(``FQTK_HOST_MATCHER_MAX_K=0``: the device matcher, ``colmerge_top2`` on the
card), after one untimed run of each arm.  Each run prints its
``DemuxResult.matcher`` counts beside its split;
the decompressed outputs and ``demux-metrics.txt`` of every run must agree.

Run: python -m fqtk_tpu_torch.scripts.profile_e2e [varlen|dualindex|headline|single]
         [n_reads] [--device cuda|cpu]
Record: build/fqtk_tpu_torch/profile_e2e_<config>.json
"""

from __future__ import annotations

import argparse
import os
import resource
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np

from .. import bench
from ..runtime.demux import DemuxConfig, run_demux
from .common import RECORD_DIR, arm_env, host, outputs_digest, write_record

CONFIGS = ("varlen", "dualindex", "headline", "single")
TRIALS = 3
#: arm name -> its variables (``KEY=V[,KEY=V]``)
ARMS = {"as_is": "", "device": "FQTK_HOST_MATCHER_MAX_K=0"}
IO_KEYS = ("native_parse", "native_gate_pack", "native_route", "native_compress")


def make_barcodes(n, length, seed=3):
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    out, seen = [], set()
    while len(out) < n:
        bc = bytes(rng.choice(bases, size=length)).decode()
        if bc not in seen:
            seen.add(bc)
            out.append(bc)
    return out


def _writer(path):
    """A BGZF writer of the native engine (built where the committed binary
    does not load; an unavailable engine raises)."""
    return bench._writers({"x": path})["x"]


def write_input(tmp, barcodes, n_reads, name, var_template):
    rng = np.random.default_rng(13)
    choices = rng.integers(0, len(barcodes), size=n_reads)
    path = tmp / f"{name}.fq.gz"
    tmpl_full = ("ACGT" * 40).encode()
    with _writer(path) as fh:
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
    return path


def write_plain(tmp, seqs, name):
    """One FASTQ of the headline shape: record ``i`` carries ``seqs[i]``."""
    path = tmp / f"{name}.fq.gz"
    n_reads = len(seqs)
    with _writer(path) as fh:
        chunk = 100_000
        for lo in range(0, n_reads, chunk):
            hi = min(lo + chunk, n_reads)
            fh.write(
                b"".join(
                    b"@inst:1:AB:1:2:%d:3 1:N:0:0\n%s\n+\n%s\n"
                    % (i, seqs[i], b"I" * len(seqs[i]))
                    for i in range(lo, hi)
                )
            )
    return path


def build(tmp: Path, config: str, n_reads: int):
    """``(inputs, structures, meta)`` of ``config``, written under ``tmp``."""
    barcodes = make_barcodes(96, 17)
    if config in ("varlen", "dualindex"):
        var, tag = (True, "v") if config == "varlen" else (False, "d")
        i1 = write_input(tmp, [b[:8] for b in barcodes], n_reads, f"{tag}1", var_template=var)
        i2 = write_input(tmp, [b[8:] for b in barcodes], n_reads, f"{tag}2", var_template=var)
        inputs, structures = [i1, i2], ["8B+T", "9B+T"]
    elif config == "headline":
        # the bench headline shape: I1 + R1 + R2 + I2 (8B, 100T, 100T, 9B)
        rng = np.random.default_rng(13)
        choices = rng.integers(0, len(barcodes), size=n_reads)
        tmpl = ("ACGT" * 25).encode()
        i1 = write_plain(tmp, [barcodes[c][:8].encode() for c in choices], "h_i1")
        i2 = write_plain(tmp, [barcodes[c][8:].encode() for c in choices], "h_i2")
        r1 = write_plain(tmp, [tmpl] * n_reads, "h_r1")
        r2 = write_plain(tmp, [tmpl] * n_reads, "h_r2")
        inputs, structures = [i1, r1, r2, i2], ["8B", "100T", "100T", "9B"]
    elif config == "single":
        inputs = [write_input(tmp, barcodes, n_reads, "s1", var_template=False)]
        structures = ["17B+T"]
    else:
        raise ValueError(f"unknown config {config!r}; one of {CONFIGS}")
    meta = tmp / "meta.tsv"
    meta.write_text(
        "sample_id\tbarcode\n"
        + "".join(f"S{i:02d}\t{b}\n" for i, b in enumerate(barcodes))
    )
    return inputs, structures, meta


def split(wall: float, cpu: float, timings: dict, n_reads: int, cores: int) -> dict:
    """One run's ``cores * wall = counted_io + uncounted_cpu + idle``."""
    io_core_s = sum(timings.get(k, 0.0) for k in IO_KEYS)
    budget = cores * wall
    return {
        "wall_s": wall,
        "reads_per_sec": n_reads / wall,
        "cores": cores,
        "cores_x_wall": budget,
        "cpu_s": cpu,
        "counted_io_s": io_core_s,
        "uncounted_cpu_s": cpu - io_core_s,
        "idle_s": budget - cpu,
        "frac_of_ceiling": (n_reads / wall) / (n_reads * cores / io_core_s) if io_core_s > 0
        else None,
        "stages": {k: v for k, v in sorted(timings.items())
                   if k.startswith("native") and not k.endswith("bytes")},
    }


def profile_run(cfg: DemuxConfig, n_reads: int) -> dict:
    """One demux run: its split and its matcher counts."""
    cores = len(os.sched_getaffinity(0))
    r0 = resource.getrusage(resource.RUSAGE_SELF)
    t0 = time.perf_counter()
    res = run_demux(cfg)
    wall = time.perf_counter() - t0
    r1 = resource.getrusage(resource.RUSAGE_SELF)
    if res.total_templates != n_reads:
        raise AssertionError((res.total_templates, n_reads))
    cpu = (r1.ru_utime - r0.ru_utime) + (r1.ru_stime - r0.ru_stime)
    return dict(split(wall, cpu, res.timings, n_reads, cores), matcher=dict(res.matcher))


def run(config: str = "varlen", n_reads: int = 1_000_000, device: str = "cuda",
        trials: int = TRIALS, record_path: Optional[Path] = None) -> dict:
    """Profile ``config`` over ``trials`` x :data:`ARMS` runs in turns,
    print each, write the record (default ``RECORD_DIR /
    profile_e2e_<config>.json``) and return it."""
    machine = host(device)
    runs = []
    with tempfile.TemporaryDirectory() as td:
        tmp = Path(td)
        inputs, structures, meta = build(tmp, config, n_reads)

        def config_to(out):
            return DemuxConfig(inputs=inputs, read_structures=structures, sample_metadata=meta,
                               output=out, engine="auto", device=device)

        # each arm once, untimed: the device's start, the placement probe
        # and the matcher's build are not a run's split
        for arm, env in ARMS.items():
            with arm_env(env):
                run_demux(config_to(tmp / f"warm_{arm}"))
            shutil.rmtree(tmp / f"warm_{arm}")
        for trial in range(trials):
            for arm, env in ARMS.items():
                out = tmp / f"out{trial}_{arm}"
                with arm_env(env):
                    r = profile_run(config_to(out), n_reads)
                r.update(trial=trial, arm=arm, outputs_sha256=outputs_digest(out))
                shutil.rmtree(out)
                runs.append(r)
                frac = r["frac_of_ceiling"]
                print(
                    f"trial {trial} [{arm}]: wall={r['wall_s']:.3f}s "
                    f"rps={r['reads_per_sec']:,.0f} frac_of_ceiling="
                    f"{'?' if frac is None else f'{frac:.3f}'}"
                )
                print(
                    f"  cores*wall={r['cores_x_wall']:.2f} cpu={r['cpu_s']:.2f} "
                    f"counted_io={r['counted_io_s']:.2f} "
                    f"uncounted_cpu={r['uncounted_cpu_s']:.2f} idle={r['idle_s']:.2f}"
                )
                print("  matcher:", r["matcher"] or "host (no device matcher)")
                print("  stages:", {k: round(v, 3) for k, v in r["stages"].items()}, flush=True)
    if len({r["outputs_sha256"] for r in runs}) != 1:
        raise AssertionError("the runs' outputs differ: "
                             f"{[(r['arm'], r['outputs_sha256']) for r in runs]}")
    record = {
        "tool": "profile_e2e", "config": config, "n_reads": n_reads, "trials": trials,
        "device": device, "host": machine, "arms": ARMS,
        "note": "cores*wall = counted_io (thread-CPU of parse, gate/pack, route, compress) "
                "+ uncounted_cpu (process CPU less counted_io) + idle (cores*wall less "
                "process CPU); cores = the CPUs this process may run on",
        "runs": runs,
    }
    write_record(record_path or RECORD_DIR / f"profile_e2e_{config}.json", record)
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("config", nargs="?", default="varlen", choices=CONFIGS)
    ap.add_argument("n_reads", nargs="?", type=int, default=1_000_000)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    run(args.config, args.n_reads, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
