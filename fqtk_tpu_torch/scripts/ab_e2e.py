"""Interleaved A/B of one e2e demux config over env-knob arms on the port,
the counterpart of ``scripts/ab_e2e.py``: picks a config
(single|iupac|dualindex|midk|varlen, the same inputs from the same seeds),
builds its inputs once, warms each arm, then alternates trials across the
arms so a noise phase hits every arm.  Each arm prints its best, median,
``host_speed_of_light`` fraction and its matcher counts (at ``midk`` the
device arm runs ``colmerge_top2``); the decompressed outputs and
``demux-metrics.txt`` of every timed run must agree across arms.

Run: python -m fqtk_tpu_torch.scripts.ab_e2e <config> <trials> KEY=V[,KEY=V] ...
         [--device cuda|cpu]
e.g. python -m fqtk_tpu_torch.scripts.ab_e2e midk 3 FQTK_HOST_MATCHER_MAX_K=0 \
         FQTK_HOST_MATCHER_MAX_K=100000
Record: build/fqtk_tpu_torch/ab_e2e_<config>.json
"""

from __future__ import annotations

import argparse
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from .. import bench
from ..runtime.demux import run_demux
from .common import RECORD_DIR, arm_env, host, outputs_digest, write_record

CONFIGS = ("single", "iupac", "dualindex", "midk", "varlen")
N = 1_000_000
#: reads of each arm's untimed warm run
WARM_READS = 200_000


def build(tmp, config):
    """Returns (inputs, structures, meta, warm_inputs, max_mm, delta)."""
    if config == "single":
        bcs = bench.make_whitelist(16, 17, seed=21)
        meta = bench.write_metadata(tmp, bcs, "meta.tsv")
        p, _ = bench.write_single_end_inputs(tmp, bcs, N, "se")
        w, _ = bench.write_single_end_inputs(tmp, bcs, WARM_READS, "w")
        return [p], ["17B+T"], meta, [w], 0, 2
    if config == "iupac":
        bcs = bench.make_whitelist(16, 17, seed=23)
        bcs = [
            b[:4] + "N" + b[5:10] + "RY"[i % 2] + b[11:]
            for i, b in enumerate(bcs)
        ]
        meta = bench.write_metadata(tmp, bcs, "meta.tsv")
        reads = [b.replace("N", "A").replace("R", "G").replace("Y", "C")
                 for b in bcs]
        p, _ = bench.write_single_end_inputs(tmp, reads, N, "iu")
        w, _ = bench.write_single_end_inputs(tmp, reads, WARM_READS, "w")
        return [p], ["17B+T"], meta, [w], 1, 2
    if config == "dualindex":
        bcs = bench.make_whitelist(bench.K, bench.L, seed=7)
        paths, meta = bench.write_inputs(tmp, bcs, N, "di_")
        wpaths, _ = bench.write_inputs(tmp, bcs, WARM_READS, "w_")
        order = ["i1", "r1", "r2", "i2"]
        return ([paths[n] for n in order], ["8B", "100T", "100T", "9B"],
                meta, [wpaths[n] for n in order], 1, 2)
    if config == "midk":
        # 8,192 16bp samples: the placement picks the device matcher
        # (colmerge_top2 on the card), so this is the e2e leg for device-call
        # A/Bs.  fd preflight: ~8,193 writers.
        rng = np.random.default_rng(11)
        vals = rng.choice(1 << 28, size=8192 + 64, replace=False)[:8192]
        letters = "ACGT"
        bcs = []
        for v in vals:
            v = int(v)
            bcs.append("".join(letters[(v >> (2 * j)) & 3] for j in range(16)))
        meta = bench.write_metadata(tmp, bcs, "meta.tsv")
        p, _ = bench.write_single_end_inputs(tmp, bcs, N, "mk")
        w, _ = bench.write_single_end_inputs(tmp, bcs, WARM_READS, "w")
        return [p], ["16B+T"], meta, [w], 1, 2
    if config == "varlen":
        bcs = bench.make_whitelist(bench.K, bench.L, seed=7)
        meta = bench.write_metadata(tmp, bcs, "meta.tsv")
        v1, _ = bench.write_single_end_inputs(
            tmp, [b[:bench.BC1] for b in bcs], N, "v1", var_template=True)
        v2, _ = bench.write_single_end_inputs(
            tmp, [b[bench.BC1:] for b in bcs], N, "v2", var_template=True)
        w1, _ = bench.write_single_end_inputs(
            tmp, [b[:bench.BC1] for b in bcs], WARM_READS, "w1",
            var_template=True)
        w2, _ = bench.write_single_end_inputs(
            tmp, [b[bench.BC1:] for b in bcs], WARM_READS, "w2",
            var_template=True)
        return [v1, v2], ["8B+T", "9B+T"], meta, [w1, w2], 1, 2
    raise ValueError(f"unknown config {config!r}; one of {CONFIGS}")


def _add_counts(total: dict, counts: dict) -> None:
    for k, v in counts.items():
        total[k] = v if isinstance(v, str) else total.get(k, 0) + v


def run(config: str, trials: int, arms: Sequence[str], device: str = "cuda",
        record_path: Optional[Path] = None) -> dict:
    """Warm each arm, then ``trials`` rounds of every arm in turns; print
    each arm's summary, write the record (default ``RECORD_DIR /
    ab_e2e_<config>.json``) and return it."""
    if not arms:
        raise ValueError("give at least one arm (KEY=V[,KEY=V])")
    machine = host(device)
    arms = list(arms)
    results = {a: [] for a in arms}
    timings = {a: {} for a in arms}
    counts = {a: {} for a in arms}
    digests = {a: [] for a in arms}
    with tempfile.TemporaryDirectory() as td:
        tmp = Path(td)
        inputs, structs, meta, warm, mm, delta = build(tmp, config)
        for i, arm in enumerate(arms):
            with arm_env(arm):
                run_demux(bench._demux_cfg(warm, structs, meta, tmp / f"warm_{i}",
                                           max_mm=mm, delta=delta, device=device))
            shutil.rmtree(tmp / f"warm_{i}")

        for t in range(trials):
            for i, arm in enumerate(arms):
                out = tmp / f"o{i}_{t}"
                with arm_env(arm):
                    t0 = time.perf_counter()
                    res = run_demux(bench._demux_cfg(inputs, structs, meta, out,
                                                     max_mm=mm, delta=delta, device=device))
                    dt = time.perf_counter() - t0
                if res.total_templates != N:
                    raise AssertionError((res.total_templates, N))
                rps = N / dt
                results[arm].append(rps)
                if rps >= max(results[arm]):
                    timings[arm] = {k: round(v, 3) for k, v in res.timings.items()}
                _add_counts(counts[arm], res.matcher)
                digests[arm].append(outputs_digest(out))
                shutil.rmtree(out)
                print(f"trial {t} [{arm}]: {rps/1e6:.3f}M", flush=True)

    summary = {}
    for arm in arms:
        best = max(results[arm])
        sol = bench.host_speed_of_light(best, N, timings[arm])
        med = sorted(results[arm])[len(results[arm]) // 2]
        summary[arm] = dict(best_reads_per_sec=best, median_reads_per_sec=med,
                            reads_per_sec=results[arm], host_speed_of_light=sol,
                            timings_of_best=timings[arm], matcher=counts[arm],
                            outputs_sha256=digests[arm])
        print(
            f"[{arm}] best {best/1e6:.3f}M median {med/1e6:.3f}M "
            f"frac {sol['frac_of_ceiling'] if sol else '?'} "
            f"io_core_s {sol['io_core_seconds'] if sol else '?'} "
            f"matcher {counts[arm] or 'host (no device matcher)'}", flush=True)
    if len({d for a in arms for d in digests[a]}) != 1:
        raise AssertionError(f"the arms' outputs differ: {digests}")
    record = {"tool": "ab_e2e", "config": config, "n_reads": N, "warm_reads": WARM_READS,
              "trials": trials, "device": device, "host": machine, "arms": summary}
    write_record(record_path or RECORD_DIR / f"ab_e2e_{config}.json", record)
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("config", choices=CONFIGS)
    ap.add_argument("trials", type=int)
    ap.add_argument("arms", nargs="+", help="KEY=V[,KEY=V] per arm")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    run(args.config, args.trials, args.arms, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
