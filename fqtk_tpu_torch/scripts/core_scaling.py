"""Host-core scaling curve on the port, the counterpart of
``scripts/core_scaling.py``: does e2e demux throughput track the host cores
it is given?

It runs the dual-index e2e (``product``: the port's demux, its matcher
placed by the port's rules on ``--device``), the reference-architecture
proxy (``proxy``: the same native scanner and writer forced into the
reference's serial assign loop), and the PE subsample and its serial proxy
(``sub_product``, ``sub_proxy``) in children pinned with ``taskset`` to the
first 1..n CPUs this process may run on, trials interleaved so a noise phase
hits every leg, and reports reads/s, reads/s per core and a least-squares
slope through the origin with its R^2.  One untimed pass of every leg on
all the CPUs first settles the page cache and the placement decision
(``FQTK_CACHE_DIR``), and a ``product`` child starts its device before its
timed run.  Without ``taskset`` it raises: it never runs unpinned.  Each
child also reports its CPU time over its wall time: where that exceeds its
pinned cores the host does not enforce the pin, and the record says so
(``pins_enforced``).

Run:  python -m fqtk_tpu_torch.scripts.core_scaling [n_reads] [trials] [--device cuda|cpu]
Leg:  python -m fqtk_tpu_torch.scripts.core_scaling --leg <kind> <data_dir> <n> [--device ...]
Record: build/fqtk_tpu_torch/core_scaling.json
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

from .common import RECORD_DIR, host, init_device, pin_enforced, write_record

KINDS = ("product", "proxy", "sub_product", "sub_proxy")
_REPO_ROOT = Path(__file__).resolve().parent.parent.parent
#: a pinned child that outlives this is a hang, not a measurement
CHILD_TIMEOUT_S = 3600


def build_inputs(tmp: Path, n: int):
    from .. import bench

    bcs = bench.make_whitelist(bench.K, bench.L, seed=7)
    paths, meta = bench.write_inputs(tmp, bcs, n, "cs_")
    order = ["i1", "r1", "r2", "i2"]
    manifest = {
        "inputs": [str(paths[k]) for k in order],
        "structures": ["8B", "100T", "100T", "9B"],
        "meta": str(meta),
        "barcodes": bcs,
        "n": n,
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    return manifest


def run_leg(kind: str, data_dir: Path, n: int, device: str = "cuda") -> Tuple[float, float]:
    """One measurement (normally in a pinned child): prints and returns
    reads/s and the process's CPU time over the wall time of the leg (above
    the pinned core count only where the pin does not bind).  Only the
    ``product`` and ``proxy`` legs import torch (through the harness)."""
    from ..io import native as native_io
    from ..ops._build import ensure_native_engine

    ensure_native_engine()
    m = json.loads((Path(data_dir) / "manifest.json").read_text())
    if kind == "product":
        init_device(device)
    if kind in ("product", "proxy"):
        from .. import bench
    r0, w0 = resource.getrusage(resource.RUSAGE_SELF), time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        tmp = Path(td)
        if kind == "product":
            rps, _ = bench.run_e2e(
                tmp, m["inputs"], m["structures"], m["meta"], n, "leg",
                trials=1, device=device,
            )
        elif kind == "proxy":
            rps = bench.run_refproxy(
                tmp, m["inputs"], m["structures"], m["barcodes"], n, "leg",
                trials=1, threads=16,
            )
        elif kind == "sub_product":
            from ..runtime.subsample import SubsampleConfig, run_subsample

            cfg = SubsampleConfig(
                inputs=[m["inputs"][1], m["inputs"][2]],
                output=tmp / "sub", fraction=0.3, threads=8, seed=42,
            )
            t0 = time.perf_counter()
            res = run_subsample(cfg, use_native=True)
            rps = res.total_read / (time.perf_counter() - t0)
        elif kind == "sub_proxy":
            # reference shape: serial lockstep loop, native ChaCha mask drawn
            # between chunks (generous to the baseline, as the harness's
            # subsample proxy)
            rng = native_io.NativeChaChaMask(42)
            eng = native_io.NativeSubsampleEngine(threads=7, compression_level=5)
            try:
                for i, p in enumerate(m["inputs"][1:3]):
                    eng.add_input(p, tmp / f"subproxy.R{i + 1}.fq.gz")
                eng.configure(check_names=True, parallel=False)
                t0 = time.perf_counter()
                total = 0
                while True:
                    mask = rng.keep_mask(1 << 16, 0.3)
                    c, _ = eng.process_chunk(mask)
                    total += c
                    if c < len(mask):
                        break
                eng.finish()
            finally:
                eng.close()
            rps = total / (time.perf_counter() - t0)
        else:
            raise ValueError(f"unknown leg {kind!r}; one of {KINDS}")
    r1 = resource.getrusage(resource.RUSAGE_SELF)
    cpu = (r1.ru_utime - r0.ru_utime) + (r1.ru_stime - r0.ru_stime)
    cpu_per_wall = cpu / (time.perf_counter() - w0)
    print(f"RPS {rps:.1f} CPU_PER_WALL {cpu_per_wall:.3f}", flush=True)
    return rps, cpu_per_wall


def pinned_cpus(cores: int) -> str:
    """The first ``cores`` CPUs of this process's affinity, for ``taskset -c``."""
    cpus = sorted(os.sched_getaffinity(0))
    if not 1 <= cores <= len(cpus):
        raise ValueError(f"cores must be 1..{len(cpus)}, got {cores}")
    return ",".join(str(c) for c in cpus[:cores])


def child(kind: str, cores: int, data_dir: Path, n: int, device: str) -> Tuple[float, float]:
    """One leg in a child pinned to :func:`pinned_cpus`: its reads/s and its
    CPU time over wall time."""
    cmd = ["taskset", "-c", pinned_cpus(cores), sys.executable, "-m",
           "fqtk_tpu_torch.scripts.core_scaling", "--leg", kind, str(data_dir), str(n),
           "--device", device]
    out = subprocess.run(cmd, capture_output=True, text=True, cwd=str(_REPO_ROOT),
                         timeout=CHILD_TIMEOUT_S)
    if out.returncode != 0:
        raise RuntimeError(f"leg {kind} on {cores} core(s) exited {out.returncode}:\n"
                           f"{out.stderr[-3000:]}")
    fields = out.stdout.strip().splitlines()[-1].split()
    return float(fields[1]), float(fields[3])


def fit(results: Dict[int, float]) -> dict:
    """reads/s by cores, per core, the least-squares slope through the
    origin and the R^2 of that fit (about the mean)."""
    xs = sorted(results)
    ys = [results[c] for c in xs]
    slope = sum(c * r for c, r in zip(xs, ys)) / sum(c * c for c in xs)
    mean = sum(ys) / len(ys)
    ss_res = sum((r - slope * c) ** 2 for c, r in zip(xs, ys))
    ss_tot = sum((r - mean) ** 2 for r in ys) or 1.0
    return {
        "reads_per_sec_by_cores": {str(c): round(results[c], 1) for c in xs},
        "reads_per_sec_per_core": {str(c): round(results[c] / c, 1) for c in xs},
        "slope_reads_per_sec_per_core": round(slope, 1),
        "r2_linear_through_origin": round(1 - ss_res / ss_tot, 4),
    }


def report(results: Dict[str, Dict[int, float]], n: int, trials: int, ncores: int) -> dict:
    """The record of a run: ``results[kind][cores]`` = best reads/s."""
    out = {
        "config": "dual-index PE, 96 samples, 8B+9B, max_mm=1, delta=2; "
        "sub_* legs: PE subsample fraction 0.3 on the same R1/R2",
        "n_reads": n,
        "trials_best_of": trials,
        "host_cores": ncores,
        "note": (
            "taskset-pinned children, interleaved trials; per-core = "
            "reads/s divided by cores; slope = least-squares through "
            "the origin of reads/s vs cores (linear scaling => e2e is "
            "host-core-bound, so throughput on a bigger host tracks "
            "its core count until other limits bind)"
        ),
    }
    for kind in KINDS:
        out[kind] = fit(results[kind])
    out["product_vs_proxy_slope"] = round(
        out["product"]["slope_reads_per_sec_per_core"]
        / out["proxy"]["slope_reads_per_sec_per_core"], 3)
    out["subsample_product_vs_proxy_slope"] = round(
        out["sub_product"]["slope_reads_per_sec_per_core"]
        / out["sub_proxy"]["slope_reads_per_sec_per_core"], 3)
    return out


def run(n: int = 2_000_000, trials: int = 3, cores: Optional[Iterable[int]] = None,
        device: str = "cuda", record_path: Optional[Path] = None) -> dict:
    """Every leg at each core count of ``cores`` (default 1..all) in turns,
    best of ``trials``; writes the record (default ``RECORD_DIR /
    core_scaling.json``) and returns it."""
    if shutil.which("taskset") is None:
        raise RuntimeError("core_scaling needs taskset to pin its legs; it never runs unpinned")
    machine = host(device)
    ncores = len(os.sched_getaffinity(0))
    counts = sorted(set(cores)) if cores is not None else list(range(1, ncores + 1))
    for c in counts:
        pinned_cpus(c)  # every count in range before anything runs
    with tempfile.TemporaryDirectory() as td:
        tmp = Path(td)
        build_inputs(tmp, n)
        # page-cache warm + thread-pool shapes (and the placement decision)
        # made once, untimed
        for kind in KINDS:
            child(kind, ncores, tmp, n, device)
        results = {k: {c: 0.0 for c in counts} for k in KINDS}
        cpu_per_wall = {k: {c: 0.0 for c in counts} for k in KINDS}
        for t in range(trials):
            for c in counts:
                for kind in KINDS:
                    rps, cpw = child(kind, c, tmp, n, device)
                    results[kind][c] = max(results[kind][c], rps)
                    cpu_per_wall[kind][c] = max(cpu_per_wall[kind][c], cpw)
                    print(f"trial {t} {kind} cores={c}: {rps / 1e6:.3f}M "
                          f"cpu/wall {cpw:.2f}", flush=True)
    out = report(results, n, trials, ncores)
    enforced = all(pin_enforced(v, c) for k in KINDS for c, v in cpu_per_wall[k].items())
    out.update(device=device, host=machine,
               pins={str(c): pinned_cpus(c) for c in counts},
               cpu_per_wall_max={k: {str(c): round(v, 3) for c, v in cpu_per_wall[k].items()}
                                 for k in KINDS},
               pins_enforced=enforced)
    if not enforced:
        print("core_scaling: WARNING a leg used more CPU than its pinned cores "
              "(cpu_per_wall_max): this host does not enforce the pins, so the "
              "curve does not measure cores", file=sys.stderr, flush=True)
    write_record(record_path or RECORD_DIR / "core_scaling.json", out)
    print(json.dumps(out, indent=1))
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--leg"]:
        ap = argparse.ArgumentParser(prog="core_scaling --leg")
        ap.add_argument("kind", choices=KINDS)
        ap.add_argument("data_dir", type=Path)
        ap.add_argument("n", type=int)
        ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
        args = ap.parse_args(argv[1:])
        run_leg(args.kind, args.data_dir, args.n, args.device)
        return 0
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_reads", nargs="?", type=int, default=2_000_000)
    ap.add_argument("trials", nargs="?", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    run(args.n_reads, args.trials, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
