"""Measured multi-process scaling on the port, the counterpart of
``scripts/scaling_bench.py``: the same input demuxed by

  A. one standalone process, vs
  B. two ``torch.distributed`` processes (gloo, split inputs, shard outputs
     and the merged metric counts: ``run_demux_multihost``).

Two framings, as there:

1. **Coordination overhead**: each side gets the SAME per-process
   resources (one half of this process's CPUs, pinned, one shard).
   ``coordination_efficiency = T_solo / T_dist`` isolates what the process
   group's rendezvous and the final count collective cost on top of a
   share-nothing pipeline.
2. **Same-box throughput**: one process on all the CPUs over one shard vs
   the pair over two shards.  ``samebox_2proc_vs_1proc_throughput =
   (2n / T_dist) / (n / T_1proc)``; CPU contention (shared LLC/DRAM,
   doubled compressor pools) is the expected loss, absent across hosts.

The pins are the two halves of ``os.sched_getaffinity(0)`` (the JAX
script's ``0,1`` / ``2,3`` on its 4-core host); each process gets
``max(5, 2 x its cores)`` demux threads (its 5 and 8 there).  Without
``taskset`` it raises.  One untimed solo run first settles the page cache
and the placement decision, and each process starts its device before its
timed run.  The solo run demuxes shard 0 only, so every trial
checks that rank 0's shard-0 outputs equal the solo run's and that the
merged ``demux-metrics.txt`` holds the two shards' counts summed.  Each
process reports its CPU time over its wall time: above its pinned cores the
host does not enforce the pins, and the record says so (``pins_enforced``).

Run: python -m fqtk_tpu_torch.scripts.scaling_bench [reads_per_shard] [--device cuda|cpu]
Record: build/fqtk_tpu_torch/scaling.json
"""

from __future__ import annotations

import argparse
import contextlib
import gzip
import json
import os
import resource
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from .common import (
    RECORD_DIR,
    host,
    init_device,
    outputs_digest,
    pin_enforced,
    write_record,
)

_REPO_ROOT = Path(__file__).resolve().parent.parent.parent
_MODULE = "fqtk_tpu_torch.scripts.scaling_bench"
TIMEOUT_S = 1200
TRIALS = 2


def write_shard(tmp, barcodes, n_reads, name, seed):
    rng = np.random.default_rng(seed)
    length = len(barcodes[0])
    choices = rng.integers(0, len(barcodes), size=n_reads)
    path = tmp / f"{name}.fq.gz"
    tmpl = ("ACGT" * 25).encode()
    chunk = 100_000
    with gzip.open(path, "wb", compresslevel=1) as fh:
        for lo in range(0, n_reads, chunk):
            hi = min(lo + chunk, n_reads)
            parts = []
            for i in range(lo, hi):
                seq = barcodes[choices[i]].encode() + tmpl
                parts.append(
                    b"@inst:1:AB:1:2:%d:3 1:N:0:0\n%s\n+\n%s\n"
                    % (i, seq, b"I" * len(seq))
                )
            fh.write(b"".join(parts))
    return path, length


def make_barcodes():
    barcodes = []
    rng = np.random.default_rng(5)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    seen = set()
    while len(barcodes) < 16:
        bc = bytes(rng.choice(bases, size=17)).decode()
        if bc not in seen:
            seen.add(bc)
            barcodes.append(bc)
    return barcodes


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _config(inputs, meta, out, threads, device):
    """Every run (a rank's shard, the solo run) reads one FASTQ."""
    from ..runtime.demux import DemuxConfig

    return DemuxConfig(inputs=[Path(p) for p in inputs], read_structures=["17B+T"],
                       sample_metadata=Path(meta), output=Path(out), threads=threads,
                       engine="native", device=device)


def worker(pid: int, nproc: int, port: int, shards: List[str], out: str, meta: str,
           threads: int, device: str) -> None:
    """One rank of the pair: joins the gloo group and demuxes its shard."""
    import torch.distributed as dist

    from ..parallel.distributed import init_distributed, run_demux_multihost

    init_device(device)
    init_distributed(f"127.0.0.1:{port}", num_processes=nproc, process_id=pid)
    try:
        cfg = _config([], meta, out, threads, device)
        with _timed():
            run_demux_multihost(cfg, input_shards=[[Path(s)] for s in shards])
    finally:
        dist.destroy_process_group()


def solo(inputs: List[str], out: str, meta: str, threads: int, device: str) -> None:
    from ..runtime.demux import run_demux

    init_device(device)
    cfg = _config(inputs, meta, out, threads, device)
    with _timed():
        run_demux(cfg)


@contextlib.contextmanager
def _timed():
    """Print the body's wall time and this process's CPU time over it."""
    r0, t0 = resource.getrusage(resource.RUSAGE_SELF), time.perf_counter()
    yield
    wall = time.perf_counter() - t0
    r1 = resource.getrusage(resource.RUSAGE_SELF)
    cpu = (r1.ru_utime - r0.ru_utime) + (r1.ru_stime - r0.ru_stime)
    print(f"WALL {wall:.3f} CPU {cpu:.3f}", flush=True)


def _wall(text: str) -> Tuple[float, float]:
    """``(wall, cpu / wall)`` of a child's ``WALL ... CPU ...`` line."""
    fields = text.split("WALL ")[-1].split()
    return float(fields[0]), float(fields[2]) / float(fields[0])


def run_distributed(shards, meta, threads, pins, device, out):
    port = _free_port()
    procs = []
    try:
        for pid in range(2):
            argv = ["taskset", "-c", pins[pid], sys.executable, "-m", _MODULE, "--worker",
                    str(pid), "2", str(port), ",".join(map(str, shards)), str(out), str(meta),
                    str(threads), "--device", device]
            procs.append(subprocess.Popen(argv, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, cwd=str(_REPO_ROOT)))
        texts = [p.communicate(timeout=TIMEOUT_S)[0].decode("utf-8", "replace") for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, text in zip(procs, texts):
        if p.returncode != 0:
            raise RuntimeError(f"a rank exited {p.returncode}:\n{text[-3000:]}")
    walls = [_wall(t) for t in texts]
    return max(w for w, _ in walls), max(c for _, c in walls)


def run_solo(inputs, meta, threads, pin, device, out):
    """A standalone process (a subprocess, so pinning and interpreter start
    match the pair's): its wall time and CPU time over wall."""
    argv = ["taskset", "-c", pin, sys.executable, "-m", _MODULE, "--solo",
            ",".join(map(str, inputs)), str(out), str(meta), str(threads), "--device", device]
    proc = subprocess.run(argv, capture_output=True, text=True, cwd=str(_REPO_ROOT),
                          timeout=TIMEOUT_S)
    if proc.returncode != 0:
        raise RuntimeError(f"the solo run exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    return _wall(proc.stdout)


def read_templates(metrics: Path) -> np.ndarray:
    lines = Path(metrics).read_text().splitlines()[1:]
    return np.array([int(line.split("\t")[2]) for line in lines], dtype=np.int64)


def check_shards(solo_out: Path, dist_out: Path) -> None:
    """Rank 0's shard-0 outputs equal the solo run's (decompressed, metrics
    included); the merged metrics hold the two shards' counts summed."""
    if outputs_digest(solo_out) != outputs_digest(dist_out / "shard-0"):
        raise AssertionError("rank 0's shard-0 outputs differ from the solo run's")
    merged = read_templates(dist_out / "demux-metrics.txt")
    parts = sum(read_templates(dist_out / f"shard-{p}" / "demux-metrics.txt") for p in range(2))
    if not np.array_equal(merged, parts):
        raise AssertionError(f"merged counts {merged.tolist()} != shards summed {parts.tolist()}")


def halves():
    """The two halves of this process's CPUs, as ``taskset -c`` lists."""
    cpus = sorted(os.sched_getaffinity(0))
    if len(cpus) < 2:
        raise RuntimeError(f"scaling_bench needs two CPUs to split, has {len(cpus)}")
    half = len(cpus) // 2
    return [",".join(map(str, cpus[:half])), ",".join(map(str, cpus[half:2 * half]))], cpus


def run(n: int = 1_000_000, device: str = "cuda", trials: int = TRIALS,
        record_path: Optional[Path] = None) -> dict:
    """Solo, pair and one-process runs in turns, best of ``trials``; writes
    the record (default ``RECORD_DIR / scaling.json``) and returns it."""
    if shutil.which("taskset") is None:
        raise RuntimeError("scaling_bench needs taskset to pin its processes")
    machine = host(device)
    pins, cpus = halves()
    full_pin = ",".join(map(str, cpus))
    half_cores = len(cpus) // 2
    threads_half, threads_full = max(5, 2 * half_cores), max(5, 2 * len(cpus))
    barcodes = make_barcodes()
    with tempfile.TemporaryDirectory() as td:
        tmp = Path(td)
        meta = tmp / "meta.tsv"
        meta.write_text(
            "sample_id\tbarcode\n"
            + "".join(f"S{i:02d}\t{b}\n" for i, b in enumerate(barcodes))
        )
        print(f"generating 2 x {n} reads ...", file=sys.stderr, flush=True)
        shard0, _ = write_shard(tmp, barcodes, n, "shard0", seed=11)
        shard1, _ = write_shard(tmp, barcodes, n, "shard1", seed=22)

        # page cache and the placement decision (FQTK_CACHE_DIR) made once,
        # untimed; then A/B/A/B to split noise fairly
        run_solo([shard0], meta, threads_full, full_pin, device, tmp / "out_warm")
        shutil.rmtree(tmp / "out_warm")
        t_solo = t_dist = t_1proc = float("inf")
        cpw_half = 0.0  # the most CPU over wall of a process pinned to a half
        for trial in range(trials):
            solo_out, dist_out = tmp / f"out_solo{trial}", tmp / f"out_dist{trial}"
            wall, cpw = run_solo([shard0], meta, threads_half, pins[0], device, solo_out)
            t_solo, cpw_half = min(t_solo, wall), max(cpw_half, cpw)
            wall, cpw = run_distributed([shard0, shard1], meta, threads_half, pins, device,
                                        dist_out)
            t_dist, cpw_half = min(t_dist, wall), max(cpw_half, cpw)
            wall, _ = run_solo([shard0], meta, threads_full, full_pin, device,
                               tmp / f"out_full{trial}")
            t_1proc = min(t_1proc, wall)
            check_shards(solo_out, dist_out)
            for d in (solo_out, dist_out, tmp / f"out_full{trial}"):
                shutil.rmtree(d)
            print(f"trial {trial}: solo {t_solo:.3f}s pair {t_dist:.3f}s one process "
                  f"{t_1proc:.3f}s (best so far)", file=sys.stderr, flush=True)

    result = {
        "metric": "multiprocess_scaling",
        "reads_per_shard": n,
        "trials_best_of": trials,
        "device": device,
        "host": machine,
        "pins": {"rank0_and_solo": pins[0], "rank1": pins[1], "oneproc": full_pin},
        "threads": {"per_half": threads_half, "oneproc": threads_full},
        "solo_half_shard_s": round(t_solo, 3),
        "dist_2x_half_shard_each_s": round(t_dist, 3),
        "coordination_efficiency": round(t_solo / t_dist, 4),
        "oneproc_all_cores_shard_s": round(t_1proc, 3),
        "samebox_2proc_vs_1proc_throughput": round((2 * n / t_dist) / (n / t_1proc), 4),
        "cpu_per_wall_max_half": round(cpw_half, 3),
        "pins_enforced": pin_enforced(cpw_half, half_cores),
        "shard0_outputs_equal_solo": True,
        "merged_counts_equal_shards_summed": True,
        "note": "coordination_efficiency = same per-process resources (half the "
        "CPUs, pinned, 1 shard) standalone vs under torch.distributed (gloo) with "
        "the O(1) count collective; samebox ratio divides all the CPUs between 2 "
        "processes (contention that separate hosts don't have)",
    }
    if not result["pins_enforced"]:
        print("scaling_bench: WARNING a process pinned to half the CPUs used more "
              "(cpu_per_wall_max_half): this host does not enforce the pins, so the "
              "halves are not isolated", file=sys.stderr, flush=True)
    print(json.dumps(result))
    write_record(record_path or RECORD_DIR / "scaling.json", result)
    return result


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    if argv[:1] == ["--worker"]:
        for name, kind in (("pid", int), ("nproc", int), ("port", int), ("shards", str),
                           ("out", str), ("meta", str), ("threads", int)):
            ap.add_argument(name, type=kind)
        args = ap.parse_args(argv[1:])
        worker(args.pid, args.nproc, args.port, args.shards.split(","), args.out, args.meta,
               args.threads, args.device)
    elif argv[:1] == ["--solo"]:
        for name, kind in (("inputs", str), ("out", str), ("meta", str), ("threads", int)):
            ap.add_argument(name, type=kind)
        args = ap.parse_args(argv[1:])
        solo(args.inputs.split(","), args.out, args.meta, args.threads, args.device)
    else:
        ap.add_argument("reads_per_shard", nargs="?", type=int, default=1_000_000)
        args = ap.parse_args(argv)
        run(args.reads_per_shard, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
