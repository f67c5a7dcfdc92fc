"""Real two-process runs of the port's multi-process demux on
``torch.distributed`` (gloo over ``127.0.0.1``): ``merge_host_counts``,
``run_demux_multihost`` and the CLI's ``--distributed-coordinator`` path,
with ``process_count() == 2`` (the one-process identity never runs here).
Mirrors ``tests/test_multiprocess.py``; the merged outputs and metrics are
held to the JAX package's single-process run over the concatenated input.

Each test starts this file twice as a script (the worker at the bottom),
one process per rank, and kills both if either outlives its timeout.

Rank 0's store listens on a port below the kernel's ephemeral range
(:func:`store_port`): a test that picks its port by binding port 0 and hands
it to a process still starting (``tests/test_multiprocess.py``'s JAX
workers) draws from that range, so the two cannot pick the same port."""

import gzip
import json
import random
import socket
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve()
REPO = HERE.parent.parent
TIMEOUT_S = 120


def store_port() -> int:
    """A random port that binds now on 127.0.0.1, below the ephemeral range
    (``/proc/sys/net/ipv4/ip_local_port_range``) where the kernel picks a
    port for a bind to port 0; that pick where the range starts too low to
    leave room below it."""
    try:
        low = int(Path("/proc/sys/net/ipv4/ip_local_port_range").read_text().split()[0])
    except (OSError, ValueError, IndexError):
        low = 32768
    rng = random.Random()
    for _ in range(64 if low > 12_000 else 0):
        port = rng.randrange(10_000, low)
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
        return port
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_pair(mode: str, workdir: Path):
    port = store_port()
    procs = [
        subprocess.Popen(
            [sys.executable, str(HERE), mode, str(pid), "2", str(port), str(workdir)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=str(REPO),
        )
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT_S)
            outs.append(out.decode("utf-8", "replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out}"
    return outs


def _fq(path, bcs, comment=""):
    lines = []
    for i, bc in enumerate(bcs):
        lines += [f"@{path.stem}_{i}{comment}", bc + "GGGGG", "+", ";" * (len(bc) + 5)]
    path.write_text("\n".join(lines) + "\n")


def _single_jax_run(tmp_path):
    """The JAX package's single-process run over the concatenated input."""
    from fqtk_tpu.runtime.demux import DemuxConfig, run_demux

    combined = tmp_path / "combined.fastq"
    combined.write_text(
        (tmp_path / "in0.fastq").read_text() + (tmp_path / "in1.fastq").read_text()
    )
    run_demux(DemuxConfig(inputs=[combined], read_structures=["7B+T"],
                          sample_metadata=tmp_path / "metadata.tsv",
                          output=tmp_path / "single", engine="numpy", batch_size=4))
    return tmp_path / "single"


def _unzip(path):
    return gzip.decompress(path.read_bytes())


def test_merge_host_counts_two_processes(tmp_path):
    outs = _run_pair("merge_counts", tmp_path)
    for out in outs:
        assert "MERGE_OK" in out, out
    lines = [l for o in outs for l in o.splitlines() if l.startswith("MERGE_OK")]
    assert lines[0] == lines[1]


def test_run_demux_multihost_two_processes(tmp_path):
    _fq(tmp_path / "in0.fastq", ["GATTACA", "GATTACA", "GATTACA"])
    _fq(tmp_path / "in1.fastq", ["GATTACA", "GATTACA", "TTTTTTT"])
    (tmp_path / "metadata.tsv").write_text("sample_id\tbarcode\nsA\tGATTACA\n")

    _run_pair("demux_multihost", tmp_path)

    metrics = json.loads((tmp_path / "metrics.json").read_text())
    by_id = {m["sample_id"]: m for m in metrics}
    assert by_id["sA"]["templates"] == 5
    assert by_id["unmatched"]["templates"] == 1
    text = (tmp_path / "out" / "demux-metrics.txt").read_text()
    assert "sA\tGATTACA\t5" in text
    assert (tmp_path / "out" / "shard-0" / "sA.R1.fq.gz").exists()
    assert (tmp_path / "out" / "shard-1" / "sA.R1.fq.gz").exists()
    assert text == (_single_jax_run(tmp_path) / "demux-metrics.txt").read_text()


def test_cli_distributed_demux_two_processes(tmp_path):
    """``fqtk-tpu-torch demux --distributed-coordinator ... --merge-output``
    from the command line, each rank's matcher on the device path
    (``--matcher device --device cpu``: the kernels' plain versions)."""
    _fq(tmp_path / "in0.fastq", ["GATTACA"] * 4, " 1:N:0:0")
    _fq(tmp_path / "in1.fastq", ["GATTACA", "TTTTTTT"], " 1:N:0:0")
    (tmp_path / "metadata.tsv").write_text("sample_id\tbarcode\nsA\tGATTACA\n")

    outs = _run_pair("demux_cli", tmp_path)
    assert all("CLI_DEMUX_OK" in o for o in outs), outs

    out = tmp_path / "out"
    text = (out / "demux-metrics.txt").read_text()
    assert "sA\tGATTACA\t5" in text
    single = _single_jax_run(tmp_path)
    assert text == (single / "demux-metrics.txt").read_text()
    for name in ("sA.R1.fq.gz", "unmatched.R1.fq.gz"):
        merged = _unzip(out / name)
        assert merged == b"".join(_unzip(out / f"shard-{p}" / name) for p in range(2))
        assert merged == _unzip(single / name), name


def test_multihost_shards_concatenate_to_single_process_output(tmp_path):
    _fq(tmp_path / "in0.fastq", ["GATTACA", "GATTACA", "TTTTTTT", "GATTACA"], " 1:N:0:0")
    _fq(tmp_path / "in1.fastq", ["GATTACA", "CCCCCCC", "GATTACA"], " 1:N:0:0")
    (tmp_path / "metadata.tsv").write_text("sample_id\tbarcode\nsA\tGATTACA\n")

    _run_pair("demux_multihost", tmp_path)

    single = _single_jax_run(tmp_path)
    for name in ("sA.R1.fq.gz", "unmatched.R1.fq.gz"):
        sharded = b"".join(_unzip(tmp_path / "out" / f"shard-{p}" / name) for p in range(2))
        assert sharded == _unzip(single / name), name
    assert (tmp_path / "out" / "demux-metrics.txt").read_text() == (
        single / "demux-metrics.txt"
    ).read_text()


def _worker(mode: str, pid: int, nproc: int, port: str, workdir: Path) -> int:
    """One rank: ``python tests/test_torch_multiprocess.py <mode> <pid>
    <nproc> <port> <workdir>``."""
    sys.path.insert(0, str(REPO))
    import numpy as np

    from fqtk_tpu_torch.parallel import distributed

    if mode != "demux_cli":  # the CLI joins through its --distributed-* flags
        distributed.init_distributed(f"127.0.0.1:{port}", num_processes=nproc,
                                     process_id=pid)
        assert distributed.process_count() == nproc, distributed.process_count()
        assert distributed.process_index() == pid

    if mode == "merge_counts":
        local = np.arange(7, dtype=np.int64) + pid * 100
        local[3] = (1 << 40) + pid  # int64 end to end
        merged = distributed.merge_host_counts(local)
        want = sum(np.arange(7, dtype=np.int64) + p * 100 for p in range(nproc))
        want[3] = sum((1 << 40) + p for p in range(nproc))
        assert np.array_equal(merged, want), (merged, want)
        print("MERGE_OK", merged.tolist())
    elif mode == "demux_multihost":
        from fqtk_tpu_torch.runtime.demux import DemuxConfig

        cfg = DemuxConfig(inputs=[workdir / f"in{pid}.fastq"], read_structures=["7B+T"],
                          sample_metadata=workdir / "metadata.tsv", output=workdir / "out",
                          engine="numpy", batch_size=4, device="cpu")
        shards = [[workdir / f"in{p}.fastq"] for p in range(nproc)]
        metrics = distributed.run_demux_multihost(cfg, input_shards=shards)
        if pid == 0:
            (workdir / "metrics.json").write_text(json.dumps(metrics))
        print("DEMUX_OK")
    elif mode == "demux_cli":
        from fqtk_tpu_torch.cli import main as cli_main

        rc = cli_main([
            "demux", "-i", str(workdir / f"in{pid}.fastq"), "-r", "7B+T",
            "-s", str(workdir / "metadata.tsv"), "-o", str(workdir / "out"),
            "--threads", "5", "--batch-size", "4", "--matcher", "device",
            "--device", "cpu",
            "--distributed-coordinator", f"127.0.0.1:{port}",
            "--num-processes", str(nproc), "--process-id", str(pid), "--merge-output",
        ])
        assert rc == 0
        print("CLI_DEMUX_OK")
    else:
        raise SystemExit(f"unknown mode {mode}")
    distributed.dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                     Path(sys.argv[5])))
