"""fqtk_tpu_torch's command line: flag parity with fqtk_tpu's, dispatch
(the mesh's ``--devices``, the multi-process flags' errors; the two-process
runs are ``test_torch_multiprocess.py``), clean errors, and no JAX anywhere
in the package."""

import argparse
import ast
import gzip
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from fqtk_tpu.cli import _build_parser as jax_parser
from fqtk_tpu.runtime import demux as jax_demux
from fqtk_tpu_torch import __version__
from fqtk_tpu_torch.cli import _build_parser, main

from .util import fastq_file, metadata_file

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "fqtk_tpu_torch"


def _flags(parser):
    subs = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return {
        name: {
            opt: (a.default, a.nargs, getattr(a, "choices", None))
            for a in sub._actions
            for opt in a.option_strings
            if opt not in ("--version", "-h", "--help")
        }
        for name, sub in subs.choices.items()
    }


def test_flag_parity_with_jax_cli():
    ours, theirs = _flags(_build_parser()), _flags(jax_parser())
    assert set(ours) == set(theirs) == {"demux", "subsample", "concat-shards"}
    assert ours["demux"].pop("--device") == ("cuda", None, ["cuda", "cpu"])
    assert ours == theirs


@pytest.mark.parametrize("sub", [[], ["demux"], ["subsample"], ["concat-shards"]])
def test_version_names_the_port(sub, capsys):
    with pytest.raises(SystemExit) as e:
        main([*sub, "--version"])
    assert e.value.code == 0
    assert f"fqtk-tpu-torch {' '.join(sub) + ' ' if sub else ''}{__version__}" in capsys.readouterr().out


def _demux_args(tmp_path, out, *extra):
    meta = metadata_file(tmp_path, ["AAAAC", "CCCCA", "GGTTA"])
    reads = ["AAAAC" + "G" * 10, "CCCCA" + "T" * 10, "GGTTC" + "A" * 10, "NCCCA" + "C" * 10]
    fq = fastq_file(tmp_path, "in", "ex", reads * 5)
    return [
        "demux", "-i", str(fq), "-r", "5B+T", "-s", str(meta), "-o", str(out),
        "--batch-size", "4", *extra,
    ]


def _read_all(out):
    blob = {p.name: gzip.open(p).read() for p in sorted(out.glob("*.fq.gz"))}
    blob["metrics"] = (out / "demux-metrics.txt").read_bytes()
    return blob


def test_demux_cli_on_cpu_matches_jax_numpy_engine(tmp_path):
    out = tmp_path / "port"
    assert main(_demux_args(tmp_path, out, "--matcher", "device", "--device", "cpu")) == 0
    ref = tmp_path / "ref"
    args = jax_parser().parse_args(_demux_args(tmp_path, ref, "--engine", "numpy"))
    jax_demux.run_demux(
        jax_demux.DemuxConfig(
            inputs=args.inputs, read_structures=args.read_structures,
            sample_metadata=args.sample_metadata, output=args.output,
            batch_size=args.batch_size, engine="numpy",
        )
    )
    got = _read_all(out)
    assert got == _read_all(ref)
    assert got["Sample0000.R1.fq.gz"].count(b"\n@") == 4  # 5 reads


def test_merge_output_requires_coordinator(tmp_path, capsys):
    """``--merge-output`` without ``--distributed-coordinator`` fails with the
    JAX package's words, before anything runs."""
    rc = main(_demux_args(tmp_path, tmp_path / "o", "--merge-output", "--device", "cpu"))
    assert rc == 1
    err = capsys.readouterr().err
    assert "Traceback" not in err
    assert ("--merge-output requires --distributed-coordinator (a single-process run "
            "already writes single per-sample files)") in err
    assert not (tmp_path / "o").exists()  # nothing ran


def test_devices_flag_runs_the_mesh(tmp_path, monkeypatch, caplog):
    """``--devices 4`` lays the device matcher out on a 4 x 1 batch mesh (four
    CPU "devices" here) and writes the bytes of ``fqtk_tpu``'s run."""
    from fqtk_tpu_torch.parallel import mesh
    from fqtk_tpu_torch.runtime import demux as torch_demux

    monkeypatch.setattr(mesh, "local_devices", lambda device="cuda": [torch.device("cpu")] * 4)
    torch_demux._ASSIGN_FN_CACHE.clear()
    out = tmp_path / "port"
    with caplog.at_level("INFO", logger="fqtk"):
        rc = main(_demux_args(tmp_path, out, "--devices", "4", "--matcher", "device",
                              "--device", "cpu"))
    torch_demux._ASSIGN_FN_CACHE.clear()
    assert rc == 0
    assert "device mesh: 4-way batch parallelism over 4 local devices" in caplog.text
    ref = tmp_path / "ref"
    args = jax_parser().parse_args(_demux_args(tmp_path, ref, "--engine", "numpy"))
    jax_demux.run_demux(
        jax_demux.DemuxConfig(
            inputs=args.inputs, read_structures=args.read_structures,
            sample_metadata=args.sample_metadata, output=args.output,
            batch_size=args.batch_size, engine="numpy",
        )
    )
    assert _read_all(out) == _read_all(ref)


@pytest.mark.parametrize("engine", ["pallas", "jax", "numpy"])
def test_python_io_engines_match_jax_cli(tmp_path, engine):
    """``--engine pallas|jax|numpy --device cpu`` run the port's Python-IO
    engine and write the bytes of ``fqtk_tpu``'s run of the same engine."""
    out = tmp_path / "port"
    assert main(_demux_args(tmp_path, out, "--engine", engine, "--device", "cpu")) == 0
    ref = tmp_path / "ref"
    args = jax_parser().parse_args(_demux_args(tmp_path, ref, "--engine", engine))
    jax_demux.run_demux(
        jax_demux.DemuxConfig(
            inputs=args.inputs, read_structures=args.read_structures,
            sample_metadata=args.sample_metadata, output=args.output,
            batch_size=args.batch_size, engine=engine,
        )
    )
    got = _read_all(out)
    assert got == _read_all(ref)
    assert got["Sample0000.R1.fq.gz"].count(b"\n@") == 4  # 5 reads


def test_device_cuda_without_card_fails_cleanly(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = main(_demux_args(tmp_path, tmp_path / "o", "--matcher", "device"))
    assert rc == 1
    err = capsys.readouterr().err
    assert "cuda" in err and "Traceback" not in err


def test_subsample_routes_to_shared_runtime(tmp_path):
    fq = fastq_file(tmp_path, "in", "r", ["ACGT"] * 20)
    assert main(["subsample", "-i", str(fq), "-o", str(tmp_path / "sub"), "-f", "1.0", "--seed", "3"]) == 0
    with gzip.open(tmp_path / "sub.R1.fq.gz") as fh:
        assert fh.read().count(b"@") == 20


def test_import_leaves_jax_unloaded():
    code = (
        "import sys\n"
        "import fqtk_tpu_torch.cli, fqtk_tpu_torch.runtime.demux\n"
        "import fqtk_tpu_torch.ops.hopper_matcher, fqtk_tpu_torch.ops._build\n"
        "import fqtk_tpu_torch.utils.profiling\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib')))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_imports_in_port_sources():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 8
    for f in files:
        for mod in _imports(f):
            assert mod != "jax" and not mod.startswith(("jax.", "jaxlib")), (f, mod)
    # the smoke script drives the port only: nothing of the JAX package
    for mod in _imports(ROOT / "chip_smoke.py"):
        assert mod.split(".")[0] != "fqtk_tpu", mod


def test_profile_dir_writes_torch_trace(tmp_path, monkeypatch):
    import json

    trace_dir = tmp_path / "trace"
    monkeypatch.setenv("FQTK_PROFILE_DIR", str(trace_dir))
    out = tmp_path / "o"
    assert main(_demux_args(tmp_path, out, "--matcher", "device", "--device", "cpu")) == 0
    (trace,) = trace_dir.glob("*.json")
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("ph") == "X" for e in events)
    assert (out / "demux-metrics.txt").exists()
