"""The port's host measuring tools (``fqtk_tpu_torch/scripts/``) on the CPU,
against their counterparts in ``scripts/`` (loaded here by path; the port
imports nothing of them).

Each tool's inputs are the original's bytes from the same seeds (compared
decompressed, with the metadata); ``core_scaling``'s fit equals a NumPy
least-squares fit; one trial of ``profile_e2e`` splits ``cores * wall``
exactly and its forced device arm runs the kernel's plain version; two
``ab_e2e`` arms write identical outputs; a real two-process gloo
``scaling_bench`` matches its solo run on shard 0 and sums the shards'
counts; ``measure_baseline`` keeps the best-ever pin; every tool raises on
``cuda`` without a card and writes nowhere but where it is pointed (the
root JSON files of the JAX round keep their bytes).  Small sizes
(<= 30,000 reads), ``--device cpu``, every record and ``FQTK_CACHE_DIR``
under ``tmp_path``."""

import gzip
import hashlib
import importlib.util
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fqtk_tpu_torch import bench
from fqtk_tpu_torch.scripts import (
    ab_e2e,
    common,
    core_scaling,
    measure_baseline,
    profile_e2e,
    scaling_bench,
)

ROOT = Path(__file__).resolve().parent.parent
#: the JAX round's records at the root: no tool may touch them
ROOT_JSON = ("BASELINE_MEASURED.json", "CORE_SCALING_LOCAL.json", "SCALING_LOCAL.json")
DEVICE_ARMS = ["FQTK_HOST_MATCHER_MAX_K=0", "FQTK_HOST_MATCHER_MAX_K=100000"]


def jax_script(name):
    """``scripts/<name>.py`` as a module of its own."""
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}",
                                                  ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def unzip(path):
    return gzip.decompress(Path(path).read_bytes())


def root_digests():
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest() for p in sorted(ROOT.glob("*.json"))}


@pytest.fixture
def cache(tmp_path, monkeypatch):
    monkeypatch.setenv("FQTK_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.delenv("FQTK_HOST_MATCHER_MAX_K", raising=False)
    monkeypatch.delenv("FQTK_MEASURE_CROSSOVER", raising=False)
    return tmp_path / "cache"


class Captured(Exception):
    pass


# --------------------------------------------------------------------------
# the input builders against the originals
# --------------------------------------------------------------------------


def test_profile_e2e_make_barcodes():
    jax = jax_script("profile_e2e")
    assert profile_e2e.make_barcodes(96, 17) == jax.make_barcodes(96, 17)
    assert profile_e2e.make_barcodes(10, 6, seed=9) == jax.make_barcodes(10, 6, seed=9)


@pytest.mark.parametrize("var_template", [False, True])
def test_profile_e2e_write_input(tmp_path, var_template):
    jax = jax_script("profile_e2e")
    bcs = profile_e2e.make_barcodes(12, 8)
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    got = profile_e2e.write_input(tmp_path / "a", bcs, 2500, "x", var_template)
    want = jax.write_input(tmp_path / "b", bcs, 2500, "x", var_template)
    assert unzip(got) == unzip(want)


@pytest.mark.parametrize("config", profile_e2e.CONFIGS)
def test_profile_e2e_inputs_equal_the_originals(tmp_path, monkeypatch, config):
    """Every config's inputs, structures and metadata: the original's
    ``main`` is stopped at its first ``run_demux`` and its inputs read."""
    import fqtk_tpu.runtime.demux as jax_demux

    jax = jax_script("profile_e2e")
    seen = {}

    def capture(cfg):
        seen.update(inputs=[unzip(p) for p in cfg.inputs], structures=list(cfg.read_structures),
                    meta=Path(cfg.sample_metadata).read_text())
        raise Captured

    monkeypatch.setattr(jax_demux, "run_demux", capture)
    monkeypatch.setattr(sys, "argv", ["profile_e2e.py", config, "2200"])
    with pytest.raises(Captured):
        jax.main()
    inputs, structures, meta = profile_e2e.build(tmp_path, config, 2200)
    assert [unzip(p) for p in inputs] == seen["inputs"]
    assert structures == seen["structures"]
    assert meta.read_text() == seen["meta"]


@pytest.mark.parametrize("config", ab_e2e.CONFIGS)
def test_ab_e2e_build_equals_the_original(tmp_path, monkeypatch, config):
    jax = jax_script("ab_e2e")
    monkeypatch.setattr(jax, "N", 2000)
    monkeypatch.setattr(ab_e2e, "N", 2000)
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    got = ab_e2e.build(tmp_path / "a", config)
    want = jax.build(tmp_path / "b", config)
    assert ab_e2e.WARM_READS == 200_000  # the original's warm run
    for g, w in ((got[0], want[0]), (got[3], want[3])):  # inputs, warm inputs
        assert [unzip(p) for p in g] == [unzip(p) for p in w]
    assert got[1] == want[1] and got[4:] == want[4:]  # structures, max_mm, delta
    assert got[2].read_text() == want[2].read_text()


def test_scaling_bench_inputs_equal_the_original(tmp_path, monkeypatch):
    """The original's barcodes, metadata and both shards (its ``main``
    stopped at its first solo run)."""
    jax = jax_script("scaling_bench")
    seen = {}

    def capture(tmp, inputs, meta, **kw):
        shard0 = Path(inputs[0])
        seen.update(meta=Path(meta).read_text(), shard0=unzip(shard0),
                    shard1=unzip(shard0.with_name("shard1.fq.gz")))
        raise Captured

    monkeypatch.setattr(jax, "run_solo", capture)
    monkeypatch.setattr(sys, "argv", ["scaling_bench.py", "1500"])
    with pytest.raises(Captured):
        jax.main()
    barcodes = scaling_bench.make_barcodes()
    meta = "sample_id\tbarcode\n" + "".join(f"S{i:02d}\t{b}\n" for i, b in enumerate(barcodes))
    assert meta == seen["meta"]
    (tmp_path / "jax").mkdir()
    for name, seed in (("shard0", 11), ("shard1", 22)):
        path, length = scaling_bench.write_shard(tmp_path, barcodes, 1500, name, seed)
        want, want_length = jax.write_shard(tmp_path / "jax", barcodes, 1500, name, seed)
        assert unzip(path) == seen[name] == unzip(want) and length == want_length == 17


def test_core_scaling_build_inputs_equal_the_original(tmp_path):
    jax = jax_script("core_scaling")
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    got = core_scaling.build_inputs(tmp_path / "a", 2500)
    want = jax.build_inputs(tmp_path / "b", 2500)
    for key in ("structures", "barcodes", "n"):
        assert got[key] == want[key]
    assert [unzip(p) for p in got["inputs"]] == [unzip(p) for p in want["inputs"]]
    assert Path(got["meta"]).read_text() == Path(want["meta"]).read_text()
    assert json.loads((tmp_path / "a" / "manifest.json").read_text()) == got


# --------------------------------------------------------------------------
# core_scaling: the fit, the legs, the pins
# --------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_core_scaling_report_is_a_least_squares_fit(seed):
    rng = np.random.default_rng(seed)
    cores = list(range(1, 9)) if seed < 2 else [1, 8]
    results = {k: {c: float(c * rng.uniform(2e5, 5e5) + rng.normal(0, 3e4)) for c in cores}
               for k in core_scaling.KINDS}
    rep = core_scaling.report(results, 1000, 3, 8)
    for kind in core_scaling.KINDS:
        x = np.array(cores, dtype=np.float64)
        y = np.array([results[kind][c] for c in cores])
        slope = np.linalg.lstsq(x[:, None], y, rcond=None)[0][0]
        r2 = 1 - np.sum((y - slope * x) ** 2) / np.sum((y - y.mean()) ** 2)
        got = rep[kind]
        assert abs(got["slope_reads_per_sec_per_core"] - slope) <= 0.05 + 1e-9 * slope
        assert abs(got["r2_linear_through_origin"] - r2) <= 5e-5 + 1e-12
        assert got["reads_per_sec_per_core"] == {str(c): round(results[kind][c] / c, 1)
                                                 for c in cores}
    assert rep["product_vs_proxy_slope"] == round(
        rep["product"]["slope_reads_per_sec_per_core"]
        / rep["proxy"]["slope_reads_per_sec_per_core"], 3)
    assert rep["host_cores"] == 8 and rep["trials_best_of"] == 3


def test_core_scaling_legs_and_a_pinned_child(tmp_path, cache, capsys):
    core_scaling.build_inputs(tmp_path, 3000)
    for kind in core_scaling.KINDS:
        rps, cpu_per_wall = core_scaling.run_leg(kind, tmp_path, 3000, device="cpu")
        assert rps > 0 and cpu_per_wall > 0
    assert capsys.readouterr().out.count("CPU_PER_WALL ") == 4
    rps, cpu_per_wall = core_scaling.child("sub_proxy", 1, tmp_path, 3000, "cpu")
    assert rps > 0 and cpu_per_wall > 0
    with pytest.raises(ValueError, match="unknown leg"):
        core_scaling.run_leg("nope", tmp_path, 3000, device="cpu")


@pytest.mark.parametrize("overused", [False, True])
def test_core_scaling_run_records_whether_pins_bind(tmp_path, monkeypatch, overused):
    """``run`` over fake children: every leg at every core count in turns,
    the best reads/s, and ``pins_enforced`` false once a leg's CPU over
    wall exceeds its pinned cores."""
    calls = []

    def fake_child(kind, cores, data_dir, n, device):
        calls.append((kind, cores))
        return 1000.0 * cores + len(calls), (cores + 1.5 if overused and cores == 1 else 0.9)

    monkeypatch.setattr(core_scaling, "child", fake_child)
    rec = core_scaling.run(500, 2, cores=[2, 1], device="cpu", record_path=tmp_path / "cs.json")
    warm = [(k, len(os.sched_getaffinity(0))) for k in core_scaling.KINDS]
    timed = [(k, c) for _ in range(2) for c in (1, 2) for k in core_scaling.KINDS]
    assert calls == warm + timed
    assert rec["pins_enforced"] is (not overused)
    assert rec["cpu_per_wall_max"]["product"]["1"] == (2.5 if overused else 0.9)
    assert rec["product"]["reads_per_sec_by_cores"]["2"] == max(
        1000.0 * 2 + i + 1 for i, call in enumerate(calls) if call == ("product", 2))
    assert json.loads((tmp_path / "cs.json").read_text()) == rec


def test_pin_enforced():
    assert common.pin_enforced(1.0, 1) and common.pin_enforced(1.2, 1)
    assert not common.pin_enforced(1.3, 1) and not common.pin_enforced(5.0, 4)
    assert common.pin_enforced(8.5, 8)


def test_core_scaling_pins_and_taskset(monkeypatch):
    cpus = sorted(os.sched_getaffinity(0))
    assert core_scaling.pinned_cpus(1) == str(cpus[0])
    assert core_scaling.pinned_cpus(len(cpus)) == ",".join(map(str, cpus))
    with pytest.raises(ValueError):
        core_scaling.pinned_cpus(len(cpus) + 1)
    monkeypatch.setattr(core_scaling.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="never runs unpinned"):
        core_scaling.run(1000, 1, device="cpu")


# --------------------------------------------------------------------------
# profile_e2e and ab_e2e: one small run each
# --------------------------------------------------------------------------


def test_profile_e2e_splits_the_budget(tmp_path, cache):
    record_path = tmp_path / "profile.json"
    rec = profile_e2e.run("headline", 20_000, device="cpu", trials=1, record_path=record_path)
    assert json.loads(record_path.read_text()) == json.loads(json.dumps(rec))
    assert [r["arm"] for r in rec["runs"]] == ["as_is", "device"]
    for r in rec["runs"]:
        parts = r["counted_io_s"] + r["uncounted_cpu_s"] + r["idle_s"]
        assert parts == pytest.approx(r["cores_x_wall"], rel=1e-12)
        assert r["counted_io_s"] > 0 and r["cpu_s"] > 0 and r["wall_s"] > 0
        assert r["reads_per_sec"] == pytest.approx(20_000 / r["wall_s"])
    as_is, dev = rec["runs"]
    assert as_is["matcher"] == {}  # K 96 on the CPU: the host matcher
    m = dev["matcher"]
    assert m["scheme"] == "colmerge_top2" and m["launches"] == 0 and m["plain_calls"] > 0
    assert as_is["outputs_sha256"] == dev["outputs_sha256"]
    assert rec["host"] == bench.host_info("cpu")
    assert "FQTK_HOST_MATCHER_MAX_K" not in os.environ  # the arm's env restored


def test_ab_e2e_arms_write_identical_outputs(tmp_path, cache, monkeypatch, capsys):
    monkeypatch.setattr(ab_e2e, "N", 20_000)
    monkeypatch.setattr(ab_e2e, "WARM_READS", 2_000)
    rec = ab_e2e.run("single", 1, DEVICE_ARMS, device="cpu", record_path=tmp_path / "ab.json")
    dev, host_arm = (rec["arms"][a] for a in DEVICE_ARMS)
    assert dev["outputs_sha256"] == host_arm["outputs_sha256"]
    assert dev["matcher"]["launches"] == 0 and dev["matcher"]["plain_calls"] > 0
    assert host_arm["matcher"] == {}
    assert dev["best_reads_per_sec"] > 0 and dev["host_speed_of_light"]["frac_of_ceiling"] > 0
    out = capsys.readouterr().out
    assert out.count("best ") == 2 and "plain_calls" in out

    # arms whose outputs differ fail the run
    digests = iter(["a", "b"])
    monkeypatch.setattr(ab_e2e, "outputs_digest", lambda out: next(digests))
    with pytest.raises(AssertionError, match="outputs differ"):
        ab_e2e.run("single", 1, DEVICE_ARMS, device="cpu", record_path=tmp_path / "ab2.json")


def test_arm_env_sets_and_restores(monkeypatch):
    monkeypatch.setenv("FQTK_A", "1")
    monkeypatch.delenv("FQTK_B", raising=False)
    with common.arm_env("FQTK_A=2,FQTK_B=3"):
        assert os.environ["FQTK_A"] == "2" and os.environ["FQTK_B"] == "3"
    assert os.environ["FQTK_A"] == "1" and "FQTK_B" not in os.environ
    assert common.parse_arm("") == {}
    with pytest.raises(ValueError):
        common.parse_arm("FQTK_A")


def test_patched_env_sets_unsets_and_restores(monkeypatch):
    monkeypatch.setenv("FQTK_A", "1")
    monkeypatch.delenv("FQTK_B", raising=False)
    with pytest.raises(KeyError):
        with common.patched_env({"FQTK_A": None, "FQTK_B": "3"}):
            assert "FQTK_A" not in os.environ and os.environ["FQTK_B"] == "3"
            raise KeyError("the body fails")
    assert os.environ["FQTK_A"] == "1" and "FQTK_B" not in os.environ


def test_outputs_digest_reads_decompressed_bytes(tmp_path):
    for name, level in (("a", 1), ("b", 9)):
        (tmp_path / name).mkdir()
        (tmp_path / name / "S0.R1.fq.gz").write_bytes(gzip.compress(b"@r\nACGT\n+\nIIII\n", level))
        (tmp_path / name / "demux-metrics.txt").write_text("sample_id\n")
    assert common.outputs_digest(tmp_path / "a") == common.outputs_digest(tmp_path / "b")
    (tmp_path / "b" / "demux-metrics.txt").write_text("sample_id \n")
    assert common.outputs_digest(tmp_path / "a") != common.outputs_digest(tmp_path / "b")


# --------------------------------------------------------------------------
# scaling_bench: a real two-process gloo run
# --------------------------------------------------------------------------


def test_scaling_bench_two_processes(tmp_path, cache, monkeypatch):
    checked = []
    real_check = scaling_bench.check_shards

    def check(solo_out, dist_out):
        # independently of the tool: per file, and the counts summed
        names = sorted(p.name for p in solo_out.glob("*.fq.gz"))
        assert names == sorted(p.name for p in (dist_out / "shard-0").glob("*.fq.gz"))
        for n in names:
            assert unzip(solo_out / n) == unzip(dist_out / "shard-0" / n)
        merged = scaling_bench.read_templates(dist_out / "demux-metrics.txt")
        want = sum(scaling_bench.read_templates(dist_out / f"shard-{p}" / "demux-metrics.txt")
                   for p in range(2))
        assert merged.tolist() == want.tolist() and merged.sum() == 2 * 4000
        real_check(solo_out, dist_out)
        checked.append(True)

    monkeypatch.setattr(scaling_bench, "check_shards", check)
    rec = scaling_bench.run(4000, device="cpu", trials=1, record_path=tmp_path / "scaling.json")
    assert checked == [True]
    assert rec["coordination_efficiency"] > 0 and rec["samebox_2proc_vs_1proc_throughput"] > 0
    pins, cpus = scaling_bench.halves()
    assert rec["pins"]["rank0_and_solo"] == pins[0] and rec["pins"]["rank1"] == pins[1]
    assert rec["threads"]["per_half"] == max(5, 2 * (len(cpus) // 2))
    assert rec["pins_enforced"] == common.pin_enforced(rec["cpu_per_wall_max_half"],
                                                       len(cpus) // 2)
    assert json.loads((tmp_path / "scaling.json").read_text()) == rec


def test_scaling_bench_check_shards_catches_a_difference(tmp_path):
    for d in ("solo", "dist/shard-0", "dist/shard-1"):
        (tmp_path / d).mkdir(parents=True)
    metrics = "sample_id\tbarcode\ttemplates\nS0\tA\t{}\nunmatched\tN\t{}\n"
    for d, counts in (("solo", (3, 1)), ("dist/shard-0", (3, 1)), ("dist/shard-1", (2, 0))):
        (tmp_path / d / "S0.R1.fq.gz").write_bytes(gzip.compress(b"@r\nACGT\n+\nIIII\n"))
        (tmp_path / d / "demux-metrics.txt").write_text(metrics.format(*counts))
    (tmp_path / "dist" / "demux-metrics.txt").write_text(metrics.format(5, 1))
    scaling_bench.check_shards(tmp_path / "solo", tmp_path / "dist")
    (tmp_path / "dist" / "demux-metrics.txt").write_text(metrics.format(5, 2))
    with pytest.raises(AssertionError, match="summed"):
        scaling_bench.check_shards(tmp_path / "solo", tmp_path / "dist")
    (tmp_path / "dist" / "shard-0" / "S0.R1.fq.gz").write_bytes(gzip.compress(b"@r\nACGA\n+\nIIII\n"))
    with pytest.raises(AssertionError, match="shard-0"):
        scaling_bench.check_shards(tmp_path / "solo", tmp_path / "dist")


# --------------------------------------------------------------------------
# measure_baseline and the harness's pin
# --------------------------------------------------------------------------


def test_measure_baseline_keeps_the_best_ever_pin(tmp_path):
    before = root_digests()
    pin = tmp_path / "pin.json"
    pin.write_text(json.dumps({"value": 1e12, "threads": 7, "reads": 5, "host": "elsewhere"}))
    kept = measure_baseline.run(threads=16, reads=3000, trials=1, device="cpu", record_path=pin)
    assert (kept["value"], kept["threads"], kept["reads"], kept["host"]) == (1e12, 7, 5, "elsewhere")
    pin.write_text(json.dumps({"value": 1.0, "threads": 7, "host": "elsewhere"}))
    new = measure_baseline.run(threads=16, reads=3000, trials=1, device="cpu", record_path=pin)
    assert new["value"] > 1.0 and new["threads"] == 16 and new["reads"] == 3000
    assert new["host"] == bench.host_info("cpu")
    assert json.loads(pin.read_text()) == new
    assert root_digests() == before
    for name in ROOT_JSON:
        assert name in before


def test_rust_baseline_reads_the_ports_pin(tmp_path, monkeypatch):
    pin = tmp_path / "pin.json"
    monkeypatch.setattr(bench, "BASELINE_PATH", pin)
    value, note = bench.rust_baseline("cpu")
    assert "BASELINE_MEASURED.json" in note and "another host" in note
    pin.write_text(json.dumps({"value": 2.5e6, "threads": 16, "host": bench.host_info("cpu")}))
    value, note = bench.rust_baseline("cpu")
    assert value == 2.5e6 and "pin.json" in note and "on this card's host" in note
    pin.write_text(json.dumps({"value": 2.5e6, "threads": 16,
                               "host": {"card": "cpu", "cpu_count": -1}}))
    assert "another host" in bench.rust_baseline("cpu")[1]


# --------------------------------------------------------------------------
# every tool: cuda without a card raises; records under build/
# --------------------------------------------------------------------------


@pytest.mark.parametrize("module,argv", [
    (profile_e2e, ["headline", "1000"]),
    (ab_e2e, ["single", "1", "FQTK_HOST_MATCHER_MAX_K=0"]),
    (core_scaling, ["1000", "1"]),
    (scaling_bench, ["1000"]),
    (measure_baseline, ["--reads", "1000"]),
], ids=lambda m: getattr(m, "__name__", "").rsplit(".", 1)[-1] or None)
def test_cuda_without_a_card_raises(module, argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        module.main(argv + ["--device", "cuda"])


def test_records_go_under_build():
    assert common.RECORD_DIR == ROOT / "build" / "fqtk_tpu_torch"
    assert bench.BASELINE_PATH == common.RECORD_DIR / "baseline_measured.json"
