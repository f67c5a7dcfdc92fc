"""The port's benchmark harness (``fqtk_tpu_torch/bench.py``) on the CPU
against the repository's ``bench.py`` (imported here only: the port imports
nothing of it).

The generators write the same decompressed bytes for the same seeds;
``host_speed_of_light`` returns the same dict for the same stage timings;
``_peak_ops`` knows the H100 by its name and picks the fp32 / tf32 peak by
the matmul precision setting; ``_device_only_rate`` is the two-point slope
(on a fake clock) with its ``slope <= 0`` rule; the host legs (``run_e2e``,
``run_refproxy``, ``bench_subsample_config``, the host half of
``bench_bigk_config``) run on ``device="cpu"`` at a few thousand reads and
report the original's keys; ``main`` exits non-zero when a config records
an error and writes its record only where it is pointed (``build/`` by
default), never ``BENCH_LOCAL.json``.  The kernel legs on the card are in
``test_torch_kernels_gpu.py``."""

import ast
import functools
import gzip
import hashlib
import json
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from fqtk_tpu.io import native as jax_native
from fqtk_tpu_torch import bench
from fqtk_tpu_torch.io import native as port_native

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import bench as jax_bench  # noqa: E402

H100 = "NVIDIA H100 80GB HBM3"
#: keys the port adds to a leg's entry: the precision that ran, and the
#: device legs' kernel, its counts and the K its MACs count
KERNEL_EXTRA = {"matmul_precision", "float32_matmul_precision"}
DEVICE_EXTRA = {"k_counted", "scheme", "launches", "plain_calls"}

#: small sizes of the kernel legs for the CPU (their plain versions)
SMALL_KERNEL = dict(batch=1024, batches=(512, 1024))
SMALL_MIDK = dict(k=512, b=2048, batches=(1024, 2048), n_proxy=200)
SMALL_BIGK = dict(k=4096, b=8192, n_proxy=200, device_batches=(2048, 4096), window=8192)


def decompressed(path):
    return gzip.decompress(Path(path).read_bytes())


def dict_keys_of(func_name: str, var: str = None):
    """The keys of the dict literal that ``bench.py``'s ``func_name``
    assigns to ``var`` (or returns, when ``var`` is None)."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == func_name)
    for node in ast.walk(fn):
        if var is None and isinstance(node, ast.Return) and isinstance(node.value, ast.Dict):
            return [k.value for k in node.value.keys]
        if (var is not None and isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == var for t in node.targets)):
            return [k.value for k in node.value.keys]
    raise LookupError((func_name, var))


# --------------------------------------------------------------------------
# the generators
# --------------------------------------------------------------------------


@pytest.mark.parametrize("k,length,seed,alphabet", [(96, 17, 7, "ACGT"), (16, 17, 21, "ACGT"),
                                                     (40, 6, 3, "ACGTN")])
def test_make_whitelist(k, length, seed, alphabet):
    assert bench.make_whitelist(k, length, seed, alphabet) == jax_bench.make_whitelist(
        k, length, seed, alphabet)


def test_write_inputs_bytes(tmp_path):
    barcodes = bench.make_whitelist(bench.K, bench.L)
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    paths, meta = bench.write_inputs(tmp_path / "port", barcodes, n_reads=3500, name="x_")
    jpaths, jmeta = jax_bench.write_inputs(tmp_path / "jax", barcodes, n_reads=3500, name="x_")
    assert meta.read_bytes() == jmeta.read_bytes()
    assert sorted(paths) == sorted(jpaths) == ["i1", "i2", "r1", "r2"]
    for n in paths:
        assert paths[n].name == jpaths[n].name
        data = decompressed(paths[n])
        assert data == decompressed(jpaths[n]) and data.count(b"\n") == 4 * 3500, n


@pytest.mark.parametrize("var_template", [False, True])
def test_write_single_end_inputs_bytes(tmp_path, var_template):
    barcodes = bench.make_whitelist(16, 17, seed=21)
    got = bench.write_single_end_inputs(tmp_path, barcodes, 2500, "p", var_template)
    want = jax_bench.write_single_end_inputs(tmp_path, barcodes, 2500, "j", var_template)
    assert got[1] == want[1] == 17
    assert decompressed(got[0]) == decompressed(want[0])


# --------------------------------------------------------------------------
# host_speed_of_light
# --------------------------------------------------------------------------

TIMINGS = [
    {},
    {"native_parse": 0.8, "native_gate_pack": 0.2, "native_route": 1.1, "native_compress": 3.4},
    {"native_parse": 0.8, "native_gate_pack": 0.2, "native_route": 1.1, "native_compress": 3.4,
     "steal_frac": 0.031},
    {"native_parse": 0.0, "native_route": 0.4, "native_compress": 2.0, "steal_frac": 0.0},
]


@pytest.mark.parametrize("timings", TIMINGS)
@pytest.mark.parametrize("kind", [None, "gzip", "bgzf"])
def test_host_speed_of_light(monkeypatch, timings, kind):
    inputs = None
    if kind is not None:
        inputs = ["a.fq.gz", "b.fq.gz"]
        calls = iter([(10, 0.61, kind), (10, 0.47, kind)] * 2)
        fake = lambda path: next(calls)  # noqa: E731
        monkeypatch.setattr(port_native, "inflate_bench", fake)
        monkeypatch.setattr(jax_native, "inflate_bench", fake)
    got = bench.host_speed_of_light(1.2e6, 2_000_000, timings, inputs=inputs)
    want = jax_bench.host_speed_of_light(1.2e6, 2_000_000, timings, inputs=inputs)
    assert got == want


# --------------------------------------------------------------------------
# peaks and the device-only rate
# --------------------------------------------------------------------------


def test_peak_ops_by_card_name(monkeypatch, capsys):
    monkeypatch.setattr(bench, "_device_kind", lambda device: H100)
    assert bench._peak_ops("int8", "cuda") == (1978.9e12, H100)
    assert bench._peak_ops("bf16", "cuda") == (989.4e12, H100)
    assert bench._peak_ops("tf32", "cuda") == (494.7e12, H100)
    assert bench._peak_ops("fp32", "cuda") == (66.9e12, H100)
    err = capsys.readouterr().err
    assert H100 in err and "nvidia-smi" in err  # each reading names the card
    monkeypatch.setattr(bench, "_device_kind", lambda device: "Some Other GPU")
    assert bench._peak_ops("int8", "cuda") == (None, "Some Other GPU")
    monkeypatch.undo()
    assert bench._peak_ops("int8", "cpu") == (None, "cpu")


def test_peak_follows_the_matmul_precision(monkeypatch):
    monkeypatch.setattr(bench, "_device_kind", lambda device: H100)
    saved = torch.get_float32_matmul_precision()
    try:
        for setting, want in (("highest", "fp32"), ("high", "tf32"), ("medium", "tf32")):
            torch.set_float32_matmul_precision(setting)
            assert bench._matmul_precision("cuda") == want, setting
            assert bench._matmul_precision("cpu") == "fp32"
            peak, _ = bench._peak_ops(bench._matmul_precision("cuda"), "cuda")
            assert peak == bench._PEAK_OPS[H100][want]
    finally:
        torch.set_float32_matmul_precision(saved)


class FakeClock:
    """``perf_counter`` that only moves when the toy call says so."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        return self.now


@pytest.mark.parametrize("per_row,fixed", [(2e-6, 1e-3), (5e-8, 0.0)])
def test_device_only_rate_is_the_slope(monkeypatch, per_row, fixed):
    clock = FakeClock()
    monkeypatch.setattr(bench, "time", types.SimpleNamespace(perf_counter=clock.perf_counter))
    seen = []

    def call(x):
        assert isinstance(x, torch.Tensor) and x.device.type == "cpu"  # resident
        seen.append(len(x))
        clock.now += fixed + per_row * len(x)
        return (torch.ones(len(x), dtype=torch.int32),)

    rate = bench._device_only_rate(call, lambda b: np.zeros((b, 4), np.uint8),
                                   batches=(1000, 3000), iters=3, device="cpu")
    assert rate == pytest.approx(1.0 / per_row, rel=1e-9)
    assert seen == [1000] * 4 + [3000] * 4  # warm + 3 timed, each batch


def test_device_only_rate_when_the_slope_is_not_positive(monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(bench, "time", types.SimpleNamespace(perf_counter=clock.perf_counter))

    def call(x):  # the larger batch is faster: a noise phase flipped mid-fit
        clock.now += 0.05 if len(x) == 1000 else 0.02
        return (torch.ones(len(x), dtype=torch.int32),)

    rate = bench._device_only_rate(call, lambda b: np.zeros((b, 4), np.uint8),
                                   batches=(1000, 3000), device="cpu")
    assert rate == pytest.approx(3000 / 0.02, rel=1e-9)  # the large batch's call rate


# --------------------------------------------------------------------------
# the legs on the CPU
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def headline(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("headline")
    barcodes = bench.make_whitelist(bench.K, bench.L)
    paths, meta = bench.write_inputs(tmp, barcodes, n_reads=3000)
    return tmp, barcodes, paths, meta


def test_run_e2e_keys(headline):
    tmp, barcodes, paths, meta = headline
    inputs = [paths["i1"], paths["r1"], paths["r2"], paths["i2"]]
    structs = ["8B", "100T", "100T", "9B"]
    rps, t = bench.run_e2e(tmp, inputs, structs, meta, 3000, "p", trials=1, device="cpu")
    jrps, jt = jax_bench.run_e2e(tmp, inputs, structs, meta, 3000, "j", trials=1)
    assert rps > 0 and jrps > 0
    # the port's run_demux also times its whole native pipeline
    assert set(t) == set(jt) | {"pipeline"}
    assert not list(tmp.glob("out_p*"))  # a measured run's outputs are deleted
    sol = bench.host_speed_of_light(rps, 3000, t, inputs=inputs)
    assert list(sol) == list(jax_bench.host_speed_of_light(jrps, 3000, jt, inputs=inputs))


def test_run_refproxy_and_the_ab(headline):
    tmp, barcodes, paths, meta = headline
    inputs = [paths["i1"], paths["r1"], paths["r2"], paths["i2"]]
    structs = ["8B", "100T", "100T", "9B"]
    proxy = bench.run_refproxy(tmp, inputs, structs, barcodes, 3000, "p", trials=1)
    jproxy = jax_bench.run_refproxy(tmp, inputs, structs, barcodes, 3000, "j", trials=1)
    assert isinstance(proxy, float) and proxy > 0 and jproxy > 0
    e2e, t, best_proxy = bench.run_config_ab(tmp, inputs, structs, meta, barcodes, 3000,
                                             "ab", trials=1, device="cpu")
    assert e2e > 0 and best_proxy > 0 and "native_parse" in t


def test_subsample_config_keys(headline):
    tmp, barcodes, paths, meta = headline
    got = bench.bench_subsample_config(tmp, paths, trials=1)
    want = jax_bench.bench_subsample_config(tmp, paths)
    assert list(got) == list(want)
    assert got["name"] == "subsample_PE_fraction0.3"
    assert list(got["host_speed_of_light"]) == list(want["host_speed_of_light"])


def test_bigk_config_keys_on_cpu():
    got = bench.bench_bigk_config(device="cpu", **SMALL_BIGK)
    assert list(got)[:-1] == dict_keys_of("bench_bigk_config", "result")
    dev = got["device_pallas"]
    assert "error" not in dev, dev
    assert set(dev) == set(dict_keys_of("_bench_bigk_pallas")) | DEVICE_EXTRA
    # on the CPU the kernel's plain version ran, and only it
    assert dev["scheme"] == "colmerge_top2" and dev["launches"] == 0 and dev["plain_calls"] > 0
    assert dev["device_mfu"] is None and dev["kind"] == "cpu"
    assert 0 < got["matched_frac"] <= 1


def test_bigk_device_error_is_recorded_and_fails_the_run(monkeypatch):
    def broken(*a, **kw):
        raise RuntimeError("no card")

    monkeypatch.setattr(bench, "_bench_bigk_device", broken)
    got = bench.bench_bigk_config(device="cpu", **SMALL_BIGK)
    assert got["device_pallas"] == {"error": "RuntimeError: no card"}
    full = {"configs": [{"name": "a"}, got]}
    assert bench.failed_configs(full) == ["single_cell_737K_whitelist_16B.device_pallas"]


def test_midk_and_kernel_keys_on_cpu():
    got = bench.bench_midk_config(device="cpu", **SMALL_MIDK)
    assert set(got) == set(dict_keys_of("bench_midk_config", "result")) | DEVICE_EXTRA | {
        "proxy_reads_per_sec", "vs_config_baseline"}
    assert got["name"] == "mid_K_8192_16bp_mm1_d2" and got["k_counted"] == 512
    assert got["scheme"] == "colmerge_top2" and got["plain_calls"] > 0 and got["launches"] == 0
    rps, dev = bench.bench_kernel(bench.make_whitelist(bench.K, bench.L), device="cpu",
                                  **SMALL_KERNEL)
    assert rps > 0
    assert set(dev) == set(dict_keys_of("bench_kernel", "device")) | KERNEL_EXTRA
    assert dev["matmul_precision"] == "fp32" and dev["device_mfu"] is None


# --------------------------------------------------------------------------
# main
# --------------------------------------------------------------------------


def small_main(monkeypatch, tmp_path, **patch):
    """``main`` on the CPU at a few thousand reads, the kernel legs small;
    no pin of the port's own (``BASELINE_PATH``), so the root file's is read."""
    monkeypatch.setattr(bench, "BASELINE_PATH", tmp_path / "no_pin.json")
    monkeypatch.setattr(bench, "bench_kernel", functools.partial(bench.bench_kernel, **SMALL_KERNEL))
    monkeypatch.setattr(bench, "bench_midk_config",
                        functools.partial(bench.bench_midk_config, **SMALL_MIDK))
    monkeypatch.setattr(bench, "bench_bigk_config",
                        functools.partial(bench.bench_bigk_config, **SMALL_BIGK))
    for name, fn in patch.items():
        monkeypatch.setattr(bench, name, fn)
    record = tmp_path / "build" / "bench_torch.json"
    rc = bench.main(record_path=record, device="cpu", n_reads=3000, n_reads_secondary=2000,
                    headline_trials=1, secondary_trials=1, subsample_trials=1)
    return rc, record


def root_state():
    files = sorted(p.name for p in ROOT.iterdir())
    return files, hashlib.sha256((ROOT / "BENCH_LOCAL.json").read_bytes()).hexdigest()


def test_main_runs_every_config_and_writes_only_its_record(monkeypatch, tmp_path, capsys):
    before = root_state()
    rc, record = small_main(monkeypatch, tmp_path)
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    full, summary = json.loads(out[-2]), json.loads(out[-1])
    assert json.loads(record.read_text()) == full
    assert list(summary) == ["metric", "headline_reads_per_sec", "unit", "vs_baseline",
                             "configs_vs_baseline", "value"]
    assert [c["name"] for c in full["configs"]] == [
        "dual_index_PE_96samples_8B9B_mm1_d2", "single_end_inline_17B+T_16samples_mm0",
        "iupac_N_expected_barcodes_17B+T_16samples",
        "variable_length_plus_structures_PE_96samples", "single_cell_737K_whitelist_16B",
        "mid_K_8192_16bp_mm1_d2", "subsample_PE_fraction0.3"]
    assert all(c["wall_s"] > 0 and "error" not in c for c in full["configs"])
    assert full["kernel_device"]["kind"] == "cpu"
    assert full["metric"] == "demux_e2e_reads_per_sec" and full["value"] > 0
    assert "another host" in full["baseline_note"]
    assert root_state() == before  # BENCH_LOCAL.json untouched, nothing new at the root


def test_main_exits_non_zero_on_a_config_error(monkeypatch, tmp_path, capsys):
    def broken(device="cuda"):
        raise RuntimeError("mid-K leg failed")

    rc, record = small_main(monkeypatch, tmp_path, bench_midk_config=broken)
    captured = capsys.readouterr()
    assert rc == 1
    assert "mid_K_8192_16bp_mm1_d2" in captured.err
    full = json.loads(record.read_text())
    midk = [c for c in full["configs"] if c["name"] == "mid_K_8192_16bp_mm1_d2"]
    assert midk[0]["error"] == "RuntimeError: mid-K leg failed"
    assert len(full["configs"]) == 7  # the others were kept


def test_record_defaults_under_build():
    assert bench.RECORD_PATH.relative_to(ROOT / "build")
    assert bench.RECORD_PATH.name == "bench_torch.json"
