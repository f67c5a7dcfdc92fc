"""``BENCHMARK.json`` against the contract, every piece found by its name,
a new cell added by files alone, the result line, and the import guard."""

from __future__ import annotations

import ast
import json
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import common, run
from benchmark.tests.cells import KINDS, cells, cpu_size, sizes_dir
from benchmark.tests.test_bm_faults import (_altered, check_control, check_fault,
                                            check_sound)
from benchmark.tests.test_bm_program_spans import check_readers

BENCH = common.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = cells()


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= len(BENCH["command"]) <= 32
    assert not any(w.startswith("/") or ".." in w for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_lines():
    seen = set()
    for part in ("configs", "workloads", "end_to_end", "per_layer"):
        kind = part if part in ("configs", "workloads") else "metric"
        for entry in BENCH[part]:
            assert NAME.match(entry["name"]), entry["name"]
            assert (kind, entry["name"]) not in seen
            seen.add((kind, entry["name"]))
            texts = [entry[k] for k in ("why", "layer") if k in entry]
            if part == "configs":
                texts.append(entry["source"])
                assert all(NAME.match(k) for k in entry["reduced"])
            for text in texts:
                assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
            if "unit" in entry:
                assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
            if part == "per_layer":
                assert entry["source"] in ("device_trace", "program_span", "program_counter",
                                           "host_clock")


def test_every_piece_resolves_by_name():
    for cell in CELLS:
        r = common.resolve_cell(BENCH, cell)
        assert r["driver"].is_file() and r["generator"].is_file()
        assert r["config"]["name"] == r["cell"]["config"]
        assert r["cell"]["chips"] == 1
        e2e = {m["name"] for m in r["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert r["per_layer"], f"{cell} reports no per-layer metric: add one of its own"
        for m in r["per_layer"]:
            assert m["moves"] in e2e, (cell, m["name"])
    for m in BENCH["per_layer"]:
        assert callable(common.load_module(common.metric_path(m["name"]), "metric").read)
        assert set(m["workloads"]) <= set(CELLS)
    for c in BENCH["configs"]:
        assert c["file"].startswith("benchmark/configs/")
        cfg = common.load_json(common.ROOT / c["file"])
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


def check_result_keys(cell, trace, root=common.ROOT):
    """A run of ``cell`` at its tiny size gives the result's keys in order,
    and the metrics that ``BENCHMARK.json`` lists for the cell; returns
    the result."""
    r = run.run_cell(cell, 2**33 + 17, 0.3, bool(trace), device="cpu", root=root,
                     overrides=cpu_size(cell, "tiny", root))
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r)[-1] == "checks" and r["correct"] is True
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(r["device"])
    resolved = common.resolve_cell(common.load_benchmark(root), cell, root)
    want = resolved["per_layer" if trace else "end_to_end"]
    if trace:
        assert {"busy_s", "window_s"} <= set(r["device"])
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
        # on the CPU no operation runs on a device: no roofline is read
        assert not any(n.startswith("matcher_roofline_pct") for n in r["metrics"])
        want = [m for m in want if not m["name"].startswith("matcher_roofline_pct")]
    assert {m["name"] for m in want} == set(r["metrics"])
    for m in want:
        assert r["metrics"][m["name"]]["unit"] == m["unit"]
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"}
    return r


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_result_keys(cell, trace):
    check_result_keys(cell, trace)


def check_sizes(root=common.ROOT):
    """Each cell of ``root``'s ``BENCHMARK.json`` has one size file, each
    size file names a cell there, and a size overrides only keys that the
    cell's configuration and traffic mix have."""
    bench = common.load_benchmark(root)
    names = cells(root)
    have = sorted(p.name for p in sizes_dir(root).iterdir())
    want = sorted(f"{cell}.json" for cell in names)
    missing = [f"{sizes_dir(root).relative_to(root)}/{n}" for n in want if n not in have]
    assert not missing, f"cells with no CPU size: add {', '.join(missing)}"
    extra = [n for n in have if n not in want]
    assert not extra, f"size files of no cell in BENCHMARK.json: {', '.join(extra)}"
    for cell in names:
        size = common.load_json(sizes_dir(root) / f"{cell}.json")
        assert "tiny" in size and set(size) <= {"why", *KINDS}, (cell, sorted(size))
        assert 1 <= len(size.get("why", "")) <= 200 and "\n" not in size["why"], cell
        resolved = common.resolve_cell(bench, cell, root)
        for kind in KINDS:
            over = cpu_size(cell, kind, root)
            assert set(over) <= {"deployment", "traffic"}, (cell, kind)
            assert set(over.get("deployment", {})) <= set(resolved["config"]["deployment"])
            assert set(over.get("traffic", {})) <= set(resolved["traffic"]), (cell, kind)


def test_every_cell_has_one_cpu_size():
    check_sizes()


def test_new_cell_by_files_alone(tmp_path, monkeypatch):
    """A new cell is files of its own (configuration, traffic mix, CPU
    size, a per-layer reader) plus entries in BENCHMARK.json, with the cell
    appended to the lists of the end-to-end metrics it reports: nothing
    else is edited, and every per-cell check holds on it."""
    root = tmp_path / "checkout"
    shutil.copytree(common.BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    # a list of another size, and the cells8k mix with a pool of its own
    cfg = common.load_json(common.ROOT / "benchmark/configs/sc_10x_v3_whitelist.json")
    cfg.update(name="sc_new", deployment={**cfg["deployment"], "whitelist_size": 737280})
    (root / "benchmark/configs/sc_new.json").write_text(json.dumps(cfg))
    traffic = common.load_json(common.BENCH_DIR / "traffic/cells8k.json")
    traffic.update(pool_reads_per_s=36000000)
    (root / "benchmark/traffic/cells8k_big.json").write_text(json.dumps(traffic))
    size = {"why": "a test", "tiny": {"deployment": {"whitelist_size": 2000},
                                      "traffic": {"window_reads": 4096, "cells": 100,
                                                  "pool_reads_per_s": 2000000}},
            "faults": cpu_size("sc_v3.cells8k", "faults")}
    (sizes_dir(root) / "sc_new.cells8k.json").write_text(json.dumps(size))
    (root / "benchmark/metrics/windows_done.py").write_text(
        "def read(ctx):\n    return ctx['records'].get('windows')\n")
    cell = "sc_new.cells8k"
    bench["configs"].append({**bench["configs"][0], "name": "sc_new",
                             "file": "benchmark/configs/sc_new.json"})
    bench["workloads"].append({"name": cell, "config": "sc_new", "traffic": "cells8k_big",
                               "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "sc_v3.cells8k" in m["workloads"]:
            m["workloads"].append(cell)
    # and a bound of its own: the driver's quantity under a split name
    bench["end_to_end"].append({"name": "window_p95_ms.new", "unit": "ms",
                                "better": "lower", "bound": 0.05, "source": "host_clock",
                                "workloads": [cell]})
    # a reader of its own, and a reader shared under a split name
    bench["per_layer"].append({"name": "windows_done", "unit": "windows", "better": "higher",
                               "source": "host_clock", "layer": "device",
                               "moves": "window_reads_per_s", "workloads": [cell]})
    bench["per_layer"].append({"name": "dedup_ms.new", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "window dedup and dispatch",
                               "moves": "window_reads_per_s", "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    check_sizes(root)
    r = check_result_keys(cell, 1, root)
    assert r["metrics"]["windows_done"]["value"] >= 1
    assert set(r["metrics"]) == {"windows_done", "dedup_ms.new"}
    r = check_result_keys(cell, 0, root)
    assert set(r["metrics"]) == {"window_reads_per_s", "window_p95_ms", "window_p95_ms.new",
                                 "setup_s"}
    assert r["metrics"]["window_p95_ms.new"] == r["metrics"]["window_p95_ms"]
    check_readers(cell, root)
    check_sound(cell, root)
    check_control(cell, root)
    check_fault(cell, _altered, monkeypatch, root)


def test_main_without_a_card_prints_no_result():
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", "sc_v3.cells8k", "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        cwd=common.ROOT, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""},
    )
    assert proc.returncode == 2 and proc.stdout == ""


def test_guard_compares_top_level_names_whole():
    fake = ["fqtk_tpu_torch", "fqtk_tpu_torch.ops", "jaxtyping", "jax", "fqtk_tpu.ops",
            "flax.linen", "numpy"]
    assert common.forbidden_loaded(fake) == ["flax.linen", "fqtk_tpu.ops", "jax"]
    assert common.forbidden_loaded(["fqtk_tpu_torch", "jaxlib_like"]) == []


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_loads_no_jax_and_the_reference_no_program(cell):
    code = (
        "import sys, json\n"
        "import benchmark.reference.assign\n"
        "ref = sorted(m for m in sys.modules if m.split('.')[0] == 'fqtk_tpu_torch')\n"
        "from benchmark import run, common\n"
        f"run.run_cell({cell!r}, 3, 0.2, False, device='cpu', "
        f"overrides={cpu_size(cell)!r})\n"
        "print(json.dumps([ref, common.forbidden_loaded(),"
        " 'fqtk_tpu_torch' in sys.modules]))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=common.ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    ref, bad, program = json.loads(proc.stdout.strip().splitlines()[-1])
    assert ref == [] and bad == [] and program


def test_reference_sources_import_nothing_of_the_program():
    for path in (common.BENCH_DIR / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in ("fqtk_tpu_torch", "fqtk_tpu", "jax"), (path, n)
