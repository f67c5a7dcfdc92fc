"""The per-layer metrics read from the program's own spans and counts
(``benchmark/program.py`` and its readers): nothing without a record of
this run, a number in each cell when traced, and a dedup count that equals
the benchmark's own recount."""

from __future__ import annotations

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import common, program, run
from benchmark.generators.barcodes import ascii_of_codes, random_whitelist, strings_of_ascii
from benchmark.tests.cells import cells, cpu_size

CELLS = cells()


def program_metrics(cell, root=common.ROOT):
    """The metrics that ``cell`` reports and reads from the program."""
    resolved = common.resolve_cell(common.load_benchmark(root), cell, root)
    return [m["name"] for m in resolved["per_layer"]
            if m["source"] in ("program_span", "program_counter")]


#: the metrics read from the program, by cell
PROGRAM_METRICS = {cell: program_metrics(cell) for cell in CELLS}
PROFILING = "fqtk_tpu_torch.utils.profiling"


def _reader(name):
    return common.load_module(common.metric_path(name), "metric").read


def test_every_cell_has_the_program_metrics():
    assert sorted(PROGRAM_METRICS["sc_v3.cells8k"]) == [
        "bucket_fill_pct.window", "dedup_ms.window", "expected_set_s",
        "fetch_behind_ms.window", "matcher_call_ms.window", "table_build_s"]
    assert sorted(PROGRAM_METRICS["sc_v3.uniform"]) == [
        "dedup_ms.uniform", "expected_set_s", "fetch_behind_ms.uniform",
        "matcher_call_ms.uniform", "table_build_s"]


@pytest.mark.parametrize("name", sorted({n for v in PROGRAM_METRICS.values() for n in v}))
def test_reader_gives_none_without_a_record_of_this_run(name, monkeypatch):
    read = _reader(name)
    ctx = {"records": {"windows": 3}, "trace": None, "device": {}}
    # the program not loaded (the control), or loaded without a tracer (a parent)
    monkeypatch.delitem(sys.modules, PROFILING, raising=False)
    assert read(ctx) is None
    monkeypatch.setitem(sys.modules, PROFILING, SimpleNamespace())
    assert read(ctx) is None
    # a record of another run: its windows are not the driver's
    other = SimpleNamespace(windows=[1, 2], spans=[], dedup=lambda: None)
    monkeypatch.setitem(sys.modules, PROFILING,
                        SimpleNamespace(program_record=lambda: other, setup_seconds=lambda n: 1.0))
    assert read(ctx) is None
    monkeypatch.setitem(sys.modules, PROFILING, SimpleNamespace(program_record=lambda: None))
    assert read(ctx) is None


def check_readers(cell, root=common.ROOT):
    """A traced run of ``cell`` at its tiny size gives a number for each
    metric that the cell reads from the program."""
    r = run.run_cell(cell, 2**34 + 3, 0.3, True, device="cpu", root=root,
                     overrides=cpu_size(cell, "tiny", root))
    assert r["correct"] is True
    for name in program_metrics(cell, root):
        value = r["metrics"][name]["value"]
        assert value >= 0, name
        quantity = name.split(".", 1)[0]
        if quantity in ("expected_set_s", "table_build_s"):
            assert value > 0, name
        if quantity == "bucket_fill_pct":
            assert 0 < value <= 100, name
    # the trace names idle gaps by the program's spans
    assert any(n.startswith("fqtk.") for n, _ in r["breakdown"]["idle_gaps"])


@pytest.mark.parametrize("cell", CELLS)
def test_readers_give_a_number_in_each_cell_when_traced(cell):
    check_readers(cell)


def test_bucket_fill_counts_what_the_benchmark_recounts():
    """The dedup's distinct rows over a session's windows equal the driver's
    own ``torch.unique`` recount of each (``window_stream._distinct``),
    summed and window by window, and the reader is 100 x their sum over the
    sum of the buckets."""
    from fqtk_tpu_torch.ops.matcher import ExpectedSet
    from fqtk_tpu_torch.runtime import demux
    from fqtk_tpu_torch.utils.profiling import program_record

    cell = "sc_v3.cells8k"
    resolved = common.resolve_cell(common.load_benchmark(), cell)
    driver = common.load_module(resolved["driver"], "driver")
    generator = common.load_module(resolved["generator"], "generator")
    tiny = cpu_size(cell, "tiny")
    k = tiny["deployment"]["whitelist_size"]
    traffic = {**resolved["traffic"], **tiny["traffic"]}
    gen = torch.Generator()
    gen.manual_seed(2**40 + 9)
    codes = random_whitelist(k, 16, gen)
    pool = generator.make_pool(codes, traffic, 5, gen)
    expected = ExpectedSet.from_barcodes(strings_of_ascii(ascii_of_codes(codes.numpy())))
    cfg = demux.DemuxConfig(
        inputs=[], read_structures=[], sample_metadata=Path(), output=Path(),
        max_mismatches=1, min_mismatch_delta=2, batch_size=traffic["window_reads"],
        matcher="device", devices=1, device="cpu",
    )
    assign, _, _ = demux._build_device_side(cfg, expected)
    # a traced run of a cell that reads no program metric leaves its record
    # open: a read closes it, so that this session's windows are its own
    program_record()
    with profile(activities=[ProfilerActivity.CPU]):
        driver.stream(assign, pool, None, common.Spans())
    ctx = {"records": {"windows": len(pool)}, "trace": None, "device": {}}
    counts = program.record(ctx).dedup()
    recount = [driver._distinct(w, torch.device("cpu")) for w in pool]
    buckets = [max(4096, 1 << (u - 1).bit_length()) for u in recount]
    assert all(b < traffic["window_reads"] for b in buckets)  # every window engaged
    assert counts["windows"] == counts["engaged"] == len(pool)
    assert counts["engaged_distinct"] == counts["distinct"] == sum(recount)
    assert counts["engaged_sent"] == sum(buckets)
    assert _reader("bucket_fill_pct.window")(ctx) == pytest.approx(
        100.0 * sum(recount) / sum(buckets))
    # and window by window, each in a session of its own
    for window, distinct, bucket in zip(pool[:2], recount, buckets):
        with profile(activities=[ProfilerActivity.CPU]):
            driver.stream(assign, window[None], None, common.Spans())
        counts = program.record({"records": {"windows": 1}}).dedup()
        assert (counts["engaged_distinct"], counts["engaged_sent"]) == (distinct, bucket)
