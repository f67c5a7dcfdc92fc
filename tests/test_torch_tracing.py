"""The port's program spans and counters (``fqtk_tpu_torch.utils.profiling``):
off with no profiler recording, named and nested under a CPU
``torch.profiler``, one record per session, set-up spans always, and the
window dedup's counts against a hand-computed dedup."""

import gzip
import json
import logging
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fqtk_tpu_torch.io import native as native_io
from fqtk_tpu_torch.ops import hopper_matcher as hm
from fqtk_tpu_torch.ops.device_encoding import pack_bit2
from fqtk_tpu_torch.ops.matcher import ExpectedSet
from fqtk_tpu_torch.runtime import demux
from fqtk_tpu_torch.utils import profiling
from fqtk_tpu_torch.utils.profiling import TRACER, StageTimers

L = 16
WINDOW_SPANS = {"fqtk.dedup.unique", "fqtk.dedup.gather", "fqtk.matcher", "fqtk.matcher.h2d",
                "fqtk.matcher.launch", "fqtk.matcher.gate", "fqtk.fetch.own",
                "fqtk.fetch.copy", "fqtk.dedup.scatter"}


def _whitelist(k=64, seed=0):
    rng = np.random.default_rng(seed)
    return sorted({"".join(rng.choice(list("ACGT"), size=L)) for _ in range(k)})


@pytest.fixture(autouse=True)
def _fresh_session():
    """Each test's profiling sessions open records of their own (a read
    closes the record an earlier test may have left open)."""
    TRACER.program_record()


@pytest.fixture(scope="module")
def side():
    """The device side the demux builds for ``--matcher device`` on the CPU,
    and its whitelist as ASCII rows."""
    barcodes = _whitelist()
    expected = ExpectedSet.from_barcodes(barcodes)
    cfg = demux.DemuxConfig(
        inputs=[], read_structures=[], sample_metadata=Path(), output=Path(),
        max_mismatches=1, min_mismatch_delta=2, batch_size=8192, matcher="device",
        devices=1, device="cpu",
    )
    assign, pack_mode, _ = demux._build_device_side(cfg, expected)
    assert pack_mode == "bit2"
    ascii_rows = np.frombuffer("".join(barcodes).encode(), dtype=np.uint8).reshape(-1, L)
    return assign, ascii_rows


def _clustered(ascii_rows, n=8192, seed=1):
    """A window of ``n`` rows drawn from the whitelist (the dedup engages)."""
    rng = np.random.default_rng(seed)
    return pack_bit2(ascii_rows[rng.integers(0, len(ascii_rows), size=n)])


def _distinct(n=8192, seed=2):
    """A window of ``n`` random rows, nearly all distinct (it declines)."""
    rng = np.random.default_rng(seed)
    return pack_bit2(np.frombuffer(b"ACGT", dtype=np.uint8)[rng.integers(0, 4, size=(n, L))])


def _stream(assign, windows):
    """Dispatch window n+1, then fetch window n, as the demux loop does."""
    out, pending = [], None
    for w in windows:
        fut = assign(w)
        if pending is not None:
            out.append(pending.fetch())
        pending = fut
    out.append(pending.fetch())
    return out


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        result = fn()
    return prof, result


def test_no_profiler_enters_no_range_records_no_span_and_no_event(side, monkeypatch):
    assign, ascii_rows = side

    def refuse(*a, **k):
        raise AssertionError("called with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    before = TRACER.program_record()
    n_spans = len(before.spans) if before is not None else 0
    got = _stream(assign, [_clustered(ascii_rows), _distinct(), _clustered(ascii_rows)[:1000]])
    assert [len(g) for g in got] == [8192, 8192, 1000]
    assert TRACER.program_record() is before
    assert (len(before.spans) if before is not None else 0) == n_spans
    assert TRACER.window is None
    with profiling.StageTimers().time("assign"):
        pass


def test_profiled_windows_give_named_nested_spans(side, tmp_path):
    assign, ascii_rows = side
    windows = [_clustered(ascii_rows, seed=s) for s in (3, 4)] + [_distinct()]
    plain = _stream(assign, windows)
    prof, traced = _profiled(lambda: _stream(assign, windows))
    for a, b in zip(plain, traced):
        np.testing.assert_array_equal(a, b)
    rec = TRACER.program_record()
    assert rec.closed and len(rec.windows) == 3
    by_window = {w: [s for s in rec.spans if s.window == w] for w in rec.windows}
    assert sum(map(len, by_window.values())) == len(rec.spans)
    engaged, declined = rec.windows[:2], rec.windows[2]
    for w in engaged:
        assert {s.name for s in by_window[w]} == WINDOW_SPANS
    assert {s.name for s in by_window[declined]} == WINDOW_SPANS - {
        "fqtk.dedup.gather", "fqtk.dedup.scatter"}
    for spans in by_window.values():
        assert all(len([s for s in spans if s.name == n]) <= 1 for n in WINDOW_SPANS)
        named = {s.name: s for s in spans}
        outer = named["fqtk.matcher"]
        for part in ("h2d", "launch", "gate"):
            inner = named[f"fqtk.matcher.{part}"]
            assert outer.start <= inner.start <= inner.end <= outer.end
        assert named["fqtk.dedup.unique"].end <= outer.start
        assert named["fqtk.fetch.own"].end <= named["fqtk.fetch.copy"].start
        assert all(s.start <= s.end for s in spans)
    # window n+1's dispatch comes before window n's fetch
    first, second = (by_window[w] for w in engaged)
    assert (max(s.end for s in second if s.name == "fqtk.matcher")
            <= min(s.start for s in first if s.name == "fqtk.fetch.own"))
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ranges = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    for name in WINDOW_SPANS:
        assert ranges.count(name) == sum(s.name == name for s in rec.spans), name


def test_counters_match_a_hand_computed_dedup(side):
    assign, ascii_rows = side
    clustered = _clustered(ascii_rows)
    distinct = _distinct()
    small = clustered[:1000]
    counts = [len(np.unique(w.view(np.uint32))) for w in (clustered, distinct)]
    assert counts[0] <= 64 and counts[1] > 4096
    before = demux._matcher_counts(assign.device_matcher, assign.dedup)
    _, _ = _profiled(lambda: _stream(assign, [clustered, distinct, small]))
    after = demux._matcher_counts(assign.device_matcher, assign.dedup)
    diff = {k: after[k] - before[k] for k in after if k.startswith("dedup_")}
    assert diff == {
        "dedup_windows": 3, "dedup_engaged": 1, "dedup_declined": 1,
        "dedup_rows_in": 8192 * 2 + 1000, "dedup_distinct": sum(counts),
        # the engaged window's bucket (4,096 at least), every row of the others
        "dedup_rows_sent": 4096 + 8192 + 1000,
        "dedup_engaged_distinct": counts[0], "dedup_engaged_sent": 4096,
        # both examined windows: 4-byte keys and 13 bits of row fit one word
        "dedup_sorted": 2,
    }
    # the session's record reads the same counts over its windows
    rec = TRACER.program_record()
    assert len(rec.windows) == 3
    assert {f"dedup_{k}": v for k, v in rec.dedup().items()} == diff
    stats = demux._run_counts(assign.device_matcher, before, assign.dedup)
    assert {k: v for k, v in stats.items() if k.startswith("dedup_")} == diff
    # windows after the session are not the session's
    _stream(assign, [clustered])
    assert rec.dedup()["windows"] == 3


def test_setup_spans_recorded_outside_any_profiler():
    assert not profiling.tracing()
    expected = ExpectedSet.from_barcodes(_whitelist(40, seed=5))
    hm.hopper_state_from_numpy(expected, "cpu")
    setup = TRACER.setup
    parent = setup["fqtk.setup.expected"]
    for part in ("empty", "encode", "lengths", "nocalls", "masks"):
        child = setup[f"fqtk.setup.expected.{part}"]
        assert child.calls == 1 and parent.start <= child.start
        assert child.seconds <= parent.seconds
    table = setup["fqtk.setup.table"]
    assert table.calls == 1 and parent.start + parent.seconds <= table.start
    for part in ("compat", "upload", "pack"):
        child = setup[f"fqtk.setup.table.{part}"]
        assert table.start <= child.start and child.seconds <= table.seconds
    assert profiling.setup_seconds("fqtk.setup.table") == table.seconds > 0
    # a later set-up replaces the spans of its names
    ExpectedSet.from_barcodes(_whitelist(8, seed=6))
    assert setup["fqtk.setup.expected"].start > table.start
    assert setup["fqtk.setup.expected"].calls == 1


def test_table_span_covers_every_shard_of_a_mesh():
    """A 1 x 2 whitelist mesh builds two tables inside one
    ``fqtk.setup.table``: its parts are summed over both shards."""
    from fqtk_tpu_torch.parallel import mesh

    expected = ExpectedSet.from_barcodes(_whitelist(48, seed=8))
    m = mesh.make_demux_mesh(1, 2, devices=[torch.device("cpu")] * 2)
    fn = mesh.make_sharded_assign_fn(expected, 1, 2, m, packed2=True, use_kernels=True)
    assert fn.k_per_shard == 24
    setup = TRACER.setup
    table = setup["fqtk.setup.table"]
    parts = [setup[f"fqtk.setup.table.{p}"] for p in ("compat", "upload", "pack")]
    assert table.calls == 1 and [p.calls for p in parts] == [2, 2, 2]
    assert sum(p.seconds for p in parts) <= table.seconds
    # one state alone, after it, is a set-up of its own
    hm.hopper_state_from_numpy(expected, "cpu")
    assert setup["fqtk.setup.table"] is not table
    assert [setup[f"fqtk.setup.table.{p}"].calls for p in ("compat", "upload", "pack")] == [1, 1, 1]


def test_setup_span_waits_for_its_device_events_only_when_read(monkeypatch):
    """On a card a set-up span holds the device work queued in it: two
    events, waited on when its seconds are read, not by the program."""
    log = []

    class FakeEvent:
        def __init__(self, enable_timing=False):
            assert enable_timing

        def record(self, stream):
            log.append(("record", stream))

        def synchronize(self):
            log.append(("synchronize",))

        def elapsed_time(self, end):
            return 5_000.0  # ms: the device ran on 5 s after the host was done

    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: f"stream of {dev}")
    tracer = profiling.Tracer()
    with tracer.setup_span("fqtk.setup.table", torch.device("cuda", 0)):
        with tracer.setup_span("fqtk.setup.table.compat"):
            pass
    assert log == [("record", "stream of cuda:0")] * 2
    assert tracer.setup["fqtk.setup.table.compat"].seconds < 1
    assert tracer.setup_seconds("fqtk.setup.table") == 5.0
    assert log[2:] == [("synchronize",)]


def test_setup_spans_log_one_line(caplog):
    tracer = profiling.Tracer()
    with tracer.setup_span("fqtk.setup.expected"):
        with tracer.setup_span("fqtk.setup.expected.encode"):
            pass
    with tracer.setup_span("fqtk.setup.kernels") as counts:
        counts.update(built=0, reused=3)
    with caplog.at_level(logging.INFO, logger="fqtk"):
        tracer.log_setup(since=0.0)
        tracer.log_setup(since=float("inf"))  # none started since: no line
    [line] = [r.getMessage() for r in caplog.records]
    assert line.startswith("set-up spans: fqtk.setup.expected ")
    assert "s (encode 0.0" in line
    assert line.endswith("; fqtk.setup.kernels 0.000 s (built 0, reused 3)")


def test_setup_spans_log_in_the_order_they_started(caplog):
    """A name first seen in an earlier set-up (a table built before any
    whitelist was encoded in this process) does not lead the line."""
    tracer = profiling.Tracer()
    with tracer.setup_span("fqtk.setup.table"):
        pass
    since = time.perf_counter()
    with tracer.setup_span("fqtk.setup.expected"):
        pass
    with tracer.setup_span("fqtk.setup.table"):
        pass
    with caplog.at_level(logging.INFO, logger="fqtk"):
        tracer.log_setup(since=since)
    [line] = [r.getMessage() for r in caplog.records]
    assert line.startswith("set-up spans: fqtk.setup.expected ")
    assert "; fqtk.setup.table " in line


def test_a_second_session_sees_only_its_own_spans(side):
    assign, ascii_rows = side
    _profiled(lambda: _stream(assign, [_clustered(ascii_rows)] * 2))
    first = TRACER.program_record()
    assert len(first.windows) == 2
    _profiled(lambda: _stream(assign, [_clustered(ascii_rows)] * 3))
    second = TRACER.program_record()
    assert second is not first and len(second.windows) == 3
    assert not set(second.windows) & set(first.windows)
    assert {s.window for s in second.spans} == set(second.windows)
    assert len(first.windows) == 2 and len(first.spans) == 2 * len(WINDOW_SPANS)
    assert first.dedup()["windows"] == 2 and second.dedup()["windows"] == 3
    # unread, a session is still closed by a window dispatched after it
    _profiled(lambda: _stream(assign, [_clustered(ascii_rows)]))
    third = TRACER.record
    _stream(assign, [_clustered(ascii_rows)])
    assert third.closed and third.dedup()["windows"] == 1
    _profiled(lambda: _stream(assign, [_clustered(ascii_rows)] * 2))
    assert TRACER.record is not third and len(TRACER.program_record().windows) == 2
    assert len(third.windows) == 1


def test_stage_timers_span_only_while_profiling():
    timers = StageTimers()
    with timers.time("assign"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with timers.time("assign"):
            pass
        with timers.time("submit"):
            pass
    rec = TRACER.program_record()
    assert [s.name for s in rec.spans] == ["fqtk.stage.assign", "fqtk.stage.submit"]
    assert dict(timers.counts) == {"assign": 2, "submit": 1}
    assert set(timers.summary()) == {"assign", "submit"}


def _write_dataset(tmp, barcodes, n_reads=20_000, seed=11):
    rng = np.random.default_rng(seed)
    meta = tmp / "metadata.tsv"
    meta.write_text("sample_id\tbarcode\n"
                    + "".join(f"S{i:03d}\t{b}\n" for i, b in enumerate(barcodes)))
    choices = rng.integers(0, len(barcodes), size=n_reads)
    paths = []
    for name, part in (("i1", slice(0, 8)), ("r1", None), ("i2", slice(8, L))):
        p = tmp / f"{name}.fq.gz"
        with gzip.open(p, "wt", compresslevel=1) as fh:
            for i in range(n_reads):
                seq = "ACGTTGCA" * 3 if part is None else barcodes[choices[i]][part]
                fh.write(f"@r{i} 1:N:0:0\n{seq}\n+\n{'I' * len(seq)}\n")
        paths.append(p)
    return paths, meta


def test_demux_reports_dedup_counts_and_traces_its_stages(tmp_path, monkeypatch, caplog):
    if not native_io.available():
        pytest.skip("native library unavailable")
    monkeypatch.delenv("FQTK_DEVICE_DEDUP", raising=False)
    monkeypatch.setenv("FQTK_PROFILE_DIR", str(tmp_path / "trace"))
    barcodes = _whitelist(24, seed=9)
    paths, meta = _write_dataset(tmp_path, barcodes)
    cfg = demux.DemuxConfig(
        inputs=paths, read_structures=["8B", "24T", "8B"], sample_metadata=meta,
        output=tmp_path / "out", threads=5, batch_size=8192, matcher="device", device="cpu",
    )
    with caplog.at_level(logging.INFO, logger="fqtk"):
        res = demux.run_demux(cfg)
    m = res.matcher
    # windows of 8,192, 8,192 and 3,616 rows: the last too small to examine
    assert m["dedup_windows"] == 3 and m["dedup_engaged"] == 2 and m["dedup_declined"] == 0
    assert m["dedup_rows_in"] == 20_000 and m["dedup_distinct"] <= 2 * 24
    assert m["dedup_rows_sent"] == 2 * 4096 + 3616
    assert "window dedup: 3 windows (2 engaged, 0 declined)" in caplog.text
    assert m["dedup_sorted"] == 2 and "), 2 through the packed sort," in caplog.text
    # results on the CPU take no pinned copy
    assert m["fetch_async"] == 0 and m["fetch_waited"] == 0
    assert "window fetch: 0 from pinned copies, 0 of them waited" in caplog.text
    # the run's set-up spans, in one line
    assert "set-up spans: fqtk.setup.expected " in caplog.text
    assert "(empty " in caplog.text and ", masks " in caplog.text
    assert {"dispatch", "assign"} <= set(res.timings)
    trace = next((tmp_path / "trace").glob("fqtk_trace_*.json"))
    ranges = {e["name"] for e in json.loads(trace.read_text())["traceEvents"]
              if e.get("cat") == "user_annotation"}
    assert {"fqtk.stage.dispatch", "fqtk.stage.assign", "fqtk.dedup.unique",
            "fqtk.dedup.gather", "fqtk.matcher", "fqtk.fetch.copy"} <= ranges
