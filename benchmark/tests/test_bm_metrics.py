"""The roofline arithmetic on hand-worked shapes, the trace reduction on
hand-made events, and the per-layer readers."""

from __future__ import annotations

import pytest

from benchmark import common, peaks, roofline, trace

H100 = "NVIDIA H100 80GB HBM3"


def _reader(name):
    return common.load_module(common.metric_path(name), "metric").read


def test_ops_and_bytes_by_hand():
    # 2 rows x 3 barcodes x 4 positions x 8 operations
    assert roofline.matcher_ops(2, 3, 4) == 192
    # 16 bases: 4 bytes a row and a barcode, 4 bytes a result
    assert roofline.matcher_bytes(2, 3, 16) == 2 * 4 + 3 * 4 + 2 * 4
    assert roofline.matcher_bytes(1, 1, 17) == 5 + 5 + 4
    assert roofline.least_seconds(10.0, 3.0, 5.0, 1.0) == 3.0
    assert roofline.least_seconds(10.0, 1.0, 5.0, 1.0) == 2.0


def test_the_whitelist_window_is_operation_bound():
    ops = roofline.matcher_ops(32768, 6794880, 16)
    nbytes = roofline.matcher_bytes(32768, 6794880, 16)
    p = peaks.PEAKS[H100]
    t = roofline.least_seconds(ops, nbytes, p["int8_ops_per_s"], p["hbm_bytes_per_s"])
    assert t == pytest.approx(8 * 32768 * 6794880 * 16 / 1978.9e12)
    # the kernels table's 14.40 ms bound at this shape, less the pad columns
    assert t == pytest.approx(14.40e-3, rel=0.002)


def _summary(kernel_s, window_s=1.0, busy_s=None):
    return trace.TraceSummary(window_s=window_s, busy_s=kernel_s if busy_s is None else busy_s,
                              kernel_s=kernel_s)


def test_roofline_reader():
    read = _reader("matcher_roofline_pct.window")
    rec = {"distinct_rows": [32768, 16384], "k": 6794880, "length": 16}
    dev = {"kind": H100}
    least = (8 * 49152 * 6794880 * 16) / 1978.9e12
    got = read({"records": rec, "trace": _summary(0.05), "device": dev})
    assert got == pytest.approx(100 * least / 0.05)
    assert read({"records": rec, "trace": None, "device": dev}) is None
    assert read({"records": rec, "trace": _summary(0.0), "device": dev}) is None
    assert read({"records": rec, "trace": _summary(0.05), "device": {"kind": "cpu"}}) is None
    assert read({"records": {}, "trace": _summary(0.05), "device": dev}) is None


@pytest.mark.parametrize("split", ["window", "uniform"])
def test_idle_and_dispatch_readers(split):
    tr = _summary(0.2, window_s=2.0, busy_s=0.5)
    idle = _reader(f"device_idle_pct.{split}")
    assert idle({"records": {"windows": 3}, "trace": tr, "device": {}}) == pytest.approx(75.0)
    assert idle({"records": {"windows": 3}, "trace": None, "device": {}}) is None
    dispatch = _reader(f"dispatch_ms.{split}")
    assert dispatch(
        {"records": {"dispatch_s": [0.001, 0.003, 0.002]}, "trace": None, "device": {}}) == 2.0
    assert dispatch({"records": {}, "trace": None, "device": {}}) is None


def test_a_split_metric_finds_the_reader_of_its_quantity(tmp_path):
    assert common.metric_path("dispatch_ms.uniform").name == "dispatch_ms.py"
    assert common.metric_path("matcher_roofline_pct.window").name == "matcher_roofline_pct.py"
    # a reader of the full name, where one exists, comes first
    (tmp_path / "benchmark" / "metrics").mkdir(parents=True)
    own = tmp_path / "benchmark" / "metrics" / "dispatch_ms.uniform.py"
    own.write_text("def read(ctx):\n    return 1.0\n")
    assert common.metric_path("dispatch_ms.uniform", tmp_path) == own
    assert common.metric_path("dispatch_ms.window", tmp_path).name == "dispatch_ms.py"


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_trace_summary_by_hand():
    events = [
        _x("user_annotation", trace.WINDOW_SPAN, 1000, 1000),
        _x("user_annotation", "dispatch", 1000, 300),
        _x("user_annotation", "fetch", 1500, 400),
        _x("kernel", "tile_top2", 900, 300),       # clipped to 1000-1200
        _x("gpu_memcpy", "Memcpy HtoD", 1150, 100),  # overlaps: busy to 1250
        _x("kernel", "tile_top2", 1600, 200),
        _x("gpu_user_annotation", "dispatch", 1000, 1000),  # not device activity
        _x("cpu_op", "aten::where", 1000, 5),
    ]
    s = trace.summarize(events)
    assert s.window_s == pytest.approx(1e-3)
    assert s.busy_s == pytest.approx(450e-6)
    assert s.kernel_s == pytest.approx(400e-6)
    assert s.device_ops == pytest.approx({"tile_top2": 400e-6, "Memcpy HtoD": 100e-6})
    # gaps 1250-1600 (middle 1425: no span) and 1800-2000 (middle 1900: fetch ends at 1900)
    assert s.idle_by_span == pytest.approx({"outside spans": 350e-6, "fetch": 200e-6})
    b = s.breakdown()
    assert b["device_ops"][0] == ["tile_top2", pytest.approx(400e-6)]
    assert trace.summarize([_x("kernel", "k", 0, 1)]) is None
