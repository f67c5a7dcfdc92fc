"""The window fetch (``fqtk_tpu_torch.runtime.demux._Pending``): a result on
the CPU is handed out as ``.cpu().numpy()`` hands it, with and without the
dedup's ``finish``; a result on a card is copied to pinned memory right
after its own work and fetched behind its own event only (faked here, on
the card under ``-m gpu``); arrays handed out never change after a later
window; and the fetch counts reach ``_matcher_counts``."""

import time
from pathlib import Path

import numpy as np
import pytest
import torch

from fqtk_tpu_torch.ops.device_encoding import pack_bit2
from fqtk_tpu_torch.ops.matcher import ExpectedSet
from fqtk_tpu_torch.runtime import demux

L = 16
ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


def _whitelist(k, seed=0):
    rng = np.random.default_rng(seed)
    barcodes = set()
    while len(barcodes) < k:
        barcodes.add(bytes(rng.choice(ACGT, size=L)).decode())
    return sorted(barcodes)


def _device_side(k, device, batch):
    barcodes = _whitelist(k)
    cfg = demux.DemuxConfig(
        inputs=[], read_structures=[], sample_metadata=Path(), output=Path(),
        max_mismatches=1, min_mismatch_delta=2, batch_size=batch, matcher="device",
        devices=1, device=device,
    )
    assign, pack_mode, _ = demux._build_device_side(cfg, ExpectedSet.from_barcodes(barcodes))
    assert pack_mode == "bit2"
    ascii_rows = np.frombuffer("".join(barcodes).encode(), dtype=np.uint8).reshape(-1, L)
    return assign, ascii_rows


def _window(ascii_rows, n, seed, clustered):
    """``n`` bit2 rows: drawn from the whitelist (the dedup engages), or
    two fifths so and the rest random (over half distinct: it declines)."""
    rng = np.random.default_rng(seed)
    rows = ascii_rows[rng.integers(0, len(ascii_rows), size=n)]
    if not clustered:
        rows[2 * n // 5:] = ACGT[rng.integers(0, 4, size=(n - 2 * n // 5, L))]
    return pack_bit2(rows)


@pytest.fixture(scope="module")
def cpu_side():
    return _device_side(64, "cpu", 8192)


@pytest.mark.parametrize("finish", [None, lambda h: h[:5][np.array([4, 0, 0, 2])]],
                         ids=["plain", "finish"])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32])
def test_cpu_result_is_handed_out_as_before(finish, dtype):
    result = torch.arange(7, dtype=dtype) * 3
    pending = demux._Pending(result, finish=finish, keep=np.zeros(3))
    assert pending.event is None
    want = result.cpu().numpy()
    want = want if finish is None else finish(want)
    got = pending.fetch()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if finish is None:
        # on the CPU the array is the result's own memory, as ``.cpu().numpy()``
        assert np.shares_memory(got, result.numpy())


@pytest.mark.parametrize("clustered", [True, False], ids=["engaged", "declined"])
def test_kept_windows_never_change_after_later_fetches(cpu_side, clustered):
    assign, ascii_rows = cpu_side
    windows = [_window(ascii_rows, 8192, seed, clustered) for seed in (11, 12, 13)]
    matcher = assign.device_matcher
    plain = [matcher(w)[0].numpy().copy() for w in windows]
    assert not all(np.array_equal(plain[0], p) for p in plain[1:])
    engaged = assign.dedup.engaged
    kept, at_fetch, pending = [], [], None
    for w in windows + [None]:  # dispatch window n+1, then fetch window n
        fut = assign(w) if w is not None else None
        if pending is not None:
            kept.append(pending.fetch())
            at_fetch.append(kept[-1].copy())
        pending = fut
    assert assign.dedup.engaged - engaged == (3 if clustered else 0)
    for got, then in zip(kept, at_fetch):
        np.testing.assert_array_equal(got, then)
    for got, want in zip(kept, plain):
        np.testing.assert_array_equal(got, want)
    assert not any(np.shares_memory(a, b) for i, a in enumerate(kept) for b in kept[i + 1:])


def test_fetch_counts_reach_matcher_counts_and_read_zero_on_the_cpu(cpu_side):
    assign, ascii_rows = cpu_side
    fn, dedup, fetches = assign.device_matcher, assign.dedup, assign.fetches
    assert isinstance(fetches, demux.FetchCounts)
    before = demux._matcher_counts(fn, dedup, fetches)
    assert {"fetch_async", "fetch_waited"} <= set(before)
    for seed in (21, 22):
        assign(_window(ascii_rows, 8192, seed, True)).fetch()
    stats = demux._run_counts(fn, before, dedup, fetches)
    assert stats["fetch_async"] == 0 and stats["fetch_waited"] == 0
    assert stats["dedup_windows"] == 2
    # without the fetches, the counts are those of before
    assert "fetch_async" not in demux._matcher_counts(fn, dedup)


def test_fetch_counts_logged_with_the_run(caplog):
    import logging

    with caplog.at_level(logging.INFO, logger="fqtk"):
        demux._log_counts({"scheme": "tile_top2", "tile_top2_launches": 3,
                           "tile_top2_plain_calls": 0, "fetch_async": 3, "fetch_waited": 2})
    assert "window fetch: 3 from pinned copies, 2 of them waited on the device" in caplog.text


def test_card_result_copied_to_pinned_memory_behind_its_own_work(monkeypatch):
    """The order on a card, faked on the CPU: the pinned copy and then the
    event on the result's current stream at dispatch; the fetch counts,
    waits on that event alone, and hands out memory of its own."""
    log = []

    class FakeEvent:
        def __init__(self):
            self.done = False

        def record(self, stream):
            log.append(("record", stream))

        def query(self):
            return self.done

        def synchronize(self):
            log.append(("synchronize",))
            self.done = True

    class CardResult:
        is_cuda = True
        device = torch.device("cuda", 0)

        def __init__(self, values):
            self.values = values
            self.shape, self.dtype = values.shape, values.dtype

    class Pinned:
        def __init__(self, shape, dtype):
            self.tensor = torch.full(shape, -1, dtype=dtype)

        def copy_(self, src, non_blocking=False):
            log.append(("copy", non_blocking))
            self.tensor.copy_(src.values)
            return self

        def cpu(self):
            return self.tensor

    def empty(shape, dtype, pin_memory=False):
        assert pin_memory
        log.append(("pinned", tuple(shape)))
        return Pinned(shape, dtype)

    values = torch.arange(6, dtype=torch.int32)
    counts = demux.FetchCounts()
    with monkeypatch.context() as m:
        m.setattr(torch, "empty", empty)
        m.setattr(torch.cuda, "Event", FakeEvent)
        m.setattr(torch.cuda, "current_stream", lambda dev: f"stream of {dev}")
        waits = demux._Pending(CardResult(values), counts=counts)
        ready = demux._Pending(CardResult(values + 10), finish=lambda h: h[::-1], counts=counts)
    assert log == [("pinned", (6,)), ("copy", True), ("record", "stream of cuda:0")] * 2
    ready.event.done = True
    del log[:]
    got = waits.fetch()
    assert log == [("synchronize",)]
    np.testing.assert_array_equal(got, values.numpy())
    assert not np.shares_memory(got, waits.result.tensor.numpy())
    np.testing.assert_array_equal(ready.fetch(), (values + 10).numpy()[::-1])
    assert (counts.fetch_async, counts.fetch_waited) == (2, 1)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA events and pinned memory; run with -m gpu)")


def _sleep_cycles(ms):
    """``torch.cuda._sleep`` cycles for about ``ms`` of device time."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    end.synchronize()
    return int(10_000_000 * ms / start.elapsed_time(end))


@pytest.mark.gpu
def test_fetch_does_not_wait_on_the_next_window_on_card():
    """At the benchmark's window shape (131,072 rows, int32 results): window
    n's fetch returns while window n+1 is still queued behind ~200 ms of
    device work on the same stream, equal to the plain result; the kept
    arrays do not change after later fetches; and ``fetch_waited`` counts
    only the fetch that met unfinished work."""
    _need_card()
    b = 131_072
    assign, ascii_rows = _device_side(300, "cuda", b)
    matcher, fetches = assign.device_matcher, assign.fetches
    windows = [_window(ascii_rows, b, seed, False) for seed in (31, 32, 33)]
    plain = [matcher(w)[0].cpu().numpy() for w in windows]
    assert plain[0].dtype == np.int32 and plain[0].shape == (b,)
    cycles = _sleep_cycles(200)
    assign(windows[0]).fetch()  # warm: the pinned block, the dedup
    torch.cuda.synchronize()
    async0, waited0 = fetches.fetch_async, fetches.fetch_waited

    first = assign(windows[0])
    time.sleep(0.05)  # the first window's own work ends
    torch.cuda._sleep(cycles)
    second = assign(windows[1])
    t0 = time.perf_counter()
    got0 = first.fetch()
    took = time.perf_counter() - t0
    kept0 = got0.copy()
    assert took < 0.05, f"window n's fetch took {took * 1e3:.1f} ms behind window n+1"
    third = assign(windows[2])
    got1 = second.fetch()  # behind the sleep: it waits
    time.sleep(0.05)
    got2 = third.fetch()
    for got, want in zip((got0, got1, got2), plain):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got0, kept0)
    assert (fetches.fetch_async - async0, fetches.fetch_waited - waited0) == (3, 1)


@pytest.mark.gpu
def test_window_buckets_reuse_memory_on_card():
    """Windows of 131,072 rows whose distinct counts change from window to
    window (so does the dedup's bucket, a multiple of 128 rows): once each
    size has been seen, a second pass in another order creates no device
    memory and no pinned host memory, and every window's result equals the
    matcher's on the whole window."""
    _need_card()
    b = 131_072
    assign, _ = _device_side(300, "cuda", b)
    matcher = assign.device_matcher
    rng = np.random.default_rng(41)
    windows = []
    for nu in (22_800, 22_913, 23_050, 23_170, 4_300, 30_000, 65_536):
        pool = ACGT[rng.integers(0, 4, size=(nu, L))]
        rows = pool[np.concatenate([np.arange(nu), rng.integers(0, nu, size=b - nu)])]
        windows.append(pack_bit2(rows))
    engaged0 = assign.dedup.engaged
    for w in windows:
        assign(w).fetch()
    torch.cuda.synchronize()
    assert assign.dedup.engaged - engaged0 == len(windows)

    def created():
        device = torch.cuda.memory_stats()
        host = torch.cuda.host_memory_stats() if hasattr(torch.cuda, "host_memory_stats") else {}
        return (device.get("num_device_alloc", device["segment.all.allocated"]),
                host.get("num_host_alloc", 0))

    before = created()
    for i in rng.permutation(len(windows)).tolist() * 2:
        got = assign(windows[i]).fetch()
    torch.cuda.synchronize()
    assert created() == before
    np.testing.assert_array_equal(got, matcher(windows[i])[0].cpu().numpy())
