"""Driver ``window_stream``: windows of bit2 barcode rows through the
device side that ``run_demux`` builds for ``--matcher device``
(``fqtk_tpu_torch.runtime.demux._build_device_side``: the window dedup,
the H2D copy, the Hopper kernel, the D2H copy and the scatter), driven as
the demux driver loop drives it: window n+1 is dispatched before window n
is fetched.  A closed loop with one window in flight.

Configuration ``deployment``: ``whitelist_size``, ``barcode_length``,
``max_mismatches``, ``min_mismatch_delta``.  End-to-end metrics:
``window_reads_per_s`` (reads of every window fetched over the window's
wall time) and ``window_p95_ms`` (95th percentile, over every window, of
the time from its dispatch to the end of its fetch).  ``correct``: the
assignments of windows drawn from the seed, and the first and last, equal
the plain reference's (:func:`benchmark.reference.assign.assign_ball`)."""

from __future__ import annotations

import gc
import time
from pathlib import Path

import numpy as np
import torch

from benchmark.common import seed_streams
from benchmark.generators.barcodes import ascii_of_codes, random_whitelist, strings_of_ascii
from benchmark.reference.assign import BallIndex, bit2_codes

#: windows compared with the reference, drawn from the seed (with the
#: first and the last)
CHECK_WINDOWS = 24


class PoolExhausted(RuntimeError):
    pass


class _ControlPending:
    def __init__(self, result: np.ndarray) -> None:
        self.result = result

    def fetch(self) -> np.ndarray:
        return self.result


def _control(index: BallIndex, length: int, dep: dict, device: str):
    """The reference put in the program's place, looking for rivals only
    within ``max_mismatches`` (it breaks the ``min_mismatch_delta``
    guarantee)."""
    def assign(rows):
        got = index.assign(bit2_codes(rows, length, device), dep["max_mismatches"],
                           dep["min_mismatch_delta"], rival_radius=dep["max_mismatches"])[0]
        return _ControlPending(got.to(torch.int32).cpu().numpy())

    return assign


def _distinct(rows: np.ndarray, dev: torch.device) -> int:
    """Distinct rows of a window (the matcher's work)."""
    t = torch.from_numpy(rows).to(dev).long()
    return int(torch.unique((t << (8 * torch.arange(t.shape[1], device=dev))).sum(1)).numel())


def stream(assign, windows: np.ndarray, seconds, spans) -> dict:
    """Dispatch window n+1, then fetch window n, until ``seconds`` have
    passed (``None``: every window); every dispatched window is fetched."""
    results, latency, dispatch = [], [], []
    pending = None
    t0 = time.perf_counter()
    i = 0
    while i < len(windows):
        if seconds is not None and time.perf_counter() - t0 >= seconds:
            break
        t_d = time.perf_counter()
        with spans.span("dispatch"):
            fut = assign(windows[i])
        dispatch.append(time.perf_counter() - t_d)
        if pending is not None:
            with spans.span("fetch"):
                results.append(pending[0].fetch())
            latency.append(time.perf_counter() - pending[1])
        pending = (fut, t_d)
        i += 1
    if pending is not None:
        with spans.span("fetch"):
            results.append(pending[0].fetch())
        latency.append(time.perf_counter() - pending[1])
    wall = time.perf_counter() - t0
    if seconds is not None and wall < seconds:
        raise PoolExhausted(
            f"{len(windows)} windows ran out after {wall:.3f} s of {seconds} s: the traffic "
            "file's pool_reads_per_s is below the rate reached")
    return {"results": results, "latency_s": latency, "dispatch_s": dispatch, "wall_s": wall}


def run(ctx) -> dict:
    dep, traffic = ctx.config["deployment"], ctx.traffic
    dev = torch.device(ctx.device)
    k, length = int(dep["whitelist_size"]), int(dep["barcode_length"])
    s_list, s_pool, s_check = seed_streams(ctx.seed, 3)
    gen = torch.Generator(device=dev)
    gen.manual_seed(s_list)
    with ctx.spans.span("setup.whitelist"):
        wl_codes = random_whitelist(k, length, gen)
        wl_ascii = ascii_of_codes(wl_codes.cpu().numpy())
    n_windows = ctx.generator.pool_windows(traffic, ctx.seconds)
    warm = int(traffic["warmup_windows"])
    with ctx.spans.span("setup.pool"):
        gen.manual_seed(s_pool)
        pool = ctx.generator.make_pool(wl_codes, traffic, n_windows, gen)
    del wl_codes
    ctx.log(f"whitelist K {k}, L {length}; pool of {n_windows} windows of "
            f"{traffic['window_reads']} reads ({pool.nbytes} bytes)")

    if ctx.control:
        index = BallIndex(wl_ascii, dev)
        assign = _control(index, length, dep, ctx.device)
        matcher = None
    else:
        from fqtk_tpu_torch.ops.matcher import ExpectedSet
        from fqtk_tpu_torch.runtime import demux

        with ctx.spans.span("setup.expected"):
            expected = ExpectedSet.from_barcodes(strings_of_ascii(wl_ascii))
        cfg = demux.DemuxConfig(
            inputs=[], read_structures=[], sample_metadata=Path(), output=Path(),
            max_mismatches=int(dep["max_mismatches"]),
            min_mismatch_delta=int(dep["min_mismatch_delta"]),
            batch_size=int(traffic["window_reads"]), matcher="device", devices=1,
            device=ctx.device,
        )
        with ctx.spans.span("setup.device_side"):
            assign, pack_mode, _ = demux._build_device_side(cfg, expected)
        if pack_mode != "bit2":
            raise RuntimeError(f"the device side takes {pack_mode} rows, not bit2")
        matcher = assign.device_matcher
        del expected
        ctx.log(f"device side: {matcher.scheme} on {matcher.state.device}")

    with ctx.spans.span("setup.warmup"):
        stream(assign, pool[:warm], None, ctx.spans)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    launches0 = matcher.launches if matcher is not None else 0
    with ctx.window():
        # the control is not timed: it runs the whole pool
        rec = stream(assign, pool[warm:], None if ctx.control else ctx.seconds, ctx.spans)
    n_done = len(rec["results"])
    b = int(traffic["window_reads"])
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    lat = np.array(rec["latency_s"])
    ctx.log(f"{n_done} windows in {rec['wall_s']:.6f} s; latency samples {len(lat)}, "
            f"p50 {np.percentile(lat, 50) * 1e3:.3f} ms; kernel launches "
            f"{(matcher.launches - launches0) if matcher is not None else 0}")

    # the program's state goes before the reference runs on the card
    del assign, matcher
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    rng = np.random.default_rng(s_check)
    pick = set(rng.choice(n_done, size=min(CHECK_WINDOWS, n_done), replace=False).tolist())
    pick |= {0, n_done - 1}
    index = BallIndex(wl_ascii, dev)
    wrong = 0
    for w in sorted(pick):
        want = index.assign(bit2_codes(pool[warm + w], length, dev), dep["max_mismatches"],
                            dep["min_mismatch_delta"])[0].cpu().numpy()
        wrong += int((np.asarray(rec["results"][w]).astype(np.int64) != want).sum())
    ctx.log(f"compared {len(pick)} windows ({len(pick) * b} rows) with the reference")

    distinct = None
    if ctx.tracer.enabled:
        distinct = [_distinct(pool[warm + w], dev) for w in range(n_done)]
    return {
        "attempted": n_done,
        "failed": 0,
        "memory_peak_bytes": peak,
        "end_to_end": {
            "window_reads_per_s": n_done * b / rec["wall_s"],
            "window_p95_ms": float(np.percentile(lat, 95)) * 1e3,
        },
        "records": {"windows": n_done, "k": k, "length": length,
                    "dispatch_s": rec["dispatch_s"], "distinct_rows": distinct},
        "checks": {"mismatched_rows": {"value": wrong, "limit": 0}},
    }
