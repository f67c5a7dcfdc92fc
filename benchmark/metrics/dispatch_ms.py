"""Median host time of ``assign(rows)`` over the window's windows: the
window dedup and the host half of the Hopper matcher's call (a benchmark
span around the dispatch)."""

import statistics


def read(ctx):
    spans = ctx["records"].get("dispatch_s")
    return statistics.median(spans) * 1e3 if spans else None
