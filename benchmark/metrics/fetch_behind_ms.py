"""Median host time of a window's fetch after its own device work has
finished: the D2H copy and the wait behind work queued on the stream after
the window's own, such as the next window's kernel (program span
``fqtk.fetch.copy``, which starts once ``fqtk.fetch.own`` has waited on the
window's event)."""

from benchmark.program import median_ms


def read(ctx):
    return median_ms(ctx, "fqtk.fetch.copy")
