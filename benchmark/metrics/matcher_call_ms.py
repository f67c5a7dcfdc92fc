"""Median host time of the device matcher's call in a window's dispatch:
rows to the device, the kernel's launch and the gates, queued (program span
``fqtk.matcher``)."""

from benchmark.program import median_ms


def read(ctx):
    return median_ms(ctx, "fqtk.matcher")
