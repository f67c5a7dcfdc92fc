"""Median host time a window spends in the window dedup before the
matcher: its key build and ``np.unique`` (engaged or declined) and its
gather and pad (program spans ``fqtk.dedup.unique`` + ``fqtk.dedup.gather``,
summed per window)."""

from benchmark.program import median_ms


def read(ctx):
    return median_ms(ctx, "fqtk.dedup.unique", "fqtk.dedup.gather")
