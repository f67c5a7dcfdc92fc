"""The matcher's share of its roofline over the traced window: the least
time the card could take for the window's work (``benchmark.roofline``:
each window's distinct rows x K x L comparisons at 8 int8 operations, or
its bytes, against the card's published peaks in ``benchmark.peaks``),
over the summed device time of every kernel in the window (copies left
out; no kernel named)."""

from benchmark.peaks import peak
from benchmark.roofline import least_seconds, matcher_bytes, matcher_ops


def read(ctx):
    rec, tr = ctx["records"], ctx["trace"]
    distinct = rec.get("distinct_rows")
    ops_peak = peak(ctx["device"]["kind"], "int8_ops_per_s")
    bw_peak = peak(ctx["device"]["kind"], "hbm_bytes_per_s")
    if tr is None or not distinct or tr.kernel_s <= 0 or ops_peak is None:
        return None
    k, length = rec["k"], rec["length"]
    least = sum(least_seconds(matcher_ops(u, k, length), matcher_bytes(u, k, length),
                              ops_peak, bw_peak) for u in distinct)
    return 100.0 * least / tr.kernel_s
