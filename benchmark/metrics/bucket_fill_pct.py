"""Share of the rows the window dedup sends to the matcher that are
distinct rows, over the windows where it engaged: 100 x the sum of their
distinct rows over the sum of their buckets (the program's dedup counts
over the traced session); the rest of the bucket is pad."""

from benchmark.program import record


def read(ctx):
    rec = record(ctx)
    counts = rec.dedup() if rec is not None else None
    if not counts or not counts["engaged_sent"]:
        return None
    return 100.0 * counts["engaged_distinct"] / counts["engaged_sent"]
