"""Set-up seconds of ``ExpectedSet.from_barcodes`` over the whitelist's
strings (program span ``fqtk.setup.expected``)."""

from benchmark.program import setup_s


def read(ctx):
    return setup_s(ctx, "fqtk.setup.expected")
