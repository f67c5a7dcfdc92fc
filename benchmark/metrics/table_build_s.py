"""Set-up seconds of the device table (``hopper_state_from_numpy``: the
host compat build, the upload and ``pack_table_i8``, to the end of the
device's work; program span ``fqtk.setup.table``)."""

from benchmark.program import setup_s


def read(ctx):
    return setup_s(ctx, "fqtk.setup.table")
