"""rows/s: every row folded over the whole window, with the pass-end computes inside it."""

from benchlib.readers import units_per_s as read_units


def read(records, cell):
    return read_units(records)
