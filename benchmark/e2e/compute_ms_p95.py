"""ms: the 95th percentile over every pass of ``compute()`` until its values are on the host (the slowest
rank of each pass in a world of ranks)."""

from benchlib.readers import compute_p95_ms


def read(records, cell):
    return compute_p95_ms(records)
