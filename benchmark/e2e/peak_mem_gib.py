"""GiB: ``torch.cuda.max_memory_allocated()`` over the window (reset at its start), less the bytes of the
benchmark's own inputs on the card; the highest rank in a world of ranks."""


def read(records, cell):
    if any("peak_bytes" not in r for r in records):
        return None
    return max(r["peak_bytes"] - r["input_bytes"] for r in records) / 2**30
