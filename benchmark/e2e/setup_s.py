"""s: from the start of the (rank 0) process to the first timed call: imports, the card, the kernels loaded
or built, the inputs made on the card and one warm pass."""


def read(records, cell):
    return records[0]["setup_s"]
