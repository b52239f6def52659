"""reads/update: the program's ``host_read:*`` ranges inside the benchmark's ``update()`` ranges, per update
of the traced passes; in a world of ranks, the highest rank.

Each deliberate host read of the port (a validation's distinct values, a compute's check) opens a
``host_read:<site>`` range while a profiler records. A program that opens no ``validate:`` or ``host_read:``
range at all (one without the spans) reads nothing.
"""

from benchlib.spans import count_inside, ranges_with_prefix

NEEDS = ("profile",)


def measure(view):
    if view.trace is None or not view.record["traced_passes"]:
        return None
    reads = ranges_with_prefix(view.trace, "host_read:")
    if not reads and not ranges_with_prefix(view.trace, "validate:"):
        return None
    updates = view.record["traced_passes"] * len(view.record["update_units"])
    return count_inside(view.trace, reads, view.trace.ranges("bench.update")) / updates


def combine(values):
    return max(values)
