"""Reading the program's own ranges in a ``torch.profiler`` Chrome trace.

While a profiler records, the port opens a ``record_function`` range for each of its spans, named
``phase:label``: ``update:<Class>``, ``compute:<Class>``, ``sync:<Class>``, ``gather_all:<world>``,
``validate:<task>``, ``host_read:<site>`` and ``kernel:<wrapper>`` (``metrics_tpu_torch/observe/tracing.py``).
A program without them (an older commit) leaves every reader here with nothing to read: each returns an
empty list, and the metrics built on them read None.
"""

from __future__ import annotations

from typing import Dict, Iterable, List

from benchlib.trace import Interval, Trace, merge, total_us


def range_names(trace: Trace, prefix: str) -> List[str]:
    """The distinct names of the host ranges that start with ``prefix`` (``"validate:"``, ``"sync:"``)."""
    return sorted({e["name"] for e in trace.events
                   if e.get("cat") == "user_annotation" and e.get("name", "").startswith(prefix)})


def ranges_with_prefix(trace: Trace, prefix: str) -> List[dict]:
    return [r for name in range_names(trace, prefix) for r in trace.ranges(name)]


def kernels_inside_any(trace: Trace, names: Iterable[str]) -> Dict[int, dict]:
    """The kernels launched inside a range of any of ``names``, each once, by its correlation id."""
    out: Dict[int, dict] = {}
    for name in names:
        for k in trace.kernels_inside(name):
            out[k["args"]["correlation"]] = k
    return out


def device_ms_inside(trace: Trace, names: Iterable[str], excluded_prefix: str = "sync:") -> float:
    """Device milliseconds of the kernels launched inside ranges of ``names``, less those launched inside
    a range whose name starts with ``excluded_prefix`` (the exchange between ranks inside a ``compute()``)."""
    inside = kernels_inside_any(trace, names)
    for corr in kernels_inside_any(trace, range_names(trace, excluded_prefix)):
        inside.pop(corr, None)
    return total_us(inside.values()) / 1e3


def count_inside(trace: Trace, events: Iterable[dict], outer: Iterable[dict]) -> int:
    """How many of ``events`` start inside one of the ``outer`` ranges on the same thread."""
    outer = list(outer)
    return sum(1 for e in events if any(o["pid"] == e["pid"] and o["tid"] == e["tid"]
                                        and o["ts"] <= e["ts"] <= o["ts"] + o["dur"] for o in outer))


def overlap_us(a: List[Interval], b: List[Interval]) -> float:
    """Microseconds covered by both of two lists of sorted disjoint intervals."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def intervals(ranges: Iterable[dict], lo: float, hi: float) -> List[Interval]:
    """The union of ``ranges`` clipped to [lo, hi]."""
    return merge(((r["ts"], r["ts"] + r["dur"]) for r in ranges), lo, hi)
