"""Reading a ``torch.profiler`` Chrome trace: device operations, the benchmark's host ranges, idle time.

Times in a trace are microseconds on one clock for the host and the device. The benchmark opens a
``record_function`` range around each of its own calls (``bench.update``, ``bench.compute``,
``bench.read_values``, ``bench.reset``) and around each pass (``bench.pass``).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
HOST_SPANS = ("bench.update", "bench.compute", "bench.read_values", "bench.reset")

Interval = Tuple[float, float]


class Trace:
    """The complete events of one Chrome trace, sorted into what the readers ask for."""

    def __init__(self, events: Iterable[dict]) -> None:
        self.events = [e for e in events if e.get("ph") == "X"]
        self.device_ops = [e for e in self.events if e.get("cat") in DEVICE_CATEGORIES]
        self.kernels = [e for e in self.device_ops if e.get("cat") == "kernel"]

    @classmethod
    def load(cls, path: Path) -> "Trace":
        with open(path) as f:
            return cls(json.load(f).get("traceEvents", []))

    def ranges(self, name: str) -> List[dict]:
        """The host ``record_function`` ranges named ``name``."""
        return [e for e in self.events if e.get("cat") == "user_annotation" and e.get("name") == name]

    def kernels_inside(self, range_name: str) -> List[dict]:
        """The kernels launched inside a host range named ``range_name``: a kernel counts when the runtime or
        driver call that launched it (the event with its ``correlation`` id) starts within the range on the
        range's thread."""
        ranges = self.ranges(range_name)
        launches = {e["args"]["correlation"]: e for e in self.events
                    if e.get("cat") in _LAUNCH_CATEGORIES and "correlation" in e.get("args", {})}
        out = []
        for kernel in self.kernels:
            launch = launches.get(kernel.get("args", {}).get("correlation"))
            if launch is not None and any(
                r["pid"] == launch["pid"] and r["tid"] == launch["tid"]
                and r["ts"] <= launch["ts"] <= r["ts"] + r["dur"] for r in ranges
            ):
                out.append(kernel)
        return out

    def window(self) -> Interval:
        """From the start of the first ``bench.pass`` range to the end of the last."""
        passes = self.ranges("bench.pass")
        if not passes:
            raise ValueError("the trace holds no bench.pass range")
        return min(p["ts"] for p in passes), max(p["ts"] + p["dur"] for p in passes)


def named(events: Iterable[dict], names: Iterable[str]) -> List[dict]:
    """The events whose name contains one of ``names``."""
    names = tuple(names)
    return [e for e in events if any(n in e.get("name", "") for n in names)]


def total_us(events: Iterable[dict]) -> float:
    return float(sum(e["dur"] for e in events))


def merge(intervals: Iterable[Interval], lo: float, hi: float) -> List[Interval]:
    """The union of ``intervals`` clipped to [lo, hi], as sorted disjoint intervals."""
    out: List[List[float]] = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_idle(device_ops: Iterable[dict], lo: float, hi: float) -> Tuple[float, List[Interval]]:
    """Microseconds in [lo, hi] in which some device operation ran, and the gaps in which none did."""
    busy = merge(((e["ts"], e["ts"] + e["dur"]) for e in device_ops), lo, hi)
    gaps, t = [], lo
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = b
    if hi > t:
        gaps.append((t, hi))
    return float(sum(b - a for a, b in busy)), gaps


def host_span_at(spans: Dict[str, List[dict]], t: float) -> str:
    """The benchmark's host range open at time ``t`` (``other`` when none is)."""
    for name, ranges in spans.items():
        if any(r["ts"] <= t < r["ts"] + r["dur"] for r in ranges):
            return name.split(".", 1)[1]
    return "other"


def breakdown(trace: Trace, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time, and the idle time by what the host was doing, in seconds
    over the traced window."""
    lo, hi = trace.window()
    by_op: Dict[str, float] = {}
    for e in trace.device_ops:
        if lo <= e["ts"] < hi:
            by_op[e["name"]] = by_op.get(e["name"], 0.0) + e["dur"]
    _, gaps = busy_idle(trace.device_ops, lo, hi)
    spans = {name: trace.ranges(name) for name in HOST_SPANS}
    by_host: Dict[str, float] = {}
    for a, b in gaps:
        key = host_span_at(spans, (a + b) / 2)
        by_host[key] = by_host.get(key, 0.0) + (b - a)

    def rank(d: Dict[str, float]) -> list:
        return [[k[:160], v * 1e-6] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": rank(by_op), "idle_gaps": rank(by_host)}
