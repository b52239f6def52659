"""Helpers that several metric readers share."""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

from benchlib.stats import percentile


def units_per_s(records: List[Dict[str, Any]]) -> float:
    """Every unit of every pass in the window over the window's length (a pass's units counted once, however
    many ranks share them)."""
    r0 = records[0]
    return r0["units_per_pass"] * r0["passes"] / r0["window_s"]


def compute_p95_ms(records: List[Dict[str, Any]]) -> Optional[float]:
    """The 95th percentile over every pass of the window of the time from the ``compute()`` call to its
    values on the host; in a world of ranks each pass counts its slowest rank."""
    per_pass = [max(r["compute_s"][i] for r in records) for i in range(records[0]["passes"])]
    if not per_pass or any(math.isnan(t) for t in per_pass):
        return None
    return percentile(per_pass, 95) * 1e3


def mean_update_host_ms(view) -> Optional[float]:
    """Mean host time of the benchmark's span around ``update()`` over the untraced passes of the window."""
    spans = view.record["update_host_s"]
    return sum(spans) / len(spans) * 1e3 if spans else None


def idle_pct(view) -> Optional[float]:
    """The share of the traced passes in which no kernel, copy or memset ran on the rank's device."""
    if view.trace is None or not view.record.get("trace_window_s"):
        return None
    return 100.0 * (1.0 - view.record["busy_s"] / view.record["trace_window_s"])
