"""The statistics the metrics report."""

from __future__ import annotations

import math
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile of every value (no interpolation, no median of chunks)."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    k = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[k - 1]
