"""The one generator of traffic: a mix's parameters to the updates each rank makes in a pass.

A pass covers a configuration's ``units_per_pass`` (rows or frames) once. They are split evenly over
the cell's ranks, one a chip (the first ``units % ranks`` ranks take one more), and each rank folds its
share in updates of the mix's ``units_per_update`` (the last one shorter), or in one update when that is
null.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple


def shard(units: int, ranks: int, rank: int) -> Tuple[int, int]:
    """The contiguous [start, stop) of ``units`` that ``rank`` of ``ranks`` holds."""
    q, r = divmod(units, ranks)
    start = rank * q + min(rank, r)
    return start, start + q + (1 if rank < r else 0)


def schedule(units_per_pass: int, mix: Dict[str, Any], rank: int = 0, ranks: int = 1) -> List[Tuple[int, int]]:
    """The [start, stop) of each update ``rank`` of ``ranks`` makes in one pass, in order."""
    if not 0 <= rank < ranks:
        raise ValueError(f"rank {rank} outside a world of {ranks}")
    start, stop = shard(units_per_pass, ranks, rank)
    step = mix.get("units_per_update") or (stop - start)
    if step < 1:
        raise ValueError(f"units_per_update must be at least 1, got {step}")
    return [(s, min(s + step, stop)) for s in range(start, stop, step)]
