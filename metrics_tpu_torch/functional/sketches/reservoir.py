"""Seeded bottom-k reservoir sampling with an exactly mergeable fixed state.

Counterpart of ``metrics_tpu/functional/sketches/reservoir.py``. Every value
gets a priority, a seeded hash of it, and the state keeps the k values of
smallest priority: a rank filter over the stream, so any split, merge order
or grouping reproduces the single pass bit for bit. The state is one (3, k)
float32 tensor of rows ``[prio_hi, prio_lo, value]``, the two 16-bit halves
of the priority exact in float32; empty slots carry ``prio_hi = 65536`` and
sort after every live element.

The JAX package orders the rows with ``lexsort((value, lo, hi))``; the port
takes two stable sorts, by value and then by the int64 key ``hi * 65536 +
lo``. The value key counts ``-0.0`` and subnormals as ``+0.0``, as the JAX
package's sort does (a CUDA radix sort orders ``-0.0`` first), and the rows
keep their original values.
"""

from __future__ import annotations

import torch

from metrics_tpu_torch.functional.sketches.hashing import hash32
from metrics_tpu_torch.utils.compute import _flush_subnormals

__all__ = [
    "EMPTY_PRIORITY_HI",
    "reservoir_empty",
    "reservoir_fold",
    "reservoir_merge",
    "reservoir_values",
]

EMPTY_PRIORITY_HI = 65536.0  # real halves are <= 65535; empties sort last


def reservoir_empty(k: int) -> torch.Tensor:
    """The (3, k) all-empty packed state, on the CPU."""
    if k < 1:
        raise ValueError(f"`k` must be >= 1, got {k}")
    packed = torch.zeros((3, k), dtype=torch.float32)
    packed[0] = EMPTY_PRIORITY_HI
    return packed


def _bottom_k(packed: torch.Tensor, k: int) -> torch.Tensor:
    """Columns with the k smallest (hi, lo, value) keys, in that order, as a (3, k) state."""
    hi, lo, val = packed[0], packed[1], packed[2]
    value_key = _flush_subnormals(val)
    by_value = torch.sort(torch.where(value_key == 0, torch.zeros_like(val), value_key), stable=True).indices
    key = hi.to(torch.int64) * 65536 + lo.to(torch.int64)
    order = by_value[torch.sort(key[by_value], stable=True).indices[:k]]
    return packed[:, order]


def reservoir_fold(packed: torch.Tensor, values: torch.Tensor, valid: torch.Tensor, *, seed: int = 0) -> torch.Tensor:
    """Fold one batch into the packed state: the bottom k of (state ∪ batch)."""
    k = packed.shape[1]
    v = values.to(torch.float32).reshape(-1)
    ok = torch.as_tensor(valid, dtype=torch.bool, device=v.device).reshape(-1) & torch.isfinite(v)
    h = hash32(v, seed)
    hi = torch.where(ok, (h >> 16).to(torch.float32), EMPTY_PRIORITY_HI)
    lo = torch.where(ok, (h & 0xFFFF).to(torch.float32), 0.0)
    batch = torch.stack([hi, lo, torch.where(ok, v, 0.0)])
    return _bottom_k(torch.cat([packed, batch], dim=1), k)


def reservoir_merge(stacked: torch.Tensor) -> torch.Tensor:
    """Reduce (s, 3, k) stacked shard states to one (3, k) bottom-k state.

    The ``dist_reduce_fx`` of ``ReservoirSample``, declared
    ``merge_associative=True``: the bottom k of a union does not depend on the
    shards' order or grouping.
    """
    k = stacked.shape[-1]
    return _bottom_k(stacked.movedim(0, 1).reshape(3, -1), k)


def reservoir_values(packed: torch.Tensor) -> torch.Tensor:
    """Sampled values, (k,) float32; unfilled slots read 0.0."""
    return torch.where(packed[0] < EMPTY_PRIORITY_HI, packed[2], 0.0)
