"""Seeded bottom-k reservoir sample metric (counterpart of ``metrics_tpu/sketches/sample.py``)."""

from __future__ import annotations

from typing import Any

import torch

from metrics_tpu_torch.functional.sketches.reservoir import (
    reservoir_empty,
    reservoir_fold,
    reservoir_merge,
    reservoir_values,
)
from metrics_tpu_torch.metric import Metric

__all__ = ["ReservoirSample"]


class ReservoirSample(Metric):
    """A k-element uniform sample of the distinct stream values, exactly mergeable.

    Bottom-k priority sampling: each value's priority is a seeded hash of it,
    and the state keeps the k smallest (priority, value) pairs in one (3, k)
    float32 tensor. The kept set is a rank filter over the stream, so any
    shard split, merge order or grouping gives the single pass bit for bit.
    ``compute()`` returns the (k,) sampled values; unfilled slots read 0.0.

    Args:
        k: sample capacity.
        seed: priority hash seed; it must match across shards for merges to be meaningful.

    >>> metric = ReservoirSample(k=4, device="cpu")
    >>> metric.update(torch.tensor([5.0, 7.0]))
    >>> metric.compute().sort().values
    tensor([0., 0., 5., 7.])
    """

    is_differentiable = False
    higher_is_better = None
    full_state_update = False

    def __init__(self, k: int = 128, seed: int = 0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if k < 1:
            raise ValueError(f"`k` must be >= 1, got {k}")
        self.k = int(k)
        self.seed = int(seed)
        # the bottom k of a union does not depend on the shards' order or grouping
        self.add_state("packed", default=reservoir_empty(self.k), dist_reduce_fx=reservoir_merge, merge_associative=True)

    def update(self, value: torch.Tensor) -> None:
        value = torch.as_tensor(value, device=self.device)
        # bottom-k is a rank filter — an order-invariant fold the static rule cannot recognize; the dynamic merge
        # harness verifies the claim
        self.packed = reservoir_fold(  # distlint: disable=DL002
            self.packed, value, torch.ones(value.shape, dtype=torch.bool, device=self.device), seed=self.seed
        )

    def compute(self) -> torch.Tensor:
        return reservoir_values(self.packed)
