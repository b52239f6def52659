"""HyperLogLog distinct-count metric (counterpart of ``metrics_tpu/sketches/cardinality.py``)."""

from __future__ import annotations

from typing import Any

import torch

from metrics_tpu_torch.functional.sketches.hll import hll_delta, hll_estimate, hll_std_error
from metrics_tpu_torch.metric import Metric

__all__ = ["HyperLogLog"]


class HyperLogLog(Metric):
    """Approximate distinct-value count in 2^p int32 registers.

    The standard error is ``1.04/√(2^p)`` for any stream length. The
    registers merge by ``max``, which is associative, commutative and
    idempotent, so shard merges and re-merges are exact.

    Args:
        p: register-index bits; 2^p registers, in [4, 16].
        seed: hash-family seed; sketches only merge meaningfully when built with the same seed.

    >>> metric = HyperLogLog(p=8, device="cpu")
    >>> metric.update(torch.arange(100))
    >>> round(float(metric.compute()))
    106
    """

    is_differentiable = False
    higher_is_better = None
    full_state_update = False

    def __init__(self, p: int = 12, seed: int = 0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not 4 <= int(p) <= 16:
            raise ValueError(f"`p` must be in [4, 16], got {p}")
        self.p = int(p)
        self.seed = int(seed)
        self.add_state("registers", default=torch.zeros(1 << self.p, dtype=torch.int32), dist_reduce_fx="max")

    @property
    def std_error(self) -> float:
        """Theoretical relative standard error of ``compute()``."""
        return hll_std_error(self.p)

    def update(self, value: torch.Tensor) -> None:
        value = torch.as_tensor(value, device=self.device)
        delta = hll_delta(value, torch.ones(value.shape, dtype=torch.bool, device=self.device), p=self.p, seed=self.seed)
        self.registers = torch.maximum(self.registers, delta)

    def compute(self) -> torch.Tensor:
        return hll_estimate(self.registers)
