"""DDSketch streaming quantile metric (counterpart of ``metrics_tpu/sketches/quantile.py``)."""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import torch

from metrics_tpu_torch.functional.sketches.ddsketch import ddsketch_delta, ddsketch_gamma, ddsketch_quantiles
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.compute import count_dtype

__all__ = ["DDSketch"]


def _check_config(alpha: float, quantiles: Sequence[float], num_buckets: int) -> Tuple[float, ...]:
    """Validate the shared DDSketch arguments; returns the quantiles as floats."""
    ddsketch_gamma(alpha)  # validates alpha
    if num_buckets < 2:
        raise ValueError(f"`num_buckets` must be >= 2, got {num_buckets}")
    qs = tuple(float(q) for q in quantiles)
    if not qs or any(not 0.0 <= q <= 1.0 for q in qs):
        raise ValueError(f"`quantiles` must be non-empty values in [0, 1], got {quantiles}")
    return qs


class DDSketch(Metric):
    """Streaming quantiles with relative error at most α in O(num_buckets) memory.

    Three count states (positive and negative log-γ bucket histograms and a
    zero count), all ``sum`` algebra, so merges are exact. ``compute()``
    returns one estimate per requested quantile, each within ``alpha``
    relative error of the exact stream quantile for values inside the covered
    magnitude range.

    Args:
        alpha: relative accuracy of every estimate (bucket growth γ = (1+α)/(1−α)).
        quantiles: which quantiles ``compute()`` estimates.
        num_buckets: buckets per sign; with ``key_offset`` fixes the covered magnitudes.
        key_offset: log-γ key of bucket 0; ``None`` centres the window on magnitude 1.0
            (``-num_buckets // 2``).

    >>> metric = DDSketch(quantiles=(0.5,), num_buckets=256, device="cpu")
    >>> metric.update(torch.full((100,), 3.0))
    >>> metric.compute()
    tensor(2.9742)
    """

    is_differentiable = False
    higher_is_better = None
    full_state_update = False

    def __init__(
        self,
        alpha: float = 0.01,
        quantiles: Sequence[float] = (0.5, 0.9, 0.99),
        num_buckets: int = 2048,
        key_offset: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.quantiles = _check_config(alpha, quantiles, num_buckets)
        self.alpha = float(alpha)
        self.num_buckets = int(num_buckets)
        self.key_offset = int(-num_buckets // 2 if key_offset is None else key_offset)
        self.add_state("pos_buckets", default=torch.zeros(self.num_buckets, dtype=count_dtype()), dist_reduce_fx="sum")
        self.add_state("neg_buckets", default=torch.zeros(self.num_buckets, dtype=count_dtype()), dist_reduce_fx="sum")
        self.add_state("zero_count", default=torch.zeros((), dtype=count_dtype()), dist_reduce_fx="sum")

    def update(self, value: torch.Tensor) -> None:
        value = torch.as_tensor(value, device=self.device)
        d_pos, d_neg, d_zero = ddsketch_delta(
            value,
            torch.ones(value.shape, dtype=torch.bool, device=self.device),
            alpha=self.alpha,
            key_offset=self.key_offset,
            num_buckets=self.num_buckets,
        )
        self.pos_buckets = self.pos_buckets + d_pos
        self.neg_buckets = self.neg_buckets + d_neg
        self.zero_count = self.zero_count + d_zero

    def compute(self) -> torch.Tensor:
        return ddsketch_quantiles(
            self.pos_buckets, self.neg_buckets, self.zero_count, self.quantiles,
            alpha=self.alpha, key_offset=self.key_offset,
        )
