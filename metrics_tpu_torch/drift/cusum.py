"""Two-sided CUSUM change detection with a fixed-shape composable state (counterpart of ``metrics_tpu/drift/cusum.py``)."""

from __future__ import annotations

from typing import Any, Dict

import torch

from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.ops.decay import cusum_compose, cusum_segment

__all__ = ["CUSUM"]


class CUSUM(Metric):
    """Page's two-sided cumulative-sum change detector.

    Tracks ``S⁺ ← max(0, S⁺ + (x − target − k))`` and ``S⁻ ← max(0, S⁻ +
    (target − x − k))`` and alarms when either side's watermark (the highest
    its statistic got anywhere in the stream) exceeds ``h``. Each side's state
    is a (4,) float32 segment summary ``(total, statistic, max prefix,
    watermark)``; a batch folds in one prefix-sum pass, and partials compose
    exactly in stream order. The composition is not commutative, so the states
    declare no reduction (``dist_reduce_fx=None``, ``merge_associative=False``)
    and merges go through :meth:`merge_state`, the incoming (earlier) side
    first.

    ``compute()`` returns (3,) float32 ``[S⁺, S⁻, alarm]``, alarm 1.0 when
    ``max(watermark⁺, watermark⁻) > h``.

    >>> m = CUSUM(target=0.0, k=0.5, h=2.0, device="cpu")
    >>> m.update(torch.tensor([0.0, 2.0, 2.0, 0.0]))
    >>> m.compute()
    tensor([2.5000, 0.0000, 1.0000])

    Args:
        target: the in-control mean of the monitored statistic.
        k: the slack per observation, typically half the shift to detect (>= 0).
        h: the decision threshold (> 0).
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False

    def __init__(self, target: float, k: float = 0.5, h: float = 5.0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not float(k) >= 0.0:
            raise ValueError(f"`k` must be >= 0, got {k}")
        if not float(h) > 0.0:
            raise ValueError(f"`h` must be > 0, got {h}")
        self.target = float(target)
        self.k = float(k)
        self.h = float(h)
        for side in ("pos", "neg"):
            self.add_state(side, default=torch.zeros(4, dtype=torch.float32), dist_reduce_fx=None,
                           merge_associative=False)

    def update(self, value: torch.Tensor) -> None:
        v = torch.as_tensor(value, dtype=torch.float32, device=self.device).reshape(-1)
        ok = torch.isfinite(v)
        self.pos = cusum_compose(self.pos, cusum_segment(v - (self.target + self.k), ok))
        self.neg = cusum_compose(self.neg, cusum_segment((self.target - self.k) - v, ok))

    def compute(self) -> torch.Tensor:
        state = self.__dict__["_state"]
        pos, neg = state["pos"], state["neg"]
        alarm = torch.maximum(pos[3], neg[3]) > self.h
        return torch.stack([pos[1], neg[1], alarm.to(torch.float32)])

    def _merge_state_dicts(
        self, state_a: Dict[str, Any], state_b: Dict[str, Any], count_a: int, count_b: int
    ) -> Dict[str, Any]:
        # `state_a` is the stream-earlier side wherever this runs: merge_state folds the incoming state first,
        # and forward folds the running state before the batch's
        return {"pos": cusum_compose(state_a["pos"], state_b["pos"]), "neg": cusum_compose(state_a["neg"], state_b["neg"])}
