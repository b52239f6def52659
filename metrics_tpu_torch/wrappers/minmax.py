"""Running min and max of a metric's value (counterpart of ``metrics_tpu/wrappers/minmax.py``)."""

from __future__ import annotations

from typing import Any, Dict

import torch

from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.wrappers.abstract import WrapperMetric, wrapped_device

__all__ = ["MinMaxMetric"]


class MinMaxMetric(WrapperMetric):
    """The base metric's value with its least and greatest values over the updates so far.

    Each update computes the base metric (whose value must be a scalar) and
    folds it into the ``min_val``/``max_val`` states (float32, reduced by min
    and max across ranks), on the device: no host read.

    >>> from metrics_tpu_torch.classification import BinaryAccuracy
    >>> metric = MinMaxMetric(BinaryAccuracy(device="cpu"))
    >>> metric.update(torch.tensor([1, 0, 1, 1]), torch.tensor([1, 0, 1, 0]))
    >>> sorted(metric.compute())
    ['max', 'min', 'raw']
    """

    full_state_update = True

    def __init__(self, base_metric: Metric, **kwargs: Any) -> None:
        if not isinstance(base_metric, Metric):
            raise ValueError(
                f"Expected base metric to be an instance of `metrics_tpu_torch.Metric` but received {base_metric}"
            )
        kwargs["device"] = wrapped_device([base_metric], kwargs.get("device"))
        super().__init__(**kwargs)
        self._base_metric = base_metric
        self.add_state("min_val", torch.tensor(float("inf")), dist_reduce_fx="min")
        self.add_state("max_val", torch.tensor(float("-inf")), dist_reduce_fx="max")

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Update the base metric, then fold its new value into the min and max."""
        self._base_metric.update(*args, **kwargs)
        val = self._base_metric.compute()
        if not self._is_suitable_val(val):
            raise RuntimeError(f"Returned value from base metric should be a float or scalar tensor, but got {val}")
        val = torch.as_tensor(val, dtype=torch.float32, device=self.device).reshape(())
        self.max_val = torch.maximum(self.max_val, val)
        self.min_val = torch.minimum(self.min_val, val)

    def forward(self, *args: Any, **kwargs: Any) -> Dict[str, torch.Tensor]:
        """One update, then the current raw, min and max values (the base metric is fed once)."""
        self.update(*args, **kwargs)
        return self.compute()

    def compute(self) -> Dict[str, torch.Tensor]:
        """``{"raw": the base metric's value, "max": ..., "min": ...}``."""
        return {"raw": self._base_metric.compute(), "max": self.max_val, "min": self.min_val}

    def reset(self) -> None:
        """Reset the wrapper's states and the base metric."""
        super().reset()
        self._base_metric.reset()

    @staticmethod
    def _is_suitable_val(val: Any) -> bool:
        if isinstance(val, (int, float)):
            return True
        return isinstance(val, torch.Tensor) and val.numel() == 1
