"""Sum-state regression metrics (counterpart of ``metrics_tpu/regression/basics.py``).

Ported so far: ``MeanSquaredError`` and ``MeanAbsoluteError``. The module's
other classes (log MSE, the percentage errors, log-cosh, Minkowski, Tweedie
deviance, CSI, NRMSE) are not ported yet.
"""

from __future__ import annotations

from typing import Any

import torch

from metrics_tpu_torch.functional.regression.mae import _mean_absolute_error_compute, _mean_absolute_error_update
from metrics_tpu_torch.functional.regression.mse import _mean_squared_error_compute, _mean_squared_error_update
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.compute import count_dtype

__all__ = ["MeanAbsoluteError", "MeanSquaredError"]

Tensor = torch.Tensor


class MeanSquaredError(Metric):
    """Mean squared error, or its root with ``squared=False``.

    >>> metric = MeanSquaredError(device="cpu")
    >>> metric.update(torch.tensor([2.5, 0.0, 2., 8.]), torch.tensor([3., -0.5, 2., 7.]))
    >>> metric.compute()
    tensor(0.3750)
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    def __init__(self, squared: bool = True, num_outputs: int = 1, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(squared, bool):
            raise ValueError(f"Expected argument `squared` to be a boolean but got {squared}")
        self.squared = squared
        if not (isinstance(num_outputs, int) and num_outputs > 0):
            raise ValueError(f"Expected num_outputs to be a positive integer but got {num_outputs}")
        self.num_outputs = num_outputs
        self.add_state("sum_squared_error", torch.zeros(num_outputs) if num_outputs > 1 else torch.zeros(()), "sum")
        self.add_state("total", torch.zeros((), dtype=count_dtype()), "sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Update state with predictions and targets."""
        sum_squared_error, num_obs = _mean_squared_error_update(preds, target, self.num_outputs)
        self.sum_squared_error = self.sum_squared_error + sum_squared_error
        self.total = self.total + num_obs

    def compute(self) -> Tensor:
        """Compute metric."""
        return _mean_squared_error_compute(self.sum_squared_error, self.total, self.squared)


class MeanAbsoluteError(Metric):
    """Mean absolute error.

    >>> metric = MeanAbsoluteError(device="cpu")
    >>> metric.update(torch.tensor([2.5, 0.0, 2., 8.]), torch.tensor([3., -0.5, 2., 7.]))
    >>> metric.compute()
    tensor(0.5000)
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    def __init__(self, num_outputs: int = 1, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not (isinstance(num_outputs, int) and num_outputs > 0):
            raise ValueError(f"Expected num_outputs to be a positive integer but got {num_outputs}")
        self.num_outputs = num_outputs
        self.add_state("sum_abs_error", torch.zeros(num_outputs) if num_outputs > 1 else torch.zeros(()), "sum")
        self.add_state("total", torch.zeros((), dtype=count_dtype()), "sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Update state with predictions and targets."""
        sum_abs_error, num_obs = _mean_absolute_error_update(preds, target, self.num_outputs)
        self.sum_abs_error = self.sum_abs_error + sum_abs_error
        self.total = self.total + num_obs

    def compute(self) -> Tensor:
        """Compute metric."""
        return _mean_absolute_error_compute(self.sum_abs_error, self.total)
