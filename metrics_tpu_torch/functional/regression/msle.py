"""Mean squared log error (counterpart of ``metrics_tpu/functional/regression/msle.py``)."""

from __future__ import annotations

from typing import Tuple, Union

import torch

from metrics_tpu_torch.utils.checks import _check_same_shape

Tensor = torch.Tensor


def _mean_squared_log_error_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, int]:
    """The sum of ``(log1p(p) - log1p(t))**2`` in float32, and the number of elements."""
    _check_same_shape(preds, target)
    diff = torch.log1p(preds.to(torch.float32)) - torch.log1p(target.to(torch.float32))
    return torch.sum(diff * diff), target.numel()


def _mean_squared_log_error_compute(sum_squared_log_error: Tensor, total: Union[int, Tensor]) -> Tensor:
    """MSLE."""
    return sum_squared_log_error / total


def mean_squared_log_error(preds: Tensor, target: Tensor) -> Tensor:
    """Mean squared log error.

    >>> mean_squared_log_error(torch.tensor([0., 1., 2., 3.]), torch.tensor([0., 1., 2., 2.]))
    tensor(0.0207)
    """
    sum_squared_log_error, total = _mean_squared_log_error_update(preds, target)
    return _mean_squared_log_error_compute(sum_squared_log_error, total)
