"""Mean squared error (counterpart of ``metrics_tpu/functional/regression/mse.py``)."""

from __future__ import annotations

from typing import Tuple, Union

import torch

from metrics_tpu_torch.utils.checks import _check_same_shape

Tensor = torch.Tensor


def _mean_squared_error_update(preds: Tensor, target: Tensor, num_outputs: int) -> Tuple[Tensor, int]:
    """The sum of squared errors (in float32) and the number of observations."""
    _check_same_shape(preds, target)
    if num_outputs == 1:
        preds = preds.reshape(-1)
        target = target.reshape(-1)
    diff = preds.to(torch.float32) - target.to(torch.float32)
    return torch.sum(diff * diff, dim=0), target.shape[0]


def _mean_squared_error_compute(sum_squared_error: Tensor, total: Union[int, Tensor], squared: bool = True) -> Tensor:
    """MSE, or its square root (RMSE) when not ``squared``."""
    mse = sum_squared_error / total
    return mse if squared else torch.sqrt(mse)


def mean_squared_error(preds: Tensor, target: Tensor, squared: bool = True, num_outputs: int = 1) -> Tensor:
    """Mean squared error.

    >>> x = torch.tensor([0., 1., 2., 3.])
    >>> y = torch.tensor([0., 1., 2., 2.])
    >>> mean_squared_error(x, y)
    tensor(0.2500)
    """
    sum_squared_error, total = _mean_squared_error_update(preds, target, num_outputs)
    return _mean_squared_error_compute(sum_squared_error, total, squared)
