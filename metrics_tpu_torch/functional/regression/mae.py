"""Mean absolute error (counterpart of ``metrics_tpu/functional/regression/mae.py``)."""

from __future__ import annotations

from typing import Tuple, Union

import torch

from metrics_tpu_torch.utils.checks import _check_same_shape

Tensor = torch.Tensor


def _mean_absolute_error_update(preds: Tensor, target: Tensor, num_outputs: int = 1) -> Tuple[Tensor, int]:
    """The sum of absolute errors (in float32) and the number of observations."""
    _check_same_shape(preds, target)
    if num_outputs == 1:
        preds = preds.reshape(-1)
        target = target.reshape(-1)
    return torch.sum(torch.abs(preds.to(torch.float32) - target.to(torch.float32)), dim=0), target.shape[0]


def _mean_absolute_error_compute(sum_abs_error: Tensor, total: Union[int, Tensor]) -> Tensor:
    """MAE."""
    return sum_abs_error / total


def mean_absolute_error(preds: Tensor, target: Tensor, num_outputs: int = 1) -> Tensor:
    """Mean absolute error.

    >>> x = torch.tensor([0., 1., 2., 3.])
    >>> y = torch.tensor([0., 1., 2., 1.])
    >>> mean_absolute_error(x, y)
    tensor(0.5000)
    """
    sum_abs_error, total = _mean_absolute_error_update(preds, target, num_outputs)
    return _mean_absolute_error_compute(sum_abs_error, total)
