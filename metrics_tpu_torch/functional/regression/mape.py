"""Mean absolute percentage errors (counterpart of ``metrics_tpu/functional/regression/mape.py``): MAPE, its
symmetric form and its weighted form."""

from __future__ import annotations

from typing import Tuple, Union

import torch

from metrics_tpu_torch.utils.checks import _check_same_shape

Tensor = torch.Tensor

_EPSILON = 1.17e-06


def _mean_absolute_percentage_error_update(
    preds: Tensor, target: Tensor, epsilon: float = _EPSILON
) -> Tuple[Tensor, int]:
    """The sum of ``|p - t| / max(|t|, epsilon)`` in float32, and the number of elements."""
    _check_same_shape(preds, target)
    preds, target = preds.to(torch.float32), target.to(torch.float32)
    abs_per_error = torch.abs(preds - target) / torch.clamp(torch.abs(target), min=epsilon)
    return torch.sum(abs_per_error), target.numel()


def _mean_absolute_percentage_error_compute(sum_abs_per_error: Tensor, num_obs: Union[int, Tensor]) -> Tensor:
    """MAPE."""
    return sum_abs_per_error / num_obs


def mean_absolute_percentage_error(preds: Tensor, target: Tensor) -> Tensor:
    """Mean absolute percentage error.

    >>> mean_absolute_percentage_error(torch.tensor([0.5, 1., 2., 8.]), torch.tensor([1., 2., 2., 4.]))
    tensor(0.5000)
    """
    sum_abs_per_error, num_obs = _mean_absolute_percentage_error_update(preds, target)
    return _mean_absolute_percentage_error_compute(sum_abs_per_error, num_obs)


def _symmetric_mean_absolute_percentage_error_update(
    preds: Tensor, target: Tensor, epsilon: float = _EPSILON
) -> Tuple[Tensor, int]:
    """The sum of ``2 |p - t| / max(|t| + |p|, epsilon)`` in float32, and the number of elements."""
    _check_same_shape(preds, target)
    preds, target = preds.to(torch.float32), target.to(torch.float32)
    abs_per_error = 2 * torch.abs(preds - target) / torch.clamp(torch.abs(target) + torch.abs(preds), min=epsilon)
    return torch.sum(abs_per_error), target.numel()


def symmetric_mean_absolute_percentage_error(preds: Tensor, target: Tensor) -> Tensor:
    """Symmetric mean absolute percentage error.

    >>> symmetric_mean_absolute_percentage_error(torch.tensor([0.5, 1., 2., 8.]), torch.tensor([1., 2., 2., 4.]))
    tensor(0.5000)
    """
    sum_abs_per_error, num_obs = _symmetric_mean_absolute_percentage_error_update(preds, target)
    return sum_abs_per_error / num_obs


def _weighted_mean_absolute_percentage_error_update(
    preds: Tensor, target: Tensor, epsilon: float = _EPSILON
) -> Tuple[Tensor, Tensor]:
    """``sum |p - t|`` and ``sum |t|`` in float32."""
    _check_same_shape(preds, target)
    preds = preds.reshape(-1).to(torch.float32)
    target = target.reshape(-1).to(torch.float32)
    return torch.sum(torch.abs(preds - target)), torch.sum(torch.abs(target))


def _weighted_mean_absolute_percentage_error_compute(
    sum_abs_error: Tensor, sum_scale: Tensor, epsilon: float = _EPSILON
) -> Tensor:
    """WMAPE: the summed error over the summed scale, the scale clamped below at ``epsilon``."""
    return sum_abs_error / torch.clamp(sum_scale, min=epsilon)


def weighted_mean_absolute_percentage_error(preds: Tensor, target: Tensor) -> Tensor:
    """Weighted mean absolute percentage error.

    >>> weighted_mean_absolute_percentage_error(torch.tensor([0.5, 1., 2., 8.]), torch.tensor([1., 2., 2., 4.]))
    tensor(0.6111)
    """
    sum_abs_error, sum_scale = _weighted_mean_absolute_percentage_error_update(preds, target)
    return _weighted_mean_absolute_percentage_error_compute(sum_abs_error, sum_scale)
