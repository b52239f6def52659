"""Normalized root mean squared error (counterpart of ``metrics_tpu/functional/regression/nrmse.py``)."""

from __future__ import annotations

from typing import Tuple, Union

import torch

from metrics_tpu_torch.functional.regression.mse import _mean_squared_error_update

Tensor = torch.Tensor


def _normalized_root_mean_squared_error_update(
    preds: Tensor, target: Tensor, num_outputs: int, normalization: str = "mean"
) -> Tuple[Tensor, int, Tensor]:
    """The summed squared error, the number of samples, and the batch's normaliser: the target's mean, range,
    standard deviation (ddof 0) or l2 norm."""
    sum_squared_error, num_obs = _mean_squared_error_update(preds, target, num_outputs)
    target = (target.reshape(-1) if num_outputs == 1 else target).to(torch.float32)
    if normalization == "mean":
        denom = torch.mean(target, dim=0)
    elif normalization == "range":
        denom = torch.amax(target, dim=0) - torch.amin(target, dim=0)
    elif normalization == "std":
        denom = torch.std(target, dim=0, correction=0)
    elif normalization == "l2":
        denom = torch.linalg.vector_norm(target, dim=0)
    else:
        raise ValueError(
            f"Argument `normalization` should be either 'mean', 'range', 'std' or 'l2' but got {normalization}"
        )
    return sum_squared_error, num_obs, denom


def _normalized_root_mean_squared_error_compute(
    sum_squared_error: Tensor, num_obs: Union[int, Tensor], denom: Tensor
) -> Tensor:
    """RMSE over the normaliser."""
    return torch.sqrt(sum_squared_error / num_obs) / denom


def normalized_root_mean_squared_error(
    preds: Tensor, target: Tensor, normalization: str = "mean", num_outputs: int = 1
) -> Tensor:
    """Normalized RMSE (with ``"mean"``, the scatter index).

    >>> normalized_root_mean_squared_error(torch.tensor([0., 1, 2, 3]), torch.tensor([0., 1, 2, 2]))
    tensor(0.4000)
    """
    sum_squared_error, num_obs, denom = _normalized_root_mean_squared_error_update(
        preds, target, num_outputs, normalization
    )
    return _normalized_root_mean_squared_error_compute(sum_squared_error, num_obs, denom)
