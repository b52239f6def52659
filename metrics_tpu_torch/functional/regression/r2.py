"""R² and relative squared error (counterpart of ``metrics_tpu/functional/regression/r2.py``)."""

from __future__ import annotations

from typing import Tuple, Union

import torch

from metrics_tpu_torch.utils.checks import _check_same_shape, _is_traced
from metrics_tpu_torch.utils.prints import rank_zero_warn

Tensor = torch.Tensor


def _r2_score_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor, Tensor, int]:
    """``sum t**2``, ``sum t`` and ``sum (t - p)**2`` per output, in float32, and the number of samples."""
    _check_same_shape(preds, target)
    if preds.ndim > 2:
        raise ValueError(
            f"Expected both prediction and target to be 1D or 2D tensors, but received tensors with dimension"
            f" {tuple(preds.shape)}"
        )
    preds, target = preds.to(torch.float32), target.to(torch.float32)
    residual = target - preds
    return torch.sum(target * target, dim=0), torch.sum(target, dim=0), torch.sum(residual * residual, dim=0), \
        target.shape[0]


def _r2_score_compute(
    sum_squared_obs: Tensor,
    sum_obs: Tensor,
    rss: Tensor,
    num_obs: Union[int, Tensor],
    adjusted: int = 0,
    multioutput: str = "uniform_average",
) -> Tensor:
    """R² from the sums: an output with a constant target scores 0; ``adjusted`` falls back to the plain
    score, with a warning, when there are too few samples for it."""
    mean_obs = sum_obs / num_obs
    tss = sum_squared_obs - sum_obs * mean_obs
    cond = tss != 0
    raw_scores = 1 - (rss / torch.where(cond, tss, torch.ones_like(tss)))
    raw_scores = torch.where(cond, raw_scores, torch.zeros_like(raw_scores))
    if multioutput == "raw_values":
        r2 = raw_scores
    elif multioutput == "uniform_average":
        r2 = torch.mean(raw_scores)
    elif multioutput == "variance_weighted":
        r2 = torch.sum(tss / torch.sum(tss) * raw_scores)
    else:
        raise ValueError(
            "Argument `multioutput` must be either `raw_values`, `uniform_average` or `variance_weighted`."
            f" Received {multioutput}."
        )
    if adjusted < 0 or not isinstance(adjusted, int):
        raise ValueError("`adjusted` parameter should be an integer larger or equal to 0.")
    if adjusted != 0 and _is_traced(num_obs):
        # under vmap the count cannot be read: the adjusted score only where its denominator is positive
        # (the fallback the warnings announce eagerly), branch-free, as the JAX package does under tracing
        denom = num_obs - adjusted - 1
        adj = 1 - (1 - r2) * (num_obs - 1) / torch.clamp(denom, min=1)
        return torch.where(denom > 0, adj, r2)
    if adjusted != 0:
        n = int(num_obs)
        if n - 1 < adjusted:
            rank_zero_warn(
                "More independent regressions than data points in adjusted r2 score. Falls back to standard r2 score.",
                UserWarning,
            )
        elif n - 1 == adjusted:
            rank_zero_warn("Division by zero in adjusted r2 score. Falls back to standard r2 score.", UserWarning)
        else:
            return 1 - (1 - r2) * (num_obs - 1) / (num_obs - adjusted - 1)
    return r2


def r2_score(preds: Tensor, target: Tensor, adjusted: int = 0, multioutput: str = "uniform_average") -> Tensor:
    """Coefficient of determination.

    >>> r2_score(torch.tensor([2.5, 0.0, 2., 8.]), torch.tensor([3., -0.5, 2., 7.]))
    tensor(0.9486)
    """
    sum_squared_obs, sum_obs, rss, num_obs = _r2_score_update(preds, target)
    if num_obs < 2:
        raise ValueError("Needs at least two samples to calculate r2 score.")
    return _r2_score_compute(sum_squared_obs, sum_obs, rss, num_obs, adjusted, multioutput)


def _relative_squared_error_compute(
    sum_squared_obs: Tensor,
    sum_obs: Tensor,
    rss: Tensor,
    num_obs: Union[int, Tensor],
    squared: bool = True,
) -> Tensor:
    """``sum (t - p)**2 / sum (t - mean t)**2`` per output (its root per output when not ``squared``), then the
    mean over the outputs; the denominator is clamped below at float32's epsilon."""
    mean_obs = sum_obs / num_obs
    rse = rss / torch.clamp(sum_squared_obs - sum_obs * mean_obs, min=torch.finfo(torch.float32).eps)
    if not squared:
        rse = torch.sqrt(rse)
    return torch.mean(rse)


def relative_squared_error(preds: Tensor, target: Tensor, squared: bool = True) -> Tensor:
    """Relative squared error.

    >>> relative_squared_error(torch.tensor([2.5, 0.0, 2., 8.]), torch.tensor([3., -0.5, 2., 7.]))
    tensor(0.0514)
    """
    sum_squared_obs, sum_obs, rss, num_obs = _r2_score_update(preds, target)
    return _relative_squared_error_compute(sum_squared_obs, sum_obs, rss, num_obs, squared=squared)
