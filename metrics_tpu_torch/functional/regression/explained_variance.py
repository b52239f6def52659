"""Explained variance (counterpart of ``metrics_tpu/functional/regression/explained_variance.py``).

The state is the centred Welford moments ``(n, mean, m2)`` of ``target -
preds`` and of ``target``, not raw sums: a batch's moments come from a shifted
two-pass, and batches (or ranks) merge by Chan's pairwise formulas, which keep
their precision at any offset of the mean. ``m2 / n`` is the biased variance.
The count is float32, as in the JAX package: exact up to 2^24 samples.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

from metrics_tpu_torch.utils.checks import _check_same_shape

Tensor = torch.Tensor

ALLOWED_MULTIOUTPUT = ("raw_values", "uniform_average", "variance_weighted")


def _batch_moments(x: Tensor) -> Tuple[Tensor, Tensor]:
    """``(mean, m2)`` of one batch along dimension 0."""
    mean = torch.mean(x, dim=0)
    return mean, torch.sum((x - mean) ** 2, dim=0)


def _merge_moments(
    n_a: Union[int, Tensor], mean_a: Tensor, m2_a: Tensor, n_b: Union[int, Tensor], mean_b: Tensor, m2_b: Tensor
) -> Tuple[Tensor, Tensor, Tensor]:
    """Chan's pairwise merge of two moment sets; an empty side leaves the other as it is."""
    n = n_a + n_b
    n_safe = torch.clamp(torch.as_tensor(n), min=1)
    delta = mean_b - mean_a
    mean = mean_a + delta * n_b / n_safe
    m2 = m2_a + m2_b + delta**2 * n_a * n_b / n_safe
    return torch.as_tensor(n, dtype=torch.float32, device=mean.device), mean, m2


def _explained_variance_update(preds: Tensor, target: Tensor) -> Tuple[int, Tensor, Tensor, Tensor, Tensor]:
    """One batch's moments of ``target - preds`` and of ``target`` (float32), with its size."""
    _check_same_shape(preds, target)
    preds, target = preds.to(torch.float32), target.to(torch.float32)
    mean_diff, m2_diff = _batch_moments(target - preds)
    mean_target, m2_target = _batch_moments(target)
    return preds.shape[0], mean_diff, m2_diff, mean_target, m2_target


def _explained_variance_fold(
    num_obs: Tensor, mean_diff: Tensor, m2_diff: Tensor, mean_target: Tensor, m2_target: Tensor
) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Fold moment sets stacked along dimension 0 (one per rank), in rank order, into one."""
    n, md, m2d, mt, m2t = num_obs[0], mean_diff[0], m2_diff[0], mean_target[0], m2_target[0]
    for i in range(1, num_obs.shape[0]):
        n_new, md, m2d = _merge_moments(n, md, m2d, num_obs[i], mean_diff[i], m2_diff[i])
        _, mt, m2t = _merge_moments(n, mt, m2t, num_obs[i], mean_target[i], m2_target[i])
        n = n_new
    return n, md, m2d, mt, m2t


def _explained_variance_compute(
    num_obs: Union[int, Tensor],
    mean_diff: Tensor,
    m2_diff: Tensor,
    mean_target: Tensor,
    m2_target: Tensor,
    multioutput: str = "uniform_average",
) -> Tensor:
    """Explained variance from the moments: 1 where both variances are 0, 0 where only the target's is."""
    del mean_diff, mean_target  # carried for merging; the score needs the m2s only
    numerator = m2_diff / num_obs
    denominator = m2_target / num_obs
    nonzero_numerator = numerator != 0
    nonzero_denominator = denominator != 0
    valid_score = nonzero_numerator & nonzero_denominator
    output_scores = torch.ones_like(numerator)
    output_scores = torch.where(
        valid_score, 1.0 - numerator / torch.where(valid_score, denominator, torch.ones_like(denominator)),
        output_scores,
    )
    output_scores = torch.where(nonzero_numerator & ~nonzero_denominator, torch.zeros_like(output_scores),
                                output_scores)
    if multioutput == "raw_values":
        return output_scores
    if multioutput == "uniform_average":
        return torch.mean(output_scores)
    return torch.sum(denominator / torch.sum(denominator) * output_scores)


def explained_variance(preds: Tensor, target: Tensor, multioutput: str = "uniform_average") -> Tensor:
    """Explained variance.

    >>> explained_variance(torch.tensor([2.5, 0.0, 2., 8.]), torch.tensor([3., -0.5, 2., 7.]))
    tensor(0.9572)
    """
    if multioutput not in ALLOWED_MULTIOUTPUT:
        raise ValueError(f"Invalid input to argument `multioutput`. Choose one of the following: {ALLOWED_MULTIOUTPUT}")
    num_obs, mean_diff, m2_diff, mean_target, m2_target = _explained_variance_update(preds, target)
    return _explained_variance_compute(num_obs, mean_diff, m2_diff, mean_target, m2_target, multioutput)
