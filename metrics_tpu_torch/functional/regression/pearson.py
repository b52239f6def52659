"""Pearson correlation (counterpart of ``metrics_tpu/functional/regression/pearson.py``).

The update keeps streaming moments (means, the sums of squared deviations and
the co-deviation, and the count), folded batch by batch in Welford's manner;
:func:`_final_aggregation` merges the moments of several ranks by Chan's
pairwise formulas. Both are the JAX package's, operation for operation.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from metrics_tpu_torch.functional.regression.utils import _check_data_shape_to_num_outputs
from metrics_tpu_torch.utils.checks import _check_same_shape, _is_traced
from metrics_tpu_torch.utils.prints import rank_zero_warn

Tensor = torch.Tensor


def _pearson_corrcoef_update(
    preds: Tensor,
    target: Tensor,
    mean_x: Tensor,
    mean_y: Tensor,
    var_x: Tensor,
    var_y: Tensor,
    corr_xy: Tensor,
    num_prior: Tensor,
    num_outputs: int,
) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Fold one batch into the streaming moments."""
    _check_same_shape(preds, target)
    _check_data_shape_to_num_outputs(preds, target, num_outputs)
    preds = preds.to(torch.float32)
    target = target.to(torch.float32)
    num_obs = preds.shape[0]
    cond = (num_prior.mean() > 0) | (num_obs == 1)

    sum_p = preds.sum(0)
    sum_t = target.sum(0)
    mx_new = torch.where(cond, (num_prior * mean_x + sum_p) / (num_prior + num_obs), sum_p / num_obs)
    my_new = torch.where(cond, (num_prior * mean_y + sum_t) / (num_prior + num_obs), sum_t / num_obs)
    num_prior = num_prior + num_obs

    var_x = var_x + torch.where(
        cond,
        ((preds - mx_new) * (preds - mean_x)).sum(0),
        torch.var(preds, dim=0, correction=1) * (num_obs - 1) if num_obs > 1 else torch.zeros_like(var_x),
    )
    var_y = var_y + torch.where(
        cond,
        ((target - my_new) * (target - mean_y)).sum(0),
        torch.var(target, dim=0, correction=1) * (num_obs - 1) if num_obs > 1 else torch.zeros_like(var_y),
    )
    corr_xy = corr_xy + ((preds - mx_new) * (target - mean_y)).sum(0)
    return mx_new, my_new, var_x, var_y, corr_xy, num_prior


def _pearson_corrcoef_compute(var_x: Tensor, var_y: Tensor, corr_xy: Tensor, nb: Tensor) -> Tensor:
    """The correlation from the moments; a variance near zero warns and gives 0, not NaN."""
    nb_1 = torch.clamp(nb - 1.0, min=1.0)
    var_x = var_x / nb_1
    var_y = var_y / nb_1
    corr_xy = corr_xy / nb_1
    bound = math.sqrt(torch.finfo(torch.float32).eps)
    if not _is_traced(var_x, var_y) and (bool((var_x < bound).any()) or bool((var_y < bound).any())):
        rank_zero_warn(
            "The variance of predictions or target is close to zero. This can cause instability in Pearson correlation"
            " coefficient, leading to wrong results.",
            UserWarning,
        )
    denom = torch.clamp(torch.sqrt(var_x * var_y), min=torch.finfo(torch.float32).tiny)
    return torch.squeeze(torch.clamp(corr_xy / denom, -1.0, 1.0))


def pearson_corrcoef(preds: Tensor, target: Tensor) -> Tensor:
    """Pearson correlation coefficient.

    >>> target = torch.tensor([3., -0.5, 2., 7.])
    >>> preds = torch.tensor([2.5, 0.0, 2., 8.])
    >>> pearson_corrcoef(preds, target)
    tensor(0.9849)
    """
    d = preds.shape[1] if preds.ndim == 2 else 1
    zeros = torch.zeros(d if d > 1 else (), device=preds.device)
    _, _, var_x, var_y, corr_xy, nb = _pearson_corrcoef_update(
        preds, target, zeros, zeros, zeros, zeros, zeros, zeros, num_outputs=d
    )
    return _pearson_corrcoef_compute(var_x, var_y, corr_xy, nb)


def _final_aggregation(
    means_x: Tensor,
    means_y: Tensor,
    vars_x: Tensor,
    vars_y: Tensor,
    corrs_xy: Tensor,
    nbs: Tensor,
) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Fold the stacked moments of several ranks, pairwise in rank order, into one set."""
    if means_x.shape[0] == 1:
        return means_x[0], means_y[0], vars_x[0], vars_y[0], corrs_xy[0], nbs[0]
    mx1, my1, vx1, vy1, cxy1, n1 = means_x[0], means_y[0], vars_x[0], vars_y[0], corrs_xy[0], nbs[0]
    for i in range(1, means_x.shape[0]):
        mx2, my2, vx2, vy2, cxy2, n2 = means_x[i], means_y[i], vars_x[i], vars_y[i], corrs_xy[i], nbs[i]
        nb = n1 + n2
        mean_x = (n1 * mx1 + n2 * mx2) / nb
        mean_y = (n1 * my1 + n2 * my2) / nb

        element_x1 = (n1 + 1) * mean_x - n1 * mx1
        vx1 = vx1 + (element_x1 - mx1) * (element_x1 - mean_x) - (element_x1 - mean_x) ** 2
        element_x2 = (n2 + 1) * mean_x - n2 * mx2
        vx2 = vx2 + (element_x2 - mx2) * (element_x2 - mean_x) - (element_x2 - mean_x) ** 2
        var_x = vx1 + vx2

        element_y1 = (n1 + 1) * mean_y - n1 * my1
        vy1 = vy1 + (element_y1 - my1) * (element_y1 - mean_y) - (element_y1 - mean_y) ** 2
        element_y2 = (n2 + 1) * mean_y - n2 * my2
        vy2 = vy2 + (element_y2 - my2) * (element_y2 - mean_y) - (element_y2 - mean_y) ** 2
        var_y = vy1 + vy2

        cxy1 = cxy1 + (element_x1 - mx1) * (element_y1 - mean_y) - (element_x1 - mean_x) * (element_y1 - mean_y)
        cxy2 = cxy2 + (element_x2 - mx2) * (element_y2 - mean_y) - (element_x2 - mean_x) * (element_y2 - mean_y)
        corr_xy = cxy1 + cxy2

        mx1, my1, vx1, vy1, cxy1, n1 = mean_x, mean_y, var_x, var_y, corr_xy, nb
    return mx1, my1, vx1, vy1, cxy1, n1
