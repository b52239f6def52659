"""Concordance correlation (counterpart of ``metrics_tpu/functional/regression/concordance.py``), on Pearson's
streaming moments."""

from __future__ import annotations

import torch

from metrics_tpu_torch.functional.regression.pearson import _pearson_corrcoef_update

Tensor = torch.Tensor


def _concordance_corrcoef_compute(
    mean_x: Tensor, mean_y: Tensor, var_x: Tensor, var_y: Tensor, corr_xy: Tensor, nb: Tensor
) -> Tensor:
    """``2 cov / (var_x + var_y + (mean_x - mean_y)**2)``, the denominator clamped below at float32's smallest
    normal number (two equal constants score 0, not NaN)."""
    var_x, var_y, corr_xy = var_x / nb, var_y / nb, corr_xy / nb
    denom = var_x + var_y + (mean_x - mean_y) ** 2
    return torch.squeeze(2.0 * corr_xy / torch.clamp(denom, min=torch.finfo(torch.float32).tiny))


def concordance_corrcoef(preds: Tensor, target: Tensor) -> Tensor:
    """Lin's concordance correlation coefficient.

    >>> concordance_corrcoef(torch.tensor([2.5, 0.0, 2., 8.]), torch.tensor([3., -0.5, 2., 7.]))
    tensor(0.9768)
    """
    d = preds.shape[1] if preds.ndim == 2 else 1
    zeros = torch.zeros(d if d > 1 else (), device=preds.device)
    mean_x, mean_y, var_x, var_y, corr_xy, nb = _pearson_corrcoef_update(
        preds, target, zeros, zeros, zeros, zeros, zeros, zeros, num_outputs=d
    )
    return _concordance_corrcoef_compute(mean_x, mean_y, var_x, var_y, corr_xy, nb)
