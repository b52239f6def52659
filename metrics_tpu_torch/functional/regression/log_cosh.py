"""Log-cosh error (counterpart of ``metrics_tpu/functional/regression/log_cosh.py``)."""

from __future__ import annotations

import math
from typing import Tuple

import torch

from metrics_tpu_torch.functional.regression.utils import _check_data_shape_to_num_outputs
from metrics_tpu_torch.utils.checks import _check_same_shape

Tensor = torch.Tensor


def _unsqueeze_tensors(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    if preds.ndim == 2:
        return preds, target
    return preds.unsqueeze(1), target.unsqueeze(1)


def _log_cosh_error_update(preds: Tensor, target: Tensor, num_outputs: int) -> Tuple[Tensor, int]:
    """The sum of ``logcosh(p - t)`` per output, in the stable form ``x + softplus(-2x) - log 2``."""
    _check_same_shape(preds, target)
    _check_data_shape_to_num_outputs(preds, target, num_outputs)
    preds, target = _unsqueeze_tensors(preds.to(torch.float32), target.to(torch.float32))
    diff = preds - target
    softplus = torch.logaddexp(-2 * diff, torch.zeros((), dtype=diff.dtype, device=diff.device))
    return torch.sum(diff + softplus - math.log(2.0), dim=0), preds.shape[0]


def _log_cosh_error_compute(sum_log_cosh_error: Tensor, total: int) -> Tensor:
    """The mean log-cosh error, squeezed."""
    return torch.squeeze(sum_log_cosh_error / total)


def log_cosh_error(preds: Tensor, target: Tensor) -> Tensor:
    """Log-cosh error; ``(B,)`` inputs give a scalar, ``(B, K)`` inputs one value per output.

    >>> log_cosh_error(torch.tensor([3.0, 5.0, 2.5, 7.0]), torch.tensor([2.5, 5.0, 4.0, 8.0]))
    tensor(0.3523)
    """
    num_outputs = 1 if preds.ndim == 1 else preds.shape[-1]
    sum_log_cosh_error, total = _log_cosh_error_update(preds, target, num_outputs)
    return _log_cosh_error_compute(sum_log_cosh_error, total)
