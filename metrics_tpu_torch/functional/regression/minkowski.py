"""Minkowski distance (counterpart of ``metrics_tpu/functional/regression/minkowski.py``)."""

from __future__ import annotations

import torch

from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.exceptions import TPUMetricsUserError

Tensor = torch.Tensor


def _minkowski_distance_update(preds: Tensor, targets: Tensor, p: float) -> Tensor:
    """The sum of ``|p - t| ** p`` in float32; ``p`` below 1 raises."""
    _check_same_shape(preds, targets)
    if not (isinstance(p, (float, int)) and p >= 1):
        raise TPUMetricsUserError(f"Argument ``p`` must be a float or int greater than 1, but got {p}")
    difference = torch.abs(preds.to(torch.float32) - targets.to(torch.float32))
    return torch.sum(torch.pow(difference, p))


def _minkowski_distance_compute(distance: Tensor, p: float) -> Tensor:
    """``(sum |p - t| ** p) ** (1 / p)``."""
    return torch.pow(distance, 1.0 / p)


def minkowski_distance(preds: Tensor, targets: Tensor, p: float) -> Tensor:
    """Minkowski distance of order ``p``.

    >>> minkowski_distance(torch.tensor([0.0, 1.0, 3.0, 2.0]), torch.tensor([1.0, 2.0, 3.0, 1.0]), p=3)
    tensor(1.4422)
    """
    return _minkowski_distance_compute(_minkowski_distance_update(preds, targets, p), p)
