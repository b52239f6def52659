"""Input-validation helpers (counterpart of ``metrics_tpu/utils/checks.py``).

PyTorch runs eagerly, so there is no traced mode in which value checks must be
skipped: ``_is_traced`` has no counterpart here.
"""

from __future__ import annotations

import torch


def _check_same_shape(preds: torch.Tensor, target: torch.Tensor) -> None:
    """Raise unless predictions and target have the same shape."""
    if preds.shape != target.shape:
        raise RuntimeError(
            "Predictions and targets are expected to have the same shape, but got"
            f" {tuple(preds.shape)} and {tuple(target.shape)}."
        )


def _unique_values(x: torch.Tensor) -> list:
    """Sorted distinct values of ``x`` as Python numbers (one host read)."""
    return torch.unique(x).tolist()
