"""Input-validation helpers (counterpart of ``metrics_tpu/utils/checks.py``).

PyTorch runs eagerly, so there is no traced mode in which value checks must be
skipped: ``_is_traced`` has no counterpart here.
"""

from __future__ import annotations

from typing import Optional, Tuple

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


def _is_integer(x: torch.Tensor) -> bool:
    return not (x.is_floating_point() or x.is_complex() or x.dtype == torch.bool)


def _check_retrieval_shape(indexes: torch.Tensor, preds: torch.Tensor, target: torch.Tensor) -> None:
    """Raise unless ``indexes``, ``preds`` and ``target`` have one shape."""
    if indexes.shape != preds.shape or preds.shape != target.shape:
        raise IndexError("`indexes`, `preds` and `target` must be of the same shape")


def _check_retrieval_inputs(
    indexes: torch.Tensor,
    preds: torch.Tensor,
    target: torch.Tensor,
    allow_non_binary_target: bool = False,
    ignore_index: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Validate and flatten a retrieval batch; drop the rows whose target is ``ignore_index``.

    Returns int32 query ids, float32 scores and the targets in their own type,
    as the JAX package stores them. A non-binary target raises unless
    ``allow_non_binary_target`` (one host read of its range).
    """
    _check_retrieval_shape(indexes, preds, target)
    if not _is_integer(indexes):
        raise ValueError("`indexes` must be a tensor of integers")
    if not (_is_integer(target) or target.dtype == torch.bool):
        raise ValueError("`target` must be a tensor of booleans or integers")
    if not preds.is_floating_point():
        raise ValueError("`preds` must be a tensor of floats")
    indexes, preds, target = indexes.reshape(-1), preds.reshape(-1), target.reshape(-1)
    if ignore_index is not None:
        keep = target != ignore_index
        indexes, preds, target = indexes[keep], preds[keep], target[keep]
    if not allow_non_binary_target and target.numel() and target.dtype != torch.bool:
        if bool((target.max() > 1) | (target.min() < 0)):
            raise ValueError("`target` must contain binary values")
    return indexes.to(torch.int32), preds.to(torch.float32), target
