"""Hinge loss for binary and multiclass tasks.

Counterpart of ``metrics_tpu/functional/classification/hinge.py``. Ignored
samples (target -1 after formatting) are clipped into range and masked out of
the sums. Crammer-Singer takes the margin against the best other class
(``-inf`` masking); one-vs-all returns a measure per class. The measures are
summed in the scores' type and divided by an int64 count of samples, so the
loss is float32 for float32 scores.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.functional.classification.confusion_matrix import (
    _binary_confusion_matrix_format,
    _binary_confusion_matrix_tensor_validation,
    _multiclass_confusion_matrix_format,
    _multiclass_confusion_matrix_tensor_validation,
)
from metrics_tpu_torch.utils.compute import normalize_logits_if_needed
from metrics_tpu_torch.utils.enums import ClassificationTaskNoMultilabel


def _hinge_loss_compute(measure: Tensor, total: Tensor) -> Tensor:
    """Final reduction: the summed measures over the number of samples counted."""
    return measure / total


def _binary_hinge_loss_arg_validation(squared: bool, ignore_index: Optional[int] = None) -> None:
    """Validate non-tensor args."""
    if not isinstance(squared, bool):
        raise ValueError(f"Expected argument `squared` to be an bool but got {squared}")
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an integer, but got {ignore_index}")


def _binary_hinge_loss_tensor_validation(preds: Tensor, target: Tensor, ignore_index: Optional[int] = None) -> None:
    """Validate tensor inputs (reads the target's distinct values on the host)."""
    _binary_confusion_matrix_tensor_validation(preds, target, ignore_index)
    if not preds.is_floating_point():
        raise ValueError(
            "Expected argument `preds` to be floating tensor with probabilities/logits"
            f" but got tensor with dtype {preds.dtype}"
        )


def _binary_hinge_loss_update(preds: Tensor, target: Tensor, squared: bool) -> Tuple[Tensor, Tensor]:
    """Accumulate hinge measures; flagged (-1) targets contribute 0."""
    valid = target >= 0
    margin = torch.where(target == 1, preds, -preds)
    measures = (1 - margin).clamp(min=0)
    if squared:
        measures = measures**2
    measures = torch.where(valid, measures, 0.0)
    total = valid.sum()
    return measures.sum(dim=0), total


def binary_hinge_loss(
    preds: Tensor,
    target: Tensor,
    squared: bool = False,
    ignore_index: Optional[int] = None,
    validate_args: bool = False,
) -> Tensor:
    """Compute hinge loss for binary tasks.

    >>> preds = torch.tensor([0.25, 0.25, 0.55, 0.75, 0.75])
    >>> target = torch.tensor([0, 0, 1, 1, 1])
    >>> binary_hinge_loss(preds, target)
    tensor(0.6900)
    """
    if validate_args:
        _binary_hinge_loss_arg_validation(squared, ignore_index)
        _binary_hinge_loss_tensor_validation(preds, target, ignore_index)
    preds, target = _binary_confusion_matrix_format(
        preds, target, threshold=0.0, ignore_index=ignore_index, convert_to_labels=False
    )
    measures, total = _binary_hinge_loss_update(preds, target, squared)
    return _hinge_loss_compute(measures, total)


def _multiclass_hinge_loss_arg_validation(
    num_classes: int,
    squared: bool = False,
    multiclass_mode: str = "crammer-singer",
    ignore_index: Optional[int] = None,
) -> None:
    """Validate non-tensor args."""
    if not isinstance(num_classes, int) or num_classes < 2:
        raise ValueError(f"Expected argument `num_classes` to be an integer larger than 1, but got {num_classes}")
    _binary_hinge_loss_arg_validation(squared, ignore_index)
    if multiclass_mode not in ("crammer-singer", "one-vs-all"):
        raise ValueError(
            f"Expected argument `multiclass_mode` to be one of ('crammer-singer', 'one-vs-all'),"
            f" but got {multiclass_mode}."
        )


def _multiclass_hinge_loss_tensor_validation(
    preds: Tensor, target: Tensor, num_classes: int, ignore_index: Optional[int] = None
) -> None:
    """Validate tensor inputs (reads the target's distinct values on the host)."""
    _multiclass_confusion_matrix_tensor_validation(preds, target, num_classes, ignore_index)
    if not preds.is_floating_point():
        raise ValueError(
            "Expected argument `preds` to be floating tensor with probabilities/logits"
            f" but got tensor with dtype {preds.dtype}"
        )


def _multiclass_hinge_loss_update(
    preds: Tensor,
    target: Tensor,
    squared: bool,
    multiclass_mode: str = "crammer-singer",
) -> Tuple[Tensor, Tensor]:
    """Accumulate hinge measures."""
    preds = normalize_logits_if_needed(preds, "softmax")
    valid = target >= 0
    safe_target = target.clamp(0, preds.shape[1] - 1)
    target_oh = safe_target[:, None] == torch.arange(preds.shape[1], device=preds.device)
    if multiclass_mode == "crammer-singer":
        margin = torch.where(target_oh, preds, 0.0).sum(dim=1)
        margin = margin - torch.where(target_oh, -torch.inf, preds).amax(dim=1)
        measures = (1 - margin).clamp(min=0)
        if squared:
            measures = measures**2
        measures = torch.where(valid, measures, 0.0)
    else:
        margin = torch.where(target_oh, preds, -preds)
        measures = (1 - margin).clamp(min=0)
        if squared:
            measures = measures**2
        measures = torch.where(valid[:, None], measures, 0.0)
    total = valid.sum()
    return measures.sum(dim=0), total


def multiclass_hinge_loss(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    squared: bool = False,
    multiclass_mode: str = "crammer-singer",
    ignore_index: Optional[int] = None,
    validate_args: bool = False,
) -> Tensor:
    """Compute hinge loss for multiclass tasks.

    >>> preds = torch.tensor([[0.25, 0.20, 0.55], [0.55, 0.05, 0.40], [0.10, 0.30, 0.60], [0.90, 0.05, 0.05]])
    >>> target = torch.tensor([0, 1, 2, 0])
    >>> multiclass_hinge_loss(preds, target, num_classes=3)
    tensor(0.9125)
    """
    if validate_args:
        _multiclass_hinge_loss_arg_validation(num_classes, squared, multiclass_mode, ignore_index)
        _multiclass_hinge_loss_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target = _multiclass_confusion_matrix_format(preds, target, ignore_index, convert_to_labels=False)
    measures, total = _multiclass_hinge_loss_update(preds, target, squared, multiclass_mode)
    return _hinge_loss_compute(measures, total)


def hinge_loss(
    preds: Tensor,
    target: Tensor,
    task: str,
    num_classes: Optional[int] = None,
    squared: bool = False,
    multiclass_mode: str = "crammer-singer",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Task-dispatching hinge loss."""
    task = ClassificationTaskNoMultilabel.from_str(task)
    if task == ClassificationTaskNoMultilabel.BINARY:
        return binary_hinge_loss(preds, target, squared, ignore_index, validate_args)
    if not isinstance(num_classes, int):
        raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)}` was passed.")
    return multiclass_hinge_loss(preds, target, num_classes, squared, multiclass_mode, ignore_index, validate_args)
