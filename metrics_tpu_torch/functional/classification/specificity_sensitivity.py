"""Specificity at a fixed sensitivity (counterpart of
``metrics_tpu/functional/classification/specificity_sensitivity.py``).

The best specificity (1 - fpr) on the ROC curve among the points whose
sensitivity (tpr) is at least ``min_sensitivity``, and its threshold.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from metrics_tpu_torch.functional.classification._fixed_point import _constrained_argmax, _per_class_reduce
from metrics_tpu_torch.functional.classification.precision_recall_curve import (
    Thresholds,
    _binary_precision_recall_curve_arg_validation,
    _binary_precision_recall_curve_format,
    _binary_precision_recall_curve_tensor_validation,
    _binary_precision_recall_curve_update,
    _multiclass_precision_recall_curve_arg_validation,
    _multiclass_precision_recall_curve_format,
    _multiclass_precision_recall_curve_tensor_validation,
    _multiclass_precision_recall_curve_update,
    _multilabel_precision_recall_curve_arg_validation,
    _multilabel_precision_recall_curve_format,
    _multilabel_precision_recall_curve_tensor_validation,
    _multilabel_precision_recall_curve_update,
)
from metrics_tpu_torch.functional.classification.roc import (
    _binary_roc_compute,
    _multiclass_roc_compute,
    _multilabel_roc_compute,
)
from metrics_tpu_torch.functional.classification.sensitivity_specificity import _validate_min_arg
from metrics_tpu_torch.utils.enums import ClassificationTask

Tensor = torch.Tensor


def _binary_specificity_at_sensitivity_compute(
    state, thresholds: Optional[Tensor], min_sensitivity: float, pos_label: int = 1
) -> Tuple[Tensor, Tensor]:
    """Best specificity subject to sensitivity >= ``min_sensitivity``."""
    fpr, sensitivity, thres = _binary_roc_compute(state, thresholds, pos_label)
    return _constrained_argmax(1 - fpr, sensitivity, thres, min_sensitivity)


def binary_specificity_at_sensitivity(
    preds: Tensor,
    target: Tensor,
    min_sensitivity: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    """The highest specificity at a minimum sensitivity, binary.

    >>> preds = torch.tensor([0.1, 0.4, 0.6, 0.8])
    >>> target = torch.tensor([0, 0, 1, 1])
    >>> binary_specificity_at_sensitivity(preds, target, min_sensitivity=0.5)
    (tensor(1.), tensor(0.8000))
    """
    if validate_args:
        _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
        _validate_min_arg(min_sensitivity, "min_sensitivity")
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    preds, target, thresholds = _binary_precision_recall_curve_format(preds, target, thresholds, ignore_index)
    state = _binary_precision_recall_curve_update(preds, target, thresholds)
    return _binary_specificity_at_sensitivity_compute(state, thresholds, min_sensitivity)


def _multiclass_specificity_at_sensitivity_compute(
    state, num_classes: int, thresholds: Optional[Tensor], min_sensitivity: float
) -> Tuple[Tensor, Tensor]:
    """Per-class values and thresholds."""
    fpr, tpr, thres = _multiclass_roc_compute(state, num_classes, thresholds)
    return _per_class_reduce(
        (fpr, tpr, thres), num_classes, lambda f, t, th: _constrained_argmax(1 - f, t, th, min_sensitivity)
    )


def multiclass_specificity_at_sensitivity(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    min_sensitivity: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    """The highest specificity at a minimum sensitivity, per class."""
    if validate_args:
        _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index)
        _validate_min_arg(min_sensitivity, "min_sensitivity")
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, thresholds = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index
    )
    state = _multiclass_precision_recall_curve_update(preds, target, num_classes, thresholds)
    return _multiclass_specificity_at_sensitivity_compute(state, num_classes, thresholds, min_sensitivity)


def _multilabel_specificity_at_sensitivity_compute(
    state, num_labels: int, thresholds: Optional[Tensor], ignore_index: Optional[int], min_sensitivity: float
) -> Tuple[Tensor, Tensor]:
    """Per-label values and thresholds."""
    fpr, tpr, thres = _multilabel_roc_compute(state, num_labels, thresholds, ignore_index)
    return _per_class_reduce(
        (fpr, tpr, thres), num_labels, lambda f, t, th: _constrained_argmax(1 - f, t, th, min_sensitivity)
    )


def multilabel_specificity_at_sensitivity(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    min_sensitivity: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    """The highest specificity at a minimum sensitivity, per label."""
    if validate_args:
        _multilabel_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)
        _validate_min_arg(min_sensitivity, "min_sensitivity")
        _multilabel_precision_recall_curve_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, thresholds = _multilabel_precision_recall_curve_format(
        preds, target, num_labels, thresholds, ignore_index
    )
    state = _multilabel_precision_recall_curve_update(preds, target, num_labels, thresholds)
    return _multilabel_specificity_at_sensitivity_compute(state, num_labels, thresholds, ignore_index, min_sensitivity)


def specificity_at_sensitivity(
    preds: Tensor,
    target: Tensor,
    task: str,
    min_sensitivity: float,
    thresholds: Thresholds = None,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    """Task-dispatching specificity at a fixed sensitivity."""
    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.BINARY:
        return binary_specificity_at_sensitivity(preds, target, min_sensitivity, thresholds, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)}` was passed.")
        return multiclass_specificity_at_sensitivity(
            preds, target, num_classes, min_sensitivity, thresholds, ignore_index, validate_args
        )
    if not isinstance(num_labels, int):
        raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)}` was passed.")
    return multilabel_specificity_at_sensitivity(
        preds, target, num_labels, min_sensitivity, thresholds, ignore_index, validate_args
    )
