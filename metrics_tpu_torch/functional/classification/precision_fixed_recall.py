"""Precision at a fixed recall (counterpart of
``metrics_tpu/functional/classification/precision_fixed_recall.py``).

The best precision on the precision-recall curve among the points whose
recall is at least ``min_recall``, and its threshold; ties break toward the
higher recall, then the higher threshold.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from metrics_tpu_torch.functional.classification._fixed_point import _lex_best, _per_class_reduce
from metrics_tpu_torch.functional.classification.precision_recall_curve import (
    Thresholds,
    _binary_precision_recall_curve_arg_validation,
    _binary_precision_recall_curve_compute,
    _binary_precision_recall_curve_format,
    _binary_precision_recall_curve_tensor_validation,
    _binary_precision_recall_curve_update,
    _multiclass_precision_recall_curve_arg_validation,
    _multiclass_precision_recall_curve_compute,
    _multiclass_precision_recall_curve_format,
    _multiclass_precision_recall_curve_tensor_validation,
    _multiclass_precision_recall_curve_update,
    _multilabel_precision_recall_curve_arg_validation,
    _multilabel_precision_recall_curve_compute,
    _multilabel_precision_recall_curve_format,
    _multilabel_precision_recall_curve_tensor_validation,
    _multilabel_precision_recall_curve_update,
)
from metrics_tpu_torch.functional.classification.sensitivity_specificity import _validate_min_arg
from metrics_tpu_torch.utils.enums import ClassificationTask

Tensor = torch.Tensor


def _precision_at_recall(precision: Tensor, recall: Tensor, thresholds: Tensor,
                         min_recall: float) -> Tuple[Tensor, Tensor]:
    """Best precision subject to recall >= ``min_recall``."""
    return _lex_best(precision, recall, thresholds, min_recall)


def binary_precision_at_fixed_recall(
    preds: Tensor,
    target: Tensor,
    min_recall: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    """The highest precision at a minimum recall, binary.

    >>> preds = torch.tensor([0.1, 0.4, 0.6, 0.8])
    >>> target = torch.tensor([0, 0, 1, 1])
    >>> binary_precision_at_fixed_recall(preds, target, min_recall=0.5)
    (tensor(1.), tensor(0.6000))
    """
    if validate_args:
        _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
        _validate_min_arg(min_recall, "min_recall")
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    preds, target, thresholds = _binary_precision_recall_curve_format(preds, target, thresholds, ignore_index)
    state = _binary_precision_recall_curve_update(preds, target, thresholds)
    precision, recall, thres = _binary_precision_recall_curve_compute(state, thresholds)
    return _precision_at_recall(precision, recall, thres, min_recall)


def multiclass_precision_at_fixed_recall(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    min_recall: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    """The highest precision at a minimum recall, per class."""
    if validate_args:
        _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index)
        _validate_min_arg(min_recall, "min_recall")
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, thresholds = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index
    )
    state = _multiclass_precision_recall_curve_update(preds, target, num_classes, thresholds)
    precision, recall, thres = _multiclass_precision_recall_curve_compute(state, num_classes, thresholds)
    return _per_class_reduce(
        (precision, recall, thres), num_classes, lambda p, r, t: _precision_at_recall(p, r, t, min_recall)
    )


def multilabel_precision_at_fixed_recall(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    min_recall: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    """The highest precision at a minimum recall, per label."""
    if validate_args:
        _multilabel_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)
        _validate_min_arg(min_recall, "min_recall")
        _multilabel_precision_recall_curve_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, thresholds = _multilabel_precision_recall_curve_format(
        preds, target, num_labels, thresholds, ignore_index
    )
    state = _multilabel_precision_recall_curve_update(preds, target, num_labels, thresholds)
    precision, recall, thres = _multilabel_precision_recall_curve_compute(state, num_labels, thresholds, ignore_index)
    return _per_class_reduce(
        (precision, recall, thres), num_labels, lambda p, r, t: _precision_at_recall(p, r, t, min_recall)
    )


def precision_at_fixed_recall(
    preds: Tensor,
    target: Tensor,
    task: str,
    min_recall: float,
    thresholds: Thresholds = None,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    """Task-dispatching precision at a fixed recall."""
    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.BINARY:
        return binary_precision_at_fixed_recall(preds, target, min_recall, thresholds, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)}` was passed.")
        return multiclass_precision_at_fixed_recall(
            preds, target, num_classes, min_recall, thresholds, ignore_index, validate_args
        )
    if not isinstance(num_labels, int):
        raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)}` was passed.")
    return multilabel_precision_at_fixed_recall(
        preds, target, num_labels, min_recall, thresholds, ignore_index, validate_args
    )
