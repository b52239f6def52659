"""Negative predictive value for binary, multiclass and multilabel tasks.

Counterpart of ``metrics_tpu/functional/classification/negative_predictive_value.py``: a reduction of
the stat scores (int64 counters) into float32 scores, or scores in
``torch.get_default_dtype()`` where int64 counters are divided.
"""

from __future__ import annotations

from typing import Optional

import torch

from metrics_tpu_torch.functional.classification._reduce import _negative_predictive_value_reduce
from metrics_tpu_torch.functional.classification.stat_scores import (
    _binary_stat_scores_arg_validation,
    _binary_stat_scores_format,
    _binary_stat_scores_tensor_validation,
    _binary_stat_scores_update,
    _multiclass_stat_scores_arg_validation,
    _multiclass_stat_scores_format,
    _multiclass_stat_scores_tensor_validation,
    _multiclass_stat_scores_update,
    _multilabel_stat_scores_arg_validation,
    _multilabel_stat_scores_format,
    _multilabel_stat_scores_tensor_validation,
    _multilabel_stat_scores_update,
)
from metrics_tpu_torch.utils.enums import ClassificationTask

Tensor = torch.Tensor


def binary_negative_predictive_value(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Compute NPV for binary tasks.

    >>> target = torch.tensor([0, 1, 0, 1, 0, 1])
    >>> preds = torch.tensor([0, 0, 1, 1, 0, 1])
    >>> binary_negative_predictive_value(preds, target)
    tensor(0.6667)
    """
    if validate_args:
        _binary_stat_scores_arg_validation(threshold, multidim_average, ignore_index)
        _binary_stat_scores_tensor_validation(preds, target, multidim_average, ignore_index)
    preds, target = _binary_stat_scores_format(preds, target, threshold, ignore_index)
    tp, fp, tn, fn = _binary_stat_scores_update(preds, target, multidim_average)
    return _negative_predictive_value_reduce(tp, fp, tn, fn, average="binary", multidim_average=multidim_average)


def multiclass_negative_predictive_value(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    average: Optional[str] = "macro",
    top_k: int = 1,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Compute NPV for multiclass tasks."""
    if validate_args:
        _multiclass_stat_scores_arg_validation(num_classes, top_k, average, multidim_average, ignore_index)
        _multiclass_stat_scores_tensor_validation(preds, target, num_classes, multidim_average, ignore_index)
    preds, target = _multiclass_stat_scores_format(preds, target, top_k)
    tp, fp, tn, fn = _multiclass_stat_scores_update(
        preds, target, num_classes, top_k, average, multidim_average, ignore_index
    )
    return _negative_predictive_value_reduce(
        tp, fp, tn, fn, average=average, multidim_average=multidim_average, top_k=top_k
    )


def multilabel_negative_predictive_value(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    threshold: float = 0.5,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Compute NPV for multilabel tasks."""
    if validate_args:
        _multilabel_stat_scores_arg_validation(num_labels, threshold, average, multidim_average, ignore_index)
        _multilabel_stat_scores_tensor_validation(preds, target, num_labels, multidim_average, ignore_index)
    preds, target = _multilabel_stat_scores_format(preds, target, num_labels, threshold, ignore_index)
    tp, fp, tn, fn = _multilabel_stat_scores_update(preds, target, multidim_average)
    return _negative_predictive_value_reduce(
        tp, fp, tn, fn, average=average, multidim_average=multidim_average, multilabel=True
    )


def negative_predictive_value(
    preds: Tensor,
    target: Tensor,
    task: str,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    average: Optional[str] = "micro",
    multidim_average: str = "global",
    top_k: int = 1,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Task-dispatching NPV."""
    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.BINARY:
        return binary_negative_predictive_value(preds, target, threshold, multidim_average, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)}` was passed.")
        return multiclass_negative_predictive_value(
            preds, target, num_classes, average, top_k, multidim_average, ignore_index, validate_args
        )
    if not isinstance(num_labels, int):
        raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)}` was passed.")
    return multilabel_negative_predictive_value(
        preds, target, num_labels, threshold, average, multidim_average, ignore_index, validate_args
    )
