"""F-beta and F1 scores for binary, multiclass and multilabel tasks.

Counterpart of ``metrics_tpu/functional/classification/f_beta.py``: a reduction of
the stat scores (int64 counters) into float32 scores, or scores in
``torch.get_default_dtype()`` where int64 counters are divided.
"""

from __future__ import annotations

from typing import Optional

import torch

from metrics_tpu_torch.functional.classification._reduce import _fbeta_reduce
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


def _check_beta(beta: float) -> None:
    if not (isinstance(beta, float) and beta > 0):
        raise ValueError(f"Expected argument `beta` to be a float larger than 0, but got {beta}.")


def binary_fbeta_score(
    preds: Tensor,
    target: Tensor,
    beta: float,
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    zero_division: float = 0,
) -> Tensor:
    """Compute F-beta for binary tasks.

    >>> target = torch.tensor([0, 1, 0, 1, 0, 1])
    >>> preds = torch.tensor([0, 0, 1, 1, 0, 1])
    >>> binary_fbeta_score(preds, target, beta=2.0)
    tensor(0.6667)
    """
    if validate_args:
        _check_beta(beta)
        _binary_stat_scores_arg_validation(threshold, multidim_average, ignore_index, zero_division)
        _binary_stat_scores_tensor_validation(preds, target, multidim_average, ignore_index)
    preds, target = _binary_stat_scores_format(preds, target, threshold, ignore_index)
    tp, fp, tn, fn = _binary_stat_scores_update(preds, target, multidim_average)
    return _fbeta_reduce(
        tp, fp, tn, fn, beta, average="binary", multidim_average=multidim_average, zero_division=zero_division
    )


def multiclass_fbeta_score(
    preds: Tensor,
    target: Tensor,
    beta: float,
    num_classes: int,
    average: Optional[str] = "macro",
    top_k: int = 1,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    zero_division: float = 0,
) -> Tensor:
    """Compute F-beta for multiclass tasks."""
    if validate_args:
        _check_beta(beta)
        _multiclass_stat_scores_arg_validation(
            num_classes, top_k, average, multidim_average, ignore_index, zero_division
        )
        _multiclass_stat_scores_tensor_validation(preds, target, num_classes, multidim_average, ignore_index)
    preds, target = _multiclass_stat_scores_format(preds, target, top_k)
    tp, fp, tn, fn = _multiclass_stat_scores_update(
        preds, target, num_classes, top_k, average, multidim_average, ignore_index
    )
    return _fbeta_reduce(
        tp, fp, tn, fn, beta, average=average, multidim_average=multidim_average, zero_division=zero_division
    )


def multilabel_fbeta_score(
    preds: Tensor,
    target: Tensor,
    beta: float,
    num_labels: int,
    threshold: float = 0.5,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    zero_division: float = 0,
) -> Tensor:
    """Compute F-beta for multilabel tasks."""
    if validate_args:
        _check_beta(beta)
        _multilabel_stat_scores_arg_validation(
            num_labels, threshold, average, multidim_average, ignore_index, zero_division
        )
        _multilabel_stat_scores_tensor_validation(preds, target, num_labels, multidim_average, ignore_index)
    preds, target = _multilabel_stat_scores_format(preds, target, num_labels, threshold, ignore_index)
    tp, fp, tn, fn = _multilabel_stat_scores_update(preds, target, multidim_average)
    return _fbeta_reduce(
        tp, fp, tn, fn, beta, average=average, multidim_average=multidim_average, multilabel=True,
        zero_division=zero_division,
    )


def binary_f1_score(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    zero_division: float = 0,
) -> Tensor:
    """Compute F1 for binary tasks.

    >>> target = torch.tensor([0, 1, 0, 1, 0, 1])
    >>> preds = torch.tensor([0, 0, 1, 1, 0, 1])
    >>> binary_f1_score(preds, target)
    tensor(0.6667)
    """
    return binary_fbeta_score(
        preds, target, 1.0, threshold, multidim_average, ignore_index, validate_args, zero_division
    )


def multiclass_f1_score(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    average: Optional[str] = "macro",
    top_k: int = 1,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    zero_division: float = 0,
) -> Tensor:
    """Compute F1 for multiclass tasks."""
    return multiclass_fbeta_score(
        preds, target, 1.0, num_classes, average, top_k, multidim_average, ignore_index, validate_args, zero_division
    )


def multilabel_f1_score(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    threshold: float = 0.5,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    zero_division: float = 0,
) -> Tensor:
    """Compute F1 for multilabel tasks."""
    return multilabel_fbeta_score(
        preds, target, 1.0, num_labels, threshold, average, multidim_average, ignore_index, validate_args,
        zero_division,
    )


def fbeta_score(
    preds: Tensor,
    target: Tensor,
    task: str,
    beta: float = 1.0,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    average: Optional[str] = "micro",
    multidim_average: str = "global",
    top_k: int = 1,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    zero_division: float = 0,
) -> Tensor:
    """Task-dispatching F-beta."""
    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.BINARY:
        return binary_fbeta_score(
            preds, target, beta, threshold, multidim_average, ignore_index, validate_args, zero_division
        )
    if task == ClassificationTask.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)}` was passed.")
        return multiclass_fbeta_score(
            preds, target, beta, num_classes, average, top_k, multidim_average, ignore_index, validate_args,
            zero_division,
        )
    if not isinstance(num_labels, int):
        raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)}` was passed.")
    return multilabel_fbeta_score(
        preds, target, beta, num_labels, threshold, average, multidim_average, ignore_index, validate_args,
        zero_division,
    )


def f1_score(
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
    zero_division: float = 0,
) -> Tensor:
    """Task-dispatching F1."""
    return fbeta_score(
        preds, target, task, 1.0, threshold, num_classes, num_labels, average, multidim_average, top_k,
        ignore_index, validate_args, zero_division,
    )
