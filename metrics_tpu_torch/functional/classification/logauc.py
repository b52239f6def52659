"""Log-AUC (counterpart of ``metrics_tpu/functional/classification/logauc.py``).

The area under the ROC curve with the false positive rate on a log10 axis,
between the two ends of ``fpr_range``, divided by the width of that range.
The curve is first given points at both ends (tpr interpolated there), then
trimmed to them. The trim reads indices on the host, as the JAX package does
eagerly.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch

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
from metrics_tpu_torch.utils.checks import _is_traced
from metrics_tpu_torch.utils.exceptions import TraceIneligibleError
from metrics_tpu_torch.utils.compute import _auc_compute_without_check, interp
from metrics_tpu_torch.utils.enums import ClassificationTask
from metrics_tpu_torch.utils.prints import rank_zero_warn

Tensor = torch.Tensor


def _validate_fpr_range(fpr_range: Tuple[float, float]) -> None:
    """Validate the ``fpr_range`` argument."""
    if not isinstance(fpr_range, tuple) or len(fpr_range) != 2:
        raise ValueError(f"The `fpr_range` should be a tuple of two floats, but got {type(fpr_range)}.")
    if not (0 <= fpr_range[0] < fpr_range[1] <= 1):
        raise ValueError(f"The `fpr_range` should be a tuple of two floats in the range [0, 1], but got {fpr_range}.")


def _binary_logauc_compute(
    fpr: Tensor,
    tpr: Tensor,
    fpr_range: Tuple[float, float] = (0.001, 0.1),
) -> Tensor:
    """Area under the log10-fpr slice of one ROC curve, divided by the slice's log width."""
    if fpr.numel() < 2 or tpr.numel() < 2:
        rank_zero_warn(
            "At least two values on for the fpr and tpr are required to compute the log AUC. Returns 0 score."
        )
        return torch.tensor(0.0, device=fpr.device)
    if _is_traced(fpr, tpr):
        raise TraceIneligibleError(
            "binary_logauc trims the ROC curve at data-dependent indices and cannot run under torch.func.vmap;"
            " call it eagerly."
        )
    fpr_rng = torch.tensor(fpr_range, dtype=fpr.dtype, device=fpr.device)
    tpr = torch.cat([tpr, interp(fpr_rng, fpr, tpr)]).sort().values
    fpr = torch.cat([fpr, fpr_rng]).sort().values

    log_fpr = torch.log10(fpr)
    bounds = torch.log10(fpr_rng)

    lower_bound_idx = int(torch.nonzero(log_fpr == bounds[0])[-1, 0])
    upper_bound_idx = int(torch.nonzero(log_fpr == bounds[1])[-1, 0])
    trimmed_log_fpr = log_fpr[lower_bound_idx : upper_bound_idx + 1]
    trimmed_tpr = tpr[lower_bound_idx : upper_bound_idx + 1]
    return _auc_compute_without_check(trimmed_log_fpr, trimmed_tpr, 1.0) / (bounds[1] - bounds[0])


def _reduce_logauc(
    fpr: Union[Tensor, List[Tensor]],
    tpr: Union[Tensor, List[Tensor]],
    fpr_range: Tuple[float, float] = (0.001, 0.1),
    average: Optional[str] = "macro",
    weights: Optional[Tensor] = None,
) -> Tensor:
    """Per-class log-AUC, then its ``macro`` or ``weighted`` average without the NaN classes (0 if all are NaN)."""
    scores = torch.stack([_binary_logauc_compute(f, t, fpr_range) for f, t in zip(fpr, tpr)])
    if average is None or average == "none":
        return scores
    nan = torch.isnan(scores)
    if not _is_traced(scores) and bool(nan.any()):
        rank_zero_warn(f"Some classes had `nan` log AUC. Ignoring these classes in {average}-average", UserWarning)
    if average == "macro":
        return torch.where(nan, 0.0, scores).sum() / (~nan).sum().clamp(min=1)
    if average == "weighted" and weights is not None:
        weights = torch.where(nan, 0.0, weights)
        weights = weights / weights.sum()
        return torch.where(nan, 0.0, scores * weights).sum()
    raise ValueError(f"Got unknown average parameter: {average}. Please choose one of ['macro', 'weighted', 'none']")


def binary_logauc(
    preds: Tensor,
    target: Tensor,
    fpr_range: Tuple[float, float] = (0.001, 0.1),
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Log-AUC for binary tasks.

    >>> preds = torch.tensor([0.75, 0.05, 0.05, 0.05, 0.05])
    >>> target = torch.tensor([1, 0, 0, 0, 0])
    >>> binary_logauc(preds, target)
    tensor(1.)
    """
    if validate_args:
        _validate_fpr_range(fpr_range)
        _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    preds, target, thresholds = _binary_precision_recall_curve_format(preds, target, thresholds, ignore_index)
    state = _binary_precision_recall_curve_update(preds, target, thresholds)
    fpr, tpr, _ = _binary_roc_compute(state, thresholds)
    return _binary_logauc_compute(fpr, tpr, fpr_range)


def multiclass_logauc(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    fpr_range: Tuple[float, float] = (0.001, 0.1),
    average: Optional[str] = "macro",
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Log-AUC for multiclass tasks (one-vs-rest per class)."""
    if validate_args:
        _validate_fpr_range(fpr_range)
        _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index)
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, thresholds = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index
    )
    state = _multiclass_precision_recall_curve_update(preds, target, num_classes, thresholds)
    fpr, tpr, _ = _multiclass_roc_compute(state, num_classes, thresholds)
    return _reduce_logauc(fpr, tpr, fpr_range, average)


def multilabel_logauc(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    fpr_range: Tuple[float, float] = (0.001, 0.1),
    average: Optional[str] = "macro",
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Log-AUC for multilabel tasks."""
    if validate_args:
        _validate_fpr_range(fpr_range)
        _multilabel_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)
        _multilabel_precision_recall_curve_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, thresholds = _multilabel_precision_recall_curve_format(
        preds, target, num_labels, thresholds, ignore_index
    )
    state = _multilabel_precision_recall_curve_update(preds, target, num_labels, thresholds)
    fpr, tpr, _ = _multilabel_roc_compute(state, num_labels, thresholds, ignore_index)
    return _reduce_logauc(fpr, tpr, fpr_range, average)


def logauc(
    preds: Tensor,
    target: Tensor,
    task: str,
    thresholds: Thresholds = None,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    fpr_range: Tuple[float, float] = (0.001, 0.1),
    average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Task-dispatching log-AUC (per-class scores unless ``average`` says otherwise)."""
    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.BINARY:
        return binary_logauc(preds, target, fpr_range, thresholds, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)}` was passed.")
        return multiclass_logauc(preds, target, num_classes, fpr_range, average, thresholds, ignore_index, validate_args)
    if not isinstance(num_labels, int):
        raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)}` was passed.")
    return multilabel_logauc(preds, target, num_labels, fpr_range, average, thresholds, ignore_index, validate_args)
