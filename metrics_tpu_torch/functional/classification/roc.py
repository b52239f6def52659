"""ROC curves (counterpart of ``metrics_tpu/functional/classification/roc.py``).

The updates are the precision-recall curve's: the binned path counts through
the binned-counts kernel, the exact path keeps the samples. Only the compute
differs: on the binned path the curve runs from the highest threshold down
(tpr, fpr and thresholds flipped), on the exact path it starts at (0, 0) with
threshold 1.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch

from metrics_tpu_torch.functional.classification.precision_recall_curve import (
    Thresholds,
    _binary_clf_curve,
    _binary_precision_recall_curve_arg_validation,
    _binary_precision_recall_curve_format,
    _binary_precision_recall_curve_tensor_validation,
    _binary_precision_recall_curve_update,
    _label_samples,
    _multiclass_precision_recall_curve_arg_validation,
    _multiclass_precision_recall_curve_format,
    _multiclass_precision_recall_curve_tensor_validation,
    _multiclass_precision_recall_curve_update,
    _multilabel_precision_recall_curve_arg_validation,
    _multilabel_precision_recall_curve_format,
    _multilabel_precision_recall_curve_tensor_validation,
    _multilabel_precision_recall_curve_update,
)
from metrics_tpu_torch.utils.checks import _host_bool, _is_traced
from metrics_tpu_torch.utils.compute import _safe_divide, interp
from metrics_tpu_torch.utils.enums import ClassificationTask
from metrics_tpu_torch.utils.prints import rank_zero_warn

Tensor = torch.Tensor
Curves = Union[Tuple[Tensor, Tensor, Tensor], Tuple[List[Tensor], List[Tensor], List[Tensor]]]


def _binary_roc_compute(
    state: Union[Tensor, Tuple[Tensor, Tensor]],
    thresholds: Optional[Tensor],
    pos_label: int = 1,
) -> Tuple[Tensor, Tensor, Tensor]:
    """fpr, tpr and thresholds from a binned state or from the kept samples."""
    if not isinstance(state, tuple) and thresholds is not None:
        tps = state[:, 1, 1]
        fps = state[:, 0, 1]
        fns = state[:, 1, 0]
        tns = state[:, 0, 0]
        tpr = _safe_divide(tps, tps + fns).flip(0)
        fpr = _safe_divide(fps, fps + tns).flip(0)
        return fpr, tpr, thresholds.flip(0)

    fps, tps, thres = _binary_clf_curve(state[0], state[1], pos_label=pos_label)
    tps = torch.cat([tps.new_zeros(1), tps])
    fps = torch.cat([fps.new_zeros(1), fps])
    thres = torch.cat([thres.new_ones(1), thres])
    if not _is_traced(fps) and _host_bool(fps[-1] <= 0, "binary_roc.no_negatives"):
        rank_zero_warn(
            "No negative samples in targets, false positive value should be meaningless."
            " Returning zero tensor in false positive score",
            UserWarning,
        )
    fpr = _safe_divide(fps, fps[-1])
    if not _is_traced(tps) and _host_bool(tps[-1] <= 0, "binary_roc.no_positives"):
        rank_zero_warn(
            "No positive samples in targets, true positive value should be meaningless."
            " Returning zero tensor in true positive score",
            UserWarning,
        )
    tpr = _safe_divide(tps, tps[-1])
    return fpr, tpr, thres


def binary_roc(
    preds: Tensor,
    target: Tensor,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor, Tensor]:
    """The ROC curve for binary tasks.

    >>> preds = torch.tensor([0.0, 0.5, 0.7, 0.8])
    >>> target = torch.tensor([0, 1, 1, 0])
    >>> fpr, tpr, thresholds = binary_roc(preds, target, thresholds=5)
    >>> fpr
    tensor([0.0000, 0.5000, 0.5000, 0.5000, 1.0000])
    """
    if validate_args:
        _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    preds, target, thresholds = _binary_precision_recall_curve_format(preds, target, thresholds, ignore_index)
    state = _binary_precision_recall_curve_update(preds, target, thresholds)
    return _binary_roc_compute(state, thresholds)


def _multiclass_roc_compute(
    state: Union[Tensor, Tuple[Tensor, Tensor]],
    num_classes: int,
    thresholds: Optional[Tensor],
    average: Optional[str] = None,
) -> Curves:
    """Per-class curves (stacked on the binned path, lists on the exact path), or their micro or macro average."""
    if average == "micro":
        return _binary_roc_compute(state, thresholds, pos_label=1)

    if not isinstance(state, tuple) and thresholds is not None:
        tps = state[:, :, 1, 1]
        fps = state[:, :, 0, 1]
        fns = state[:, :, 1, 0]
        tns = state[:, :, 0, 0]
        tpr = _safe_divide(tps, tps + fns).flip(0).T
        fpr = _safe_divide(fps, fps + tns).flip(0).T
        fpr_list, tpr_list = list(fpr), list(tpr)
        thres = thresholds.flip(0)
        tensor_state = True
    else:
        fpr_list, tpr_list, thres_list = [], [], []
        for i in range(num_classes):
            res = _binary_roc_compute((state[0][:, i], state[1]), thresholds=None, pos_label=i)
            fpr_list.append(res[0])
            tpr_list.append(res[1])
            thres_list.append(res[2])
        tensor_state = False

    if average == "macro":
        thres = thres.repeat(num_classes) if tensor_state else torch.cat(thres_list, 0)
        thres = -(-thres).sort().values
        mean_fpr = torch.cat(fpr_list, 0).sort().values
        mean_tpr = torch.zeros_like(mean_fpr)
        for i in range(num_classes):
            mean_tpr = mean_tpr + interp(mean_fpr, fpr_list[i], tpr_list[i])
        return mean_fpr, mean_tpr / num_classes, thres

    if tensor_state:
        return fpr, tpr, thres
    return fpr_list, tpr_list, thres_list


def multiclass_roc(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    thresholds: Thresholds = None,
    average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Curves:
    """The ROC curve for multiclass tasks (one-vs-rest per class)."""
    if validate_args:
        _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index, average)
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, thresholds = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index, average
    )
    state = _multiclass_precision_recall_curve_update(preds, target, num_classes, thresholds, average)
    return _multiclass_roc_compute(state, num_classes, thresholds, average)


def _multilabel_roc_compute(
    state: Union[Tensor, Tuple[Tensor, Tensor]],
    num_labels: int,
    thresholds: Optional[Tensor],
    ignore_index: Optional[int] = None,
) -> Curves:
    """Per-label curves: stacked on the binned path, lists on the exact path (ignored samples dropped per label)."""
    if not isinstance(state, tuple) and thresholds is not None:
        tps = state[:, :, 1, 1]
        fps = state[:, :, 0, 1]
        fns = state[:, :, 1, 0]
        tns = state[:, :, 0, 0]
        tpr = _safe_divide(tps, tps + fns).flip(0).T
        fpr = _safe_divide(fps, fps + tns).flip(0).T
        return fpr, tpr, thresholds.flip(0)

    fpr_list, tpr_list, thres_list = [], [], []
    for i in range(num_labels):
        res = _binary_roc_compute(_label_samples(state, i, ignore_index), thresholds=None, pos_label=1)
        fpr_list.append(res[0])
        tpr_list.append(res[1])
        thres_list.append(res[2])
    return fpr_list, tpr_list, thres_list


def multilabel_roc(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Curves:
    """The ROC curve for multilabel tasks (one curve per label)."""
    if validate_args:
        _multilabel_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)
        _multilabel_precision_recall_curve_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, thresholds = _multilabel_precision_recall_curve_format(
        preds, target, num_labels, thresholds, ignore_index
    )
    state = _multilabel_precision_recall_curve_update(preds, target, num_labels, thresholds)
    return _multilabel_roc_compute(state, num_labels, thresholds, ignore_index)


def roc(
    preds: Tensor,
    target: Tensor,
    task: str,
    thresholds: Thresholds = None,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Curves:
    """Task-dispatching ROC curve."""
    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.BINARY:
        return binary_roc(preds, target, thresholds, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)}` was passed.")
        return multiclass_roc(preds, target, num_classes, thresholds, None, ignore_index, validate_args)
    if not isinstance(num_labels, int):
        raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)}` was passed.")
    return multilabel_roc(preds, target, num_labels, thresholds, ignore_index, validate_args)
