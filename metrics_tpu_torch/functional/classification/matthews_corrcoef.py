"""Matthews correlation coefficient for binary, multiclass and multilabel tasks.

Counterpart of ``metrics_tpu/functional/classification/matthews_corrcoef.py``:
a reduction of the confusion matrix (a multilabel one summed over labels) in
float32, whatever the default dtype, with the binary degenerate cases chosen
by ``torch.where`` as the JAX package chooses them, so the reduction reads
nothing back to the host.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from metrics_tpu_torch.functional.classification.confusion_matrix import (
    _binary_confusion_matrix_arg_validation,
    _binary_confusion_matrix_format,
    _binary_confusion_matrix_tensor_validation,
    _binary_confusion_matrix_update,
    _multiclass_confusion_matrix_arg_validation,
    _multiclass_confusion_matrix_format,
    _multiclass_confusion_matrix_tensor_validation,
    _multiclass_confusion_matrix_update,
    _multilabel_confusion_matrix_arg_validation,
    _multilabel_confusion_matrix_format,
    _multilabel_confusion_matrix_tensor_validation,
    _multilabel_confusion_matrix_update,
)
from metrics_tpu_torch.utils.enums import ClassificationTask


def _matthews_corrcoef_reduce(confmat: Tensor) -> Tensor:
    """Reduce an un-normalized confusion matrix into the MCC score."""
    confmat = confmat.sum(0) if confmat.ndim == 3 else confmat  # multilabel to binary
    confmat = confmat.float()

    tk = confmat.sum(dim=-1)
    pk = confmat.sum(dim=-2)
    c = torch.trace(confmat)
    s = confmat.sum()

    cov_ytyp = c * s - torch.sum(tk * pk)
    cov_ypyp = s**2 - torch.sum(pk * pk)
    cov_ytyt = s**2 - torch.sum(tk * tk)
    denom = cov_ypyp * cov_ytyt

    general = torch.where(denom > 0, cov_ytyp / torch.sqrt(torch.where(denom > 0, denom, 1.0)), 0.0)

    if confmat.numel() != 4:
        return general

    # binary degenerate cases, selected without a host read
    tn, fp, fn, tp = confmat.reshape(-1)
    eps = torch.tensor(torch.finfo(torch.float32).eps, dtype=torch.float32, device=confmat.device)
    # pick (a, b) by which row/column of the matrix collapsed
    a = torch.where((fn == 0) & (tn == 0), tp,
        torch.where((fp == 0) & (tn == 0), tp,
        torch.where((tp == 0) & (fn == 0), tn, tn)))
    b = torch.where((fn == 0) & (tn == 0), fp,
        torch.where((fp == 0) & (tn == 0), fn,
        torch.where((tp == 0) & (fn == 0), fp, fn)))
    eps_num = torch.sqrt(eps) * (a - b)
    eps_denom = (tp + fp + eps) * (tp + fn + eps) * (tn + fp + eps) * (tn + fn + eps)
    degenerate = eps_num / torch.sqrt(eps_denom)

    out = torch.where(denom == 0, degenerate, general)
    out = torch.where((tp + tn != 0) & (fp + fn == 0), 1.0, out)
    return torch.where((tp + tn == 0) & (fp + fn != 0), -1.0, out)


def binary_matthews_corrcoef(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Calculate MCC for binary tasks.

    >>> target = torch.tensor([1, 1, 0, 0])
    >>> preds = torch.tensor([0, 1, 0, 0])
    >>> binary_matthews_corrcoef(preds, target)
    tensor(0.5774)
    """
    if validate_args:
        _binary_confusion_matrix_arg_validation(threshold, ignore_index)
        _binary_confusion_matrix_tensor_validation(preds, target, ignore_index)
    preds, target = _binary_confusion_matrix_format(preds, target, threshold, ignore_index)
    confmat = _binary_confusion_matrix_update(preds, target)
    return _matthews_corrcoef_reduce(confmat)


def multiclass_matthews_corrcoef(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Calculate MCC for multiclass tasks.

    >>> target = torch.tensor([2, 1, 0, 0])
    >>> preds = torch.tensor([2, 1, 0, 1])
    >>> multiclass_matthews_corrcoef(preds, target, num_classes=3)
    tensor(0.7000)
    """
    if validate_args:
        _multiclass_confusion_matrix_arg_validation(num_classes, ignore_index)
        _multiclass_confusion_matrix_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target = _multiclass_confusion_matrix_format(preds, target, ignore_index)
    confmat = _multiclass_confusion_matrix_update(preds, target, num_classes)
    return _matthews_corrcoef_reduce(confmat)


def multilabel_matthews_corrcoef(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Calculate MCC for multilabel tasks."""
    if validate_args:
        _multilabel_confusion_matrix_arg_validation(num_labels, threshold, ignore_index)
        _multilabel_confusion_matrix_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target = _multilabel_confusion_matrix_format(preds, target, num_labels, threshold, ignore_index)
    confmat = _multilabel_confusion_matrix_update(preds, target, num_labels)
    return _matthews_corrcoef_reduce(confmat)


def matthews_corrcoef(
    preds: Tensor,
    target: Tensor,
    task: str,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Task-dispatching MCC."""
    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.BINARY:
        return binary_matthews_corrcoef(preds, target, threshold, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)}` was passed.")
        return multiclass_matthews_corrcoef(preds, target, num_classes, ignore_index, validate_args)
    if not isinstance(num_labels, int):
        raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)}` was passed.")
    return multilabel_matthews_corrcoef(preds, target, num_labels, threshold, ignore_index, validate_args)
