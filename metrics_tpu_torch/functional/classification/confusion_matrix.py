"""Confusion matrices for binary, multiclass and multilabel tasks.

Counterpart of ``metrics_tpu/functional/classification/confusion_matrix.py``.
The update is one ``bincount`` of ``target * C + preds`` with a dead overflow
bin for ignored entries, which are masked rather than dropped (their target
becomes -1), so the update keeps the input's shape. Counts are int64;
normalized matrices are float32, as the JAX package's are under x32 and x64.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _check_same_shape, _is_traced, _unique_values, traced_validation
from metrics_tpu_torch.utils.compute import _safe_divide, normalize_logits_if_needed
from metrics_tpu_torch.utils.data import bincount
from metrics_tpu_torch.utils.enums import ClassificationTask


def _confusion_matrix_reduce(confmat: Tensor, normalize: Optional[str] = None) -> Tensor:
    """Normalize an un-normalized confusion matrix."""
    allowed_normalize = ("true", "pred", "all", "none", None)
    if normalize not in allowed_normalize:
        raise ValueError(f"Argument `normalize` needs to one of the following: {allowed_normalize}")
    if normalize is not None and normalize != "none":
        confmat = confmat.float()
        if normalize == "true":
            return _safe_divide(confmat, confmat.sum(dim=-1, keepdim=True))
        if normalize == "pred":
            return _safe_divide(confmat, confmat.sum(dim=-2, keepdim=True))
        return _safe_divide(confmat, confmat.sum(dim=(-2, -1), keepdim=True))
    return confmat


def _binary_confusion_matrix_arg_validation(
    threshold: float = 0.5, ignore_index: Optional[int] = None, normalize: Optional[str] = None
) -> None:
    """Validate non-tensor args."""
    if not (isinstance(threshold, float) and (0 <= threshold <= 1)):
        raise ValueError(f"Expected argument `threshold` to be a float in the [0,1] range, but got {threshold}.")
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an integer, but got {ignore_index}")
    if normalize not in ("true", "pred", "all", "none", None):
        raise ValueError(f"Argument `normalize` needs to one of the following: ('true','pred','all','none',None)")


@traced_validation("binary_confusion_matrix")
def _binary_confusion_matrix_tensor_validation(
    preds: Tensor, target: Tensor, ignore_index: Optional[int] = None
) -> None:
    """Validate tensor inputs (reads their distinct values on the host; skipped under vmap)."""
    _check_same_shape(preds, target)
    if _is_traced(preds, target):
        return
    allowed = {0, 1} | ({ignore_index} if ignore_index is not None else set())
    uniq = set(_unique_values(target, "binary_confusion_matrix.target"))
    if not uniq.issubset(allowed):
        raise RuntimeError(
            f"Detected the following values in `target`: {sorted(uniq)} but expected only"
            f" the following values {sorted(allowed)}."
        )
    if not preds.is_floating_point():
        uniq_p = set(_unique_values(preds, "binary_confusion_matrix.preds"))
        if not uniq_p.issubset({0, 1}):
            raise RuntimeError(
                f"Detected the following values in `preds`: {sorted(uniq_p)} but expected only binary values."
            )


def _binary_confusion_matrix_format(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    convert_to_labels: bool = True,
) -> Tuple[Tensor, Tensor]:
    """Flatten and threshold; ignored positions get target -1."""
    preds = preds.reshape(-1)
    target = target.reshape(-1).long()
    if preds.is_floating_point():
        preds = normalize_logits_if_needed(preds, "sigmoid")
        if convert_to_labels:
            preds = (preds > threshold).long()
    if ignore_index is not None:
        target = torch.where(target == ignore_index, -1, target)
    return preds, target


def _binary_confusion_matrix_update(preds: Tensor, target: Tensor) -> Tensor:
    """One count into 2 x 2 bins; ignored entries (target -1) go to a dead bin."""
    valid = target >= 0
    idx = torch.where(valid, target * 2 + preds, 4)
    return bincount(idx, 5)[:4].reshape(2, 2)


def _binary_confusion_matrix_compute(confmat: Tensor, normalize: Optional[str] = None) -> Tensor:
    return _confusion_matrix_reduce(confmat, normalize)


def binary_confusion_matrix(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    normalize: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Compute the confusion matrix for binary tasks.

    >>> target = torch.tensor([1, 1, 0, 0])
    >>> preds = torch.tensor([0, 1, 0, 0])
    >>> binary_confusion_matrix(preds, target)
    tensor([[2, 0],
            [1, 1]])
    """
    if validate_args:
        _binary_confusion_matrix_arg_validation(threshold, ignore_index, normalize)
        _binary_confusion_matrix_tensor_validation(preds, target, ignore_index)
    preds, target = _binary_confusion_matrix_format(preds, target, threshold, ignore_index)
    confmat = _binary_confusion_matrix_update(preds, target)
    return _binary_confusion_matrix_compute(confmat, normalize)


def _multiclass_confusion_matrix_arg_validation(
    num_classes: int, ignore_index: Optional[int] = None, normalize: Optional[str] = None
) -> None:
    """Validate non-tensor args."""
    if not isinstance(num_classes, int) or num_classes < 2:
        raise ValueError(f"Expected argument `num_classes` to be an integer larger than 1, but got {num_classes}")
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an integer, but got {ignore_index}")
    if normalize not in ("true", "pred", "all", "none", None):
        raise ValueError(f"Argument `normalize` needs to one of the following: ('true','pred','all','none',None)")


@traced_validation("multiclass_confusion_matrix")
def _multiclass_confusion_matrix_tensor_validation(
    preds: Tensor, target: Tensor, num_classes: int, ignore_index: Optional[int] = None
) -> None:
    """Validate tensor inputs (reads their distinct values on the host)."""
    if preds.ndim == target.ndim + 1:
        if not preds.is_floating_point():
            raise ValueError("If `preds` have one dimension more than `target`, `preds` should be a float tensor.")
        if preds.shape[1] != num_classes:
            raise ValueError("If `preds` have one dimension more than `target`, `preds.shape[1]` should be"
                             " equal to number of classes.")
        if preds.shape[2:] != target.shape[1:]:
            raise ValueError("If `preds` have one dimension more than `target`, the shape of `preds` should be"
                             " (N, C, ...), and the shape of `target` should be (N, ...).")
    elif preds.ndim == target.ndim:
        if preds.shape != target.shape:
            raise ValueError("The `preds` and `target` should have the same shape,"
                             f" got `preds` with shape={tuple(preds.shape)} and `target` with"
                             f" shape={tuple(target.shape)}.")
    else:
        raise ValueError("Either `preds` and `target` both should have the (same) shape (N, ...), or `target`"
                         " should be (N, ...) and `preds` should be (N, C, ...).")
    if _is_traced(preds, target):
        return
    check_value = num_classes if ignore_index is None else num_classes + 1
    to_check = [(target, "target")]
    if not preds.is_floating_point():
        to_check.append((preds, "preds"))
    for t, name in to_check:
        found = len(_unique_values(t, f"multiclass_confusion_matrix.{name}"))
        if found > check_value:
            raise RuntimeError(
                f"Detected more unique values in `{name}` than expected. Expected only {check_value} but found"
                f" {found} in `{name}`."
            )


def _multiclass_confusion_matrix_format(
    preds: Tensor, target: Tensor, ignore_index: Optional[int] = None, convert_to_labels: bool = True
) -> Tuple[Tensor, Tensor]:
    """Argmax and flatten; ignored positions get target -1."""
    if preds.ndim == target.ndim + 1 and convert_to_labels:
        preds = preds.argmax(dim=1)
    preds = preds.reshape(-1) if convert_to_labels else preds.reshape(preds.shape[0], -1)
    target = target.reshape(-1).long()
    if ignore_index is not None:
        target = torch.where(target == ignore_index, -1, target)
    return preds, target


def _multiclass_confusion_matrix_update(preds: Tensor, target: Tensor, num_classes: int) -> Tensor:
    """One count into C * C bins and a dead bin for ignored entries (``torch.bincount``, which syncs on CUDA)."""
    valid = target >= 0
    safe_t = target.clamp(0, num_classes - 1)
    safe_p = preds.long().clamp(0, num_classes - 1)
    idx = torch.where(valid, safe_t * num_classes + safe_p, num_classes * num_classes)
    return bincount(idx, num_classes * num_classes + 1)[: num_classes * num_classes].reshape(num_classes, num_classes)


def _multiclass_confusion_matrix_compute(confmat: Tensor, normalize: Optional[str] = None) -> Tensor:
    return _confusion_matrix_reduce(confmat, normalize)


def multiclass_confusion_matrix(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    normalize: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Compute the confusion matrix for multiclass tasks.

    >>> target = torch.tensor([2, 1, 0, 0])
    >>> preds = torch.tensor([2, 1, 0, 1])
    >>> multiclass_confusion_matrix(preds, target, num_classes=3)
    tensor([[1, 1, 0],
            [0, 1, 0],
            [0, 0, 1]])
    """
    if validate_args:
        _multiclass_confusion_matrix_arg_validation(num_classes, ignore_index, normalize)
        _multiclass_confusion_matrix_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target = _multiclass_confusion_matrix_format(preds, target, ignore_index)
    confmat = _multiclass_confusion_matrix_update(preds, target, num_classes)
    return _multiclass_confusion_matrix_compute(confmat, normalize)


def _multilabel_confusion_matrix_arg_validation(
    num_labels: int, threshold: float = 0.5, ignore_index: Optional[int] = None, normalize: Optional[str] = None
) -> None:
    """Validate non-tensor args."""
    if not isinstance(num_labels, int) or num_labels < 2:
        raise ValueError(f"Expected argument `num_labels` to be an integer larger than 1, but got {num_labels}")
    if not (isinstance(threshold, float) and (0 <= threshold <= 1)):
        raise ValueError(f"Expected argument `threshold` to be a float in the [0,1] range, but got {threshold}.")
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an integer, but got {ignore_index}")
    if normalize not in ("true", "pred", "all", "none", None):
        raise ValueError(f"Argument `normalize` needs to one of the following: ('true','pred','all','none',None)")


@traced_validation("multilabel_confusion_matrix")
def _multilabel_confusion_matrix_tensor_validation(
    preds: Tensor, target: Tensor, num_labels: int, ignore_index: Optional[int] = None
) -> None:
    """Validate tensor inputs (reads the target's distinct values on the host)."""
    _check_same_shape(preds, target)
    if preds.shape[1] != num_labels:
        raise ValueError(
            f"Expected both `target.shape[1]` and `preds.shape[1]` to be equal to the number of labels"
            f" but got {preds.shape[1]} and {num_labels}"
        )
    if _is_traced(preds, target):
        return
    allowed = {0, 1} | ({ignore_index} if ignore_index is not None else set())
    uniq = set(_unique_values(target, "multilabel_confusion_matrix.target"))
    if not uniq.issubset(allowed):
        raise RuntimeError(
            f"Detected the following values in `target`: {sorted(uniq)} but expected only"
            f" the following values {sorted(allowed)}."
        )


def _multilabel_confusion_matrix_format(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    should_threshold: bool = True,
) -> Tuple[Tensor, Tensor]:
    """Sigmoid and threshold; move the label dim last and flatten to (N * S, L)."""
    if preds.is_floating_point():
        preds = normalize_logits_if_needed(preds, "sigmoid")
        if should_threshold:
            preds = (preds > threshold).long()
    preds = preds.movedim(1, -1).reshape(-1, num_labels)
    target = target.long().movedim(1, -1).reshape(-1, num_labels)
    if ignore_index is not None:
        target = torch.where(target == ignore_index, -1, target)
    return preds, target


def _multilabel_confusion_matrix_update(preds: Tensor, target: Tensor, num_labels: int) -> Tensor:
    """One count into (L, 2, 2) bins with a dead bin for ignored entries."""
    valid = target >= 0
    safe_t = target.clamp(0, 1)
    idx = torch.where(valid, 2 * safe_t + preds + 4 * torch.arange(num_labels, device=preds.device), 4 * num_labels)
    return bincount(idx, 4 * num_labels + 1)[: 4 * num_labels].reshape(num_labels, 2, 2)


def _multilabel_confusion_matrix_compute(confmat: Tensor, normalize: Optional[str] = None) -> Tensor:
    return _confusion_matrix_reduce(confmat, normalize)


def multilabel_confusion_matrix(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    threshold: float = 0.5,
    normalize: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Compute the confusion matrix for multilabel tasks.

    >>> target = torch.tensor([[0, 1, 0], [1, 0, 1]])
    >>> preds = torch.tensor([[0, 0, 1], [1, 0, 1]])
    >>> multilabel_confusion_matrix(preds, target, num_labels=3)
    tensor([[[1, 0], [0, 1]],
            [[1, 0], [1, 0]],
            [[0, 1], [0, 1]]])
    """
    if validate_args:
        _multilabel_confusion_matrix_arg_validation(num_labels, threshold, ignore_index, normalize)
        _multilabel_confusion_matrix_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target = _multilabel_confusion_matrix_format(preds, target, num_labels, threshold, ignore_index)
    confmat = _multilabel_confusion_matrix_update(preds, target, num_labels)
    return _multilabel_confusion_matrix_compute(confmat, normalize)


def confusion_matrix(
    preds: Tensor,
    target: Tensor,
    task: str,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    normalize: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Task-dispatching confusion matrix."""
    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.BINARY:
        return binary_confusion_matrix(preds, target, threshold, normalize, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)}` was passed.")
        return multiclass_confusion_matrix(preds, target, num_classes, normalize, ignore_index, validate_args)
    if not isinstance(num_labels, int):
        raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)}` was passed.")
    return multilabel_confusion_matrix(preds, target, num_labels, threshold, normalize, ignore_index, validate_args)
