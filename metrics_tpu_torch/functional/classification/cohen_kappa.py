"""Cohen's kappa for binary and multiclass tasks.

Counterpart of ``metrics_tpu/functional/classification/cohen_kappa.py``: a
reduction of the confusion matrix in float32, its weight matrix in
``torch.get_default_dtype()`` without weights (``1 - eye``), as the JAX
package's is under x32 and x64.
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
)
from metrics_tpu_torch.utils.enums import ClassificationTaskNoMultilabel


def _cohen_kappa_reduce(confmat: Tensor, weights: Optional[str] = None) -> Tensor:
    """Reduce an un-normalized confusion matrix into the cohen kappa score."""
    confmat = confmat.float()
    num_classes = confmat.shape[0]
    sum0 = confmat.sum(dim=0, keepdim=True)
    sum1 = confmat.sum(dim=1, keepdim=True)
    # the outer product (C, 1) x (1, C) as an elementwise product: no matmul path (TF32, cuBLAS) on the card
    expected = sum1 * sum0 / sum0.sum()

    if weights is None or weights == "none":
        w_mat = 1.0 - torch.eye(num_classes, device=confmat.device)
    elif weights in ("linear", "quadratic"):
        iota = torch.arange(num_classes, dtype=torch.float32, device=confmat.device)
        diff = iota[None, :] - iota[:, None]
        w_mat = diff.abs() if weights == "linear" else diff**2
    else:
        raise ValueError(
            f"Received {weights} for argument ``weights`` but should be either None, 'linear' or 'quadratic'"
        )
    # nan for a single-class confmat, as in the JAX package
    k = torch.sum(w_mat * confmat) / torch.sum(w_mat * expected)
    return 1 - k


def binary_cohen_kappa(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    weights: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Calculate Cohen's kappa for binary tasks.

    >>> target = torch.tensor([1, 1, 0, 0])
    >>> preds = torch.tensor([0, 1, 0, 0])
    >>> binary_cohen_kappa(preds, target)
    tensor(0.5000)
    """
    if validate_args:
        _binary_confusion_matrix_arg_validation(threshold, ignore_index)
        _binary_confusion_matrix_tensor_validation(preds, target, ignore_index)
    preds, target = _binary_confusion_matrix_format(preds, target, threshold, ignore_index)
    confmat = _binary_confusion_matrix_update(preds, target)
    return _cohen_kappa_reduce(confmat, weights)


def multiclass_cohen_kappa(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    weights: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Calculate Cohen's kappa for multiclass tasks.

    >>> target = torch.tensor([2, 1, 0, 0])
    >>> preds = torch.tensor([2, 1, 0, 1])
    >>> multiclass_cohen_kappa(preds, target, num_classes=3)
    tensor(0.6364)
    """
    if validate_args:
        _multiclass_confusion_matrix_arg_validation(num_classes, ignore_index)
        _multiclass_confusion_matrix_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target = _multiclass_confusion_matrix_format(preds, target, ignore_index)
    confmat = _multiclass_confusion_matrix_update(preds, target, num_classes)
    return _cohen_kappa_reduce(confmat, weights)


def cohen_kappa(
    preds: Tensor,
    target: Tensor,
    task: str,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    weights: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Task-dispatching Cohen's kappa."""
    task = ClassificationTaskNoMultilabel.from_str(task)
    if task == ClassificationTaskNoMultilabel.BINARY:
        return binary_cohen_kappa(preds, target, threshold, weights, ignore_index, validate_args)
    if not isinstance(num_classes, int):
        raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)}` was passed.")
    return multiclass_cohen_kappa(preds, target, num_classes, weights, ignore_index, validate_args)
