"""Top-label calibration error for binary and multiclass tasks.

Counterpart of ``metrics_tpu/functional/classification/calibration_error.py``.
The bins are the JAX package's ``linspace(0, 1, n_bins + 1)`` bit for bit
(``_linspace_thresholds``), so a confidence on a boundary falls into the same
bin; each bin's count and its sums of confidences and accuracies are one count
and two weighted counts (``bincount_weighted``, float sums whose order differs
from the JAX package's). Ignored samples get confidence -1 and fall into a dead
bin. The score is in the confidences' type: float32, or float64 for binary
float64 scores.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.functional.classification.confusion_matrix import (
    _binary_confusion_matrix_format,
    _binary_confusion_matrix_tensor_validation,
    _multiclass_confusion_matrix_format,
    _multiclass_confusion_matrix_tensor_validation,
)
from metrics_tpu_torch.functional.classification.precision_recall_curve import _linspace_thresholds
from metrics_tpu_torch.utils.compute import normalize_logits_if_needed
from metrics_tpu_torch.utils.data import bincount, bincount_weighted
from metrics_tpu_torch.utils.enums import ClassificationTaskNoMultilabel


def _binning_bucketize(
    confidences: Tensor, accuracies: Tensor, bin_boundaries: Tensor
) -> Tuple[Tensor, Tensor, Tensor]:
    """Per-bin mean accuracy/confidence/mass.

    Elements with negative confidence (flagged ignored) fall into a dead bin.
    """
    n_bins = bin_boundaries.shape[0]
    valid = confidences >= 0
    indices = torch.searchsorted(bin_boundaries, confidences.clamp(0.0, 1.0).contiguous(), right=True) - 1
    indices = indices.clamp(0, n_bins - 1)
    indices = torch.where(valid, indices, n_bins)

    count_bin = bincount(indices, n_bins + 1)[:n_bins].to(confidences.dtype)
    conf_bin = bincount_weighted(indices, torch.where(valid, confidences, 0.0), n_bins + 1)[:n_bins]
    acc_bin = bincount_weighted(indices, torch.where(valid, accuracies.to(confidences.dtype), 0.0), n_bins + 1)[:n_bins]

    safe = count_bin.clamp(min=1.0)
    conf_bin = torch.where(count_bin > 0, conf_bin / safe, 0.0)
    acc_bin = torch.where(count_bin > 0, acc_bin / safe, 0.0)
    prop_bin = count_bin / count_bin.sum()
    return acc_bin, conf_bin, prop_bin


def _ce_compute(
    confidences: Tensor,
    accuracies: Tensor,
    bin_boundaries: Union[Tensor, int],
    norm: str = "l1",
    debias: bool = False,
) -> Tensor:
    """Calibration error over the given binning."""
    if isinstance(bin_boundaries, int):
        grid = _linspace_thresholds(bin_boundaries + 1, confidences.dtype)
        bin_boundaries = torch.from_numpy(grid).to(device=confidences.device, dtype=confidences.dtype)
    if norm not in ("l1", "l2", "max"):
        raise ValueError(f"Argument `norm` is expected to be one of 'l1', 'l2', 'max' but got {norm}")

    acc_bin, conf_bin, prop_bin = _binning_bucketize(confidences, accuracies, bin_boundaries)

    if norm == "l1":
        return torch.sum((acc_bin - conf_bin).abs() * prop_bin)
    if norm == "max":
        return torch.max((acc_bin - conf_bin).abs())
    ce = torch.sum((acc_bin - conf_bin) ** 2 * prop_bin)
    if debias:
        debias_bins = (acc_bin * (acc_bin - 1) * prop_bin) / (prop_bin * accuracies.shape[0] - 1)
        ce = ce + torch.sum(torch.nan_to_num(debias_bins))
    return torch.where(ce > 0, torch.sqrt(ce.clamp(min=0.0)), 0.0)


def _binary_calibration_error_arg_validation(
    n_bins: int, norm: str = "l1", ignore_index: Optional[int] = None
) -> None:
    """Validate non-tensor args."""
    if not isinstance(n_bins, int) or n_bins < 1:
        raise ValueError(f"Expected argument `n_bins` to be an integer larger than 0, but got {n_bins}")
    if norm not in ("l1", "l2", "max"):
        raise ValueError(f"Expected argument `norm` to be one of ('l1', 'l2', 'max'), but got {norm}.")
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an integer, but got {ignore_index}")


def _binary_calibration_error_tensor_validation(
    preds: Tensor, target: Tensor, ignore_index: Optional[int] = None
) -> None:
    """Validate tensor inputs (reads the target's distinct values on the host)."""
    _binary_confusion_matrix_tensor_validation(preds, target, ignore_index)
    if not preds.is_floating_point():
        raise ValueError(
            "Expected argument `preds` to be floating tensor with probabilities/logits"
            f" but got tensor with dtype {preds.dtype}"
        )


def _binary_calibration_error_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """Confidences are the raw positive-class probabilities, accuracies the targets
   . Ignored positions (target flagged
    -1) get confidence -1 → dead bin downstream."""
    confidences = torch.where(target < 0, -1.0, preds)
    accuracies = target.clamp(0, 1).to(preds.dtype)
    return confidences, accuracies


def binary_calibration_error(
    preds: Tensor,
    target: Tensor,
    n_bins: int = 15,
    norm: str = "l1",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Top-label calibration error for binary tasks.

    >>> preds = torch.tensor([0.25, 0.25, 0.55, 0.75, 0.75])
    >>> target = torch.tensor([0, 0, 1, 1, 1])
    >>> binary_calibration_error(preds, target, n_bins=2, norm='l1')
    tensor(0.2900)
    """
    if validate_args:
        _binary_calibration_error_arg_validation(n_bins, norm, ignore_index)
        _binary_calibration_error_tensor_validation(preds, target, ignore_index)
    preds, target = _binary_confusion_matrix_format(
        preds, target, threshold=0.5, ignore_index=ignore_index, convert_to_labels=False
    )
    confidences, accuracies = _binary_calibration_error_update(preds, target)
    return _ce_compute(confidences, accuracies, n_bins, norm)


def _multiclass_calibration_error_arg_validation(
    num_classes: int, n_bins: int, norm: str = "l1", ignore_index: Optional[int] = None
) -> None:
    """Validate non-tensor args."""
    if not isinstance(num_classes, int) or num_classes < 2:
        raise ValueError(f"Expected argument `num_classes` to be an integer larger than 1, but got {num_classes}")
    _binary_calibration_error_arg_validation(n_bins, norm, ignore_index)


def _multiclass_calibration_error_tensor_validation(
    preds: Tensor, target: Tensor, num_classes: int, ignore_index: Optional[int] = None
) -> None:
    """Validate tensor inputs (reads the target's distinct values on the host)."""
    _multiclass_confusion_matrix_tensor_validation(preds, target, num_classes, ignore_index)
    if not preds.is_floating_point():
        raise ValueError(
            "Expected argument `preds` to be floating tensor with probabilities/logits"
            f" but got tensor with dtype {preds.dtype}"
        )


def _multiclass_calibration_error_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """Top-1 confidence + correctness."""
    preds = normalize_logits_if_needed(preds, "softmax")
    confidences = preds.amax(dim=1)
    predictions = preds.argmax(dim=1)
    accuracies = (predictions == target).float()
    confidences = torch.where(target < 0, -1.0, confidences.float())
    return confidences, accuracies


def multiclass_calibration_error(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    n_bins: int = 15,
    norm: str = "l1",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Top-label calibration error for multiclass tasks."""
    if validate_args:
        _multiclass_calibration_error_arg_validation(num_classes, n_bins, norm, ignore_index)
        _multiclass_calibration_error_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target = _multiclass_confusion_matrix_format(preds, target, ignore_index, convert_to_labels=False)
    confidences, accuracies = _multiclass_calibration_error_update(preds, target)
    return _ce_compute(confidences, accuracies, n_bins, norm)


def calibration_error(
    preds: Tensor,
    target: Tensor,
    task: str,
    n_bins: int = 15,
    norm: str = "l1",
    num_classes: Optional[int] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Task-dispatching calibration error."""
    task = ClassificationTaskNoMultilabel.from_str(task)
    if task == ClassificationTaskNoMultilabel.BINARY:
        return binary_calibration_error(preds, target, n_bins, norm, ignore_index, validate_args)
    if not isinstance(num_classes, int):
        raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)}` was passed.")
    return multiclass_calibration_error(preds, target, num_classes, n_bins, norm, ignore_index, validate_args)
