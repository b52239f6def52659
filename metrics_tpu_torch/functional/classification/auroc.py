"""Area under the ROC curve (counterpart of ``metrics_tpu/functional/classification/auroc.py``).

The trapezoids of each class's ROC curve are summed in the curve's float type.
Classes whose area is NaN are dropped from the ``macro`` and ``weighted``
averages, with a warning. The weights are the classes' positives: from the
binned state at its first threshold, or counted from the kept targets.
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
from metrics_tpu_torch.utils.checks import _host_bool, _is_traced
from metrics_tpu_torch.utils.exceptions import TraceIneligibleError
from metrics_tpu_torch.utils.compute import _auc_compute_without_check, _safe_divide, _searchsorted_right
from metrics_tpu_torch.utils.data import bincount
from metrics_tpu_torch.utils.enums import ClassificationTask
from metrics_tpu_torch.utils.prints import rank_zero_warn

Tensor = torch.Tensor


def _nan_masked_mean(res: Tensor) -> Tensor:
    """Mean of the non-NaN entries; NaN when every entry is NaN."""
    nan = torch.isnan(res)
    count = (~nan).sum()
    mean = torch.where(nan, 0.0, res).sum() / count.clamp(min=1)
    return torch.where(count > 0, mean, torch.nan)


def _reduce_scores(res: Tensor, average: Optional[str], weights: Optional[Tensor]) -> Tensor:
    """``macro`` or ``weighted`` average of per-class scores, NaN classes dropped with a warning."""
    if average is None or average == "none":
        return res
    nan = torch.isnan(res)
    if not _is_traced(res) and _host_bool(nan.any(), "reduce_scores.any_nan"):
        rank_zero_warn(
            f"Average precision score for one or more classes was `nan`. Ignoring these classes in {average}-average",
            UserWarning,
        )
    if average == "macro":
        return _nan_masked_mean(res)
    if average == "weighted" and weights is not None:
        weights = torch.where(nan, 0.0, weights)
        weights = _safe_divide(weights, weights.sum())
        return torch.where(nan, 0.0, res * weights).sum()
    raise ValueError("Received an incompatible combinations of inputs to make reduction.")


def _reduce_auroc(
    fpr: Union[Tensor, List[Tensor]],
    tpr: Union[Tensor, List[Tensor]],
    average: Optional[str] = "macro",
    weights: Optional[Tensor] = None,
    direction: float = 1.0,
) -> Tensor:
    """Per-class areas (stacked curves on the binned path, lists on the exact path), then their average."""
    if isinstance(fpr, Tensor):
        res = _auc_compute_without_check(fpr, tpr, direction=direction, axis=1)
    else:
        res = torch.stack([_auc_compute_without_check(x, y, direction=direction) for x, y in zip(fpr, tpr)])
    return _reduce_scores(res, average, weights)


def _positives_per_class(
    state: Union[Tensor, Tuple[Tensor, Tensor]], thresholds: Optional[Tensor], num_classes: int, multilabel: bool
) -> Tensor:
    """Each class's valid positives as float32: the binned state's first row, or counted from the kept targets."""
    if thresholds is not None:
        return state[0][:, 1, :].sum(-1).float()
    if multilabel:
        return (state[1] == 1).sum(0).float()
    return bincount(state[1].clamp(0, num_classes - 1), num_classes).float()


def _binary_auroc_arg_validation(
    max_fpr: Optional[float] = None,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
) -> None:
    """Validate non-tensor args."""
    if max_fpr is not None and not (isinstance(max_fpr, float) and 0 < max_fpr <= 1):
        raise ValueError(f"Argument `max_fpr` should be a float in range (0, 1], but got: {max_fpr}")
    _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)


def _binary_auroc_compute(
    state: Union[Tensor, Tuple[Tensor, Tensor]],
    thresholds: Optional[Tensor],
    max_fpr: Optional[float] = None,
    pos_label: int = 1,
) -> Tensor:
    """The area under the ROC curve; below ``max_fpr < 1``, the partial area with the McClish correction."""
    fpr, tpr, _ = _binary_roc_compute(state, thresholds, pos_label)
    if max_fpr is None or max_fpr == 1:
        return _auc_compute_without_check(fpr, tpr, 1.0)
    if _is_traced(fpr, tpr):
        raise TraceIneligibleError(
            "binary_auroc with max_fpr < 1 slices the ROC curve at a data-dependent index"
            " and cannot run under torch.func.vmap; call it eagerly or use max_fpr=None."
        )
    if bool((fpr.sum() == 0) | (tpr.sum() == 0)):
        return _auc_compute_without_check(fpr, tpr, 1.0)

    max_area = torch.tensor(max_fpr, dtype=fpr.dtype, device=fpr.device)
    # the JAX package's bisection steps: with unsorted thresholds the binned fpr is not monotone
    stop = int(_searchsorted_right(fpr, max_area.reshape(1)))
    # an index past the end reads the last point, as a JAX gather does
    upper = min(stop, fpr.shape[0] - 1)
    weight = (max_area - fpr[stop - 1]) / (fpr[upper] - fpr[stop - 1])
    interp_tpr = tpr[stop - 1] + weight * (tpr[upper] - tpr[stop - 1])
    tpr = torch.cat([tpr[:stop], interp_tpr.reshape(1)])
    fpr = torch.cat([fpr[:stop], max_area.reshape(1)])
    partial_auc = _auc_compute_without_check(fpr, tpr, 1.0)
    min_area = 0.5 * max_area**2
    return 0.5 * (1 + (partial_auc - min_area) / (max_area - min_area))


def binary_auroc(
    preds: Tensor,
    target: Tensor,
    max_fpr: Optional[float] = None,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """The area under the ROC curve for binary tasks.

    >>> preds = torch.tensor([0.0, 0.5, 0.7, 0.8])
    >>> target = torch.tensor([0, 1, 1, 0])
    >>> binary_auroc(preds, target, thresholds=None)
    tensor(0.5000)
    """
    if validate_args:
        _binary_auroc_arg_validation(max_fpr, thresholds, ignore_index)
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    preds, target, thresholds = _binary_precision_recall_curve_format(preds, target, thresholds, ignore_index)
    state = _binary_precision_recall_curve_update(preds, target, thresholds)
    return _binary_auroc_compute(state, thresholds, max_fpr)


def _multiclass_auroc_arg_validation(
    num_classes: int,
    average: Optional[str] = "macro",
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
) -> None:
    """Validate non-tensor args."""
    if average not in ("macro", "weighted", "none", None):
        raise ValueError(f"Expected argument `average` to be one of ('macro','weighted','none',None), got {average}")
    _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index)


def _multiclass_auroc_compute(
    state: Union[Tensor, Tuple[Tensor, Tensor]],
    num_classes: int,
    average: Optional[str] = "macro",
    thresholds: Optional[Tensor] = None,
) -> Tensor:
    """Per-class areas, reduced."""
    fpr, tpr, _ = _multiclass_roc_compute(state, num_classes, thresholds)
    return _reduce_auroc(fpr, tpr, average, weights=_positives_per_class(state, thresholds, num_classes, False))


def multiclass_auroc(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    average: Optional[str] = "macro",
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """The area under the ROC curve for multiclass tasks (one-vs-rest per class)."""
    if validate_args:
        _multiclass_auroc_arg_validation(num_classes, average, thresholds, ignore_index)
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, thresholds = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index
    )
    state = _multiclass_precision_recall_curve_update(preds, target, num_classes, thresholds)
    return _multiclass_auroc_compute(state, num_classes, average, thresholds)


def _multilabel_auroc_arg_validation(
    num_labels: int,
    average: Optional[str],
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
) -> None:
    """Validate non-tensor args."""
    if average not in ("micro", "macro", "weighted", "none", None):
        raise ValueError(
            f"Expected argument `average` to be one of ('micro','macro','weighted','none',None), got {average}"
        )
    _multilabel_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)


def _micro_samples(state: Tuple[Tensor, Tensor], ignore_index: Optional[int]) -> Tuple[Tensor, Tensor]:
    """Every label's kept scores and targets in one flat pair, without the ignored ones when there is an
    ``ignore_index``."""
    preds, target = state[0].reshape(-1), state[1].reshape(-1)
    if ignore_index is not None:
        keep = (target != ignore_index) & (target >= 0)
        preds, target = preds[keep], target[keep]
    return preds, target


def _multilabel_auroc_compute(
    state: Union[Tensor, Tuple[Tensor, Tensor]],
    num_labels: int,
    average: Optional[str],
    thresholds: Optional[Tensor],
    ignore_index: Optional[int] = None,
) -> Tensor:
    """Per-label areas, reduced; ``micro`` is the binary area over every label's samples."""
    if average == "micro":
        if thresholds is not None:
            return _binary_auroc_compute(state.sum(1), thresholds, max_fpr=None)
        return _binary_auroc_compute(_micro_samples(state, ignore_index), thresholds, max_fpr=None)

    fpr, tpr, _ = _multilabel_roc_compute(state, num_labels, thresholds, ignore_index)
    return _reduce_auroc(fpr, tpr, average, weights=_positives_per_class(state, thresholds, num_labels, True))


def multilabel_auroc(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    average: Optional[str] = "macro",
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """The area under the ROC curve for multilabel tasks."""
    if validate_args:
        _multilabel_auroc_arg_validation(num_labels, average, thresholds, ignore_index)
        _multilabel_precision_recall_curve_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, thresholds = _multilabel_precision_recall_curve_format(
        preds, target, num_labels, thresholds, ignore_index
    )
    state = _multilabel_precision_recall_curve_update(preds, target, num_labels, thresholds)
    return _multilabel_auroc_compute(state, num_labels, average, thresholds, ignore_index)


def auroc(
    preds: Tensor,
    target: Tensor,
    task: str,
    thresholds: Thresholds = None,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    average: Optional[str] = "macro",
    max_fpr: Optional[float] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Task-dispatching area under the ROC curve."""
    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.BINARY:
        return binary_auroc(preds, target, max_fpr, thresholds, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)}` was passed.")
        return multiclass_auroc(preds, target, num_classes, average, thresholds, ignore_index, validate_args)
    if not isinstance(num_labels, int):
        raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)}` was passed.")
    return multilabel_auroc(preds, target, num_labels, average, thresholds, ignore_index, validate_args)
