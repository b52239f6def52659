"""Precision-recall curves for binary, multiclass and multilabel tasks.

Counterpart of ``metrics_tpu/functional/classification/precision_recall_curve.py``.

* Binned path (``thresholds`` an int, list or tensor): one update adds a
  (T, ..., 2, 2) confusion tensor built by the binned-counts kernel
  (:func:`metrics_tpu_torch.ops.binned_hist.binned_counts`, and its labels
  mode for the multiclass curve); ignored samples are masked, not dropped.
  Multilabel targets above 1 count as positives there (clamped to 1), as in
  the JAX package.
* Exact path (``thresholds=None``): the samples are kept and the curve is
  computed over every distinct score at ``compute()``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.ops.binned_hist import binned_counts, binned_counts_labels
from metrics_tpu_torch.utils.checks import _check_same_shape, _unique_values
from metrics_tpu_torch.utils.compute import _safe_divide, interp, normalize_logits_if_needed
from metrics_tpu_torch.utils.enums import ClassificationTask
from metrics_tpu_torch.utils.prints import rank_zero_warn

Tensor = torch.Tensor
Thresholds = Optional[Union[int, List[float], Tensor]]


# --------------------------------------------------------------------------- shared helpers
def _binary_clf_curve(
    preds: Tensor,
    target: Tensor,
    sample_weights: Optional[Sequence] = None,
    pos_label: int = 1,
) -> Tuple[Tensor, Tensor, Tensor]:
    """fps and tps at every distinct score, scores descending (the exact path)."""
    if sample_weights is not None and not isinstance(sample_weights, Tensor):
        sample_weights = torch.tensor(sample_weights, dtype=torch.float32, device=preds.device)
    if preds.ndim > target.ndim:
        preds = preds[:, 0]
    desc = torch.argsort(-preds, stable=True)
    preds = preds[desc]
    target = target[desc]
    distinct_value_indices = torch.nonzero(preds[1:] - preds[:-1])[:, 0]
    threshold_idxs = torch.cat(
        [distinct_value_indices, torch.tensor([target.shape[0] - 1], device=preds.device)]
    )
    # the JAX package's int-times-float cumsum runs in its default float type (float64 under x64)
    target = (target == pos_label).to(torch.get_default_dtype())
    if sample_weights is not None:
        weight = sample_weights[desc]
        tps = torch.cumsum(target * weight, dim=0)[threshold_idxs]
        fps = torch.cumsum((1 - target) * weight, dim=0)[threshold_idxs]
    else:
        tps = torch.cumsum(target, dim=0)[threshold_idxs]
        fps = 1 + threshold_idxs - tps
    return fps, tps, preds[threshold_idxs]


def _linspace_thresholds(num: int, dtype: torch.dtype = torch.float32) -> np.ndarray:
    """The values of ``jnp.linspace(0, 1, num)`` in ``dtype``, bit for bit.

    XLA turns the division in ``jnp.linspace`` into a product with the
    reciprocal, ``i * fl(1 / (num - 1))``, and the last value is exactly 1.
    ``torch.linspace`` computes another way and differs at some ``num`` (at 100,
    200 and 1000, for instance), which moves a score that lands on a threshold
    into another bin. Computed on the host, so every device gets the same bits.
    The JAX package builds the grid in its default float type (float32, or
    float64 under x64); the port's counterpart is ``torch.get_default_dtype()``.
    """
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    if num == 1:
        return np.zeros(1, np_dtype)
    step = np_dtype(1) / np_dtype(num - 1)
    return np.append(np.arange(num - 1, dtype=np_dtype) * step, np_dtype(1))


def _adjust_threshold_arg(thresholds: Thresholds = None, device: Optional[torch.device] = None) -> Optional[Tensor]:
    """Thresholds argument to a tensor on ``device``: an int grid in the default float type, a list in float32."""
    if isinstance(thresholds, int):
        return torch.from_numpy(_linspace_thresholds(thresholds, torch.get_default_dtype())).to(device)
    if isinstance(thresholds, list):
        return torch.tensor(thresholds, dtype=torch.float32, device=device)
    if isinstance(thresholds, Tensor):
        return thresholds.to(device)
    return thresholds


def _binary_precision_recall_curve_arg_validation(
    thresholds: Thresholds = None, ignore_index: Optional[int] = None
) -> None:
    """Validate non-tensor args."""
    if thresholds is not None and not isinstance(thresholds, (list, int, Tensor)):
        raise ValueError(
            "Expected argument `thresholds` to either be an integer, list of floats or"
            f" tensor of floats, but got {thresholds}"
        )
    if isinstance(thresholds, int) and thresholds < 2:
        raise ValueError(
            f"If argument `thresholds` is an integer, expected it to be larger than 1, but got {thresholds}"
        )
    if isinstance(thresholds, list) and not all(isinstance(t, float) and 0 <= t <= 1 for t in thresholds):
        raise ValueError(
            "If argument `thresholds` is a list, expected all elements to be floats in the [0,1] range,"
            f" but got {thresholds}"
        )
    if isinstance(thresholds, Tensor) and thresholds.ndim != 1:
        raise ValueError("If argument `thresholds` is a tensor, expected the tensor to be 1d")
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an integer, but got {ignore_index}")


def _check_binary_target_values(target: Tensor, ignore_index: Optional[int]) -> None:
    """Raise unless every target is 0, 1 or ``ignore_index`` (one host read of the distinct values)."""
    allowed = {0, 1} | ({ignore_index} if ignore_index is not None else set())
    found = _unique_values(target)
    if not set(found).issubset(allowed):
        raise RuntimeError(
            f"Detected the following values in `target`: {found} but expected only"
            f" the following values {sorted(allowed)}."
        )


def _binary_precision_recall_curve_tensor_validation(
    preds: Tensor, target: Tensor, ignore_index: Optional[int] = None
) -> None:
    """Validate tensor inputs (reads the target's distinct values on the host)."""
    _check_same_shape(preds, target)
    if not preds.is_floating_point():
        raise ValueError(
            "Expected argument `preds` to be a float tensor with probability/logit scores,"
            f" but got tensor with dtype {preds.dtype}"
        )
    if target.is_floating_point():
        raise ValueError("Expected argument `target` to be an int tensor, but got float")
    _check_binary_target_values(target, ignore_index)


# --------------------------------------------------------------------------- binary
def _binary_precision_recall_curve_format(
    preds: Tensor,
    target: Tensor,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Optional[Tensor]]:
    """Flatten, sigmoid if needed, thresholds to a tensor.

    On the exact path ignored samples are dropped; on the binned path they get
    target -1 and the update masks them out.
    """
    preds = preds.reshape(-1)
    target = target.reshape(-1).int()
    if ignore_index is not None:
        if thresholds is None:
            keep = target != ignore_index
            preds, target = preds[keep], target[keep]
        else:
            target = torch.where(target == ignore_index, -1, target)
    preds = normalize_logits_if_needed(preds, "sigmoid")
    return preds, target, _adjust_threshold_arg(thresholds, preds.device)


def _confusion_from_counts(counts, order: Tensor) -> Tensor:
    """``(tp, fp, pos_tot, neg_tot)`` over sorted thresholds to the (T, C, 2, 2) confusion tensor, rows in
    the caller's threshold order."""
    tp, fp, pos_tot, neg_tot = counts
    fn = pos_tot[:, None] - tp
    tn = neg_tot[:, None] - fp
    # (C, T, 2, 2) in [y, p >= t] layout, then (T, C, 2, 2) with rows in the caller's order
    bins = torch.stack([torch.stack([tn, fp], -1), torch.stack([fn, tp], -1)], -2)
    return bins.transpose(0, 1)[torch.argsort(order)]


def _float32_thresholds(thresholds: Tensor) -> Tensor:
    """The kernel's float32 thresholds, each met by exactly the float32 scores that meet the original.

    A float64 threshold (an int grid under a float64 default) is rounded up,
    not to nearest: for a float32 score ``s``, ``s >= t`` holds exactly when
    ``s >= t`` rounded up to float32. So the counts are those of the JAX
    package, which compares in float64 under x64.
    """
    if thresholds.dtype != torch.float64:
        return thresholds.float().contiguous()
    t32 = thresholds.float()
    rounded_down = t32.double() < thresholds
    return torch.where(rounded_down, torch.nextafter(t32, torch.full_like(t32, torch.inf)), t32).contiguous()


def _binned_confusion_tensor(preds: Tensor, target01: Tensor, valid: Tensor, thresholds: Tensor) -> Tensor:
    """(N, C) scores to the (T, C, 2, 2) multi-threshold confusion tensor, int32.

    The kernel needs ascending thresholds; the rows come back in the caller's
    threshold order (a stable sort and its inverse permutation, so tied
    thresholds keep their places).
    """
    order = torch.argsort(thresholds, stable=True)
    counts = binned_counts(
        preds.float().contiguous(),
        target01.int().contiguous(),
        valid.bool().contiguous(),
        _float32_thresholds(thresholds[order]),
    )
    return _confusion_from_counts(counts, order)


def _binned_confusion_tensor_labels(preds: Tensor, labels: Tensor, thresholds: Tensor) -> Tensor:
    """:func:`_binned_confusion_tensor` of the one-vs-rest targets ``labels == c`` and the mask
    ``labels >= 0``, through the kernel's labels mode: no (N, C) one-hot is built."""
    order = torch.argsort(thresholds, stable=True)
    counts = binned_counts_labels(
        preds.float().contiguous(), labels.int().contiguous(), _float32_thresholds(thresholds[order])
    )
    return _confusion_from_counts(counts, order)


def _binary_precision_recall_curve_update(
    preds: Tensor,
    target: Tensor,
    thresholds: Optional[Tensor],
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """The samples (exact path) or the (T, 2, 2) confusion tensor of this batch (binned path)."""
    if thresholds is None:
        return preds, target
    bins = _binned_confusion_tensor(preds[:, None], target.clamp(0, 1)[:, None], (target >= 0)[:, None], thresholds)
    return bins[:, 0]


def _binary_precision_recall_curve_compute(
    state: Union[Tensor, Tuple[Tensor, Tensor]],
    thresholds: Optional[Tensor],
    pos_label: int = 1,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Precision, recall and thresholds from a binned state or from the kept samples."""
    if not isinstance(state, tuple) and thresholds is not None:
        tps = state[:, 1, 1]
        fps = state[:, 0, 1]
        fns = state[:, 1, 0]
        precision = _safe_divide(tps, tps + fps)
        recall = _safe_divide(tps, tps + fns)
        precision = torch.cat([precision, precision.new_ones(1)])
        recall = torch.cat([recall, recall.new_zeros(1)])
        return precision, recall, thresholds

    fps, tps, thres = _binary_clf_curve(state[0], state[1], pos_label=pos_label)
    precision = _safe_divide(tps, tps + fps)
    recall = _safe_divide(tps, tps[-1])
    if not bool((state[1] == pos_label).any()):
        rank_zero_warn(
            "No positive samples found in target, recall is undefined. Setting recall to one for all thresholds.",
            UserWarning,
        )
        recall = torch.ones_like(recall)
    precision = torch.cat([precision.flip(0), precision.new_ones(1)])
    recall = torch.cat([recall.flip(0), recall.new_zeros(1)])
    return precision, recall, thres.flip(0)


def binary_precision_recall_curve(
    preds: Tensor,
    target: Tensor,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor, Tensor]:
    """The precision-recall curve for binary tasks.

    >>> preds = torch.tensor([0.0, 0.5, 0.7, 0.8])
    >>> target = torch.tensor([0, 1, 1, 0])
    >>> precision, recall, thresholds = binary_precision_recall_curve(preds, target, thresholds=5)
    >>> precision
    tensor([0.5000, 0.6667, 0.6667, 0.0000, 0.0000, 1.0000])
    """
    if validate_args:
        _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    preds, target, thresholds = _binary_precision_recall_curve_format(preds, target, thresholds, ignore_index)
    state = _binary_precision_recall_curve_update(preds, target, thresholds)
    return _binary_precision_recall_curve_compute(state, thresholds)


# --------------------------------------------------------------------------- multiclass
def _multiclass_precision_recall_curve_arg_validation(
    num_classes: int,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    average: Optional[str] = None,
) -> None:
    """Validate non-tensor args."""
    if not isinstance(num_classes, int) or num_classes < 2:
        raise ValueError(f"Expected argument `num_classes` to be an integer larger than 1, but got {num_classes}")
    if average not in (None, "micro", "macro"):
        raise ValueError(f"Expected argument `average` to be one of None, 'micro' or 'macro', but got {average}")
    _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)


def _multiclass_precision_recall_curve_tensor_validation(
    preds: Tensor, target: Tensor, num_classes: int, ignore_index: Optional[int] = None
) -> None:
    """Validate tensor inputs (reads the target's distinct values on the host)."""
    if not preds.ndim == target.ndim + 1:
        raise ValueError(
            f"Expected `preds` to have one more dimension than `target` but got {preds.ndim} and {target.ndim}"
        )
    if not preds.is_floating_point():
        raise ValueError(f"Expected `preds` to be a float tensor, but got {preds.dtype}")
    if target.is_floating_point():
        raise ValueError("Expected argument `target` to be an int tensor, but got float")
    if preds.shape[1] != num_classes:
        raise ValueError(f"Expected `preds.shape[1]={preds.shape[1]}` to be equal to the number of classes")
    if preds.shape[0] != target.shape[0] or preds.shape[2:] != target.shape[1:]:
        raise ValueError(
            "Expected the shape of `preds` should be (N, C, ...) and the shape of `target` should be (N, ...)."
        )
    found = np.asarray(_unique_values(target))
    counted = found >= 0 if ignore_index is None else (found >= 0) & (found != ignore_index)
    num_unique = int(counted.sum())
    if num_unique > num_classes or (found.min() < 0 and ignore_index is None):
        raise RuntimeError(
            f"Detected more unique values in `target` than expected. Expected only {num_classes} but found"
            f" {num_unique}."
        )


def _multiclass_precision_recall_curve_format(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    average: Optional[str] = None,
) -> Tuple[Tensor, Tensor, Optional[Tensor]]:
    """Reshape to (M, C), softmax if needed, flatten one-vs-rest for ``micro``."""
    preds = preds.movedim(1, -1).reshape(-1, num_classes)
    target = target.reshape(-1).int()
    if ignore_index is not None:
        if thresholds is None:
            keep = target != ignore_index
            preds, target = preds[keep], target[keep]
        else:
            target = torch.where(target == ignore_index, -1, target)
    preds = normalize_logits_if_needed(preds, "softmax")
    if average == "micro":
        target_oh = (target[:, None] == torch.arange(num_classes, device=target.device)).int()
        target = torch.where((target >= 0)[:, None], target_oh, -1).reshape(-1)
        preds = preds.reshape(-1)
    return preds, target, _adjust_threshold_arg(thresholds, preds.device)


def _multiclass_precision_recall_curve_update(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    thresholds: Optional[Tensor],
    average: Optional[str] = None,
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """The samples (exact path) or the (T, C, 2, 2) confusion tensor of this batch (binned path)."""
    if thresholds is None:
        return preds, target
    if average == "micro":
        return _binary_precision_recall_curve_update(preds, target, thresholds)
    return _binned_confusion_tensor_labels(preds, target, thresholds)


def _multiclass_precision_recall_curve_compute(
    state: Union[Tensor, Tuple[Tensor, Tensor]],
    num_classes: int,
    thresholds: Optional[Tensor],
    average: Optional[str] = None,
) -> Union[Tuple[Tensor, Tensor, Tensor], Tuple[List[Tensor], List[Tensor], List[Tensor]]]:
    """Per-class curves (stacked on the binned path, lists on the exact path), or their macro average."""
    if average == "micro":
        return _binary_precision_recall_curve_compute(state, thresholds)

    if not isinstance(state, tuple) and thresholds is not None:
        tps = state[:, :, 1, 1]
        fps = state[:, :, 0, 1]
        fns = state[:, :, 1, 0]
        precision = _safe_divide(tps, tps + fps)
        recall = _safe_divide(tps, tps + fns)
        precision = torch.cat([precision, precision.new_ones((1, num_classes))]).T
        recall = torch.cat([recall, recall.new_zeros((1, num_classes))]).T
        precision_list, recall_list = list(precision), list(recall)
        thres = thresholds
        tensor_state = True
    else:
        precision_list, recall_list, thres_list = [], [], []
        for i in range(num_classes):
            res = _binary_precision_recall_curve_compute((state[0][:, i], state[1]), thresholds=None, pos_label=i)
            precision_list.append(res[0])
            recall_list.append(res[1])
            thres_list.append(res[2])
        tensor_state = False

    if average == "macro":
        thres = thres.repeat(num_classes) if tensor_state else torch.cat(thres_list, 0)
        thres = thres.sort().values
        mean_precision = torch.cat(precision_list, 0).sort().values
        mean_recall = torch.zeros_like(mean_precision)
        for i in range(num_classes):
            mean_recall = mean_recall + interp(mean_precision, precision_list[i], recall_list[i])
        return mean_precision, mean_recall / num_classes, thres

    if tensor_state:
        return precision, recall, thres
    return precision_list, recall_list, thres_list


def multiclass_precision_recall_curve(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    thresholds: Thresholds = None,
    average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Union[Tuple[Tensor, Tensor, Tensor], Tuple[List[Tensor], List[Tensor], List[Tensor]]]:
    """The precision-recall curve for multiclass tasks (one-vs-rest per class)."""
    if validate_args:
        _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index, average)
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, thresholds = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index, average
    )
    state = _multiclass_precision_recall_curve_update(preds, target, num_classes, thresholds, average)
    return _multiclass_precision_recall_curve_compute(state, num_classes, thresholds, average)


# --------------------------------------------------------------------------- multilabel
def _multilabel_precision_recall_curve_arg_validation(
    num_labels: int,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
) -> None:
    """Validate non-tensor args."""
    if not isinstance(num_labels, int) or num_labels < 2:
        raise ValueError(f"Expected argument `num_labels` to be an integer larger than 1, but got {num_labels}")
    _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)


def _multilabel_precision_recall_curve_tensor_validation(
    preds: Tensor, target: Tensor, num_labels: int, ignore_index: Optional[int] = None
) -> None:
    """Validate tensor inputs (reads the target's distinct values on the host)."""
    _check_same_shape(preds, target)
    if preds.shape[1] != num_labels:
        raise ValueError(
            "Expected both `target.shape[1]` and `preds.shape[1]` to be equal to the number of labels"
            f" but got {preds.shape[1]} and {num_labels}"
        )
    if not preds.is_floating_point():
        raise ValueError(f"Expected `preds` to be a float tensor, but got {preds.dtype}")
    _check_binary_target_values(target, ignore_index)


def _multilabel_precision_recall_curve_format(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Optional[Tensor]]:
    """Reshape to (M, L), sigmoid if needed, ignored targets to -1 (on both paths)."""
    preds = preds.movedim(1, -1).reshape(-1, num_labels)
    target = target.int().movedim(1, -1).reshape(-1, num_labels)
    preds = normalize_logits_if_needed(preds, "sigmoid")
    if ignore_index is not None:
        target = torch.where(target == ignore_index, -1, target)
    return preds, target, _adjust_threshold_arg(thresholds, preds.device)


def _multilabel_precision_recall_curve_update(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    thresholds: Optional[Tensor],
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """The samples (exact path) or the (T, L, 2, 2) confusion tensor of this batch (binned path)."""
    if thresholds is None:
        return preds, target
    return _binned_confusion_tensor(preds, target.clamp(0, 1), target >= 0, thresholds)


def _multilabel_precision_recall_curve_compute(
    state: Union[Tensor, Tuple[Tensor, Tensor]],
    num_labels: int,
    thresholds: Optional[Tensor],
    ignore_index: Optional[int] = None,
) -> Union[Tuple[Tensor, Tensor, Tensor], Tuple[List[Tensor], List[Tensor], List[Tensor]]]:
    """Per-label curves: stacked on the binned path, lists on the exact path (ignored samples dropped per label)."""
    if not isinstance(state, tuple) and thresholds is not None:
        tps = state[:, :, 1, 1]
        fps = state[:, :, 0, 1]
        fns = state[:, :, 1, 0]
        precision = _safe_divide(tps, tps + fps)
        recall = _safe_divide(tps, tps + fns)
        precision = torch.cat([precision, precision.new_ones((1, num_labels))])
        recall = torch.cat([recall, recall.new_zeros((1, num_labels))])
        return precision.T, recall.T, thresholds

    precision_list, recall_list, thres_list = [], [], []
    for i in range(num_labels):
        preds_i, target_i = _label_samples(state, i, ignore_index)
        res = _binary_precision_recall_curve_compute((preds_i, target_i), thresholds=None)
        precision_list.append(res[0])
        recall_list.append(res[1])
        thres_list.append(res[2])
    return precision_list, recall_list, thres_list


def _label_samples(state: Tuple[Tensor, Tensor], i: int, ignore_index: Optional[int]) -> Tuple[Tensor, Tensor]:
    """Label ``i``'s kept scores and targets, without the ignored ones when there is an ``ignore_index``."""
    preds_i, target_i = state[0][:, i], state[1][:, i]
    if ignore_index is not None:
        keep = (target_i != ignore_index) & (target_i >= 0)
        preds_i, target_i = preds_i[keep], target_i[keep]
    return preds_i, target_i


def multilabel_precision_recall_curve(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Union[Tuple[Tensor, Tensor, Tensor], Tuple[List[Tensor], List[Tensor], List[Tensor]]]:
    """The precision-recall curve for multilabel tasks (one curve per label).

    >>> preds = torch.tensor([[0.75, 0.05], [0.45, 0.75], [0.05, 0.55]])
    >>> target = torch.tensor([[1, 0], [0, 1], [0, 1]])
    >>> precision, recall, thresholds = multilabel_precision_recall_curve(preds, target, num_labels=2, thresholds=3)
    >>> recall
    tensor([[1., 1., 0., 0.],
            [1., 1., 0., 0.]])
    """
    if validate_args:
        _multilabel_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)
        _multilabel_precision_recall_curve_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, thresholds = _multilabel_precision_recall_curve_format(
        preds, target, num_labels, thresholds, ignore_index
    )
    state = _multilabel_precision_recall_curve_update(preds, target, num_labels, thresholds)
    return _multilabel_precision_recall_curve_compute(state, num_labels, thresholds, ignore_index)


def precision_recall_curve(
    preds: Tensor,
    target: Tensor,
    task: str,
    thresholds: Thresholds = None,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Union[Tuple[Tensor, Tensor, Tensor], Tuple[List[Tensor], List[Tensor], List[Tensor]]]:
    """Task-dispatching precision-recall curve."""
    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.BINARY:
        return binary_precision_recall_curve(preds, target, thresholds, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)}` was passed.")
        return multiclass_precision_recall_curve(
            preds, target, num_classes, thresholds, None, ignore_index, validate_args
        )
    if not isinstance(num_labels, int):
        raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)}` was passed.")
    return multilabel_precision_recall_curve(preds, target, num_labels, thresholds, ignore_index, validate_args)
