"""tp/fp/tn/fn counters for binary, multiclass and multilabel tasks.

Counterpart of ``metrics_tpu/functional/classification/stat_scores.py``. Ignored
positions are masked rather than dropped (targets go to a dead bin, one-hot rows
to ``-1``), as in the JAX package, so every op keeps the input's shape and the
update makes no host round trip. Counts come out as int64, PyTorch's sum type
for booleans.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from metrics_tpu_torch.utils.checks import _check_same_shape, _unique_values
from metrics_tpu_torch.utils.compute import normalize_logits_if_needed
from metrics_tpu_torch.utils.data import _topk_indices, bincount

Tensor = torch.Tensor


# --------------------------------------------------------------------------- validation
def _check_average_args(multidim_average: str, ignore_index: Optional[int], zero_division: float) -> None:
    if multidim_average not in ("global", "samplewise"):
        raise ValueError(
            f"Expected argument `multidim_average` to be one of ('global', 'samplewise'), but got {multidim_average}"
        )
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an integer, but got {ignore_index}")
    if zero_division not in (0, 1):
        raise ValueError(f"Expected argument `zero_division` to be 0 or 1, but got {zero_division}")


def _check_threshold(threshold: float) -> None:
    if not (isinstance(threshold, float) and (0 <= threshold <= 1)):
        raise ValueError(f"Expected argument `threshold` to be a float in the [0,1] range, but got {threshold}.")


def _check_average(average: Optional[str]) -> None:
    if average not in ("micro", "macro", "weighted", "none", None):
        raise ValueError(
            f"Expected argument `average` to be one of ('micro','macro','weighted','none',None), got {average}"
        )


def _check_binary_values(x: Tensor, name: str, ignore_index: Optional[int]) -> None:
    allowed = {0, 1} | ({ignore_index} if ignore_index is not None else set())
    found = _unique_values(x)
    if not set(found).issubset(allowed):
        raise RuntimeError(
            f"Detected the following values in `{name}`: {found} but expected only"
            f" the following values {sorted(allowed)}."
        )


def _binary_stat_scores_arg_validation(
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    zero_division: float = 0,
) -> None:
    """Validate non-tensor args."""
    _check_threshold(threshold)
    _check_average_args(multidim_average, ignore_index, zero_division)


def _binary_stat_scores_tensor_validation(
    preds: Tensor, target: Tensor, multidim_average: str = "global", ignore_index: Optional[int] = None
) -> None:
    """Validate tensor inputs (reads their distinct values on the host)."""
    _check_same_shape(preds, target)
    if target.is_floating_point():
        raise ValueError("Expected argument `target` to be an int tensor, but got a float tensor.")
    _check_binary_values(target, "target", ignore_index)
    if not preds.is_floating_point():
        _check_binary_values(preds, "preds", None)
    if multidim_average != "global" and preds.ndim < 2:
        raise ValueError("Expected input to be at least 2D when multidim_average is set to `samplewise`")


# --------------------------------------------------------------------------- binary
def _binary_stat_scores_format(
    preds: Tensor, target: Tensor, threshold: float = 0.5, ignore_index: Optional[int] = None
) -> Tuple[Tensor, Tensor]:
    """Labels of shape (N, S); ignored positions get target -1."""
    if preds.is_floating_point():
        preds = (normalize_logits_if_needed(preds, "sigmoid") > threshold).long()
    preds = preds.reshape(preds.shape[0], -1).long()
    target = target.reshape(target.shape[0], -1).long()
    if ignore_index is not None:
        target = torch.where(target == ignore_index, -1, target)
    return preds, target


def _count_stats(preds: Tensor, target: Tensor, dims: Tuple[int, ...]) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """tp/fp/tn/fn over ``dims``; a target outside {0, 1} counts nowhere."""
    hit = target == preds
    tp = (hit & (target == 1)).sum(dim=dims)
    fn = (~hit & (target == 1)).sum(dim=dims)
    fp = (~hit & (target == 0)).sum(dim=dims)
    tn = (hit & (target == 0)).sum(dim=dims)
    return tp, fp, tn, fn


def _binary_stat_scores_update(
    preds: Tensor, target: Tensor, multidim_average: str = "global"
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """tp/fp/tn/fn from formatted labels."""
    return _count_stats(preds, target, (0, 1) if multidim_average == "global" else (1,))


def _binary_stat_scores_compute(
    tp: Tensor, fp: Tensor, tn: Tensor, fn: Tensor, multidim_average: str = "global"
) -> Tensor:
    """Stack [tp, fp, tn, fn, support]."""
    return torch.stack([tp, fp, tn, fn, tp + fn], dim=0 if multidim_average == "global" else 1).squeeze()


def binary_stat_scores(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """tp/fp/tn/fn/support for binary tasks.

    >>> target = torch.tensor([0, 1, 0, 1, 0, 1])
    >>> preds = torch.tensor([0, 0, 1, 1, 0, 1])
    >>> binary_stat_scores(preds, target)
    tensor([2, 1, 2, 1, 3])
    """
    if validate_args:
        _binary_stat_scores_arg_validation(threshold, multidim_average, ignore_index)
        _binary_stat_scores_tensor_validation(preds, target, multidim_average, ignore_index)
    preds, target = _binary_stat_scores_format(preds, target, threshold, ignore_index)
    tp, fp, tn, fn = _binary_stat_scores_update(preds, target, multidim_average)
    return _binary_stat_scores_compute(tp, fp, tn, fn, multidim_average)


# --------------------------------------------------------------------------- multiclass
def _multiclass_stat_scores_arg_validation(
    num_classes: Optional[int],
    top_k: int = 1,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    zero_division: float = 0,
) -> None:
    """Validate non-tensor args."""
    if num_classes is None and average != "micro":
        raise ValueError(
            f"Argument `num_classes` can only be `None` for `average='micro'`, but got `average={average}`."
        )
    if num_classes is not None and (not isinstance(num_classes, int) or num_classes < 2):
        raise ValueError(f"Expected argument `num_classes` to be an integer larger than 1, but got {num_classes}")
    if not isinstance(top_k, int) or top_k < 1:
        raise ValueError(f"Expected argument `top_k` to be an integer larger than or equal to 1, but got {top_k}")
    if num_classes is not None and top_k > num_classes:
        raise ValueError(
            f"Expected argument `top_k` to be smaller or equal to `num_classes` but got {top_k} and {num_classes}"
        )
    _check_average(average)
    _check_average_args(multidim_average, ignore_index, zero_division)


def _multiclass_stat_scores_tensor_validation(
    preds: Tensor,
    target: Tensor,
    num_classes: Optional[int],
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> None:
    """Validate tensor inputs (reads their distinct values on the host)."""
    if preds.ndim == target.ndim + 1:
        if not preds.is_floating_point():
            raise ValueError("If `preds` have one dimension more than `target`, `preds` should be a float tensor.")
        if num_classes is not None and preds.shape[1] != num_classes:
            raise ValueError(
                "If `preds` have one dimension more than `target`, `preds.shape[1]` should be"
                " equal to number of classes."
            )
        if preds.shape[2:] != target.shape[1:]:
            raise ValueError(
                "If `preds` have one dimension more than `target`, the shape of `preds` should be (N, C, ...),"
                " and the shape of `target` should be (N, ...)."
            )
        if multidim_average != "global" and preds.ndim < 3:
            raise ValueError(
                "If `preds` have one dimension more than `target`, the shape of `preds` should be at least 3D"
                " when multidim_average is set to `samplewise`"
            )
    elif preds.ndim == target.ndim:
        if preds.shape != target.shape:
            raise ValueError(
                "The `preds` and `target` should have the same shape,"
                f" got `preds` with shape={tuple(preds.shape)} and `target` with shape={tuple(target.shape)}."
            )
        if multidim_average != "global" and preds.ndim < 2:
            raise ValueError(
                "When `preds` and `target` have the same shape, the shape of `preds` should be at least 2D when"
                " multidim_average is set to `samplewise`"
            )
    else:
        raise ValueError(
            "Either `preds` and `target` both should have the (same) shape (N, ...), or `target` should be (N, ...)"
            " and `preds` should be (N, C, ...)."
        )
    if num_classes is None:
        return
    check_value = num_classes if ignore_index is None else num_classes + 1
    to_check = [(target, "target")]
    if not preds.is_floating_point():
        to_check.append((preds, "preds"))
    for t, name in to_check:
        found = _unique_values(t)
        if len(found) > check_value:
            raise RuntimeError(
                f"Detected more unique values in `{name}` than expected. Expected only {check_value} but found"
                f" {len(found)} in `{name}`. Found values: {found}."
            )


def _multiclass_stat_scores_format(preds: Tensor, target: Tensor, top_k: int = 1) -> Tuple[Tensor, Tensor]:
    """Argmax probabilities (unless top-k) and flatten the extra dims."""
    if preds.ndim == target.ndim + 1 and top_k == 1:
        preds = preds.argmax(dim=1)
    preds = preds.reshape(*preds.shape[:2], -1) if top_k != 1 else preds.reshape(preds.shape[0], -1)
    target = target.reshape(target.shape[0], -1)
    return preds, target


def _refine_preds_oh(preds: Tensor, target: Tensor, num_classes_oh: int, top_k: int) -> Tensor:
    """One-hot (N, S, C) predictions: the target class if it is in the top k, else the top-1 class."""
    topk_idx = _topk_indices(preds.movedim(1, -1), top_k)  # (N, S, k)
    target_in_topk = (topk_idx == target.unsqueeze(-1)).any(dim=-1)
    result = torch.where(target_in_topk, target, topk_idx[..., 0])
    return _onehot_last(result, num_classes_oh)


def _onehot_last(labels: Tensor, num_classes: int) -> Tensor:
    return (labels.unsqueeze(-1) == torch.arange(num_classes, device=labels.device)).long()


def _multiclass_stat_scores_update(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    top_k: int = 1,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """tp/fp/tn/fn with masked ignore handling.

    Paths: one-hot comparisons for ``samplewise`` or ``top_k > 1`` (ignored rows
    get ``target_oh = -1``, which no comparison counts); a micro shortcut; and
    a confusion matrix by ``bincount`` with a dead overflow bin for ignored
    entries.
    """
    if multidim_average == "samplewise" or top_k != 1:
        valid = torch.ones_like(target, dtype=torch.bool) if ignore_index is None else target != ignore_index
        safe_target = torch.where(valid, target, 0).clamp(0, num_classes - 1)
        if top_k > 1:
            preds_oh = _refine_preds_oh(preds, safe_target, num_classes, top_k)
        else:
            preds_f = preds if preds.ndim == target.ndim else preds.argmax(dim=1)
            safe_preds = torch.where(valid, preds_f, 0).clamp(0, num_classes - 1)
            preds_oh = _onehot_last(safe_preds, num_classes)
        target_oh = torch.where(valid.unsqueeze(-1), _onehot_last(safe_target, num_classes), -1)
        return _count_stats(preds_oh, target_oh, (0, 1) if multidim_average == "global" else (1,))
    preds = preds.reshape(-1)
    target = target.reshape(-1)
    valid = torch.ones_like(target, dtype=torch.bool) if ignore_index is None else target != ignore_index
    if average == "micro":
        tp = ((preds == target) & valid).sum()
        fp = ((preds != target) & valid).sum()
        fn = fp
        tn = num_classes * valid.sum() - (fp + fn + tp)
        return tp, fp, tn, fn
    safe_t = target.clamp(0, num_classes - 1)
    safe_p = preds.clamp(0, num_classes - 1)
    idx = torch.where(valid, safe_t * num_classes + safe_p, num_classes * num_classes)
    confmat = bincount(idx, num_classes * num_classes + 1)[: num_classes * num_classes].reshape(num_classes, -1)
    tp = confmat.diagonal()
    fp = confmat.sum(0) - tp
    fn = confmat.sum(1) - tp
    tn = confmat.sum() - (fp + fn + tp)
    return tp, fp, tn, fn


def _weighted_stats(res: Tensor, tp: Tensor, fn: Tensor, sum_axis: int, global_weights: bool) -> Tensor:
    weight = (tp + fn).float()
    w = weight / (weight.sum() if global_weights else weight.sum(-1, keepdim=True))
    return (res * w.unsqueeze(-1)).sum(sum_axis)


def _multiclass_stat_scores_compute(
    tp: Tensor, fp: Tensor, tn: Tensor, fn: Tensor, average: Optional[str] = "macro", multidim_average: str = "global"
) -> Tensor:
    """Stack [tp, fp, tn, fn, support] and apply the average."""
    res = torch.stack([tp, fp, tn, fn, tp + fn], dim=-1)
    sum_axis = 0 if multidim_average == "global" else 1
    if average == "micro":
        return res.sum(sum_axis) if res.ndim > 1 else res
    if average == "macro":
        return res.float().mean(sum_axis)
    if average == "weighted":
        return _weighted_stats(res, tp, fn, sum_axis, multidim_average == "global")
    return res


def multiclass_stat_scores(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    average: Optional[str] = "macro",
    top_k: int = 1,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """tp/fp/tn/fn/support for multiclass tasks.

    >>> target = torch.tensor([2, 1, 0, 0])
    >>> preds = torch.tensor([2, 1, 0, 1])
    >>> multiclass_stat_scores(preds, target, num_classes=3, average='micro')
    tensor([3, 1, 7, 1, 4])
    """
    if validate_args:
        _multiclass_stat_scores_arg_validation(num_classes, top_k, average, multidim_average, ignore_index)
        _multiclass_stat_scores_tensor_validation(preds, target, num_classes, multidim_average, ignore_index)
    preds, target = _multiclass_stat_scores_format(preds, target, top_k)
    tp, fp, tn, fn = _multiclass_stat_scores_update(
        preds, target, num_classes, top_k, average, multidim_average, ignore_index
    )
    return _multiclass_stat_scores_compute(tp, fp, tn, fn, average, multidim_average)


# --------------------------------------------------------------------------- multilabel
def _multilabel_stat_scores_arg_validation(
    num_labels: int,
    threshold: float = 0.5,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    zero_division: float = 0,
) -> None:
    """Validate non-tensor args."""
    if not isinstance(num_labels, int) or num_labels < 2:
        raise ValueError(f"Expected argument `num_labels` to be an integer larger than 1, but got {num_labels}")
    _check_threshold(threshold)
    _check_average(average)
    _check_average_args(multidim_average, ignore_index, zero_division)


def _multilabel_stat_scores_tensor_validation(
    preds: Tensor, target: Tensor, num_labels: int, multidim_average: str = "global", ignore_index: Optional[int] = None
) -> None:
    """Validate tensor inputs (reads the target's distinct values on the host)."""
    _check_same_shape(preds, target)
    if preds.shape[1] != num_labels:
        raise ValueError(
            "Expected both `target.shape[1]` and `preds.shape[1]` to be equal to the number of labels"
            f" but got {preds.shape[1]} and {num_labels}"
        )
    if multidim_average != "global" and preds.ndim < 3:
        raise ValueError("Expected input to be at least 3D when multidim_average is set to `samplewise`")
    _check_binary_values(target, "target", ignore_index)


def _multilabel_stat_scores_format(
    preds: Tensor, target: Tensor, num_labels: int, threshold: float = 0.5, ignore_index: Optional[int] = None
) -> Tuple[Tensor, Tensor]:
    """Threshold float preds; flatten to (N, L, S); ignored targets become -1."""
    if preds.is_floating_point():
        preds = (normalize_logits_if_needed(preds, "sigmoid") > threshold).long()
    preds = preds.reshape(*preds.shape[:2], -1).long()
    target = target.reshape(*target.shape[:2], -1).long()
    if ignore_index is not None:
        target = torch.where(target == ignore_index, -1, target)
    return preds, target


def _multilabel_stat_scores_update(
    preds: Tensor, target: Tensor, multidim_average: str = "global"
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """tp/fp/tn/fn per label."""
    return _count_stats(preds, target, (0, -1) if multidim_average == "global" else (-1,))


def _multilabel_stat_scores_compute(
    tp: Tensor, fp: Tensor, tn: Tensor, fn: Tensor, average: Optional[str] = "macro", multidim_average: str = "global"
) -> Tensor:
    """Stack [tp, fp, tn, fn, support] and apply the average."""
    res = torch.stack([tp, fp, tn, fn, tp + fn], dim=-1)
    sum_axis = 0 if multidim_average == "global" else 1
    if average == "micro":
        return res.sum(sum_axis)
    if average == "macro":
        return res.float().mean(sum_axis)
    if average == "weighted":
        return _weighted_stats(res, tp, fn, sum_axis, True)
    return res


def multilabel_stat_scores(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    threshold: float = 0.5,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """tp/fp/tn/fn/support for multilabel tasks."""
    if validate_args:
        _multilabel_stat_scores_arg_validation(num_labels, threshold, average, multidim_average, ignore_index)
        _multilabel_stat_scores_tensor_validation(preds, target, num_labels, multidim_average, ignore_index)
    preds, target = _multilabel_stat_scores_format(preds, target, num_labels, threshold, ignore_index)
    tp, fp, tn, fn = _multilabel_stat_scores_update(preds, target, multidim_average)
    return _multilabel_stat_scores_compute(tp, fp, tn, fn, average, multidim_average)


def stat_scores(
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
    """Task-dispatching stat scores.

    >>> stat_scores(torch.tensor([1, 0, 1, 1]), torch.tensor([1, 1, 0, 1]), task="binary")
    tensor([2, 1, 0, 1, 3])
    """
    from metrics_tpu_torch.utils.enums import ClassificationTask

    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.BINARY:
        return binary_stat_scores(preds, target, threshold, multidim_average, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)}` was passed.")
        return multiclass_stat_scores(
            preds, target, num_classes, average, top_k, multidim_average, ignore_index, validate_args
        )
    if not isinstance(num_labels, int):
        raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)}` was passed.")
    return multilabel_stat_scores(
        preds, target, num_labels, threshold, average, multidim_average, ignore_index, validate_args
    )
