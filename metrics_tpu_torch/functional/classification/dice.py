"""The Dice coefficient, with the legacy classification API.

Counterpart of ``metrics_tpu/functional/classification/dice.py``:
``dice = 2 TP / (2 TP + FP + FN)`` over stat scores, with the legacy
parameters: ``average`` in micro, macro, weighted, none or samples,
``mdmc_average`` in global or samplewise, a probability ``threshold``, a
multiclass ``top_k``, ``ignore_index`` and ``zero_division``. The kind of
input is read from shapes and dtypes: hard labels (the class count from the
data unless given, one host read), binary or multilabel probabilities
(thresholded), or multiclass probabilities ``(N, C, ...)`` (top k, ties to
the lower class as in the JAX package's stable sort). The per-class counts are
int64, so the function's score is in ``torch.get_default_dtype()``; the
``Dice`` class returns float32, as the JAX package's do.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _is_traced
from metrics_tpu_torch.utils.exceptions import TraceIneligibleError
from metrics_tpu_torch.utils.compute import _safe_divide

__all__ = ["dice"]

_AVERAGES = ("micro", "macro", "weighted", "none", None, "samples")
_MDMC = ("global", "samplewise", None)


def _dice_format(
    preds: Tensor,
    target: Tensor,
    threshold: float,
    top_k: Optional[int],
    num_classes: Optional[int],
) -> Tuple[Tensor, Tensor, int]:
    """Return one-hot-ish (N, C, S) stat tensors (preds_oh, target_oh, C)."""
    preds = torch.as_tensor(preds)
    target = torch.as_tensor(target, device=preds.device)
    floating = preds.is_floating_point()
    if floating and preds.ndim == target.ndim + 1:
        # multiclass probabilities (N, C, ...): top-k membership by each class's rank along the class axis
        c = preds.shape[1]
        k = top_k or 1
        rank = torch.argsort(torch.argsort(-preds, dim=1, stable=True), dim=1, stable=True)
        preds_oh = rank < k
        target_oh = torch.arange(c, device=preds.device).reshape(1, c, *([1] * (target.ndim - 1))) == target[:, None]
        n = preds.shape[0]
        return preds_oh.reshape(n, c, -1), target_oh.reshape(n, c, -1), c
    if floating:
        # binary / multilabel probabilities, same shape as target
        preds_hard = preds >= threshold
        target_b = target.bool()
        if preds.ndim >= 2 and (num_classes is None or preds.shape[1] == num_classes):
            c = preds.shape[1]
            n = preds.shape[0]
            return preds_hard.reshape(n, c, -1), target_b.reshape(n, c, -1), c
        return preds_hard.reshape(-1, 1, 1), target_b.reshape(-1, 1, 1), 1
    # hard labels: the class count from the data unless given
    if not num_classes and _is_traced(preds, target):
        raise TraceIneligibleError(
            "dice with hard labels infers the class count from the data, which cannot run under"
            " torch.func.vmap; pass num_classes explicitly."
        )
    c = num_classes or int(max(int(preds.max()), int(target.max())) + 1)
    n = preds.shape[0] if preds.ndim else 1
    classes = torch.arange(c, device=preds.device)
    preds_oh = classes.reshape(1, c, *([1] * max(preds.ndim - 1, 0))) == preds[:, None]
    target_oh = classes.reshape(1, c, *([1] * max(target.ndim - 1, 0))) == target[:, None]
    return preds_oh.reshape(n, c, -1), target_oh.reshape(n, c, -1), c


def _dice_stats(
    preds_oh: Tensor, target_oh: Tensor, target_raw: Tensor, ignore_index: Optional[int]
) -> Tuple[Tensor, Tensor, Tensor]:
    """Per-(sample, class) tp/fp/fn over the flattened extra dims.

    Legacy ``ignore_index`` semantics (reference ``utilities/checks.py`` column
    deletion): the ignored CLASS column is removed from the stats — other-class
    predictions on ignored-target samples still count.
    """
    tp = (preds_oh & target_oh).sum(-1)
    fp = (preds_oh & ~target_oh).sum(-1)
    fn = (~preds_oh & target_oh).sum(-1)
    if ignore_index is not None and 0 <= ignore_index < tp.shape[1]:
        keep = torch.arange(tp.shape[1], device=tp.device) != ignore_index
        tp = tp * keep
        fp = fp * keep
        fn = fn * keep
    return tp, fp, fn


def _dice_reduce(tp: Tensor, fp: Tensor, fn: Tensor, average: Optional[str], zero_division: float) -> Tensor:
    """Reduce (..., C) stats by the average mode (trailing axis = classes)."""
    if average == "micro":
        tp, fp, fn = tp.sum(-1), fp.sum(-1), fn.sum(-1)
        denom = 2 * tp + fp + fn
        return torch.where(denom == 0, zero_division, _safe_divide(2 * tp, denom))
    score = torch.where(2 * tp + fp + fn == 0, zero_division, _safe_divide(2 * tp, 2 * tp + fp + fn))
    present = (tp + fp + fn) > 0
    if average == "macro":
        return _safe_divide((torch.where(present, score, 0.0)).sum(-1), present.sum(-1))
    if average == "weighted":
        support = tp + fn
        return _safe_divide((score * support).sum(-1), support.sum(-1))
    # none: absent classes are reported as zero_division is NOT applied — keep score
    return score


def dice(
    preds: Tensor,
    target: Tensor,
    zero_division: float = 0,
    average: Optional[str] = "micro",
    mdmc_average: Optional[str] = "global",
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    num_classes: Optional[int] = None,
    ignore_index: Optional[int] = None,
) -> Tensor:
    """Compute the Dice coefficient.

    >>> preds = torch.tensor([2, 0, 2, 1])
    >>> target = torch.tensor([1, 1, 2, 0])
    >>> float(dice(preds, target, average="micro"))
    0.25
    """
    if average not in _AVERAGES:
        raise ValueError(f"The `average` has to be one of {_AVERAGES}, got {average}.")
    if mdmc_average not in _MDMC:
        raise ValueError(f"The `mdmc_average` has to be one of {_MDMC}, got {mdmc_average}.")
    preds_oh, target_oh, _ = _dice_format(preds, target, threshold, top_k, num_classes)
    tp, fp, fn = _dice_stats(preds_oh, target_oh, target, ignore_index)  # (N, C)
    if average == "samples" or mdmc_average == "samplewise":
        inner = "micro" if average == "samples" else average
        per_sample = _dice_reduce(tp, fp, fn, inner, zero_division)  # (N,) or (N, C) for 'none'
        return per_sample.mean(dim=0)  # average over samples only; per-class axis survives
    tp, fp, fn = tp.sum(0), fp.sum(0), fn.sum(0)  # global accumulation → (C,)
    return _dice_reduce(tp, fp, fn, average, zero_division)
