"""The Dice metric (counterpart of ``metrics_tpu/classification/dice.py``)."""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import Tensor

from metrics_tpu_torch.functional.classification.dice import (
    _AVERAGES,
    _MDMC,
    _dice_format,
    _dice_reduce,
    _dice_stats,
)
from metrics_tpu_torch.metric import Metric

__all__ = ["Dice"]


class Dice(Metric):
    """Dice coefficient: ``2·TP / (2·TP + FP + FN)``.

    Legacy parameter surface — see :func:`metrics_tpu_torch.functional.classification.dice.dice`.
    ``num_classes`` is required for ``average`` ∈ {macro, weighted, none}.

    >>> dice = Dice(average="micro", device="cpu")
    >>> dice.update(torch.tensor([2, 0, 2, 1]), torch.tensor([1, 1, 2, 0]))
    >>> round(float(dice.compute()), 4)
    0.25
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        zero_division: float = 0,
        num_classes: Optional[int] = None,
        threshold: float = 0.5,
        average: Optional[str] = "micro",
        mdmc_average: Optional[str] = "global",
        ignore_index: Optional[int] = None,
        top_k: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if average not in _AVERAGES:
            raise ValueError(f"The `average` has to be one of {_AVERAGES}, got {average}.")
        if mdmc_average not in _MDMC:
            raise ValueError(f"The `mdmc_average` has to be one of {_MDMC}, got {mdmc_average}.")
        if average in ("macro", "weighted", "none", None) and (not num_classes or num_classes < 1):
            raise ValueError(f"When you set `average` as {average}, you have to provide the number of classes.")
        if ignore_index is not None and num_classes and not 0 <= ignore_index < num_classes:
            raise ValueError(f"The `ignore_index` {ignore_index} is not valid for inputs with {num_classes} classes")
        self.zero_division = zero_division
        self.num_classes = num_classes
        self.threshold = threshold
        self.average = average
        self.mdmc_average = mdmc_average
        self.ignore_index = ignore_index
        self.top_k = top_k

        self._samplewise = average == "samples" or mdmc_average == "samplewise"
        if self._samplewise:
            # per-class axis survives samplewise averaging for average='none'/None
            score_shape = (num_classes,) if average in ("none", None) else ()
            self.add_state("score_sum", torch.zeros(score_shape), dist_reduce_fx="sum")
            self.add_state("n_samples", torch.zeros((), dtype=torch.int64), dist_reduce_fx="sum")
        elif average == "micro":
            self.add_state("tp", torch.zeros(()), dist_reduce_fx="sum")
            self.add_state("fp", torch.zeros(()), dist_reduce_fx="sum")
            self.add_state("fn", torch.zeros(()), dist_reduce_fx="sum")
        else:
            self.add_state("tp", torch.zeros(num_classes), dist_reduce_fx="sum")
            self.add_state("fp", torch.zeros(num_classes), dist_reduce_fx="sum")
            self.add_state("fn", torch.zeros(num_classes), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Update stat-score states from a batch."""
        preds_oh, target_oh, _ = _dice_format(preds, target, self.threshold, self.top_k, self.num_classes)
        tp, fp, fn = _dice_stats(preds_oh, target_oh, target, self.ignore_index)  # (N, C)
        if self._samplewise:
            inner = "micro" if self.average == "samples" else self.average
            per_sample = _dice_reduce(tp, fp, fn, inner, self.zero_division)  # (N,) or (N, C)
            self.score_sum = self.score_sum + per_sample.sum(axis=0)
            self.n_samples = self.n_samples + per_sample.shape[0]
        elif self.average == "micro":
            self.tp = self.tp + tp.sum()
            self.fp = self.fp + fp.sum()
            self.fn = self.fn + fn.sum()
        else:
            self.tp = self.tp + tp.sum(0)
            self.fp = self.fp + fp.sum(0)
            self.fn = self.fn + fn.sum(0)

    def compute(self) -> Tensor:
        """Compute the accumulated Dice coefficient."""
        if self._samplewise:
            return (self.score_sum / self.n_samples.clamp(min=1)).float()
        if self.average == "micro":
            denom = 2 * self.tp + self.fp + self.fn
            return torch.where(denom == 0, self.zero_division, 2 * self.tp / denom.clamp(min=1)).float()
        return _dice_reduce(self.tp, self.fp, self.fn, self.average, self.zero_division).float()
