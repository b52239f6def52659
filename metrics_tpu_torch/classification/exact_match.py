"""Exact-match metrics (counterpart of ``metrics_tpu/classification/exact_match.py``).

``correct`` and ``total`` are int64 sum states for ``multidim_average="global"``
and "cat" list states for ``"samplewise"``.
"""

from __future__ import annotations

from typing import Any, List, Optional, Union

import torch
from torch import Tensor

from metrics_tpu_torch.classification.base import _ClassificationTaskWrapper
from metrics_tpu_torch.functional.classification.exact_match import (
    _exact_match_reduce,
    _multiclass_exact_match_update,
    _multilabel_exact_match_update,
)
from metrics_tpu_torch.functional.classification.stat_scores import (
    _multiclass_stat_scores_arg_validation,
    _multiclass_stat_scores_format,
    _multiclass_stat_scores_tensor_validation,
    _multilabel_stat_scores_arg_validation,
    _multilabel_stat_scores_format,
    _multilabel_stat_scores_tensor_validation,
)
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.data import dim_zero_cat
from metrics_tpu_torch.utils.enums import ClassificationTaskNoBinary


class _AbstractExactMatch(Metric):
    """Shared state plumbing for exact-match metrics."""

    correct: Union[Tensor, List[Tensor]]
    total: Union[Tensor, List[Tensor]]

    def _create_state(self, multidim_average: str) -> None:
        for name in ("correct", "total"):
            if multidim_average == "samplewise":
                self.add_state(name, [], dist_reduce_fx="cat")
            else:
                self.add_state(name, torch.zeros((), dtype=torch.int64), dist_reduce_fx="sum")

    def _update_state(self, correct: Tensor, total: Tensor) -> None:
        if self.multidim_average == "samplewise":
            self.correct.append(torch.atleast_1d(correct))
            self.total.append(torch.atleast_1d(total))
        else:
            self.correct = self.correct + correct
            self.total = self.total + total

    def _final_state(self):
        return dim_zero_cat(self.correct), dim_zero_cat(self.total)


class MulticlassExactMatch(_AbstractExactMatch):
    """Compute Exact match for multiclass tasks.

    >>> target = torch.tensor([[0, 1], [1, 1]])
    >>> preds = torch.tensor([[0, 1], [0, 1]])
    >>> metric = MulticlassExactMatch(num_classes=2, device="cpu")
    >>> metric.update(preds, target)
    >>> metric.compute()
    tensor(0.5000)
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(
        self,
        num_classes: int,
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multiclass_stat_scores_arg_validation(num_classes, 1, "micro", multidim_average, ignore_index)
        self.num_classes = num_classes
        self.multidim_average = multidim_average
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_state(multidim_average)

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Update state with predictions and targets."""
        if self.validate_args:
            _multiclass_stat_scores_tensor_validation(
                preds, target, self.num_classes, self.multidim_average, self.ignore_index
            )
        preds, target = _multiclass_stat_scores_format(preds, target, 1)
        correct, total = _multiclass_exact_match_update(preds, target, self.multidim_average, self.ignore_index)
        self._update_state(correct, total)

    def compute(self) -> Tensor:
        """Compute metric."""
        correct, total = self._final_state()
        return _exact_match_reduce(correct, total)


class MultilabelExactMatch(_AbstractExactMatch):
    """Compute Exact match for multilabel tasks.

    >>> target = torch.tensor([[0, 1, 0], [1, 0, 1]])
    >>> preds = torch.tensor([[0, 1, 1], [1, 0, 1]])
    >>> metric = MultilabelExactMatch(num_labels=3, device="cpu")
    >>> metric.update(preds, target)
    >>> metric.compute()
    tensor(0.5000)
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(
        self,
        num_labels: int,
        threshold: float = 0.5,
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multilabel_stat_scores_arg_validation(num_labels, threshold, None, multidim_average, ignore_index)
        self.num_labels = num_labels
        self.threshold = threshold
        self.multidim_average = multidim_average
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_state(multidim_average)

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Update state with predictions and targets."""
        if self.validate_args:
            _multilabel_stat_scores_tensor_validation(
                preds, target, self.num_labels, self.multidim_average, self.ignore_index
            )
        preds, target = _multilabel_stat_scores_format(
            preds, target, self.num_labels, self.threshold, self.ignore_index
        )
        correct, total = _multilabel_exact_match_update(preds, target, self.num_labels, self.multidim_average)
        self._update_state(correct, total)

    def compute(self) -> Tensor:
        """Compute metric."""
        correct, total = self._final_state()
        return _exact_match_reduce(correct, total)


class ExactMatch(_ClassificationTaskWrapper):
    """Task-dispatching Exact match.

    >>> target = torch.tensor([[0, 1], [1, 1]])
    >>> preds = torch.tensor([[0, 1], [0, 1]])
    >>> metric = ExactMatch(task="multiclass", num_classes=2, device="cpu")
    >>> metric.update(preds, target)
    >>> metric.compute()
    tensor(0.5000)
    """

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        threshold: float = 0.5,
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        """Initialize task metric."""
        task = ClassificationTaskNoBinary.from_str(task)
        kwargs.update({
            "multidim_average": multidim_average,
            "ignore_index": ignore_index,
            "validate_args": validate_args,
        })
        if task == ClassificationTaskNoBinary.MULTICLASS:
            if not isinstance(num_classes, int):
                raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)}` was passed.")
            return MulticlassExactMatch(num_classes, **kwargs)
        if task == ClassificationTaskNoBinary.MULTILABEL:
            if not isinstance(num_labels, int):
                raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)}` was passed.")
            return MultilabelExactMatch(num_labels, threshold, **kwargs)
        raise ValueError(f"Not handled value: {task}")
