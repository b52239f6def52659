"""Stat-scores metrics (counterpart of ``metrics_tpu/classification/stat_scores.py``).

tp/fp/tn/fn are int64 sum states for ``multidim_average="global"`` and "cat"
list states for ``"samplewise"``.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from metrics_tpu_torch.classification.base import _ClassificationTaskWrapper
from metrics_tpu_torch.functional.classification.stat_scores import (
    _binary_stat_scores_arg_validation,
    _binary_stat_scores_compute,
    _binary_stat_scores_format,
    _binary_stat_scores_tensor_validation,
    _binary_stat_scores_update,
    _multiclass_stat_scores_arg_validation,
    _multiclass_stat_scores_compute,
    _multiclass_stat_scores_format,
    _multiclass_stat_scores_tensor_validation,
    _multiclass_stat_scores_update,
    _multilabel_stat_scores_arg_validation,
    _multilabel_stat_scores_compute,
    _multilabel_stat_scores_format,
    _multilabel_stat_scores_tensor_validation,
    _multilabel_stat_scores_update,
)
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.data import dim_zero_cat
from metrics_tpu_torch.utils.enums import ClassificationTask

Tensor = torch.Tensor


class _AbstractStatScores(Metric):
    """State plumbing shared by the tp/fp/tn/fn metrics."""

    def _create_state(self, size: int, multidim_average: str = "global") -> None:
        for name in ("tp", "fp", "tn", "fn"):
            if multidim_average == "samplewise":
                self.add_state(name, [], dist_reduce_fx="cat")
            else:
                self.add_state(name, torch.zeros(size, dtype=torch.int64), dist_reduce_fx="sum")

    def _update_state(self, tp: Tensor, fp: Tensor, tn: Tensor, fn: Tensor) -> None:
        if self.multidim_average == "samplewise":
            self.tp.append(torch.atleast_1d(tp))
            self.fp.append(torch.atleast_1d(fp))
            self.tn.append(torch.atleast_1d(tn))
            self.fn.append(torch.atleast_1d(fn))
        else:
            self.tp = self.tp + tp
            self.fp = self.fp + fp
            self.tn = self.tn + tn
            self.fn = self.fn + fn

    def _final_state(self) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
        return dim_zero_cat(self.tp), dim_zero_cat(self.fp), dim_zero_cat(self.tn), dim_zero_cat(self.fn)


class BinaryStatScores(_AbstractStatScores):
    """tp/fp/tn/fn/support for binary tasks.

    >>> metric = BinaryStatScores(device="cpu")
    >>> metric.update(torch.tensor([0, 0, 1, 1, 0, 1]), torch.tensor([0, 1, 0, 1, 0, 1]))
    >>> metric.compute()
    tensor([2, 1, 2, 1, 3])
    """

    is_differentiable = False
    higher_is_better = None
    full_state_update = False

    def __init__(
        self,
        threshold: float = 0.5,
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _binary_stat_scores_arg_validation(threshold, multidim_average, ignore_index)
        self.threshold = threshold
        self.multidim_average = multidim_average
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_state(size=1, multidim_average=multidim_average)

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Update state with predictions and targets."""
        if self.validate_args:
            _binary_stat_scores_tensor_validation(preds, target, self.multidim_average, self.ignore_index)
        preds, target = _binary_stat_scores_format(preds, target, self.threshold, self.ignore_index)
        self._update_state(*_binary_stat_scores_update(preds, target, self.multidim_average))

    def compute(self) -> Tensor:
        """Compute the final statistics."""
        return _binary_stat_scores_compute(*self._final_state(), self.multidim_average)


class MulticlassStatScores(_AbstractStatScores):
    """tp/fp/tn/fn/support for multiclass tasks.

    >>> metric = MulticlassStatScores(num_classes=3, average='micro', device="cpu")
    >>> metric.update(torch.tensor([2, 1, 0, 1]), torch.tensor([2, 1, 0, 0]))
    >>> metric.compute()
    tensor([3, 1, 7, 1, 4])
    """

    is_differentiable = False
    higher_is_better = None
    full_state_update = False

    def __init__(
        self,
        num_classes: int,
        top_k: int = 1,
        average: Optional[str] = "macro",
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multiclass_stat_scores_arg_validation(num_classes, top_k, average, multidim_average, ignore_index)
        self.num_classes = num_classes
        self.top_k = top_k
        self.average = average
        self.multidim_average = multidim_average
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_state(
            size=1 if (average == "micro" and top_k == 1) else (num_classes or 1), multidim_average=multidim_average
        )

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Update state with predictions and targets."""
        if self.validate_args:
            _multiclass_stat_scores_tensor_validation(
                preds, target, self.num_classes, self.multidim_average, self.ignore_index
            )
        preds, target = _multiclass_stat_scores_format(preds, target, self.top_k)
        self._update_state(*_multiclass_stat_scores_update(
            preds, target, self.num_classes, self.top_k, self.average, self.multidim_average, self.ignore_index
        ))

    def compute(self) -> Tensor:
        """Compute the final statistics."""
        return _multiclass_stat_scores_compute(*self._final_state(), self.average, self.multidim_average)


class MultilabelStatScores(_AbstractStatScores):
    """tp/fp/tn/fn/support for multilabel tasks."""

    is_differentiable = False
    higher_is_better = None
    full_state_update = False

    def __init__(
        self,
        num_labels: int,
        threshold: float = 0.5,
        average: Optional[str] = "macro",
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multilabel_stat_scores_arg_validation(num_labels, threshold, average, multidim_average, ignore_index)
        self.num_labels = num_labels
        self.threshold = threshold
        self.average = average
        self.multidim_average = multidim_average
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_state(size=num_labels, multidim_average=multidim_average)

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Update state with predictions and targets."""
        if self.validate_args:
            _multilabel_stat_scores_tensor_validation(
                preds, target, self.num_labels, self.multidim_average, self.ignore_index
            )
        preds, target = _multilabel_stat_scores_format(
            preds, target, self.num_labels, self.threshold, self.ignore_index
        )
        self._update_state(*_multilabel_stat_scores_update(preds, target, self.multidim_average))

    def compute(self) -> Tensor:
        """Compute the final statistics."""
        return _multilabel_stat_scores_compute(*self._final_state(), self.average, self.multidim_average)


class StatScores(_ClassificationTaskWrapper):
    """Task-dispatching stat scores: returns the binary, multiclass or multilabel metric."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        threshold: float = 0.5,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        average: Optional[str] = "micro",
        multidim_average: str = "global",
        top_k: Optional[int] = 1,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        task = ClassificationTask.from_str(task)
        kwargs.update({"multidim_average": multidim_average, "ignore_index": ignore_index,
                       "validate_args": validate_args})
        if task == ClassificationTask.BINARY:
            return BinaryStatScores(threshold, **kwargs)
        if task == ClassificationTask.MULTICLASS:
            if not isinstance(num_classes, int):
                raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)}` was passed.")
            if not isinstance(top_k, int):
                raise ValueError(f"`top_k` is expected to be `int` but `{type(top_k)}` was passed.")
            return MulticlassStatScores(num_classes, top_k, average, **kwargs)
        if not isinstance(num_labels, int):
            raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)}` was passed.")
        return MultilabelStatScores(num_labels, threshold, average, **kwargs)
