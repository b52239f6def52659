"""Accuracy metrics (counterpart of ``metrics_tpu/classification/accuracy.py``)."""

from __future__ import annotations

from typing import Any, Optional

import torch

from metrics_tpu_torch.classification.base import _ClassificationTaskWrapper
from metrics_tpu_torch.classification.stat_scores import BinaryStatScores, MulticlassStatScores, MultilabelStatScores
from metrics_tpu_torch.functional.classification._reduce import _accuracy_reduce
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.enums import ClassificationTask


class BinaryAccuracy(BinaryStatScores):
    """Accuracy for binary tasks.

    >>> metric = BinaryAccuracy(device="cpu")
    >>> metric.update(torch.tensor([0, 0, 1, 1, 0, 1]), torch.tensor([0, 1, 0, 1, 0, 1]))
    >>> metric.compute()
    tensor(0.6667)
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def compute(self) -> torch.Tensor:
        """Accuracy over every update so far."""
        tp, fp, tn, fn = self._final_state()
        return _accuracy_reduce(tp, fp, tn, fn, average="binary", multidim_average=self.multidim_average)


class MulticlassAccuracy(MulticlassStatScores):
    """Accuracy for multiclass tasks.

    >>> metric = MulticlassAccuracy(num_classes=3, device="cpu")
    >>> metric.update(torch.tensor([2, 1, 0, 1]), torch.tensor([2, 1, 0, 0]))
    >>> metric.compute()
    tensor(0.8333)
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    plot_legend_name = "Class"

    def compute(self) -> torch.Tensor:
        """Accuracy over every update so far."""
        tp, fp, tn, fn = self._final_state()
        return _accuracy_reduce(
            tp, fp, tn, fn, average=self.average, multidim_average=self.multidim_average, top_k=self.top_k
        )


class MultilabelAccuracy(MultilabelStatScores):
    """Accuracy for multilabel tasks."""

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    plot_legend_name = "Label"

    def compute(self) -> torch.Tensor:
        """Accuracy over every update so far."""
        tp, fp, tn, fn = self._final_state()
        return _accuracy_reduce(
            tp, fp, tn, fn, average=self.average, multidim_average=self.multidim_average, multilabel=True
        )


class Accuracy(_ClassificationTaskWrapper):
    """Task-dispatching accuracy: returns the binary, multiclass or multilabel metric.

    >>> accuracy = Accuracy(task="multiclass", num_classes=3, device="cpu")
    >>> accuracy.update(torch.tensor([2, 1, 0, 1]), torch.tensor([2, 1, 0, 0]))
    >>> accuracy.compute()
    tensor(0.7500)
    """

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
            return BinaryAccuracy(threshold, **kwargs)
        if task == ClassificationTask.MULTICLASS:
            if not isinstance(num_classes, int):
                raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)}` was passed.")
            if not isinstance(top_k, int):
                raise ValueError(f"`top_k` is expected to be `int` but `{type(top_k)}` was passed.")
            return MulticlassAccuracy(num_classes, top_k, average, **kwargs)
        if not isinstance(num_labels, int):
            raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)}` was passed.")
        return MultilabelAccuracy(num_labels, threshold, average, **kwargs)
