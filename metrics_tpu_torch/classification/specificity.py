"""Specificity metrics (counterpart of ``metrics_tpu/classification/specificity.py``)."""

from __future__ import annotations

from typing import Any, Optional

import torch

from metrics_tpu_torch.classification.base import _ClassificationTaskWrapper
from metrics_tpu_torch.classification.stat_scores import BinaryStatScores, MulticlassStatScores, MultilabelStatScores
from metrics_tpu_torch.functional.classification._reduce import _specificity_reduce
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.enums import ClassificationTask

Tensor = torch.Tensor


class BinarySpecificity(BinaryStatScores):
    """Compute Specificity for binary tasks.

    >>> target = torch.tensor([0, 1, 0, 1, 0, 1])
    >>> preds = torch.tensor([0, 0, 1, 1, 0, 1])
    >>> metric = BinarySpecificity(device="cpu")
    >>> metric.update(preds, target)
    >>> metric.compute()
    tensor(0.6667)
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def compute(self) -> Tensor:
        """Compute metric."""
        tp, fp, tn, fn = self._final_state()
        return _specificity_reduce(tp, fp, tn, fn, average="binary", multidim_average=self.multidim_average)


class MulticlassSpecificity(MulticlassStatScores):
    """Compute Specificity for multiclass tasks."""

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def compute(self) -> Tensor:
        """Compute metric."""
        tp, fp, tn, fn = self._final_state()
        return _specificity_reduce(tp, fp, tn, fn, average=self.average, multidim_average=self.multidim_average)


class MultilabelSpecificity(MultilabelStatScores):
    """Compute Specificity for multilabel tasks."""

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def compute(self) -> Tensor:
        """Compute metric."""
        tp, fp, tn, fn = self._final_state()
        return _specificity_reduce(
            tp, fp, tn, fn, average=self.average, multidim_average=self.multidim_average, multilabel=True
        )


class Specificity(_ClassificationTaskWrapper):
    """Task-dispatching Specificity.

    >>> preds = torch.tensor([2, 0, 2, 1])
    >>> target = torch.tensor([1, 1, 2, 0])
    >>> specificity = Specificity(task="multiclass", average='macro', num_classes=3, device="cpu")
    >>> specificity.update(preds, target)
    >>> specificity.compute()
    tensor(0.6111)
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
        """Initialize task metric."""
        task = ClassificationTask.from_str(task)
        kwargs.update({
            "multidim_average": multidim_average,
            "ignore_index": ignore_index,
            "validate_args": validate_args,
        })
        if task == ClassificationTask.BINARY:
            return BinarySpecificity(threshold, **kwargs)
        if task == ClassificationTask.MULTICLASS:
            if not isinstance(num_classes, int):
                raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)}` was passed.")
            if not isinstance(top_k, int):
                raise ValueError(f"`top_k` is expected to be `int` but `{type(top_k)}` was passed.")
            return MulticlassSpecificity(num_classes, top_k, average, **kwargs)
        if task == ClassificationTask.MULTILABEL:
            if not isinstance(num_labels, int):
                raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)}` was passed.")
            return MultilabelSpecificity(num_labels, threshold, average, **kwargs)
        raise ValueError(f"Not handled value: {task}")
