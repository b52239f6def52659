"""Precision and recall metrics.

Counterpart of ``metrics_tpu/classification/precision_recall.py``.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from metrics_tpu_torch.classification.base import _ClassificationTaskWrapper
from metrics_tpu_torch.classification.stat_scores import BinaryStatScores, MulticlassStatScores, MultilabelStatScores
from metrics_tpu_torch.functional.classification._reduce import _precision_recall_reduce
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.enums import ClassificationTask

Tensor = torch.Tensor


class _PrecisionRecallMixin:
    """Shared compute over stat-score states; ``_stat`` picks the score."""

    _stat: str = "precision"
    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(self, *args: Any, zero_division: float = 0, **kwargs: Any) -> None:
        super().__init__(*args, **kwargs)
        self.zero_division = zero_division


class BinaryPrecision(_PrecisionRecallMixin, BinaryStatScores):
    """Compute Precision for binary tasks.

    >>> target = torch.tensor([0, 1, 0, 1, 0, 1])
    >>> preds = torch.tensor([0, 0, 1, 1, 0, 1])
    >>> metric = BinaryPrecision(device="cpu")
    >>> metric.update(preds, target)
    >>> metric.compute()
    tensor(0.6667)
    """

    _stat = "precision"

    def compute(self) -> Tensor:
        """Compute metric."""
        tp, fp, tn, fn = self._final_state()
        return _precision_recall_reduce(
            self._stat, tp, fp, tn, fn, average="binary", multidim_average=self.multidim_average,
            zero_division=self.zero_division,
        )


class MulticlassPrecision(_PrecisionRecallMixin, MulticlassStatScores):
    """Compute Precision for multiclass tasks.

    >>> target = torch.tensor([2, 1, 0, 0])
    >>> preds = torch.tensor([2, 1, 0, 1])
    >>> metric = MulticlassPrecision(num_classes=3, device="cpu")
    >>> metric.update(preds, target)
    >>> metric.compute()
    tensor(0.8333)
    """

    _stat = "precision"

    def compute(self) -> Tensor:
        """Compute metric."""
        tp, fp, tn, fn = self._final_state()
        return _precision_recall_reduce(
            self._stat, tp, fp, tn, fn, average=self.average, multidim_average=self.multidim_average,
            top_k=self.top_k, zero_division=self.zero_division,
        )


class MultilabelPrecision(_PrecisionRecallMixin, MultilabelStatScores):
    """Compute Precision for multilabel tasks."""

    _stat = "precision"

    def compute(self) -> Tensor:
        """Compute metric."""
        tp, fp, tn, fn = self._final_state()
        return _precision_recall_reduce(
            self._stat, tp, fp, tn, fn, average=self.average, multidim_average=self.multidim_average,
            multilabel=True, zero_division=self.zero_division,
        )


class BinaryRecall(BinaryPrecision):
    """Compute Recall for binary tasks.

    >>> target = torch.tensor([0, 1, 0, 1, 0, 1])
    >>> preds = torch.tensor([0, 0, 1, 1, 0, 1])
    >>> metric = BinaryRecall(device="cpu")
    >>> metric.update(preds, target)
    >>> metric.compute()
    tensor(0.6667)
    """

    _stat = "recall"


class MulticlassRecall(MulticlassPrecision):
    """Compute Recall for multiclass tasks."""

    _stat = "recall"


class MultilabelRecall(MultilabelPrecision):
    """Compute Recall for multilabel tasks."""

    _stat = "recall"


def _dispatch_task(
    stat_cls_binary, stat_cls_multiclass, stat_cls_multilabel, task, threshold, num_classes, num_labels, average,
    multidim_average, top_k, ignore_index, validate_args, zero_division, kwargs,
) -> Metric:
    task = ClassificationTask.from_str(task)
    kwargs.update({
        "multidim_average": multidim_average,
        "ignore_index": ignore_index,
        "validate_args": validate_args,
        "zero_division": zero_division,
    })
    if task == ClassificationTask.BINARY:
        return stat_cls_binary(threshold, **kwargs)
    if task == ClassificationTask.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)}` was passed.")
        if not isinstance(top_k, int):
            raise ValueError(f"`top_k` is expected to be `int` but `{type(top_k)}` was passed.")
        return stat_cls_multiclass(num_classes, top_k, average, **kwargs)
    if task == ClassificationTask.MULTILABEL:
        if not isinstance(num_labels, int):
            raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)}` was passed.")
        return stat_cls_multilabel(num_labels, threshold, average, **kwargs)
    raise ValueError(f"Not handled value: {task}")


class Precision(_ClassificationTaskWrapper):
    """Task-dispatching Precision.

    >>> preds = torch.tensor([2, 0, 2, 1])
    >>> target = torch.tensor([1, 1, 2, 0])
    >>> precision = Precision(task="multiclass", average='macro', num_classes=3, device="cpu")
    >>> precision.update(preds, target)
    >>> precision.compute()
    tensor(0.1667)
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
        zero_division: float = 0,
        **kwargs: Any,
    ) -> Metric:
        """Initialize task metric."""
        return _dispatch_task(
            BinaryPrecision, MulticlassPrecision, MultilabelPrecision, task, threshold, num_classes, num_labels,
            average, multidim_average, top_k, ignore_index, validate_args, zero_division, kwargs,
        )


class Recall(_ClassificationTaskWrapper):
    """Task-dispatching Recall."""

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
        zero_division: float = 0,
        **kwargs: Any,
    ) -> Metric:
        """Initialize task metric."""
        return _dispatch_task(
            BinaryRecall, MulticlassRecall, MultilabelRecall, task, threshold, num_classes, num_labels,
            average, multidim_average, top_k, ignore_index, validate_args, zero_division, kwargs,
        )
