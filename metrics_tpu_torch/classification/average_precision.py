"""AveragePrecision metrics (counterpart of ``metrics_tpu/classification/average_precision.py``).

The states and updates are the precision-recall curve's; ``compute`` reduces
the precision-recall curves to their average precision.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from metrics_tpu_torch.classification.base import _ClassificationTaskWrapper, _plot_as_scalar
from metrics_tpu_torch.classification.precision_recall_curve import (
    BinaryPrecisionRecallCurve,
    MulticlassPrecisionRecallCurve,
    MultilabelPrecisionRecallCurve,
)
from metrics_tpu_torch.functional.classification.average_precision import (
    _binary_average_precision_compute,
    _multiclass_average_precision_arg_validation,
    _multiclass_average_precision_compute,
    _multilabel_average_precision_arg_validation,
    _multilabel_average_precision_compute,
)
from metrics_tpu_torch.functional.classification.precision_recall_curve import Thresholds
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.enums import ClassificationTask

Tensor = torch.Tensor


class BinaryAveragePrecision(BinaryPrecisionRecallCurve):
    """Average precision for binary tasks.

    >>> metric = BinaryAveragePrecision(device="cpu")
    >>> metric.update(torch.tensor([0.0, 0.5, 0.7, 0.8]), torch.tensor([0, 1, 1, 0]))
    >>> metric.compute()
    tensor(0.5833)
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def compute(self) -> Tensor:
        """The average precision."""
        return _binary_average_precision_compute(self._final_state(), self.thresholds)


class MulticlassAveragePrecision(MulticlassPrecisionRecallCurve):
    """Average precision for multiclass tasks (one-vs-rest per class, then averaged).

    >>> metric = MulticlassAveragePrecision(num_classes=2, device="cpu")
    >>> metric.update(torch.tensor([[0.9, 0.1], [0.2, 0.8], [0.7, 0.3]]), torch.tensor([0, 1, 0]))
    >>> metric.compute()
    tensor(1.)
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    plot_legend_name = "Class"

    def __init__(
        self,
        num_classes: int,
        average: Optional[str] = "macro",
        thresholds: Thresholds = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            num_classes=num_classes, thresholds=thresholds, ignore_index=ignore_index, validate_args=False, **kwargs
        )
        if validate_args:
            _multiclass_average_precision_arg_validation(num_classes, average, thresholds, ignore_index)
        self.validate_args = validate_args
        self.average = average

    def compute(self) -> Tensor:
        """The per-class average precision, reduced by ``average``."""
        return _multiclass_average_precision_compute(self._final_state(), self.num_classes, self.average, self.thresholds)


class MultilabelAveragePrecision(MultilabelPrecisionRecallCurve):
    """Average precision for multilabel tasks (per label, then averaged: mAP under ``average="macro"``)."""

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    plot_legend_name = "Label"

    def __init__(
        self,
        num_labels: int,
        average: Optional[str] = "macro",
        thresholds: Thresholds = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            num_labels=num_labels, thresholds=thresholds, ignore_index=ignore_index, validate_args=False, **kwargs
        )
        if validate_args:
            _multilabel_average_precision_arg_validation(num_labels, average, thresholds, ignore_index)
        self.validate_args = validate_args
        self.average = average

    def compute(self) -> Tensor:
        """The per-label average precision, reduced by ``average``."""
        return _multilabel_average_precision_compute(
            self._final_state(), self.num_labels, self.average, self.thresholds, self.ignore_index
        )


class AveragePrecision(_ClassificationTaskWrapper):
    """Task-dispatching AveragePrecision: returns the binary, multiclass or multilabel metric.

    >>> average_precision = AveragePrecision(task="binary", device="cpu")
    >>> average_precision.update(torch.tensor([0.0, 0.5, 0.7, 0.8]), torch.tensor([0, 1, 1, 0]))
    >>> average_precision.compute()
    tensor(0.5833)
    """

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        thresholds: Thresholds = None,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        average: Optional[str] = "macro",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        task = ClassificationTask.from_str(task)
        kwargs.update({"thresholds": thresholds, "ignore_index": ignore_index, "validate_args": validate_args})
        if task == ClassificationTask.BINARY:
            return BinaryAveragePrecision(**kwargs)
        if task == ClassificationTask.MULTICLASS:
            if not isinstance(num_classes, int):
                raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)}` was passed.")
            return MulticlassAveragePrecision(num_classes, average, **kwargs)
        if task == ClassificationTask.MULTILABEL:
            if not isinstance(num_labels, int):
                raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)}` was passed.")
            return MultilabelAveragePrecision(num_labels, average, **kwargs)
        raise ValueError(f"Not handled value: {task}")


_plot_as_scalar(BinaryAveragePrecision, MulticlassAveragePrecision, MultilabelAveragePrecision)
