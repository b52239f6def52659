"""Precision-at-fixed-recall metrics (counterpart of ``metrics_tpu/classification/precision_fixed_recall.py``).

The states and updates are the precision-recall curve's; ``compute`` picks the
best precision at a minimum recall, and its threshold.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from metrics_tpu_torch.classification.base import _ClassificationTaskWrapper, _plot_as_scalar
from metrics_tpu_torch.classification.precision_recall_curve import (
    BinaryPrecisionRecallCurve,
    MulticlassPrecisionRecallCurve,
    MultilabelPrecisionRecallCurve,
)
from metrics_tpu_torch.functional.classification._fixed_point import _per_class_reduce
from metrics_tpu_torch.functional.classification.precision_fixed_recall import _precision_at_recall
from metrics_tpu_torch.functional.classification.precision_recall_curve import (
    Thresholds,
    _binary_precision_recall_curve_compute,
    _multiclass_precision_recall_curve_compute,
    _multilabel_precision_recall_curve_compute,
)
from metrics_tpu_torch.functional.classification.sensitivity_specificity import _validate_min_arg
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.enums import ClassificationTask

Tensor = torch.Tensor


class BinaryPrecisionAtFixedRecall(BinaryPrecisionRecallCurve):
    """The highest precision at a minimum recall, and its threshold, for binary tasks.

    >>> metric = BinaryPrecisionAtFixedRecall(min_recall=0.5, device="cpu")
    >>> metric.update(torch.tensor([0.1, 0.4, 0.6, 0.8]), torch.tensor([0, 0, 1, 1]))
    >>> metric.compute()
    (tensor(1.), tensor(0.6000))
    """

    def __init__(
        self,
        min_recall: float,
        thresholds: Thresholds = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(thresholds=thresholds, ignore_index=ignore_index, validate_args=False, **kwargs)
        if validate_args:
            _validate_min_arg(min_recall, "min_recall")
        self.validate_args = validate_args
        self.min_recall = min_recall

    def compute(self) -> Tuple[Tensor, Tensor]:
        """The precision and its threshold."""
        precision, recall, thres = _binary_precision_recall_curve_compute(self._final_state(), self.thresholds)
        return _precision_at_recall(precision, recall, thres, self.min_recall)


class MulticlassPrecisionAtFixedRecall(MulticlassPrecisionRecallCurve):
    """The highest precision at a minimum recall, and its threshold, per class."""

    def __init__(
        self,
        num_classes: int,
        min_recall: float,
        thresholds: Thresholds = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            num_classes=num_classes, thresholds=thresholds, ignore_index=ignore_index, validate_args=False, **kwargs
        )
        if validate_args:
            _validate_min_arg(min_recall, "min_recall")
        self.validate_args = validate_args
        self.min_recall = min_recall

    def compute(self) -> Tuple[Tensor, Tensor]:
        """Per-class precisions and thresholds."""
        curves = _multiclass_precision_recall_curve_compute(self._final_state(), self.num_classes, self.thresholds)
        return _per_class_reduce(curves, self.num_classes,
                                 lambda p, r, t: _precision_at_recall(p, r, t, self.min_recall))


class MultilabelPrecisionAtFixedRecall(MultilabelPrecisionRecallCurve):
    """The highest precision at a minimum recall, and its threshold, per label."""

    def __init__(
        self,
        num_labels: int,
        min_recall: float,
        thresholds: Thresholds = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            num_labels=num_labels, thresholds=thresholds, ignore_index=ignore_index, validate_args=False, **kwargs
        )
        if validate_args:
            _validate_min_arg(min_recall, "min_recall")
        self.validate_args = validate_args
        self.min_recall = min_recall

    def compute(self) -> Tuple[Tensor, Tensor]:
        """Per-label precisions and thresholds."""
        curves = _multilabel_precision_recall_curve_compute(
            self._final_state(), self.num_labels, self.thresholds, self.ignore_index
        )
        return _per_class_reduce(curves, self.num_labels,
                                 lambda p, r, t: _precision_at_recall(p, r, t, self.min_recall))


class PrecisionAtFixedRecall(_ClassificationTaskWrapper):
    """Task-dispatching precision at a fixed recall: returns the binary, multiclass or multilabel metric."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        min_recall: float,
        thresholds: Thresholds = None,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        task = ClassificationTask.from_str(task)
        if task == ClassificationTask.BINARY:
            return BinaryPrecisionAtFixedRecall(min_recall, thresholds, ignore_index, validate_args, **kwargs)
        if task == ClassificationTask.MULTICLASS:
            if not isinstance(num_classes, int):
                raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)}` was passed.")
            return MulticlassPrecisionAtFixedRecall(
                num_classes, min_recall, thresholds, ignore_index, validate_args, **kwargs
            )
        if not isinstance(num_labels, int):
            raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)}` was passed.")
        return MultilabelPrecisionAtFixedRecall(
            num_labels, min_recall, thresholds, ignore_index, validate_args, **kwargs
        )


_plot_as_scalar(BinaryPrecisionAtFixedRecall, MulticlassPrecisionAtFixedRecall, MultilabelPrecisionAtFixedRecall)
