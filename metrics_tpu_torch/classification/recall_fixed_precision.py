"""Recall-at-fixed-precision metrics (counterpart of ``metrics_tpu/classification/recall_fixed_precision.py``).

The states and updates are the precision-recall curve's; ``compute`` picks the
best recall at a minimum precision, and its threshold.
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
from metrics_tpu_torch.functional.classification.precision_recall_curve import (
    Thresholds,
    _multiclass_precision_recall_curve_compute,
    _multilabel_precision_recall_curve_compute,
)
from metrics_tpu_torch.functional.classification.recall_fixed_precision import (
    _binary_recall_at_fixed_precision_compute,
    _recall_at_precision,
)
from metrics_tpu_torch.functional.classification.sensitivity_specificity import _validate_min_arg
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.enums import ClassificationTask

Tensor = torch.Tensor


class BinaryRecallAtFixedPrecision(BinaryPrecisionRecallCurve):
    """The highest recall at a minimum precision, and its threshold, for binary tasks.

    >>> metric = BinaryRecallAtFixedPrecision(min_precision=0.5, device="cpu")
    >>> metric.update(torch.tensor([0.1, 0.4, 0.6, 0.8]), torch.tensor([0, 0, 1, 1]))
    >>> metric.compute()
    (tensor(1.), tensor(0.6000))
    """

    def __init__(
        self,
        min_precision: float,
        thresholds: Thresholds = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(thresholds=thresholds, ignore_index=ignore_index, validate_args=False, **kwargs)
        if validate_args:
            _validate_min_arg(min_precision, "min_precision")
        self.validate_args = validate_args
        self.min_precision = min_precision

    def compute(self) -> Tuple[Tensor, Tensor]:
        """The recall and its threshold."""
        return _binary_recall_at_fixed_precision_compute(self._final_state(), self.thresholds, self.min_precision)


class MulticlassRecallAtFixedPrecision(MulticlassPrecisionRecallCurve):
    """The highest recall at a minimum precision, and its threshold, per class."""

    def __init__(
        self,
        num_classes: int,
        min_precision: float,
        thresholds: Thresholds = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            num_classes=num_classes, thresholds=thresholds, ignore_index=ignore_index, validate_args=False, **kwargs
        )
        if validate_args:
            _validate_min_arg(min_precision, "min_precision")
        self.validate_args = validate_args
        self.min_precision = min_precision

    def compute(self) -> Tuple[Tensor, Tensor]:
        """Per-class recalls and thresholds."""
        curves = _multiclass_precision_recall_curve_compute(self._final_state(), self.num_classes, self.thresholds)
        return _per_class_reduce(curves, self.num_classes,
                                 lambda p, r, t: _recall_at_precision(p, r, t, self.min_precision))


class MultilabelRecallAtFixedPrecision(MultilabelPrecisionRecallCurve):
    """The highest recall at a minimum precision, and its threshold, per label."""

    def __init__(
        self,
        num_labels: int,
        min_precision: float,
        thresholds: Thresholds = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            num_labels=num_labels, thresholds=thresholds, ignore_index=ignore_index, validate_args=False, **kwargs
        )
        if validate_args:
            _validate_min_arg(min_precision, "min_precision")
        self.validate_args = validate_args
        self.min_precision = min_precision

    def compute(self) -> Tuple[Tensor, Tensor]:
        """Per-label recalls and thresholds."""
        curves = _multilabel_precision_recall_curve_compute(
            self._final_state(), self.num_labels, self.thresholds, self.ignore_index
        )
        return _per_class_reduce(curves, self.num_labels,
                                 lambda p, r, t: _recall_at_precision(p, r, t, self.min_precision))


class RecallAtFixedPrecision(_ClassificationTaskWrapper):
    """Task-dispatching recall at a fixed precision: returns the binary, multiclass or multilabel metric."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        min_precision: float,
        thresholds: Thresholds = None,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        task = ClassificationTask.from_str(task)
        if task == ClassificationTask.BINARY:
            return BinaryRecallAtFixedPrecision(min_precision, thresholds, ignore_index, validate_args, **kwargs)
        if task == ClassificationTask.MULTICLASS:
            if not isinstance(num_classes, int):
                raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)}` was passed.")
            return MulticlassRecallAtFixedPrecision(
                num_classes, min_precision, thresholds, ignore_index, validate_args, **kwargs
            )
        if not isinstance(num_labels, int):
            raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)}` was passed.")
        return MultilabelRecallAtFixedPrecision(
            num_labels, min_precision, thresholds, ignore_index, validate_args, **kwargs
        )


_plot_as_scalar(BinaryRecallAtFixedPrecision, MulticlassRecallAtFixedPrecision, MultilabelRecallAtFixedPrecision)
