"""Specificity-at-sensitivity metrics (counterpart of ``metrics_tpu/classification/specificity_sensitivity.py``).

The states and updates are the precision-recall curve's; ``compute`` picks the
best specificity on the ROC curve at a minimum sensitivity, and its threshold.
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
from metrics_tpu_torch.functional.classification.precision_recall_curve import Thresholds
from metrics_tpu_torch.functional.classification.sensitivity_specificity import _validate_min_arg
from metrics_tpu_torch.functional.classification.specificity_sensitivity import (
    _binary_specificity_at_sensitivity_compute,
    _multiclass_specificity_at_sensitivity_compute,
    _multilabel_specificity_at_sensitivity_compute,
)
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.enums import ClassificationTask

Tensor = torch.Tensor


class BinarySpecificityAtSensitivity(BinaryPrecisionRecallCurve):
    """The highest specificity at a minimum sensitivity, and its threshold, for binary tasks.

    >>> metric = BinarySpecificityAtSensitivity(min_sensitivity=0.5, device="cpu")
    >>> metric.update(torch.tensor([0.1, 0.4, 0.6, 0.8]), torch.tensor([0, 0, 1, 1]))
    >>> metric.compute()
    (tensor(1.), tensor(0.8000))
    """

    def __init__(
        self,
        min_sensitivity: float,
        thresholds: Thresholds = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(thresholds=thresholds, ignore_index=ignore_index, validate_args=False, **kwargs)
        if validate_args:
            _validate_min_arg(min_sensitivity, "min_sensitivity")
        self.validate_args = validate_args
        self.min_sensitivity = min_sensitivity

    def compute(self) -> Tuple[Tensor, Tensor]:
        """The specificity and its threshold."""
        return _binary_specificity_at_sensitivity_compute(self._final_state(), self.thresholds, self.min_sensitivity)


class MulticlassSpecificityAtSensitivity(MulticlassPrecisionRecallCurve):
    """The highest specificity at a minimum sensitivity, and its threshold, per class."""

    def __init__(
        self,
        num_classes: int,
        min_sensitivity: float,
        thresholds: Thresholds = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            num_classes=num_classes, thresholds=thresholds, ignore_index=ignore_index, validate_args=False, **kwargs
        )
        if validate_args:
            _validate_min_arg(min_sensitivity, "min_sensitivity")
        self.validate_args = validate_args
        self.min_sensitivity = min_sensitivity

    def compute(self) -> Tuple[Tensor, Tensor]:
        """Per-class specificities and thresholds."""
        return _multiclass_specificity_at_sensitivity_compute(
            self._final_state(), self.num_classes, self.thresholds, self.min_sensitivity
        )


class MultilabelSpecificityAtSensitivity(MultilabelPrecisionRecallCurve):
    """The highest specificity at a minimum sensitivity, and its threshold, per label."""

    def __init__(
        self,
        num_labels: int,
        min_sensitivity: float,
        thresholds: Thresholds = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            num_labels=num_labels, thresholds=thresholds, ignore_index=ignore_index, validate_args=False, **kwargs
        )
        if validate_args:
            _validate_min_arg(min_sensitivity, "min_sensitivity")
        self.validate_args = validate_args
        self.min_sensitivity = min_sensitivity

    def compute(self) -> Tuple[Tensor, Tensor]:
        """Per-label specificities and thresholds."""
        return _multilabel_specificity_at_sensitivity_compute(
            self._final_state(), self.num_labels, self.thresholds, self.ignore_index, self.min_sensitivity
        )


class SpecificityAtSensitivity(_ClassificationTaskWrapper):
    """Task-dispatching specificity at a fixed sensitivity: returns the binary, multiclass or multilabel metric."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        min_sensitivity: float,
        thresholds: Thresholds = None,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        task = ClassificationTask.from_str(task)
        if task == ClassificationTask.BINARY:
            return BinarySpecificityAtSensitivity(min_sensitivity, thresholds, ignore_index, validate_args, **kwargs)
        if task == ClassificationTask.MULTICLASS:
            if not isinstance(num_classes, int):
                raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)}` was passed.")
            return MulticlassSpecificityAtSensitivity(
                num_classes, min_sensitivity, thresholds, ignore_index, validate_args, **kwargs
            )
        if not isinstance(num_labels, int):
            raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)}` was passed.")
        return MultilabelSpecificityAtSensitivity(
            num_labels, min_sensitivity, thresholds, ignore_index, validate_args, **kwargs
        )


_plot_as_scalar(BinarySpecificityAtSensitivity, MulticlassSpecificityAtSensitivity, MultilabelSpecificityAtSensitivity)
