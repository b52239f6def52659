"""Sensitivity-at-specificity metrics (counterpart of ``metrics_tpu/classification/sensitivity_specificity.py``).

The states and updates are the precision-recall curve's; ``compute`` picks the
best sensitivity on the ROC curve at a minimum specificity, and its threshold.
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
from metrics_tpu_torch.functional.classification.sensitivity_specificity import (
    _binary_sensitivity_at_specificity_compute,
    _multiclass_sensitivity_at_specificity_compute,
    _multilabel_sensitivity_at_specificity_compute,
    _validate_min_arg,
)
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.enums import ClassificationTask

Tensor = torch.Tensor


class BinarySensitivityAtSpecificity(BinaryPrecisionRecallCurve):
    """The highest sensitivity at a minimum specificity, and its threshold, for binary tasks.

    >>> metric = BinarySensitivityAtSpecificity(min_specificity=0.5, device="cpu")
    >>> metric.update(torch.tensor([0.1, 0.4, 0.6, 0.8]), torch.tensor([0, 0, 1, 1]))
    >>> metric.compute()
    (tensor(1.), tensor(0.6000))
    """

    def __init__(
        self,
        min_specificity: float,
        thresholds: Thresholds = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(thresholds=thresholds, ignore_index=ignore_index, validate_args=False, **kwargs)
        if validate_args:
            _validate_min_arg(min_specificity, "min_specificity")
        self.validate_args = validate_args
        self.min_specificity = min_specificity

    def compute(self) -> Tuple[Tensor, Tensor]:
        """The sensitivity and its threshold."""
        return _binary_sensitivity_at_specificity_compute(self._final_state(), self.thresholds, self.min_specificity)


class MulticlassSensitivityAtSpecificity(MulticlassPrecisionRecallCurve):
    """The highest sensitivity at a minimum specificity, and its threshold, per class."""

    def __init__(
        self,
        num_classes: int,
        min_specificity: float,
        thresholds: Thresholds = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            num_classes=num_classes, thresholds=thresholds, ignore_index=ignore_index, validate_args=False, **kwargs
        )
        if validate_args:
            _validate_min_arg(min_specificity, "min_specificity")
        self.validate_args = validate_args
        self.min_specificity = min_specificity

    def compute(self) -> Tuple[Tensor, Tensor]:
        """Per-class sensitivities and thresholds."""
        return _multiclass_sensitivity_at_specificity_compute(
            self._final_state(), self.num_classes, self.thresholds, self.min_specificity
        )


class MultilabelSensitivityAtSpecificity(MultilabelPrecisionRecallCurve):
    """The highest sensitivity at a minimum specificity, and its threshold, per label."""

    def __init__(
        self,
        num_labels: int,
        min_specificity: float,
        thresholds: Thresholds = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            num_labels=num_labels, thresholds=thresholds, ignore_index=ignore_index, validate_args=False, **kwargs
        )
        if validate_args:
            _validate_min_arg(min_specificity, "min_specificity")
        self.validate_args = validate_args
        self.min_specificity = min_specificity

    def compute(self) -> Tuple[Tensor, Tensor]:
        """Per-label sensitivities and thresholds."""
        return _multilabel_sensitivity_at_specificity_compute(
            self._final_state(), self.num_labels, self.thresholds, self.ignore_index, self.min_specificity
        )


class SensitivityAtSpecificity(_ClassificationTaskWrapper):
    """Task-dispatching sensitivity at a fixed specificity: returns the binary, multiclass or multilabel metric."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        min_specificity: float,
        thresholds: Thresholds = None,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        task = ClassificationTask.from_str(task)
        if task == ClassificationTask.BINARY:
            return BinarySensitivityAtSpecificity(min_specificity, thresholds, ignore_index, validate_args, **kwargs)
        if task == ClassificationTask.MULTICLASS:
            if not isinstance(num_classes, int):
                raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)}` was passed.")
            return MulticlassSensitivityAtSpecificity(
                num_classes, min_specificity, thresholds, ignore_index, validate_args, **kwargs
            )
        if not isinstance(num_labels, int):
            raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)}` was passed.")
        return MultilabelSensitivityAtSpecificity(
            num_labels, min_specificity, thresholds, ignore_index, validate_args, **kwargs
        )


_plot_as_scalar(BinarySensitivityAtSpecificity, MulticlassSensitivityAtSpecificity, MultilabelSensitivityAtSpecificity)
