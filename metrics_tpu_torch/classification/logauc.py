"""Log-AUC metrics (counterpart of ``metrics_tpu/classification/logauc.py``).

The states and updates are the precision-recall curve's; ``compute`` takes the
ROC curves' areas on a log10 fpr axis within ``fpr_range``.
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
from metrics_tpu_torch.functional.classification.logauc import (
    _binary_logauc_compute,
    _reduce_logauc,
    _validate_fpr_range,
)
from metrics_tpu_torch.functional.classification.precision_recall_curve import Thresholds
from metrics_tpu_torch.functional.classification.roc import (
    _binary_roc_compute,
    _multiclass_roc_compute,
    _multilabel_roc_compute,
)
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.enums import ClassificationTask

Tensor = torch.Tensor


class BinaryLogAUC(BinaryPrecisionRecallCurve):
    """Log-AUC for binary tasks.

    >>> metric = BinaryLogAUC(device="cpu")
    >>> metric.update(torch.tensor([0.75, 0.05, 0.05, 0.05, 0.05]), torch.tensor([1, 0, 0, 0, 0]))
    >>> metric.compute()
    tensor(1.)
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        fpr_range: Tuple[float, float] = (0.001, 0.1),
        thresholds: Thresholds = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(thresholds=thresholds, ignore_index=ignore_index, validate_args=False, **kwargs)
        if validate_args:
            _validate_fpr_range(fpr_range)
        self.validate_args = validate_args
        self.fpr_range = fpr_range

    def compute(self) -> Tensor:
        """The log-AUC."""
        fpr, tpr, _ = _binary_roc_compute(self._final_state(), self.thresholds)
        return _binary_logauc_compute(fpr, tpr, self.fpr_range)


class MulticlassLogAUC(MulticlassPrecisionRecallCurve):
    """Log-AUC for multiclass tasks (one-vs-rest per class; per-class scores unless ``average`` is given)."""

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    plot_legend_name = "Class"

    def __init__(
        self,
        num_classes: int,
        fpr_range: Tuple[float, float] = (0.001, 0.1),
        average: Optional[str] = None,
        thresholds: Thresholds = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            num_classes=num_classes, thresholds=thresholds, ignore_index=ignore_index, validate_args=False, **kwargs
        )
        if validate_args:
            _validate_fpr_range(fpr_range)
        self.validate_args = validate_args
        self.fpr_range = fpr_range
        self.average = average

    def compute(self) -> Tensor:
        """The per-class log-AUC, or its average."""
        fpr, tpr, _ = _multiclass_roc_compute(self._final_state(), self.num_classes, self.thresholds)
        return _reduce_logauc(fpr, tpr, self.fpr_range, self.average)


class MultilabelLogAUC(MultilabelPrecisionRecallCurve):
    """Log-AUC for multilabel tasks (per-label scores unless ``average`` is given)."""

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    plot_legend_name = "Label"

    def __init__(
        self,
        num_labels: int,
        fpr_range: Tuple[float, float] = (0.001, 0.1),
        average: Optional[str] = None,
        thresholds: Thresholds = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            num_labels=num_labels, thresholds=thresholds, ignore_index=ignore_index, validate_args=False, **kwargs
        )
        if validate_args:
            _validate_fpr_range(fpr_range)
        self.validate_args = validate_args
        self.fpr_range = fpr_range
        self.average = average

    def compute(self) -> Tensor:
        """The per-label log-AUC, or its average."""
        fpr, tpr, _ = _multilabel_roc_compute(self._final_state(), self.num_labels, self.thresholds, self.ignore_index)
        return _reduce_logauc(fpr, tpr, self.fpr_range, self.average)


class LogAUC(_ClassificationTaskWrapper):
    """Task-dispatching log-AUC: returns the binary, multiclass or multilabel metric."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        thresholds: Thresholds = None,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        fpr_range: Tuple[float, float] = (0.001, 0.1),
        average: Optional[str] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        task = ClassificationTask.from_str(task)
        kwargs.update({"thresholds": thresholds, "ignore_index": ignore_index, "validate_args": validate_args})
        if task == ClassificationTask.BINARY:
            return BinaryLogAUC(fpr_range=fpr_range, **kwargs)
        if task == ClassificationTask.MULTICLASS:
            if not isinstance(num_classes, int):
                raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)}` was passed.")
            return MulticlassLogAUC(num_classes, fpr_range=fpr_range, average=average, **kwargs)
        if not isinstance(num_labels, int):
            raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)}` was passed.")
        return MultilabelLogAUC(num_labels, fpr_range=fpr_range, average=average, **kwargs)


_plot_as_scalar(BinaryLogAUC, MulticlassLogAUC, MultilabelLogAUC)
