"""AUROC metrics (counterpart of ``metrics_tpu/classification/auroc.py``).

The states and updates are the precision-recall curve's; ``compute`` reduces
the ROC curves to their areas.
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
from metrics_tpu_torch.functional.classification.auroc import (
    _binary_auroc_arg_validation,
    _binary_auroc_compute,
    _multiclass_auroc_arg_validation,
    _multiclass_auroc_compute,
    _multilabel_auroc_arg_validation,
    _multilabel_auroc_compute,
)
from metrics_tpu_torch.functional.classification.precision_recall_curve import Thresholds
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.enums import ClassificationTask

Tensor = torch.Tensor


class BinaryAUROC(BinaryPrecisionRecallCurve):
    """Area under the ROC curve for binary tasks (partial, with the McClish correction, below ``max_fpr``).

    >>> metric = BinaryAUROC(device="cpu")
    >>> metric.update(torch.tensor([0.0, 0.5, 0.7, 0.8]), torch.tensor([0, 1, 1, 0]))
    >>> metric.compute()
    tensor(0.5000)
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        max_fpr: Optional[float] = None,
        thresholds: Thresholds = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(thresholds=thresholds, ignore_index=ignore_index, validate_args=False, **kwargs)
        if validate_args:
            _binary_auroc_arg_validation(max_fpr, thresholds, ignore_index)
        self.validate_args = validate_args
        self.max_fpr = max_fpr

    def compute(self) -> Tensor:
        """The area."""
        return _binary_auroc_compute(self._final_state(), self.thresholds, self.max_fpr)


class MulticlassAUROC(MulticlassPrecisionRecallCurve):
    """Area under the ROC curve for multiclass tasks (one-vs-rest per class, then averaged).

    >>> metric = MulticlassAUROC(num_classes=2, device="cpu")
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
            _multiclass_auroc_arg_validation(num_classes, average, thresholds, ignore_index)
        self.validate_args = validate_args
        self.average = average

    def compute(self) -> Tensor:
        """The per-class areas, reduced by ``average``."""
        return _multiclass_auroc_compute(self._final_state(), self.num_classes, self.average, self.thresholds)


class MultilabelAUROC(MultilabelPrecisionRecallCurve):
    """Area under the ROC curve for multilabel tasks (per label, then averaged)."""

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
            _multilabel_auroc_arg_validation(num_labels, average, thresholds, ignore_index)
        self.validate_args = validate_args
        self.average = average

    def compute(self) -> Tensor:
        """The per-label areas, reduced by ``average``."""
        return _multilabel_auroc_compute(
            self._final_state(), self.num_labels, self.average, self.thresholds, self.ignore_index
        )


class AUROC(_ClassificationTaskWrapper):
    """Task-dispatching AUROC: returns the binary, multiclass or multilabel metric.

    >>> auroc = AUROC(task="binary", device="cpu")
    >>> auroc.update(torch.tensor([0.0, 0.5, 0.7, 0.8]), torch.tensor([0, 1, 1, 0]))
    >>> auroc.compute()
    tensor(0.5000)
    """

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        thresholds: Thresholds = None,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        average: Optional[str] = "macro",
        max_fpr: Optional[float] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        task = ClassificationTask.from_str(task)
        kwargs.update({"thresholds": thresholds, "ignore_index": ignore_index, "validate_args": validate_args})
        if task == ClassificationTask.BINARY:
            return BinaryAUROC(max_fpr, **kwargs)
        if task == ClassificationTask.MULTICLASS:
            if not isinstance(num_classes, int):
                raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)}` was passed.")
            return MulticlassAUROC(num_classes, average, **kwargs)
        if task == ClassificationTask.MULTILABEL:
            if not isinstance(num_labels, int):
                raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)}` was passed.")
            return MultilabelAUROC(num_labels, average, **kwargs)
        raise ValueError(f"Not handled value: {task}")


_plot_as_scalar(BinaryAUROC, MulticlassAUROC, MultilabelAUROC)
