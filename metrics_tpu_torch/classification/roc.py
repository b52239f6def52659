"""ROC curve metrics (counterpart of ``metrics_tpu/classification/roc.py``).

The states and updates are the precision-recall curve's; only ``compute`` differs.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple, Union

import torch

from metrics_tpu_torch.classification.base import _ClassificationTaskWrapper
from metrics_tpu_torch.classification.precision_recall_curve import (
    _curve_family_plot,
    BinaryPrecisionRecallCurve,
    MulticlassPrecisionRecallCurve,
    MultilabelPrecisionRecallCurve,
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


def _roc_plot(self, curve=None, score=None, ax=None):
    """Draw the ROC curve: false positive rate along x, true positive rate along y."""
    return _curve_family_plot(
        self, curve, score, ax,
        swap_xy=False,
        label_names=("False positive rate", "True positive rate"),
        auc_direction=1.0,
    )


class BinaryROC(BinaryPrecisionRecallCurve):
    """ROC curve for binary tasks.

    >>> metric = BinaryROC(thresholds=5, device="cpu")
    >>> metric.update(torch.tensor([0.0, 0.5, 0.7, 0.8]), torch.tensor([0, 1, 1, 0]))
    >>> fpr, tpr, thresholds = metric.compute()
    >>> fpr
    tensor([0.0000, 0.5000, 0.5000, 0.5000, 1.0000])
    """

    def compute(self) -> Tuple[Tensor, Tensor, Tensor]:
        """fpr, tpr and thresholds."""
        return _binary_roc_compute(self._final_state(), self.thresholds)

    plot = _roc_plot


class MulticlassROC(MulticlassPrecisionRecallCurve):
    """ROC curve for multiclass tasks (one-vs-rest per class)."""

    def compute(self) -> Union[Tuple[Tensor, Tensor, Tensor], Tuple[List[Tensor], List[Tensor], List[Tensor]]]:
        """Per-class fpr, tpr and thresholds (or their average)."""
        return _multiclass_roc_compute(self._final_state(), self.num_classes, self.thresholds, self.average)

    plot = _roc_plot


class MultilabelROC(MultilabelPrecisionRecallCurve):
    """ROC curve for multilabel tasks (one curve per label)."""

    def compute(self) -> Union[Tuple[Tensor, Tensor, Tensor], Tuple[List[Tensor], List[Tensor], List[Tensor]]]:
        """Per-label fpr, tpr and thresholds."""
        return _multilabel_roc_compute(self._final_state(), self.num_labels, self.thresholds, self.ignore_index)

    plot = _roc_plot


class ROC(_ClassificationTaskWrapper):
    """Task-dispatching ROC curve: returns the binary, multiclass or multilabel metric."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        thresholds: Thresholds = None,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        task = ClassificationTask.from_str(task)
        kwargs.update({"thresholds": thresholds, "ignore_index": ignore_index, "validate_args": validate_args})
        if task == ClassificationTask.BINARY:
            return BinaryROC(**kwargs)
        if task == ClassificationTask.MULTICLASS:
            if not isinstance(num_classes, int):
                raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)}` was passed.")
            return MulticlassROC(num_classes, **kwargs)
        if task == ClassificationTask.MULTILABEL:
            if not isinstance(num_labels, int):
                raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)}` was passed.")
            return MultilabelROC(num_labels, **kwargs)
        raise ValueError(f"Not handled value: {task}")
