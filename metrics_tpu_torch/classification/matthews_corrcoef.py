"""Matthews correlation coefficient metrics, on the confusion-matrix state.

Counterpart of ``metrics_tpu/classification/matthews_corrcoef.py``.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from metrics_tpu_torch.classification.base import _ClassificationTaskWrapper
from metrics_tpu_torch.classification.confusion_matrix import (
    BinaryConfusionMatrix,
    MulticlassConfusionMatrix,
    MultilabelConfusionMatrix,
)
from metrics_tpu_torch.functional.classification.matthews_corrcoef import _matthews_corrcoef_reduce
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.enums import ClassificationTask

Tensor = torch.Tensor


class BinaryMatthewsCorrCoef(BinaryConfusionMatrix):
    """Calculate MCC for binary tasks.

    >>> target = torch.tensor([1, 1, 0, 0])
    >>> preds = torch.tensor([0, 1, 0, 0])
    >>> metric = BinaryMatthewsCorrCoef(device="cpu")
    >>> metric.update(preds, target)
    >>> metric.compute()
    tensor(0.5774)
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(
        self,
        threshold: float = 0.5,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            threshold=threshold, ignore_index=ignore_index, normalize=None, validate_args=validate_args, **kwargs
        )

    def compute(self) -> Tensor:
        """Compute metric."""
        return _matthews_corrcoef_reduce(self.confmat)


class MulticlassMatthewsCorrCoef(MulticlassConfusionMatrix):
    """Calculate MCC for multiclass tasks.

    >>> target = torch.tensor([2, 1, 0, 0])
    >>> preds = torch.tensor([2, 1, 0, 1])
    >>> metric = MulticlassMatthewsCorrCoef(num_classes=3, device="cpu")
    >>> metric.update(preds, target)
    >>> metric.compute()
    tensor(0.7000)
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(
        self,
        num_classes: int,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            num_classes=num_classes, ignore_index=ignore_index, normalize=None, validate_args=validate_args, **kwargs
        )

    def compute(self) -> Tensor:
        """Compute metric."""
        return _matthews_corrcoef_reduce(self.confmat)


class MultilabelMatthewsCorrCoef(MultilabelConfusionMatrix):
    """Calculate MCC for multilabel tasks."""

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(
        self,
        num_labels: int,
        threshold: float = 0.5,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            num_labels=num_labels,
            threshold=threshold,
            ignore_index=ignore_index,
            normalize=None,
            validate_args=validate_args,
            **kwargs,
        )

    def compute(self) -> Tensor:
        """Compute metric."""
        return _matthews_corrcoef_reduce(self.confmat)


class MatthewsCorrCoef(_ClassificationTaskWrapper):
    """Task-dispatching MCC.

    >>> target = torch.tensor([1, 1, 0, 0])
    >>> preds = torch.tensor([0, 1, 0, 0])
    >>> metric = MatthewsCorrCoef(task="binary", device="cpu")
    >>> metric.update(preds, target)
    >>> metric.compute()
    tensor(0.5774)
    """

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        threshold: float = 0.5,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        """Initialize task metric."""
        task = ClassificationTask.from_str(task)
        kwargs.update({"ignore_index": ignore_index, "validate_args": validate_args})
        if task == ClassificationTask.BINARY:
            return BinaryMatthewsCorrCoef(threshold, **kwargs)
        if task == ClassificationTask.MULTICLASS:
            if not isinstance(num_classes, int):
                raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)}` was passed.")
            return MulticlassMatthewsCorrCoef(num_classes, **kwargs)
        if task == ClassificationTask.MULTILABEL:
            if not isinstance(num_labels, int):
                raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)}` was passed.")
            return MultilabelMatthewsCorrCoef(num_labels, threshold, **kwargs)
        raise ValueError(f"Not handled value: {task}")
