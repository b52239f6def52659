"""Jaccard index metrics, on the confusion-matrix state.

Counterpart of ``metrics_tpu/classification/jaccard.py``.
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
from metrics_tpu_torch.functional.classification.jaccard import _jaccard_index_reduce
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.enums import ClassificationTask

Tensor = torch.Tensor


class BinaryJaccardIndex(BinaryConfusionMatrix):
    """Calculate the Jaccard index for binary tasks.

    >>> target = torch.tensor([1, 1, 0, 0])
    >>> preds = torch.tensor([0, 1, 0, 0])
    >>> metric = BinaryJaccardIndex(device="cpu")
    >>> metric.update(preds, target)
    >>> metric.compute()
    tensor(0.5000)
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(
        self,
        threshold: float = 0.5,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        zero_division: float = 0.0,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            threshold=threshold, ignore_index=ignore_index, normalize=None, validate_args=validate_args, **kwargs
        )
        self.zero_division = zero_division

    def compute(self) -> Tensor:
        """Compute metric."""
        return _jaccard_index_reduce(self.confmat, average="binary", zero_division=self.zero_division)


class MulticlassJaccardIndex(MulticlassConfusionMatrix):
    """Calculate the Jaccard index for multiclass tasks.

    >>> target = torch.tensor([2, 1, 0, 0])
    >>> preds = torch.tensor([2, 1, 0, 1])
    >>> metric = MulticlassJaccardIndex(num_classes=3, device="cpu")
    >>> metric.update(preds, target)
    >>> metric.compute()
    tensor(0.6667)
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(
        self,
        num_classes: int,
        average: Optional[str] = "macro",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        zero_division: float = 0.0,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            num_classes=num_classes, ignore_index=ignore_index, normalize=None, validate_args=validate_args, **kwargs
        )
        if validate_args and average not in ("micro", "macro", "weighted", "none", None):
            raise ValueError(
                f"Expected argument `average` to be one of ('micro','macro','weighted','none',None), got {average}"
            )
        self.average = average
        self.zero_division = zero_division

    def compute(self) -> Tensor:
        """Compute metric."""
        return _jaccard_index_reduce(
            self.confmat, average=self.average, ignore_index=self.ignore_index, zero_division=self.zero_division
        )


class MultilabelJaccardIndex(MultilabelConfusionMatrix):
    """Calculate the Jaccard index for multilabel tasks.

    >>> target = torch.tensor([[0, 1, 0], [1, 0, 1]])
    >>> preds = torch.tensor([[0, 0, 1], [1, 0, 1]])
    >>> metric = MultilabelJaccardIndex(num_labels=3, device="cpu")
    >>> metric.update(preds, target)
    >>> metric.compute()
    tensor(0.5000)
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(
        self,
        num_labels: int,
        threshold: float = 0.5,
        average: Optional[str] = "macro",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        zero_division: float = 0.0,
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
        if validate_args and average not in ("micro", "macro", "weighted", "none", None):
            raise ValueError(
                f"Expected argument `average` to be one of ('micro','macro','weighted','none',None), got {average}"
            )
        self.average = average
        self.zero_division = zero_division

    def compute(self) -> Tensor:
        """Compute metric."""
        return _jaccard_index_reduce(self.confmat, average=self.average, zero_division=self.zero_division)


class JaccardIndex(_ClassificationTaskWrapper):
    """Task-dispatching Jaccard index.

    >>> target = torch.tensor([1, 1, 0, 0])
    >>> preds = torch.tensor([0, 1, 0, 0])
    >>> metric = JaccardIndex(task="binary", device="cpu")
    >>> metric.update(preds, target)
    >>> metric.compute()
    tensor(0.5000)
    """

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        threshold: float = 0.5,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        average: Optional[str] = "macro",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        zero_division: float = 0.0,
        **kwargs: Any,
    ) -> Metric:
        """Initialize task metric."""
        task = ClassificationTask.from_str(task)
        kwargs.update({"ignore_index": ignore_index, "validate_args": validate_args, "zero_division": zero_division})
        if task == ClassificationTask.BINARY:
            return BinaryJaccardIndex(threshold, **kwargs)
        if task == ClassificationTask.MULTICLASS:
            if not isinstance(num_classes, int):
                raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)}` was passed.")
            return MulticlassJaccardIndex(num_classes, average, **kwargs)
        if task == ClassificationTask.MULTILABEL:
            if not isinstance(num_labels, int):
                raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)}` was passed.")
            return MultilabelJaccardIndex(num_labels, threshold, average, **kwargs)
        raise ValueError(f"Not handled value: {task}")
