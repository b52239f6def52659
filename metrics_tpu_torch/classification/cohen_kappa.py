"""Cohen's kappa metrics, on the confusion-matrix state.

Counterpart of ``metrics_tpu/classification/cohen_kappa.py``.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from metrics_tpu_torch.classification.base import _ClassificationTaskWrapper, _plot_as_scalar
from metrics_tpu_torch.classification.confusion_matrix import BinaryConfusionMatrix, MulticlassConfusionMatrix
from metrics_tpu_torch.functional.classification.cohen_kappa import _cohen_kappa_reduce
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.enums import ClassificationTaskNoMultilabel

Tensor = torch.Tensor


class BinaryCohenKappa(BinaryConfusionMatrix):
    """Calculate Cohen's kappa for binary tasks.

    >>> target = torch.tensor([1, 1, 0, 0])
    >>> preds = torch.tensor([0, 1, 0, 0])
    >>> metric = BinaryCohenKappa(device="cpu")
    >>> metric.update(preds, target)
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
        threshold: float = 0.5,
        ignore_index: Optional[int] = None,
        weights: Optional[str] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            threshold=threshold, ignore_index=ignore_index, normalize=None, validate_args=validate_args, **kwargs
        )
        if validate_args and weights not in (None, "none", "linear", "quadratic"):
            raise ValueError(
                f"Expected argument `weights` to be one of None, 'linear' or 'quadratic' but got {weights}"
            )
        self.weights = weights

    def compute(self) -> Tensor:
        """Compute metric."""
        return _cohen_kappa_reduce(self.confmat, self.weights)


class MulticlassCohenKappa(MulticlassConfusionMatrix):
    """Calculate Cohen's kappa for multiclass tasks.

    >>> target = torch.tensor([2, 1, 0, 0])
    >>> preds = torch.tensor([2, 1, 0, 1])
    >>> metric = MulticlassCohenKappa(num_classes=3, device="cpu")
    >>> metric.update(preds, target)
    >>> metric.compute()
    tensor(0.6364)
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        num_classes: int,
        ignore_index: Optional[int] = None,
        weights: Optional[str] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            num_classes=num_classes, ignore_index=ignore_index, normalize=None, validate_args=validate_args, **kwargs
        )
        if validate_args and weights not in (None, "none", "linear", "quadratic"):
            raise ValueError(
                f"Expected argument `weights` to be one of None, 'linear' or 'quadratic' but got {weights}"
            )
        self.weights = weights

    def compute(self) -> Tensor:
        """Compute metric."""
        return _cohen_kappa_reduce(self.confmat, self.weights)


class CohenKappa(_ClassificationTaskWrapper):
    """Task-dispatching Cohen's kappa.

    >>> target = torch.tensor([1, 1, 0, 0])
    >>> preds = torch.tensor([0, 1, 0, 0])
    >>> metric = CohenKappa(task="binary", device="cpu")
    >>> metric.update(preds, target)
    >>> metric.compute()
    tensor(0.5000)
    """

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        threshold: float = 0.5,
        num_classes: Optional[int] = None,
        weights: Optional[str] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        """Initialize task metric."""
        task = ClassificationTaskNoMultilabel.from_str(task)
        kwargs.update({"weights": weights, "ignore_index": ignore_index, "validate_args": validate_args})
        if task == ClassificationTaskNoMultilabel.BINARY:
            return BinaryCohenKappa(threshold, **kwargs)
        if task == ClassificationTaskNoMultilabel.MULTICLASS:
            if not isinstance(num_classes, int):
                raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)}` was passed.")
            return MulticlassCohenKappa(num_classes, **kwargs)
        raise ValueError(f"Not handled value: {task}")


_plot_as_scalar(BinaryCohenKappa, MulticlassCohenKappa)
