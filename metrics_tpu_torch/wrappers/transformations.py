"""Wrappers that transform a metric's inputs (counterpart of ``metrics_tpu/wrappers/transformations.py``)."""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.wrappers.abstract import WrapperMetric, wrapped_device

__all__ = ["BinaryTargetTransformer", "LambdaInputTransformer", "MetricInputTransformer"]

Tensor = torch.Tensor


class MetricInputTransformer(WrapperMetric):
    """Base class: ``transform_pred`` and ``transform_target`` (identities here) run on the inputs before the
    wrapped metric sees them. The wrapper lives on its metric's device."""

    def __init__(self, wrapped_metric: Metric, **kwargs: Any) -> None:
        if not isinstance(wrapped_metric, Metric):
            raise TypeError(
                f"Expected wrapped metric to be an instance of `metrics_tpu_torch.Metric` but received {wrapped_metric}"
            )
        kwargs["device"] = wrapped_device([wrapped_metric], kwargs.get("device"))
        super().__init__(**kwargs)
        self.wrapped_metric = wrapped_metric

    def transform_pred(self, pred: Tensor) -> Tensor:
        """Identity; override to transform predictions."""
        return pred

    def transform_target(self, target: Tensor) -> Tensor:
        """Identity; override to transform targets."""
        return target

    def update(self, pred: Tensor, target: Tensor, **kwargs: Any) -> None:
        """Transform the inputs, then update the wrapped metric."""
        self.wrapped_metric.update(self.transform_pred(pred), self.transform_target(target), **kwargs)

    def compute(self) -> Any:
        """The wrapped metric's value."""
        return self.wrapped_metric.compute()

    def forward(self, pred: Tensor, target: Tensor, **kwargs: Any) -> Any:
        """Transform the inputs, then the wrapped metric's forward."""
        return self.wrapped_metric(self.transform_pred(pred), self.transform_target(target), **kwargs)

    def reset(self) -> None:
        """Reset the wrapped metric."""
        self.wrapped_metric.reset()
        super().reset()


class LambdaInputTransformer(MetricInputTransformer):
    """Apply the given callables to the predictions and targets.

    >>> from metrics_tpu_torch.classification import BinaryAccuracy
    >>> metric = LambdaInputTransformer(BinaryAccuracy(device="cpu"), transform_pred=lambda p: 1 - p)
    >>> metric.update(torch.tensor([0.1, 0.9]), torch.tensor([1, 0]))
    >>> metric.compute()
    tensor(1.)
    """

    def __init__(
        self,
        wrapped_metric: Metric,
        transform_pred: Optional[Callable[[Tensor], Tensor]] = None,
        transform_target: Optional[Callable[[Tensor], Tensor]] = None,
        **kwargs: Any,
    ) -> None:
        if transform_pred is not None and not callable(transform_pred):
            raise TypeError(f"Expected `transform_pred` to be callable, but received {transform_pred}")
        if transform_target is not None and not callable(transform_target):
            raise TypeError(f"Expected `transform_target` to be callable, but received {transform_target}")
        super().__init__(wrapped_metric, **kwargs)
        self._transform_pred_fn = transform_pred
        self._transform_target_fn = transform_target

    def transform_pred(self, pred: Tensor) -> Tensor:
        """The prediction callable, if given."""
        return self._transform_pred_fn(pred) if self._transform_pred_fn is not None else pred

    def transform_target(self, target: Tensor) -> Tensor:
        """The target callable, if given."""
        return self._transform_target_fn(target) if self._transform_target_fn is not None else target


class BinaryTargetTransformer(MetricInputTransformer):
    """Binarize the targets: 1 (int32) where above ``threshold``, else 0.

    >>> from metrics_tpu_torch.classification import BinaryAccuracy
    >>> metric = BinaryTargetTransformer(BinaryAccuracy(device="cpu"), threshold=2.0)
    >>> metric.update(torch.tensor([1, 0]), torch.tensor([3.0, 1.0]))
    >>> metric.compute()
    tensor(1.)
    """

    def __init__(self, wrapped_metric: Metric, threshold: float = 0.0, **kwargs: Any) -> None:
        if not isinstance(threshold, (int, float)):
            raise TypeError(f"Expected `threshold` to be a float, but received {threshold}")
        super().__init__(wrapped_metric, **kwargs)
        self.threshold = threshold

    def transform_target(self, target: Tensor) -> Tensor:
        """``target > threshold`` as int32."""
        return (target > self.threshold).to(torch.int32)
