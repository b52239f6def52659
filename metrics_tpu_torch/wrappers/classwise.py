"""Per-class outputs as a labelled dict (counterpart of ``metrics_tpu/wrappers/classwise.py``)."""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.wrappers.abstract import WrapperMetric, wrapped_device

__all__ = ["ClasswiseWrapper"]


class ClasswiseWrapper(WrapperMetric):
    """Split a metric's per-class output into a dict keyed ``<prefix><label><postfix>``.

    Without a prefix or postfix the prefix is the metric's class name in lower
    case and an underscore; without ``labels`` the label is the class index.
    The wrapper lives on its metric's device.

    >>> from metrics_tpu_torch.classification import MulticlassAccuracy
    >>> metric = ClasswiseWrapper(MulticlassAccuracy(num_classes=3, average=None, device="cpu"))
    >>> metric.update(torch.tensor([2, 1, 0, 1]), torch.tensor([2, 1, 0, 0]))
    >>> sorted(metric.compute())
    ['multiclassaccuracy_0', 'multiclassaccuracy_1', 'multiclassaccuracy_2']
    """

    def __init__(
        self,
        metric: Metric,
        labels: Optional[List[str]] = None,
        prefix: Optional[str] = None,
        postfix: Optional[str] = None,
        **kwargs: Any,
    ) -> None:
        if not isinstance(metric, Metric):
            raise ValueError(f"Expected argument `metric` to be an instance of `Metric` but got {metric}")
        kwargs["device"] = wrapped_device([metric], kwargs.get("device"))
        super().__init__(**kwargs)
        if labels is not None and not (isinstance(labels, list) and all(isinstance(lab, str) for lab in labels)):
            raise ValueError(f"Expected argument `labels` to either be `None` or a list of strings but got {labels}")
        if prefix is not None and not isinstance(prefix, str):
            raise ValueError(f"Expected argument `prefix` to either be `None` or a string but got {prefix}")
        if postfix is not None and not isinstance(postfix, str):
            raise ValueError(f"Expected argument `postfix` to either be `None` or a string but got {postfix}")
        self.metric = metric
        self.labels = labels
        self._prefix = prefix
        self._postfix = postfix
        self._update_count = 1  # the wrapper's own compute never warns: its metric's does

    def _convert_output(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The per-class values under their keys (views of ``x``: no copy, no host read)."""
        if not self._prefix and not self._postfix:
            prefix, postfix = f"{self.metric.__class__.__name__.lower()}_", ""
        else:
            prefix, postfix = self._prefix or "", self._postfix or ""
        if self.labels is None:
            return {f"{prefix}{i}{postfix}": val for i, val in enumerate(x)}
        return {f"{prefix}{lab}{postfix}": val for lab, val in zip(self.labels, x)}

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Update the wrapped metric."""
        self.metric.update(*args, **kwargs)

    def compute(self) -> Dict[str, torch.Tensor]:
        """The wrapped metric's value, split by class."""
        return self._convert_output(self.metric.compute())

    def forward(self, *args: Any, **kwargs: Any) -> Dict[str, torch.Tensor]:
        """The wrapped metric's batch value, split by class."""
        return self._convert_output(self.metric(*args, **kwargs))

    def reset(self) -> None:
        """Reset the wrapped metric."""
        self.metric.reset()
        super().reset()

    @property
    def metric_state(self) -> Dict[str, Any]:
        return self.metric.metric_state

    def _filter_kwargs(self, **kwargs: Any) -> Dict[str, Any]:
        return self.metric._filter_kwargs(**kwargs)
