"""One metric or collection per task (counterpart of ``metrics_tpu/wrappers/multitask.py``)."""

from __future__ import annotations

from copy import deepcopy
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple, Union

from metrics_tpu_torch.collections import MetricCollection
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.wrappers.abstract import WrapperMetric, wrapped_device

__all__ = ["MultitaskWrapper"]


class MultitaskWrapper(WrapperMetric):
    """Update and compute each task's metric (or ``MetricCollection``) from the task's own inputs.

    ``update``/``forward`` take one dict of predictions and one of targets,
    keyed like ``task_metrics``; ``compute`` gives ``{<prefix><task><postfix>:
    value}``. Every task's metrics must live on one device, the wrapper's.

    >>> import torch
    >>> from metrics_tpu_torch.classification import BinaryAccuracy
    >>> from metrics_tpu_torch.regression import MeanSquaredError
    >>> metrics = MultitaskWrapper({"cls": BinaryAccuracy(device="cpu"), "reg": MeanSquaredError(device="cpu")})
    >>> metrics.update({"cls": torch.tensor([0, 1]), "reg": torch.tensor([2.5, 5.0])},
    ...                {"cls": torch.tensor([1, 1]), "reg": torch.tensor([3.0, 5.0])})
    >>> sorted(metrics.compute())
    ['cls', 'reg']
    """

    is_differentiable = False

    def __init__(
        self,
        task_metrics: Dict[str, Union[Metric, MetricCollection]],
        prefix: Optional[str] = None,
        postfix: Optional[str] = None,
        **kwargs: Any,
    ) -> None:
        if not isinstance(task_metrics, dict):
            raise TypeError(f"Expected argument `task_metrics` to be a dict. Found task_metrics = {task_metrics}")
        for metric in task_metrics.values():
            if not isinstance(metric, (Metric, MetricCollection)):
                raise TypeError(
                    "Expected each task's metric to be a Metric or a MetricCollection. "
                    f"Found a metric of type {type(metric)}"
                )
        kwargs["device"] = wrapped_device(task_metrics.values(), kwargs.get("device"))
        super().__init__(**kwargs)
        self.task_metrics = task_metrics
        self._prefix = self._check_str(prefix, "prefix") if prefix is not None else ""
        self._postfix = self._check_str(postfix, "postfix") if postfix is not None else ""

    def items(self, flatten: bool = True) -> Iterator[Tuple[str, Union[Metric, MetricCollection]]]:
        """(task name, metric); with ``flatten``, a collection's members as ``<task>_<member>``."""
        for task_name, metric in self.task_metrics.items():
            if flatten and isinstance(metric, MetricCollection):
                for sub_name, sub_metric in metric.items():
                    yield f"{task_name}_{sub_name}", sub_metric
            else:
                yield task_name, metric

    def keys(self, flatten: bool = True) -> Iterator[str]:
        for name, _ in self.items(flatten=flatten):
            yield name

    def values(self, flatten: bool = True) -> Iterator[Union[Metric, MetricCollection]]:
        for _, metric in self.items(flatten=flatten):
            yield metric

    def update(self, task_preds: Dict[str, Any], task_targets: Dict[str, Any]) -> None:
        """Update each task's metric with its inputs; the three key sets must be equal."""
        if not self.task_metrics.keys() == task_preds.keys() == task_targets.keys():
            raise ValueError(
                "Expected arguments `task_preds` and `task_targets` to have the same keys as the wrapped `task_metrics`."
                f" Found task_preds.keys() = {task_preds.keys()}, task_targets.keys() = {task_targets.keys()} "
                f"and self.task_metrics.keys() = {self.task_metrics.keys()}"
            )
        for task_name, metric in self.task_metrics.items():
            metric.update(task_preds[task_name], task_targets[task_name])

    def compute(self) -> Dict[str, Any]:
        """Each task's value."""
        return {f"{self._prefix}{n}{self._postfix}": m.compute() for n, m in self.task_metrics.items()}


    def plot(self, val: Any = None, axes: Any = None) -> List[Any]:
        """Draw each task's metric into its own figure, or into ``axes`` (one matplotlib axis per task).

        Args:
            val: a ``compute()``/``forward()`` result dict (or list of them); defaults to ``compute()``.
            axes: optional sequence of matplotlib axes, one per task.
        """
        if axes is not None:
            if not isinstance(axes, Sequence):
                raise TypeError(f"Expected argument `axes` to be a Sequence. Found type(axes) = {type(axes)}")
            if len(axes) != len(self.task_metrics):
                raise ValueError(
                    "Expected argument `axes` to be a Sequence of the same length as the number of tasks."
                    f"Found len(axes) = {len(axes)} and {len(self.task_metrics)} tasks"
                )
        val = val if val is not None else self.compute()
        fig_axs = []
        for i, (task_name, task_metric) in enumerate(self.task_metrics.items()):
            ax = axes[i] if axes is not None else None
            key = f"{self._prefix}{task_name}{self._postfix}"
            if isinstance(val, dict):
                f, a = task_metric.plot(val[key], ax=ax)
            elif isinstance(val, Sequence):
                f, a = task_metric.plot([v[key] for v in val], ax=ax)
            else:
                raise TypeError(
                    f"Expected argument `val` to be None or of type Dict or Sequence[Dict]. Found type(val)= {type(val)}"
                )
            fig_axs.append((f, a))
        return fig_axs

    def forward(self, task_preds: Dict[str, Any], task_targets: Dict[str, Any]) -> Dict[str, Any]:
        """Each task's batch value."""
        return {
            f"{self._prefix}{n}{self._postfix}": m(task_preds[n], task_targets[n]) for n, m in self.task_metrics.items()
        }

    def reset(self) -> None:
        """Reset every task's metric."""
        for metric in self.task_metrics.values():
            metric.reset()
        super().reset()

    def clone(self, prefix: Optional[str] = None, postfix: Optional[str] = None) -> "MultitaskWrapper":
        """A deep copy, with a new prefix or postfix if given."""
        mt = deepcopy(self)
        mt._computed = None  # a cached value carries the old keys
        if prefix is not None:
            mt._prefix = self._check_str(prefix, "prefix")
        if postfix is not None:
            mt._postfix = self._check_str(postfix, "postfix")
        return mt

    @staticmethod
    def _check_str(arg: Any, name: str) -> str:
        if not isinstance(arg, str):
            raise ValueError(f"Expected argument `{name}` to be a string but got {arg}")
        return arg
