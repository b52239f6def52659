"""A metric tracked over steps (counterpart of ``metrics_tpu/wrappers/tracker.py``)."""

from __future__ import annotations

from copy import deepcopy
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.collections import MetricCollection
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.prints import rank_zero_warn
from metrics_tpu_torch.wrappers.abstract import WrapperMetric, wrapped_device

__all__ = ["MetricTracker"]


class MetricTracker(WrapperMetric):
    """A fresh copy of a metric (or ``MetricCollection``) for each step, e.g. each epoch.

    ``increment()`` starts a step; ``update``, ``forward`` and ``compute`` act on
    the current one; ``compute_all`` stacks every step's value (a dict of
    stacks for a collection); ``best_metric`` finds the best step on the host.
    ``maximize`` is one bool, or one per member of a collection. The tracker
    lives on its metric's device.

    >>> from metrics_tpu_torch.classification import MulticlassAccuracy
    >>> tracker = MetricTracker(MulticlassAccuracy(num_classes=3, average='micro', device="cpu"))
    >>> for epoch in range(3):
    ...     tracker.increment()
    ...     tracker.update(torch.tensor([0, 1, 2, 2]), torch.tensor([0, 1, 2, epoch % 3]))
    >>> best, which = tracker.best_metric(return_step=True)
    >>> bool(best >= 0.75)
    True
    """

    def __init__(self, metric: Union[Metric, MetricCollection], maximize: Union[bool, List[bool]] = True) -> None:
        if not isinstance(metric, (Metric, MetricCollection)):
            raise TypeError(f"Metric arg need to be an instance of a Metric or MetricCollection but got {metric}")
        super().__init__(device=wrapped_device([metric]))
        self._base_metric = metric
        if not isinstance(maximize, (bool, list)):
            raise ValueError("Argument `maximize` should either be a single bool or list of bool")
        if isinstance(maximize, list) and not all(isinstance(m, bool) for m in maximize):
            raise ValueError("Argument `maximize` should either be a single bool or list of bool")
        if isinstance(maximize, list) and isinstance(metric, MetricCollection) and len(maximize) != len(metric):
            raise ValueError("The len of argument `maximize` should match the length of the metric collection")
        if isinstance(metric, Metric) and not isinstance(maximize, bool):
            raise ValueError("Argument `maximize` should be a single bool when `metric` is a single Metric")
        self.maximize = maximize
        self._history: List[Union[Metric, MetricCollection]] = []
        self._increment_called = False

    @property
    def n_steps(self) -> int:
        """The number of steps tracked so far."""
        return len(self._history)

    def increment(self) -> None:
        """Start a new step with a fresh copy of the base metric."""
        self._increment_called = True
        self._history.append(deepcopy(self._base_metric))
        self._history[-1].reset()
        self._computed = None

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Update the current step's metric."""
        self._check_for_increment("update")
        self._history[-1].update(*args, **kwargs)

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        """The current step's forward."""
        self._check_for_increment("forward")
        return self._history[-1](*args, **kwargs)

    def compute(self) -> Any:
        """The current step's value."""
        self._check_for_increment("compute")
        return self._history[-1].compute()

    def compute_all(self) -> Any:
        """Every step's value, stacked along a first dimension (per key for a dict); the list of values when
        they do not stack."""
        self._check_for_increment("compute_all")
        res = [metric.compute() for metric in self._history]
        try:
            if isinstance(res[0], dict):
                return {k: torch.stack([torch.as_tensor(r[k]) for r in res], dim=0) for k in res[0]}
            if isinstance(res[0], (list, tuple)):
                return torch.stack([torch.stack([torch.as_tensor(x) for x in r], dim=0) for r in res], dim=0)
            return torch.stack([torch.as_tensor(r) for r in res], dim=0)
        except (TypeError, ValueError, RuntimeError):  # ragged or otherwise unstackable values
            return res


    def plot(self, val: Any = None, ax: Any = None):
        """Draw the tracked value(s) over the steps (``compute_all()`` when ``val`` is None); needs matplotlib."""
        from metrics_tpu_torch.utils.plot import plot_single_or_multi_val

        val = val if val is not None else self.compute_all()
        return plot_single_or_multi_val(val, ax=ax, name=self.__class__.__name__)

    def best_metric(
        self, return_step: bool = False
    ) -> Union[Optional[torch.Tensor], Tuple[Any, Any], Dict[str, Any]]:
        """The best value over the steps (the highest where ``maximize``), and its step with ``return_step``.

        The values are read to the host once and ranked there (``argmax``/``argmin``);
        a value that is not one scalar per step, or a NaN, warns and gives ``None`` for it.
        """
        res = self.compute_all()
        if isinstance(res, list):
            rank_zero_warn("Encountered unstackable per-step results in best_metric; returning None.")
            return (None, None) if return_step else None

        def _best_1d(v: np.ndarray, maximize: bool):
            if v.ndim != 1:
                raise ValueError("per-step values are not scalar")
            if np.isnan(v).any():
                raise ValueError("nan values present")
            best = int(np.argmax(v)) if maximize else int(np.argmin(v))
            return v[best], best

        if isinstance(res, dict):
            maximize = self.maximize if isinstance(self.maximize, list) else [self.maximize] * len(res)
            value, idx = {}, {}
            for i, (k, v) in enumerate(res.items()):
                try:
                    value[k], idx[k] = _best_1d(v.detach().cpu().numpy(), maximize[i])
                except ValueError:
                    rank_zero_warn(
                        f"Encountered nan values or non-scalar output for metric {k}; returning None for it."
                    )
                    value[k], idx[k] = None, None
            return (value, idx) if return_step else value
        try:
            best_val, best_idx = _best_1d(res.detach().cpu().numpy(), bool(self.maximize))
        except ValueError:
            rank_zero_warn("Encountered nan values or non-scalar output in best_metric; returning None.")
            return (None, None) if return_step else None
        return (best_val, best_idx) if return_step else best_val

    def reset(self) -> None:
        """Reset the current step's metric."""
        if self._history:
            self._history[-1].reset()
        self._computed = None

    def reset_all(self) -> None:
        """Reset every step's metric."""
        for metric in self._history:
            metric.reset()
        self._computed = None

    def _check_for_increment(self, method: str) -> None:
        if not self._increment_called:
            raise ValueError(f"`{method}` cannot be called before `.increment()` has been called.")
