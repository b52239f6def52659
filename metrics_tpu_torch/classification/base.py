"""Task-dispatch base for umbrella classification metrics (counterpart of ``metrics_tpu/classification/base.py``)."""

from __future__ import annotations

from typing import Any

from metrics_tpu_torch.metric import Metric


class _ClassificationTaskWrapper(Metric):
    """Base of the umbrella classes (``Accuracy``, ...), whose ``__new__`` returns a task-specific metric."""

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Unreachable: ``__new__`` returns a task class."""
        raise NotImplementedError(
            f"{self.__class__.__name__} metric does not have an update method. This means you likely tried"
            " to inherit from the task wrapper instead of one of its task-specific versions."
        )

    def compute(self) -> None:
        """Unreachable: ``__new__`` returns a task class."""
        raise NotImplementedError(f"{self.__class__.__name__} metric does not have a compute method.")


def _plot_as_scalar(*classes: type) -> None:
    """Give back the generic value plot to scalar metrics that inherit the curve or confusion-matrix classes for
    their states (AUROC, average precision, Jaccard, ...), as the JAX package does."""
    for cls in classes:
        cls.plot = Metric.plot
