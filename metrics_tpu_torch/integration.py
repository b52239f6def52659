"""Training-loop integration (counterpart of ``metrics_tpu/integration.py``).

A small manager with the lifecycle that Lightning's ``self.log(metric)``
gives: :meth:`MetricLogbook.log` registers a metric under a name once (a
repeated call is a no-op, so it can sit inside the step);
:meth:`MetricLogbook.log_batch` runs ``forward``, returning the batch's value
while the epoch's state accumulates; :meth:`MetricLogbook.epoch_end` computes
every logged metric (syncing across ranks once, as ``compute`` does), records
the values in :attr:`MetricLogbook.history` and resets them;
:meth:`MetricLogbook.epoch` does the same as a context manager.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Dict, Iterator, List

from metrics_tpu_torch.collections import MetricCollection
from metrics_tpu_torch.metric import Metric

__all__ = ["MetricLogbook"]


class MetricLogbook:
    """The ``self.log`` lifecycle for hand-written PyTorch loops.

    >>> import torch
    >>> from metrics_tpu_torch.aggregation import MeanMetric
    >>> book = MetricLogbook()
    >>> for epoch_data in ([1.0, 2.0], [10.0]):
    ...     for batch in epoch_data:
    ...         _ = book.log_batch("train_loss", lambda: MeanMetric(device="cpu"), torch.tensor(batch))
    ...     print(sorted((k, float(v)) for k, v in book.epoch_end().items()))
    [('train_loss', 1.5)]
    [('train_loss', 10.0)]
    """

    def __init__(self) -> None:
        self._metrics: Dict[str, Any] = {}
        self._history: List[Dict[str, Any]] = []

    def log(self, name: str, metric: Any) -> Any:
        """Register ``metric`` under ``name`` once; a :class:`Metric`, a :class:`MetricCollection`, or a
        zero-argument factory or class making one."""
        if name not in self._metrics:
            if not isinstance(metric, (Metric, MetricCollection)):
                metric = metric()
            if not isinstance(metric, (Metric, MetricCollection)):
                raise ValueError(f"Expected a Metric/MetricCollection (or factory) for {name!r}, got {type(metric)}")
            self._metrics[name] = metric
        return self._metrics[name]

    def __getitem__(self, name: str) -> Any:
        return self._metrics[name]

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def log_batch(self, name: str, metric: Any, *args: Any, **kwargs: Any) -> Any:
        """``self.log(metric, on_step=True)``: ``forward``, the batch's value back and the state accumulated."""
        return self.log(name, metric)(*args, **kwargs)

    def update(self, name: str, metric: Any, *args: Any, **kwargs: Any) -> None:
        """``self.log(metric)`` without a step value: an update only."""
        self.log(name, metric).update(*args, **kwargs)

    def epoch_end(self, reset: bool = True) -> Dict[str, Any]:
        """Compute every logged metric, record the values in :attr:`history`, then reset (unless ``reset`` is
        False). A collection's members appear as ``<name>_<member>``, and its dict under ``name`` unless a
        member took that key."""
        values: Dict[str, Any] = {}
        for name, metric in self._metrics.items():
            out = metric.compute()
            if isinstance(out, dict):
                values.update({f"{name}_{k}" if k != name else k: v for k, v in out.items()})
                values.setdefault(name, out)
            else:
                values[name] = out
        self._history.append(values)
        if reset:
            self.reset()
        return values

    @contextmanager
    def epoch(self) -> Iterator["MetricLogbook"]:
        """Context manager over one epoch: compute and reset on exit."""
        yield self
        self.epoch_end()

    def reset(self) -> None:
        for metric in self._metrics.values():
            metric.reset()

    @property
    def history(self) -> List[Dict[str, Any]]:
        """Each epoch's values, oldest first."""
        return self._history
