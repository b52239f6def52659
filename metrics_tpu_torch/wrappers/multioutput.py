"""One metric per output dimension (counterpart of ``metrics_tpu/wrappers/multioutput.py``).

The wrapper holds a list of deep copies of the base metric, one per output, as
``BootStrapper`` holds its copies, and updates each with its slice of
``output_dim``. With ``remove_nans=False`` and ``squeeze_outputs=True`` and a
base metric that can run batched, the output axis is moved to the front and
ONE vmapped update runs every output's copy (the replica engine's stacked
mode, ``wrappers/replicated.py``), as in the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.wrappers.abstract import wrapped_device
from metrics_tpu_torch.wrappers.replicated import ReplicatedWrapper, replica_compute

__all__ = ["MultioutputWrapper"]

Tensor = torch.Tensor


class MultioutputWrapper(ReplicatedWrapper):
    """Evaluate a metric on each of ``num_outputs`` slices of ``output_dim`` independently.

    With ``remove_nans`` a sample is dropped from an output's update where any
    input holds a NaN in that output's slice; the NaN flags of every output are
    found on the device and read to the host once an update (the kept counts).
    With ``squeeze_outputs`` the output dimension is removed from each slice.
    ``compute`` stacks the copies' values along a first dimension. The wrapper
    lives on its metric's device.

    >>> from metrics_tpu_torch.regression import R2Score
    >>> preds = torch.tensor([[0.25, 0.5], [0.5, 1.0], [0.75, 1.5], [1.0, 2.0]])
    >>> metric = MultioutputWrapper(R2Score(device="cpu"), num_outputs=2)
    >>> metric.update(preds, preds.clone())
    >>> metric.compute()
    tensor([1., 1.])
    """

    is_differentiable = False

    def __init__(
        self,
        base_metric: Metric,
        num_outputs: int,
        output_dim: int = -1,
        remove_nans: bool = True,
        squeeze_outputs: bool = True,
        **kwargs: Any,
    ) -> None:
        if not isinstance(base_metric, Metric):
            raise ValueError(
                f"Expected base metric to be an instance of metrics_tpu_torch.Metric but received {base_metric}"
            )
        kwargs["device"] = wrapped_device([base_metric], kwargs.get("device"))
        super().__init__(**kwargs)
        self._init_replicas(base_metric, num_outputs)
        self.output_dim = output_dim
        self.remove_nans = remove_nans
        self.squeeze_outputs = squeeze_outputs

    def _kept_rows(self, tensors: List[Tensor]) -> Optional[List[Optional[Tensor]]]:
        """Per output, the indices of the samples with no NaN in that output's slice of any input, or ``None``
        where every sample is kept; ``None`` for all when nothing is dropped. One host read: the kept counts."""
        num = len(self._replicas)
        flags = None
        for t in tensors:
            if not t.is_floating_point():
                continue
            moved = torch.movedim(t, self.output_dim, -1)  # (N, ..., num_outputs)
            nan = torch.isnan(moved).reshape(moved.shape[0], -1, num).any(1)
            flags = nan if flags is None else flags | nan
        if flags is None:
            return None
        keep = ~flags
        counts = keep.sum(0).tolist()
        if all(c == keep.shape[0] for c in counts):
            return None
        order = torch.argsort((~keep).to(torch.int8), dim=0, stable=True)  # each output's kept samples first
        return [None if c == keep.shape[0] else order[:c, i] for i, c in enumerate(counts)]

    def _get_args_kwargs_by_output(self, *args: Any, **kwargs: Any) -> List[Tuple[List[Any], Dict[str, Any]]]:
        """Each output's slice of every tensor argument (other arguments as they are)."""
        tensors = [a for a in list(args) + list(kwargs.values()) if isinstance(a, torch.Tensor)]
        kept = self._kept_rows(tensors) if self.remove_nans and tensors else None

        def select(x: Any, i: int) -> Any:
            if not isinstance(x, torch.Tensor):
                return x
            x = x.select(self.output_dim, i) if self.squeeze_outputs else x.narrow(self.output_dim, i, 1)
            rows = kept[i] if kept is not None else None
            return x if rows is None else x.index_select(0, rows)

        return [([select(a, i) for a in args], {k: select(v, i) for k, v in kwargs.items()})
                for i in range(len(self._replicas))]

    def _engine_sliceable(self, args: Tuple[Any, ...], kwargs: Dict[str, Any]) -> bool:
        """Every tensor input must expose the output axis with one slot per output."""
        num = len(self._replicas)
        d = self.output_dim
        for a in list(args) + list(kwargs.values()):
            if isinstance(a, Tensor):
                if a.ndim == 0 or not -a.ndim <= d < a.ndim or a.shape[d] != num:
                    return False
        return True

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Update each output's metric with its slice: in one vmapped update of every copy when
        ``remove_nans=False`` and ``squeeze_outputs=True`` allow it, else in a loop."""
        if (
            not self.remove_nans
            and self.squeeze_outputs
            and self._engine_ok(args, kwargs)
            and self._engine_sliceable(args, kwargs)
        ):
            moved_args = tuple(a.movedim(self.output_dim, 0) if isinstance(a, Tensor) else a for a in args)
            moved_kwargs = {k: (v.movedim(self.output_dim, 0) if isinstance(v, Tensor) else v)
                            for k, v in kwargs.items()}
            if self._engine_update(moved_args, moved_kwargs):
                return
        self._materialize()
        for (selected_args, selected_kwargs), metric in zip(
            self._get_args_kwargs_by_output(*args, **kwargs), self._replicas
        ):
            metric.update(*selected_args, **selected_kwargs)

    def compute(self) -> Tensor:
        """The outputs' values, stacked."""
        if self.__dict__.get("_stacked") is not None:
            vals = replica_compute(self._replicas[0], len(self._replicas), self.__dict__["_stacked"])
            if isinstance(vals, Tensor):
                return vals
            self._materialize()  # a tuple or dict compute: stacked below, one copy at a time
        return torch.stack([torch.as_tensor(m.compute()) for m in self.metrics], 0)

    def forward(self, *args: Any, **kwargs: Any) -> Tensor:
        """Each output's batch value (accumulated into its metric), stacked."""
        return torch.stack([
            torch.as_tensor(metric(*selected_args, **selected_kwargs))
            for (selected_args, selected_kwargs), metric in zip(
                self._get_args_kwargs_by_output(*args, **kwargs), self.metrics
            )
        ], 0)

