"""Aggregation metrics (counterpart of ``metrics_tpu/aggregation.py``).

``MaxMetric``, ``MinMetric``, ``SumMetric``, ``CatMetric`` and ``MeanMetric``
over a stream of values, with the JAX package's NaN strategies (``"error"``,
``"warn"``, ``"ignore"``, ``"disable"`` or a float replacement) and its opt-in
Neumaier compensation (``compensated=True``); ``RunningMean`` and
``RunningSum`` view the last ``window`` updates. Inputs are cast to float32,
as in the JAX package; the states take the default float type.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Union

import torch

from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.compute import _safe_divide, neumaier_add, neumaier_value
from metrics_tpu_torch.utils.data import dim_zero_cat
from metrics_tpu_torch.utils.prints import rank_zero_warn

__all__ = ["BaseAggregator", "CatMetric", "MaxMetric", "MeanMetric", "MinMetric", "RunningMean", "RunningSum",
           "SumMetric"]

Tensor = torch.Tensor


def _on_device(value: Union[float, Tensor], dtype: torch.dtype, device: torch.device) -> Tensor:
    """``value`` as a tensor of ``dtype`` on ``device``; a Python number is filled there, so that no host copy
    (which waits for the device) is made."""
    if isinstance(value, (bool, int, float)):
        return torch.full((), float(value), dtype=dtype, device=device)
    return torch.as_tensor(value, dtype=dtype, device=device)


class BaseAggregator(Metric):
    """Base class for aggregation metrics.

    Args:
        fn: the state's reduction ("sum", "max", "min", "cat" or a callable).
        default_value: the state's default.
        nan_strategy: "error", "warn", "ignore", "disable" or a float replacement value.
        state_name: the state's name.
    """

    is_differentiable = None
    higher_is_better = None
    full_state_update = False

    def __init__(
        self,
        fn: Union[Callable, str],
        default_value: Union[Tensor, List],
        nan_strategy: Union[str, float] = "error",
        state_name: str = "value",
        **kwargs: Any,
    ) -> None:
        merge_associative = kwargs.pop("merge_associative", None)
        if merge_associative is None and isinstance(fn, str):
            merge_associative = fn in ("sum", "mean", "min", "max")
        super().__init__(**kwargs)
        allowed_nan_strategy = ("error", "warn", "ignore", "disable")
        if nan_strategy not in allowed_nan_strategy and not isinstance(nan_strategy, float):
            raise ValueError(
                f"Arg `nan_strategy` should either be a float or one of {allowed_nan_strategy} but got {nan_strategy}."
            )
        self.nan_strategy = nan_strategy
        if nan_strategy in ("error", "warn"):
            self._jit_update_opt = False  # the JAX package's mark: the update reads the values on the host
        self.state_name = state_name
        self.add_state(state_name, default=default_value, dist_reduce_fx=fn, merge_associative=merge_associative)

    @property
    def value(self) -> Any:
        return self._state[self.state_name]

    @value.setter
    def value(self, new_value: Any) -> None:
        self._state[self.state_name] = new_value

    def _cast_and_nan_check_input(self, x: Union[float, Tensor], weight: Optional[Union[float, Tensor]] = None):
        """``x`` as a float32 tensor on the metric's device, with the NaN strategy applied.

        Returns ``(x, weight, keep)``: ``keep`` marks the elements to count.
        A value or weight that is NaN is dropped under "warn"/"ignore" (after
        the warning or error of "warn"/"error"), kept under "disable", and
        replaced under a float strategy: the values, and a per-element weight
        at the same positions. A scalar weight is replaced only when it is NaN
        itself, the JAX package's documented divergence from its reference.
        """
        x = _on_device(x, self._dtype, self.device)
        weight = _on_device(1.0 if weight is None else weight, self._dtype, self.device)
        weight_was_scalar = weight.ndim == 0 or weight.numel() == 1
        weight = torch.broadcast_to(weight, x.shape)
        nan_mask = torch.isnan(x) | torch.isnan(weight)
        if self.nan_strategy in ("error", "warn"):
            if bool(nan_mask.any()):
                if self.nan_strategy == "error":
                    raise RuntimeError("Encountered `nan` values in tensor")
                rank_zero_warn("Encountered `nan` values in tensor. Will be removed.", UserWarning)
                return x, weight, ~nan_mask
            return x, weight, torch.ones_like(nan_mask)
        if self.nan_strategy == "ignore":
            return x, weight, ~nan_mask
        if self.nan_strategy == "disable":
            return x, weight, torch.ones_like(nan_mask)
        repl = _on_device(self.nan_strategy, x.dtype, x.device)
        new_weight = torch.where(torch.isnan(weight) if weight_was_scalar else nan_mask, repl, weight)
        return torch.where(nan_mask, repl, x), new_weight, torch.ones_like(nan_mask)

    def update(self, value: Union[float, Tensor]) -> None:  # noqa: D102
        raise NotImplementedError

    def compute(self) -> Tensor:
        """Aggregated value."""
        return self.value


class MaxMetric(BaseAggregator):
    """The maximum of a stream of values.

    >>> metric = MaxMetric(device="cpu")
    >>> metric.update(1.0)
    >>> metric.update(torch.tensor([2.0, 3.0]))
    >>> metric.compute()
    tensor(3.)
    """

    full_state_update = True

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("max", torch.tensor(-float("inf")), nan_strategy, state_name="max_value", **kwargs)

    def update(self, value: Union[float, Tensor]) -> None:
        value, _, keep = self._cast_and_nan_check_input(value)
        masked = torch.where(keep, value, -torch.inf)
        self.max_value = torch.maximum(self.max_value, masked.max() if masked.numel() else self.max_value)


class MinMetric(BaseAggregator):
    """The minimum of a stream of values."""

    full_state_update = True

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("min", torch.tensor(float("inf")), nan_strategy, state_name="min_value", **kwargs)

    def update(self, value: Union[float, Tensor]) -> None:
        value, _, keep = self._cast_and_nan_check_input(value)
        masked = torch.where(keep, value, torch.inf)
        self.min_value = torch.minimum(self.min_value, masked.min() if masked.numel() else self.min_value)


class SumMetric(BaseAggregator):
    """The sum of a stream of values.

    ``compensated=True`` accumulates with Neumaier's compensation: a
    ``sum_value_comp`` residual state, which merges by "sum" too, keeps the
    error O(eps) instead of O(n eps) on long streams.

    >>> metric = SumMetric(device="cpu")
    >>> metric.update(1.0)
    >>> metric.update(torch.tensor([2.0, 3.0]))
    >>> metric.compute()
    tensor(6.)
    """

    def __init__(self, nan_strategy: Union[str, float] = "warn", compensated: bool = False, **kwargs: Any) -> None:
        super().__init__("sum", torch.tensor(0.0), nan_strategy, state_name="sum_value", **kwargs)
        self.compensated = bool(compensated)
        if self.compensated:
            self._precision["sum_value"] = "compensated"
            self.add_state("sum_value_comp", default=torch.tensor(0.0), dist_reduce_fx="sum", precision="compensated")

    def update(self, value: Union[float, Tensor]) -> None:
        value, _, keep = self._cast_and_nan_check_input(value)
        batch = torch.where(keep, value, 0.0).sum()
        if self.compensated:
            self.sum_value, self.sum_value_comp = neumaier_add(self.sum_value, self.sum_value_comp, batch)
        else:
            self.sum_value = self.sum_value + batch

    def compute(self) -> Tensor:
        """Aggregated value; with the Neumaier residual folded back in when compensated."""
        if self.compensated:
            return neumaier_value(self.sum_value, self.sum_value_comp)
        return super().compute()


class CatMetric(BaseAggregator):
    """The concatenation of a stream of values (a list state, reduced by "cat")."""

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("cat", [], nan_strategy, **kwargs)

    def update(self, value: Union[float, Tensor]) -> None:
        value, _, keep = self._cast_and_nan_check_input(value)
        kept = value.reshape(-1)[keep.reshape(-1)]
        if kept.numel():
            self.value.append(kept)

    def compute(self) -> Tensor:
        if isinstance(self.value, list) and self.value:
            return dim_zero_cat(self.value)
        return self.value if not isinstance(self.value, list) else torch.zeros(0, dtype=self._dtype, device=self.device)


class MeanMetric(BaseAggregator):
    """The (weighted) mean of a stream of values.

    ``weight`` is broadcast to the values' shape. ``compensated=True``
    accumulates the weighted sum with Neumaier's compensation (a
    ``mean_value_comp`` residual); the weight sum stays plain.

    >>> metric = MeanMetric(device="cpu")
    >>> metric.update(1.0)
    >>> metric.update(torch.tensor([2.0, 3.0]))
    >>> metric.compute()
    tensor(2.)
    """

    def __init__(self, nan_strategy: Union[str, float] = "warn", compensated: bool = False, **kwargs: Any) -> None:
        super().__init__("sum", torch.tensor(0.0), nan_strategy, state_name="mean_value", **kwargs)
        self.add_state("weight", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.compensated = bool(compensated)
        if self.compensated:
            self._precision["mean_value"] = "compensated"
            self.add_state("mean_value_comp", default=torch.tensor(0.0), dist_reduce_fx="sum", precision="compensated")

    def update(self, value: Union[float, Tensor], weight: Union[float, Tensor] = 1.0) -> None:
        """Fold the values, each weighed by ``weight``."""
        value, weight, keep = self._cast_and_nan_check_input(value, weight)
        batch = torch.where(keep, value * weight, 0.0).sum()
        if self.compensated:
            self.mean_value, self.mean_value_comp = neumaier_add(self.mean_value, self.mean_value_comp, batch)
        else:
            self.mean_value = self.mean_value + batch
        self.weight = self.weight + torch.where(keep, weight, 0.0).sum()

    def compute(self) -> Tensor:
        value = neumaier_value(self.mean_value, self.mean_value_comp) if self.compensated else self.mean_value
        return _safe_divide(value, self.weight)


from metrics_tpu_torch.wrappers.running import Running  # noqa: E402  (bottom import: the wrapper imports Metric)


class RunningMean(Running):
    """The mean over the last ``window`` updates.

    >>> metric = RunningMean(window=2, device="cpu")
    >>> for i in range(5):
    ...     metric.update(float(i))
    >>> metric.compute()  # mean of [3, 4]
    tensor(3.5000)
    """

    def __init__(self, window: int = 5, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__(MeanMetric(nan_strategy=nan_strategy, **kwargs), window=window)


class RunningSum(Running):
    """The sum over the last ``window`` updates.

    >>> metric = RunningSum(window=2, device="cpu")
    >>> for i in range(5):
    ...     metric.update(float(i))
    >>> metric.compute()  # 3 + 4
    tensor(7.)
    """

    def __init__(self, window: int = 5, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__(SumMetric(nan_strategy=nan_strategy, **kwargs), window=window)
