"""Exponential time decay as a scalar-rescale fold over sum-algebra metrics.

Counterpart of ``metrics_tpu/windows/decay.py``. The JAX package also keeps a
``base_spec`` (the base's class, config fingerprint and state avals) as its
jit-cache key; the port compiles nothing, so it has none.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch

from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.ops.decay import _decay_fold, _decay_weights_compiled, decay_weights
from metrics_tpu_torch.utils.compute import neumaier_add, neumaier_value
from metrics_tpu_torch.utils.data import dim_zero_sum
from metrics_tpu_torch.utils.exceptions import TPUMetricsUserError
from metrics_tpu_torch.wrappers.abstract import wrapped_device

__all__ = ["TimeDecayed"]


def _validate_decay_base(metric: Metric, wrapper: str) -> None:
    """Refuse base metrics whose update or merge breaks the decay fold, with the JAX package's messages."""
    if not isinstance(metric, Metric):
        raise TPUMetricsUserError(f"{wrapper} expects a Metric instance, got {type(metric).__name__}")
    if type(metric).__jit_ineligible__:
        raise TPUMetricsUserError(
            f"{wrapper} cannot wrap {type(metric).__name__}: its update body is "
            "declared jit-ineligible, so it cannot be traced into the wrapper's "
            "single-dispatch update."
        )
    if metric._has_list_state():
        raise TPUMetricsUserError(
            f"{wrapper} cannot wrap {type(metric).__name__}: list ('cat') states "
            "are variable-shape and have no scalar-rescale decay."
        )
    if metric._jit_update_opt is False:
        raise TPUMetricsUserError(
            f"{wrapper} cannot wrap this {type(metric).__name__}: its update runs "
            "host-side (e.g. nan_strategy='warn'/'error'); construct the base "
            "with a traceable configuration such as nan_strategy='disable'."
        )
    if metric.full_state_update is not False:
        raise TPUMetricsUserError(
            f"{wrapper} cannot wrap {type(metric).__name__}: the decay fold "
            "requires batch-local updates (full_state_update=False)."
        )


def _base_clone(metric: Metric, device: torch.device) -> Metric:
    """A reset copy of the base metric on the wrapper's device; the caller's instance stays untouched."""
    base = metric.clone()
    base.reset()
    return base.to_device(device)


class _TimedWrapper(Metric):
    """A metric that holds a private base metric ``_base`` beside its own states: on the wrapped metric's device
    (a ``device`` other than its raises), moved with the wrapper."""

    def __init__(self, metric: Metric, device: Optional[Union[str, torch.device]] = None, **kwargs: Any) -> None:
        if isinstance(metric, Metric):
            device = wrapped_device([metric], device)
        super().__init__(device=device, **kwargs)

    def to_device(self, device: Union[str, torch.device]) -> "Metric":
        super().to_device(device)
        self._base.to_device(self.device)
        return self


class TimeDecayed(_TimedWrapper):
    """Exponential time decay for any sum-algebra metric, as an O(1) rescale fold.

    Wraps a base metric all of whose states use the ``sum`` reduction
    (``SumMetric``, ``MeanMetric``, count histograms) and weighs each
    observation by ``2^(-(now - t)/half_life_s)``. The state is
    ``Σ_i batch_i · 2^(-(ref - t_i)/half_life)`` with ``ref`` the newest
    timestamp seen, an order-invariant sum, so replicas merge by decaying both
    sides to the common reference time (the state ``last_t``) and adding.

    ``update(t, *args, **kwargs)`` prepends a timestamp to the base's update:
    nonnegative stream-relative seconds, held in float32.

    >>> from metrics_tpu_torch import SumMetric
    >>> m = TimeDecayed(SumMetric(nan_strategy="disable", device="cpu"), half_life_s=10.0)
    >>> m.update(0.0, torch.tensor(1.0))
    >>> m.update(10.0, torch.tensor(1.0))  # the first observation is one half-life old
    >>> m.compute()
    tensor(1.5000)

    Args:
        metric: the base metric; every state must use the ``sum`` reduction. A reset copy is kept.
        half_life_s: the half-life, in the unit of ``t`` (> 0).
        compensated: Neumaier-compensated folds: each state carries a ``<name>_comp`` residual, decayed and
            summed with it.
    """

    is_differentiable = False
    higher_is_better = None
    full_state_update = False

    def __init__(self, metric: Metric, half_life_s: float, compensated: bool = False, **kwargs: Any) -> None:
        super().__init__(metric, **kwargs)
        self.compensated = bool(compensated)
        _validate_decay_base(metric, type(self).__name__)
        if not float(half_life_s) > 0.0:
            raise ValueError(f"`half_life_s` must be > 0, got {half_life_s}")
        bad = [n for n, fn in metric._reductions.items() if fn is not dim_zero_sum]
        if bad:
            raise TPUMetricsUserError(
                f"{type(self).__name__} requires every base state to use the 'sum' "
                f"reduce algebra (decay distributes over +); {type(metric).__name__} "
                f"states {bad} do not. Mean-style metrics qualify when their "
                "numerator and denominator are both registered as sums."
            )
        if "last_t" in metric._defaults:
            raise TPUMetricsUserError(
                f"{type(self).__name__} reserves the state name 'last_t'; "
                f"{type(metric).__name__} already registers it."
            )
        self.half_life_s = float(half_life_s)
        self._base = _base_clone(metric, self.device)
        for name, default in self._base._defaults.items():
            # integer counts become fractional the moment they decay
            d = default if default.is_floating_point() else default.to(torch.float32)
            self.add_state(name, default=d, dist_reduce_fx="sum", precision="compensated" if self.compensated else None)
            if self.compensated:
                self.add_state(f"{name}_comp", default=torch.zeros_like(d), dist_reduce_fx="sum",
                               precision="compensated")
        self.add_state("last_t", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="max")

    def update(self, t: Any, *args: Any, **kwargs: Any) -> None:
        batch = self._base._functional_update(self._base._fresh_state(), *args, **kwargs)
        ref, w_old, w_new = _decay_weights_compiled(self.last_t, t, self.half_life_s)
        for name in self._base._defaults:
            cur = getattr(self, name)
            add = torch.as_tensor(batch[name]).to(cur.dtype) * w_new
            if self.compensated:
                # the residual decays with its sum; the fold's additions are compensated
                comp = getattr(self, f"{name}_comp") * w_old
                total, comp = neumaier_add(cur * w_old, comp, add)
                setattr(self, name, total)
                setattr(self, f"{name}_comp", comp)
            else:
                setattr(self, name, _decay_fold(cur, w_old, add))
        self.last_t = ref

    def compute(self) -> Any:
        state = self.__dict__["_state"]
        if self.compensated:
            folded = {name: neumaier_value(state[name], state[f"{name}_comp"]) for name in self._base._defaults}
            return self._base._functional_compute(folded)
        return self._base._functional_compute({name: state[name] for name in self._base._defaults})

    def _merge_state_dicts(
        self, state_a: Dict[str, Any], state_b: Dict[str, Any], count_a: int, count_b: int
    ) -> Dict[str, Any]:
        # both sides decay to the common (newer) reference time, then the base's sums apply; the per-state
        # reductions of a cross-rank sync alone would add states anchored at different times
        ref, w_a, w_b = decay_weights(state_a["last_t"], state_b["last_t"], self.half_life_s)
        names = list(self._base._defaults)
        if self.compensated:
            names += [f"{n}_comp" for n in self._base._defaults]  # residuals decay like their sums
        out = {name: state_a[name] * w_a + state_b[name] * w_b for name in names}
        out["last_t"] = ref
        return out
