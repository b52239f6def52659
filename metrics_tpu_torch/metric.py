"""The stateful metric runtime (counterpart of ``metrics_tpu/metric.py``).

A metric's state is a flat ``dict[str, Tensor | list[Tensor]]`` registered with
:meth:`Metric.add_state` and kept on the metric's ``device``. Subclasses write
``update`` and ``compute``; the base class wraps them with the lifecycle the
JAX package defines: update counting, a compute cache that the next update
clears, both ``forward`` variants, ``merge_state``, ``reset`` and
``state_dict``/``load_state_dict``.

PyTorch runs eagerly, so the JAX package's jit cache, buffer donation and AOT
machinery have no counterpart. One rule follows from keeping the transactional
update cheap: an update body *replaces* tensor states (``self.tp = self.tp +
tp``) and never changes them in place, so that a reference to the old tensor is
a snapshot of it.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Callable, Dict, Optional, Union

import torch

from metrics_tpu_torch.utils.data import _flatten, dim_zero_cat, dim_zero_max, dim_zero_mean, dim_zero_min, dim_zero_sum
from metrics_tpu_torch.utils.exceptions import TPUMetricsUserError
from metrics_tpu_torch.utils.prints import rank_zero_warn

__all__ = ["Metric", "resolve_device"]

_REDUCE_ALIASES: Dict[str, Callable] = {
    "sum": dim_zero_sum,
    "mean": dim_zero_mean,
    "cat": dim_zero_cat,
    "min": dim_zero_min,
    "max": dim_zero_max,
}


def resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """The device a metric keeps its state on: ``"cuda"`` unless the caller says otherwise.

    A metric never moves to the CPU on its own: without a CUDA device the
    caller must pass ``device="cpu"``.
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "metrics_tpu_torch metrics run on a CUDA device by default, and none is available."
            " Pass device='cpu' to compute on the CPU."
        )
    return device


class Metric(ABC):
    """Base class for all metrics.

    Args:
        device: where the states live and the update runs; ``"cuda"`` when omitted.
        compute_with_cache: keep the ``compute`` result until the next ``update``/``reset``.
    """

    is_differentiable: Optional[bool] = None
    higher_is_better: Optional[bool] = None
    full_state_update: Optional[bool] = False

    def __init__(self, device: Optional[Union[str, torch.device]] = None, **kwargs: Any) -> None:
        object.__setattr__(self, "_defaults", {})
        object.__setattr__(self, "_state", {})
        self._persistent: Dict[str, bool] = {}
        self._reductions: Dict[str, Optional[Callable]] = {}
        self.compute_with_cache = kwargs.pop("compute_with_cache", True)
        if kwargs:
            raise ValueError(f"Unexpected keyword arguments: {', '.join(f'`{a}`' for a in sorted(kwargs))}")
        self.device = resolve_device(device)
        self._computed: Any = None
        self._update_count = 0
        self._update_impl: Callable = self.update
        self._compute_impl: Callable = self.compute
        self.update = self._wrapped_update  # type: ignore[method-assign]
        self.compute = self._wrapped_compute  # type: ignore[method-assign]

    # ------------------------------------------------------------------ state registry
    def add_state(
        self,
        name: str,
        default: Union[torch.Tensor, list, float, int],
        dist_reduce_fx: Optional[Union[str, Callable]] = None,
        persistent: bool = False,
    ) -> None:
        """Register a state: a fixed-shape tensor, or an empty list of tensors ("cat" style).

        ``dist_reduce_fx`` is one of "sum", "mean", "cat", "min", "max", None or a
        callable; it decides how :meth:`merge_state` folds two states.
        """
        if isinstance(default, list):
            if default:
                raise ValueError("state variable must be a tensor or an empty list (non-empty lists are ambiguous)")
        else:
            default = torch.as_tensor(default, device=self.device)
        if isinstance(dist_reduce_fx, str):
            if dist_reduce_fx not in _REDUCE_ALIASES:
                raise ValueError("`dist_reduce_fx` must be callable or one of ['mean', 'sum', 'cat', 'min', 'max']")
            dist_reduce_fx = _REDUCE_ALIASES[dist_reduce_fx]
        elif dist_reduce_fx is not None and not callable(dist_reduce_fx):
            raise ValueError("`dist_reduce_fx` must be callable or one of ['mean', 'sum', 'cat', 'min', 'max']")
        self._defaults[name] = [] if isinstance(default, list) else default
        self._persistent[name] = persistent
        self._reductions[name] = dist_reduce_fx
        self._state[name] = [] if isinstance(default, list) else default

    def __getattr__(self, name: str) -> Any:
        try:
            state = object.__getattribute__(self, "_state")
        except AttributeError:
            raise AttributeError(name) from None
        if name in state:
            return state[name]
        raise AttributeError(f"{type(self).__name__!r} object has no attribute {name!r}")

    def __setattr__(self, name: str, value: Any) -> None:
        defaults = self.__dict__.get("_defaults")
        if defaults is not None and name in defaults:
            self.__dict__["_state"][name] = value
            return
        if name in ("higher_is_better", "is_differentiable", "full_state_update") and name in type(self).__dict__:
            raise RuntimeError(f"Can't change const `{name}`.")
        object.__setattr__(self, name, value)

    @property
    def metric_state(self) -> Dict[str, Any]:
        """The current state dict (tensors and lists of tensors)."""
        return {k: self._state[k] for k in self._defaults}

    @property
    def update_count(self) -> int:
        """Number of times ``update``/``forward`` has been called."""
        return self._update_count

    def _copy_state(self) -> Dict[str, Any]:
        return {k: (list(v) if isinstance(v, list) else v) for k, v in self._state.items()}

    def _set_to_defaults(self) -> None:
        for attr, default in self._defaults.items():
            self._state[attr] = list(default) if isinstance(default, list) else default

    def _merge_state_dicts(
        self, state_a: Dict[str, Any], state_b: Dict[str, Any], count_a: int, count_b: int
    ) -> Dict[str, Any]:
        """Merge two state dicts by each state's reduction; mean states weigh by update count."""
        out: Dict[str, Any] = {}
        for attr in self._defaults:
            a, b = state_a[attr], state_b[attr]
            reduce_fn = self._reductions[attr]
            if reduce_fn is dim_zero_sum:
                out[attr] = a + b
            elif reduce_fn is dim_zero_mean:
                out[attr] = (count_a * a + count_b * b) / max(count_a + count_b, 1)
            elif reduce_fn is dim_zero_max:
                out[attr] = torch.maximum(a, b)
            elif reduce_fn is dim_zero_min:
                out[attr] = torch.minimum(a, b)
            elif reduce_fn is dim_zero_cat:
                if isinstance(a, list) or isinstance(b, list):
                    out[attr] = (a if isinstance(a, list) else [a]) + (b if isinstance(b, list) else [b])
                else:
                    out[attr] = torch.cat([a, b])
            elif reduce_fn is None and isinstance(a, list):
                out[attr] = _flatten([a, b])
            elif reduce_fn is None:
                # replica-stack semantics: one leading replica axis however many states were folded
                base_ndim = self._defaults[attr].ndim
                a_st = a if a.ndim > base_ndim else a.unsqueeze(0)
                b_st = b if b.ndim > base_ndim else b.unsqueeze(0)
                out[attr] = torch.cat([a_st, b_st], dim=0)
            else:
                if a.shape != b.shape:
                    raise TPUMetricsUserError(
                        f"Cannot merge state {attr!r}: a custom dist_reduce_fx needs equal state shapes,"
                        f" got {tuple(a.shape)} and {tuple(b.shape)}."
                    )
                out[attr] = reduce_fn(torch.stack([a, b]))
        return out

    # ------------------------------------------------------------------ lifecycle
    def _wrapped_update(self, *args: Any, **kwargs: Any) -> None:
        """Run the subclass update; on any exception every state, the update
        count and the compute cache are left as they were before the call."""
        snapshot = self._copy_state()
        prev_computed = self._computed
        prev_count = self._update_count
        self._computed = None
        self._update_count += 1
        try:
            self._update_impl(*args, **kwargs)
        except BaseException:
            self.__dict__["_state"] = snapshot
            self._computed = prev_computed
            self._update_count = prev_count
            raise

    def _wrapped_compute(self) -> Any:
        if self._update_count == 0:
            rank_zero_warn(
                f"The ``compute`` method of metric {type(self).__name__} was called before the ``update`` method.",
                UserWarning,
            )
        if self.compute_with_cache and self._computed is not None:
            return self._computed
        value = _squeeze_if_scalar(self._compute_impl())
        if self.compute_with_cache:
            self._computed = value
        return value

    @abstractmethod
    def update(self, *_: Any, **__: Any) -> None:
        """Override this method to update the state variables of your metric class."""

    @abstractmethod
    def compute(self) -> Any:
        """Override this method to compute the final metric value."""

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        """Accumulate the batch into the state and return the batch's own value."""
        if self.full_state_update or self.full_state_update is None:
            return self._forward_full_state_update(*args, **kwargs)
        return self._forward_reduce_state_update(*args, **kwargs)

    def _forward_full_state_update(self, *args: Any, **kwargs: Any) -> Any:
        """Two updates: one into the global state, one into a fresh state for the batch value."""
        self.update(*args, **kwargs)
        update_count = self._update_count
        cache = self._copy_state()
        self._set_to_defaults()
        try:
            self.update(*args, **kwargs)
            batch_val = self.compute()
        finally:
            self._update_count = update_count
            self.__dict__["_state"] = cache
            self._computed = None
        return batch_val

    def _forward_reduce_state_update(self, *args: Any, **kwargs: Any) -> Any:
        """One update into a fresh state, whose value is returned and which is then merged in."""
        global_state = self._copy_state()
        update_count = self._update_count
        self._set_to_defaults()
        self._update_count = 0
        try:
            self.update(*args, **kwargs)
            batch_val = self.compute()
        except BaseException:
            self.__dict__["_state"] = global_state
            self._update_count = update_count
            raise
        finally:
            self._computed = None
        self.__dict__["_state"] = self._merge_state_dicts(global_state, self._state, update_count, 1)
        self._update_count = update_count + 1
        return batch_val

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        return self.forward(*args, **kwargs)

    def merge_state(self, incoming_state: Union[Dict[str, Any], "Metric"]) -> None:
        """Fold another metric's state (or a bare state dict, counted as one update) into this one."""
        if not isinstance(incoming_state, (dict, Metric)):
            raise ValueError(
                f"Expected incoming state to be a dict or an instance of Metric but got {type(incoming_state)}"
            )
        if self.full_state_update or self.full_state_update is None:
            raise RuntimeError(
                "``merge_state`` is not supported for metrics with ``full_state_update=True``."
                " Please overwrite the merge_state method in the metric class."
            )
        if isinstance(incoming_state, Metric):
            if not isinstance(incoming_state, self.__class__):
                raise ValueError(
                    f"Expected incoming state to be an instance of {self.__class__.__name__}"
                    f" but got {type(incoming_state)}"
                )
            incoming_count = incoming_state._update_count
            incoming_state = incoming_state.metric_state
        else:
            incoming_count = 1
        own_count = self._update_count
        self.__dict__["_state"] = self._merge_state_dicts(incoming_state, self.metric_state, incoming_count, own_count)
        self._update_count = own_count + incoming_count
        self._computed = None

    def reset(self) -> None:
        """Reset every state to its default."""
        self._update_count = 0
        self._computed = None
        self._set_to_defaults()

    # ------------------------------------------------------------------ persistence
    def persistent(self, mode: bool = False) -> None:
        """Choose whether the states are saved by :meth:`state_dict`."""
        for key in self._persistent:
            self._persistent[key] = mode

    def state_dict(self, destination: Optional[Dict] = None, prefix: str = "") -> Dict[str, Any]:
        """The persistent states (tensors, detached) and ``_update_count``."""
        destination = destination if destination is not None else {}
        for key in self._defaults:
            if not self._persistent[key]:
                continue
            current = self._state[key]
            destination[prefix + key] = (
                [v.detach() for v in current] if isinstance(current, list) else current.detach()
            )
        destination[prefix + "_update_count"] = self._update_count
        return destination

    def _validate_loaded_state(self, key: str, value: Any) -> None:
        """Raise unless ``value`` can be state ``key``: same dtype kind, and same shape for a fixed-shape state."""
        default = self._defaults[key]
        if isinstance(default, list):
            if not isinstance(value, list) or not all(isinstance(v, torch.Tensor) for v in value):
                raise RuntimeError(f"{type(self).__name__}: state {key!r} expects a list of tensors.")
            return
        if not isinstance(value, torch.Tensor):
            raise RuntimeError(f"{type(self).__name__}: state {key!r} expects a tensor, got {type(value).__name__}.")
        if _dtype_kind(value.dtype) != _dtype_kind(default.dtype) or value.shape != default.shape:
            raise RuntimeError(
                f"{type(self).__name__}: state {key!r} expects {default.dtype} of shape {tuple(default.shape)}"
                f" but got {value.dtype} of shape {tuple(value.shape)}: wrong checkpoint or another configuration."
            )

    def load_state_dict(self, state_dict: Dict[str, Any], prefix: str = "", strict: bool = True) -> None:
        """Load what :meth:`state_dict` exported.

        Every value is validated before anything is installed, so a bad
        checkpoint never leaves the metric half loaded. Fixed-shape states are
        cast to their default's dtype and moved to the metric's device.
        """
        for key in self._defaults:
            if prefix + key in state_dict:
                self._validate_loaded_state(key, state_dict[prefix + key])
            elif strict and self._persistent[key]:
                raise RuntimeError(f"Missing key {prefix + key} in state_dict")
        for key, default in self._defaults.items():
            if prefix + key not in state_dict:
                continue
            value = state_dict[prefix + key]
            if isinstance(value, list):
                self._state[key] = [v.to(self.device) for v in value]
            else:
                self._state[key] = value.to(device=self.device, dtype=default.dtype)
        if prefix + "_update_count" in state_dict:
            self._update_count = int(state_dict[prefix + "_update_count"])
        self._computed = None


def _dtype_kind(dtype: torch.dtype) -> str:
    """numpy's kind letter for a torch dtype: 'b' bool, 'i' signed, 'u' unsigned, 'f' float, 'c' complex."""
    if dtype == torch.bool:
        return "b"
    if dtype.is_complex:
        return "c"
    if dtype.is_floating_point:
        return "f"
    return "u" if dtype in (torch.uint8, torch.uint16, torch.uint32, torch.uint64) else "i"


def _squeeze_if_scalar(data: Any) -> Any:
    """Squeeze one-element tensors to 0-d, through tuples and lists."""
    if isinstance(data, torch.Tensor):
        return data.squeeze() if data.numel() == 1 and data.ndim > 0 else data
    if isinstance(data, (list, tuple)):
        return type(data)(_squeeze_if_scalar(x) for x in data)
    return data
