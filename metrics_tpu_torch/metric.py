"""The stateful metric runtime (counterpart of ``metrics_tpu/metric.py``).

A metric's state is a flat ``dict[str, Tensor | list[Tensor]]`` registered with
:meth:`Metric.add_state` and kept on the metric's ``device``. Subclasses write
``update`` and ``compute``; the base class wraps them with the lifecycle the
JAX package defines: update counting, a compute cache that the next update
clears, both ``forward`` variants, ``merge_state``, ``reset``,
``state_dict``/``load_state_dict``, the pure functions of
:meth:`Metric.functional`, and the cross-rank ``sync``/``unsync`` over
``torch.distributed`` that ``compute`` runs inside.

PyTorch runs eagerly, so the JAX package's jit cache, buffer donation and AOT
machinery have no counterpart. One rule follows from keeping the transactional
update cheap: an update body *replaces* tensor states (``self.tp = self.tp +
tp``) and never changes them in place, so that a reference to the old tensor is
a snapshot of it. Compute-group members of a ``MetricCollection`` share their
leader's tensors on the same rule.
"""

from __future__ import annotations

import copy
import hashlib
import inspect
import operator
import types
from abc import ABC, abstractmethod
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch

from metrics_tpu_torch.utils.data import _flatten, dim_zero_cat, dim_zero_max, dim_zero_mean, dim_zero_min, dim_zero_sum
from metrics_tpu_torch.utils.exceptions import TPUMetricsUserError
from metrics_tpu_torch.utils.prints import rank_zero_warn

__all__ = ["CompositionalMetric", "Metric", "MetricFunctions", "resolve_device"]

_REDUCE_ALIASES: Dict[str, Callable] = {
    "sum": dim_zero_sum,
    "mean": dim_zero_mean,
    "cat": dim_zero_cat,
    "min": dim_zero_min,
    "max": dim_zero_max,
}

# the bound callables a copy or an unpickled metric binds anew
_BOUND = ("update", "compute", "_update_impl", "_compute_impl", "_update_signature")


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


class MetricFunctions:
    """The pure ``init/update/compute/merge`` functions of a metric.

    They close over the metric's configuration only; every state flows through
    the arguments, and ``update(state, *batch)`` returns a new dict without
    touching the metric's own state. ``merge(a, b, count_a=1, count_b=1)``
    weighs mean states by the updates folded into each side. ``reductions``
    and ``associative`` carry each state's ``dist_reduce_fx`` and
    ``merge_associative`` for :func:`metrics_tpu_torch.parallel.sync_states`.
    """

    def __init__(
        self,
        init: Callable,
        update: Callable,
        compute: Callable,
        merge: Callable,
        reductions: Dict,
        associative: Optional[Dict] = None,
    ):
        self.init = init
        self.update = update
        self.compute = compute
        self.merge = merge
        self.reductions = reductions
        self.associative = dict(associative or {})

    def __iter__(self):
        return iter((self.init, self.update, self.compute, self.merge))


class Metric(ABC):
    """Base class for all metrics.

    Args:
        device: where the states live and the update runs; ``"cuda"`` when omitted.
        dist_sync_on_step: sync across ranks on every ``forward``.
        process_group: the ``torch.distributed`` group to sync over (the default group when ``None``).
        dist_sync_fn: ``(list_of_states, group) -> list of per-rank lists`` gathering each state;
            :func:`metrics_tpu_torch.parallel.gather_all_states` when ``None``.
        distributed_available_fn: replaces the probe "is ``torch.distributed`` initialized with
            more than one rank in the group".
        sync_on_compute: sync inside ``compute``.
        compute_with_cache: keep the ``compute`` result until the next ``update``/``reset``.
        compute_on_cpu: move the list states to the CPU after each ``update`` and ``forward``; they stay
            there through sync, unsync and unpickling (the sync gathers them on ``device``).
        jit_update: accepted for the JAX package's sake and kept as ``_jit_update_opt``; no effect, since
            PyTorch runs the update eagerly.
        donate_states: accepted and kept as ``_donate_opt``; no effect, since an update replaces its
            tensor states and never reuses their memory.
    """

    is_differentiable: Optional[bool] = None
    higher_is_better: Optional[bool] = None
    full_state_update: Optional[bool] = False
    plot_lower_bound: Optional[float] = None
    plot_upper_bound: Optional[float] = None
    plot_legend_name: Optional[str] = None
    # the JAX package's mark of a class whose update runs on the host; the time-window wrappers refuse such a base
    __jit_ineligible__ = False

    def __init__(self, device: Optional[Union[str, torch.device]] = None, **kwargs: Any) -> None:
        object.__setattr__(self, "_defaults", {})
        object.__setattr__(self, "_state", {})
        self._persistent: Dict[str, bool] = {}
        self._reductions: Dict[str, Optional[Callable]] = {}
        self._merge_associative: Dict[str, Optional[bool]] = {}
        self._precision: Dict[str, Any] = {}
        self.compute_on_cpu = kwargs.pop("compute_on_cpu", False)
        self.dist_sync_on_step = kwargs.pop("dist_sync_on_step", False)
        self.process_group = kwargs.pop("process_group", None)
        self.dist_sync_fn = kwargs.pop("dist_sync_fn", None)
        self.distributed_available_fn = kwargs.pop("distributed_available_fn", None)
        self.sync_on_compute = kwargs.pop("sync_on_compute", True)
        self.compute_with_cache = kwargs.pop("compute_with_cache", True)
        self._jit_update_opt = kwargs.pop("jit_update", None)
        self._donate_opt = kwargs.pop("donate_states", None)
        if kwargs:
            raise ValueError(f"Unexpected keyword arguments: {', '.join(f'`{a}`' for a in sorted(kwargs))}")
        self.device = resolve_device(device)
        # the type inputs are cast to by the aggregators, float32 as in the JAX package
        self._dtype = torch.float32
        self._computed: Any = None
        self._update_count = 0
        self._to_sync = self.sync_on_compute
        self._should_unsync = True
        self._is_synced = False
        self._cache: Optional[Dict[str, Any]] = None
        self._bind()

    def _bind(self) -> None:
        """Wrap the subclass's ``update``/``compute`` with the lifecycle (at construction, copy and unpickling)."""
        cls = type(self)
        object.__setattr__(self, "_update_impl", types.MethodType(cls.update, self))
        object.__setattr__(self, "_update_signature", inspect.signature(self._update_impl))
        object.__setattr__(self, "_compute_impl", types.MethodType(cls.compute, self))
        object.__setattr__(self, "update", self._wrapped_update)
        object.__setattr__(self, "compute", self._wrapped_compute)

    # ------------------------------------------------------------------ state registry
    def add_state(
        self,
        name: str,
        default: Union[torch.Tensor, list, float, int],
        dist_reduce_fx: Optional[Union[str, Callable]] = None,
        persistent: bool = False,
        merge_associative: Optional[bool] = None,
        precision: Optional[Union[str, Dict[str, Any]]] = None,
    ) -> None:
        """Register a state: a fixed-shape tensor, or an empty list of tensors ("cat" style).

        ``dist_reduce_fx`` is one of "sum", "mean", "cat", "min", "max", None or a
        callable; it decides how :meth:`merge_state` and the cross-rank sync fold
        the state. ``merge_associative`` says whether that fold is associative
        and commutative: inferred for the string reductions (sum, mean, min and
        max yes, cat no: its order follows the ranks), declared for a callable,
        which the sync refuses when declared ``False``. ``precision`` is the
        state's declared numerical contract (``"compensated"`` for a state with
        a Neumaier ``<name>_comp`` companion); it is stored, not acted on.
        """
        if isinstance(default, list):
            if default:
                raise ValueError("state variable must be a tensor or an empty list (non-empty lists are ambiguous)")
        else:
            default = torch.as_tensor(default, device=self.device)
        if isinstance(dist_reduce_fx, str):
            if dist_reduce_fx not in _REDUCE_ALIASES:
                raise ValueError("`dist_reduce_fx` must be callable or one of ['mean', 'sum', 'cat', 'min', 'max']")
            reduce_fx = _REDUCE_ALIASES[dist_reduce_fx]
        elif dist_reduce_fx is None or callable(dist_reduce_fx):
            reduce_fx = dist_reduce_fx
        else:
            raise ValueError("`dist_reduce_fx` must be callable or one of ['mean', 'sum', 'cat', 'min', 'max']")
        if merge_associative is not None and not isinstance(merge_associative, bool):
            raise ValueError("`merge_associative` must be True, False or None (unknown)")
        if merge_associative is None and isinstance(dist_reduce_fx, str):
            merge_associative = dist_reduce_fx in ("sum", "mean", "min", "max")
        if precision is not None and not isinstance(precision, (str, dict)):
            raise ValueError("`precision` must be None, a string tag, or a dict of contract fields")
        self._defaults[name] = [] if isinstance(default, list) else default
        self._persistent[name] = persistent
        self._reductions[name] = reduce_fx
        self._merge_associative[name] = merge_associative
        self._precision[name] = precision
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

    @property
    def update_called(self) -> bool:
        return self._update_count > 0

    @property
    def dtype(self) -> torch.dtype:
        return self._dtype

    def _has_list_state(self) -> bool:
        return any(isinstance(v, list) for v in self._defaults.values())

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
                        f" got {tuple(a.shape)} and {tuple(b.shape)}. Pad the states to a common capacity"
                        " (metrics_tpu_torch.parallel.pad_to_capacity) or register the state with"
                        " dist_reduce_fx='cat'."
                    )
                out[attr] = reduce_fn(torch.stack([a, b]))
        return out

    # ------------------------------------------------------------------ pure functional core
    def _fresh_state(self) -> Dict[str, Any]:
        return {k: (list(v) if isinstance(v, list) else v) for k, v in self._defaults.items()}

    def _functional_update(self, state: Dict[str, Any], *args: Any, **kwargs: Any) -> Dict[str, Any]:
        """Pure form of the subclass ``update``: its body runs against a swapped-in copy of ``state``."""
        old = self.__dict__["_state"]
        self.__dict__["_state"] = {k: (list(v) if isinstance(v, list) else v) for k, v in state.items()}
        try:
            self._update_impl(*args, **kwargs)
            return self.__dict__["_state"]
        finally:
            self.__dict__["_state"] = old

    def _functional_compute(self, state: Dict[str, Any]) -> Any:
        old = self.__dict__["_state"]
        self.__dict__["_state"] = dict(state)
        try:
            return self._compute_impl()
        finally:
            self.__dict__["_state"] = old

    def functional(self) -> MetricFunctions:
        """The pure ``(init, update, compute, merge)`` functions over state dicts.

        Carry the state dict yourself, and sync it across ranks with
        :func:`metrics_tpu_torch.parallel.sync_states`.
        """
        return MetricFunctions(
            init=self._fresh_state,
            update=self._functional_update,
            compute=self._functional_compute,
            merge=lambda a, b, count_a=1, count_b=1: self._merge_state_dicts(a, b, count_a, count_b),
            reductions=dict(self._reductions),
            associative=dict(self._merge_associative),
        )

    # ------------------------------------------------------------------ lifecycle
    def _wrapped_update(self, *args: Any, **kwargs: Any) -> None:
        """Run the subclass update; on any exception every state, the update
        count and the compute cache are left as they were before the call."""
        if self._is_synced:
            raise TPUMetricsUserError("The Metric has already been synced and cannot be updated.")
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
        if self.compute_on_cpu:
            self._move_list_states_to_cpu()

    def _move_list_states_to_cpu(self) -> None:
        """Move every list state to the CPU (``compute_on_cpu``)."""
        for key, value in self._state.items():
            if isinstance(value, list):
                self._state[key] = _map_tensors(value, lambda t: t.cpu())

    def _wrapped_compute(self) -> Any:
        """The cached compute, run inside :meth:`sync_context` (synced on entry, unsynced on exit)."""
        if self._update_count == 0:
            rank_zero_warn(
                f"The ``compute`` method of metric {type(self).__name__} was called before the ``update`` method.",
                UserWarning,
            )
        if self.compute_with_cache and self._computed is not None:
            return self._computed
        with self.sync_context(
            dist_sync_fn=self.dist_sync_fn,
            process_group=self.process_group,
            should_sync=self._to_sync,
            should_unsync=self._should_unsync,
        ):
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
        if self._is_synced:
            raise TPUMetricsUserError("The Metric shouldn't be synced when performing ``forward``.")
        if self.full_state_update or self.full_state_update is None or self.dist_sync_on_step:
            return self._forward_full_state_update(*args, **kwargs)
        return self._forward_reduce_state_update(*args, **kwargs)

    def _forward_full_state_update(self, *args: Any, **kwargs: Any) -> Any:
        """Two updates: one into the global state, one into a fresh state for the batch value (synced when
        ``dist_sync_on_step``)."""
        self.update(*args, **kwargs)
        update_count = self._update_count
        cache = self._copy_state()
        self._set_to_defaults()
        try:
            self.update(*args, **kwargs)
            self._to_sync = self.dist_sync_on_step
            self._should_unsync = False
            batch_val = self.compute()
        finally:
            self._update_count = update_count
            self.__dict__["_state"] = cache
            self._computed = None
            self._is_synced = False
            self._should_unsync = True
            self._to_sync = self.sync_on_compute
        return batch_val

    def _forward_reduce_state_update(self, *args: Any, **kwargs: Any) -> Any:
        """One update into a fresh state, whose value is returned and which is then merged in."""
        global_state = self._copy_state()
        update_count = self._update_count
        self._set_to_defaults()
        self._update_count = 0
        try:
            self.update(*args, **kwargs)
            self._to_sync = self.dist_sync_on_step
            self._should_unsync = False
            batch_val = self.compute()
        except BaseException:
            self.__dict__["_state"] = global_state
            self._update_count = update_count
            raise
        finally:
            self._computed = None
            self._is_synced = False
            self._should_unsync = True
            self._to_sync = self.sync_on_compute
        self.__dict__["_state"] = self._merge_state_dicts(global_state, self._state, update_count, 1)
        self._update_count = update_count + 1
        if self.compute_on_cpu:
            self._move_list_states_to_cpu()
        return batch_val

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        return self.forward(*args, **kwargs)

    # ------------------------------------------------------------------ merge / sync
    def merge_state(self, incoming_state: Union[Dict[str, Any], "Metric"]) -> None:
        """Fold another metric's state (or a bare state dict, counted as one update) into this one."""
        if not isinstance(incoming_state, (dict, Metric)):
            raise ValueError(
                f"Expected incoming state to be a dict or an instance of Metric but got {type(incoming_state)}"
            )
        if self.full_state_update or self.full_state_update is None or self.dist_sync_on_step:
            raise RuntimeError(
                "``merge_state`` is not supported for metrics with ``full_state_update=True`` or "
                "``dist_sync_on_step=True``. Please overwrite the merge_state method in the metric class."
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

    def _distributed_available(self) -> bool:
        """``distributed_available_fn()`` when given, else: ``torch.distributed`` is initialized and the
        group has more than one rank."""
        if self.distributed_available_fn is not None:
            return bool(self.distributed_available_fn())
        dist = torch.distributed
        return dist.is_available() and dist.is_initialized() and dist.get_world_size(self.process_group) > 1

    def _default_dist_sync_fn(self, states: List[Any], group: Any) -> List[List[Any]]:
        """Gather each state from every rank (one collective per state, list states concatenated first)."""
        from metrics_tpu_torch.parallel.sync import gather_all_states

        return gather_all_states(states, group)

    def _sync_dist(self, dist_sync_fn: Optional[Callable] = None, process_group: Any = None) -> None:
        """Gather every state from every rank, then apply its reduction.

        List states are concatenated into one tensor first (one collective
        each); a rank with no data sends a zero-length placeholder. The new
        states are installed only once every collective and reduction has
        succeeded, so a failure leaves all of them local.
        """
        from metrics_tpu_torch.parallel.sync import reduce_gathered

        input_dict = {attr: self._state[attr] for attr in self._reductions}
        for attr, reduction_fn in self._reductions.items():
            value = input_dict[attr]
            if not isinstance(value, list):
                continue
            if self.compute_on_cpu:
                # list states offloaded by compute_on_cpu are gathered where the collectives run
                value = _map_tensors(value, lambda t: t.to(self.device))
            if reduction_fn is dim_zero_cat:
                if len(value) > 1:
                    value = [dim_zero_cat(value)]
                elif not value:
                    value = [torch.zeros((0,), dtype=self._dtype, device=self.device)]
            input_dict[attr] = value
        sync_fn = dist_sync_fn or self._default_dist_sync_fn
        names = list(input_dict)
        gathered = sync_fn([input_dict[n] for n in names], process_group)
        new_states: Dict[str, Any] = {}
        for attr, values in zip(names, gathered):
            if isinstance(values[0], list):
                values = _flatten(values)
            if self._reductions[attr] is None and isinstance(self._state[attr], list):
                # a list state gathered without a reduction stays a list: one tensor per rank, in rank order
                new_states[attr] = list(values)
            else:
                new_states[attr] = reduce_gathered(values, self._reductions[attr])
        self._state.update(new_states)

    def sync(
        self,
        dist_sync_fn: Optional[Callable] = None,
        process_group: Any = None,
        should_sync: bool = True,
        distributed_available: Optional[bool] = None,
    ) -> None:
        """Replace every state by its reduction over the ranks; :meth:`unsync` brings the local ones back.

        Runs under the process-wide :class:`~metrics_tpu_torch.parallel.SyncPolicy`:
        a failing collective is retried, and with ``partial_merge`` a final
        failure folds the survivors a
        :class:`~metrics_tpu_torch.parallel.SyncPeerLostError` carried into the
        local state instead of raising.
        """
        if self._is_synced and should_sync:
            raise TPUMetricsUserError("The Metric has already been synced.")
        if distributed_available is None:
            distributed_available = self._distributed_available()
        if not should_sync or not distributed_available:
            return
        from metrics_tpu_torch.parallel import sync as _sync_mod

        self._cache = self._copy_state()
        policy = _sync_mod.get_sync_policy()
        try:
            _sync_mod.run_with_retries(
                lambda: self._sync_dist(dist_sync_fn or self.dist_sync_fn, process_group or self.process_group),
                label=type(self).__name__,
                policy=policy,
            )
        except Exception as exc:
            if not policy.partial_merge or isinstance(exc, TPUMetricsUserError):
                self._cache = None
                raise
            # degraded mode: fold the survivors the failure carried into the intact local state,
            # count-weighted as merge_state folds
            merged = self._copy_state()
            merged_count = self._update_count
            survivors = getattr(exc, "survivors", None) or []
            counts = getattr(exc, "survivor_counts", None) or [1] * len(survivors)
            for peer_state, peer_count in zip(survivors, counts):
                merged = self._merge_state_dicts(merged, peer_state, merged_count, peer_count)
                merged_count += peer_count
            self.__dict__["_state"].update(merged)
        self._is_synced = True

    def unsync(self, should_unsync: bool = True) -> None:
        """Bring back the local states that :meth:`sync` replaced."""
        if not should_unsync:
            return
        if not self._is_synced:
            raise TPUMetricsUserError("The Metric has already been un-synced.")
        if self._cache is None:
            raise TPUMetricsUserError("The internal cache should exist to unsync the Metric.")
        self.__dict__["_state"].update(self._cache)
        self._is_synced = False
        self._cache = None

    def sync_context(
        self,
        dist_sync_fn: Optional[Callable] = None,
        process_group: Any = None,
        should_sync: bool = True,
        should_unsync: bool = True,
        distributed_available: Optional[bool] = None,
    ):
        """Context manager: :meth:`sync` on entry, :meth:`unsync` on exit."""

        @contextmanager
        def _ctx():
            dist_avail = self._distributed_available() if distributed_available is None else distributed_available
            self.sync(
                dist_sync_fn=dist_sync_fn,
                process_group=process_group,
                should_sync=should_sync,
                distributed_available=dist_avail,
            )
            yield
            self.unsync(should_unsync=self._is_synced and should_unsync)

        return _ctx()

    def reset(self) -> None:
        """Reset every state to its default."""
        self._update_count = 0
        self._computed = None
        self._set_to_defaults()
        self._cache = None
        self._is_synced = False

    def load_merged_state(self, merged: Dict[str, Any], update_count: int = 1) -> "Metric":
        """Install a reduced state dict (from :func:`~metrics_tpu_torch.parallel.allreduce_over_mesh`).

        A concatenated list state arrives as one tensor and becomes a one-element
        list. Returns ``self``.
        """
        for k, v in merged.items():
            if k not in self._state:
                raise KeyError(f"Unknown state {k!r} for {self.__class__.__name__}")
            self._state[k] = [v] if isinstance(self._state[k], list) and not isinstance(v, list) else v
        self._update_count = update_count
        self._computed = None
        return self

    # ------------------------------------------------------------------ copies and pickling
    def clone(self) -> "Metric":
        """A deep copy of the metric."""
        return copy.deepcopy(self)

    def __deepcopy__(self, memo: Dict) -> "Metric":
        new = self.__class__.__new__(self.__class__)
        memo[id(self)] = new
        # a copy syncs over the same process group: a torch.distributed group is a handle, not a value
        memo.setdefault(id(self.process_group), self.process_group)
        for k, v in self.__dict__.items():
            if k not in _BOUND:
                object.__setattr__(new, k, copy.deepcopy(v, memo))
        new._bind()
        return new

    def __getstate__(self) -> Dict[str, Any]:
        """Pickle without the bound callables, with every state tensor on the CPU."""
        state = {k: v for k, v in self.__dict__.items() if k not in _BOUND}
        for key in ("_state", "_defaults"):
            state[key] = {k: _map_tensors(v, lambda t: t.cpu()) for k, v in self.__dict__[key].items()}
        return state

    def __setstate__(self, state: Dict[str, Any]) -> None:
        """Unpickle: rebind ``update``/``compute`` and move the states back to the metric's device."""
        for k, v in state.items():
            object.__setattr__(self, k, v)
        self.__dict__.setdefault("compute_on_cpu", False)
        for key in ("_state", "_defaults"):
            store = self.__dict__[key]
            self.__dict__[key] = {
                # list states offloaded by compute_on_cpu stay on the CPU
                k: v if key == "_state" and isinstance(v, list) and self.compute_on_cpu
                else _map_tensors(v, lambda t: t.to(self.device))
                for k, v in store.items()
            }
        self._bind()

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
            destination[prefix + key] = _map_tensors(current, lambda t: t.detach())
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

    # ------------------------------------------------------------------ dtype moves
    def set_dtype(self, dst_type: torch.dtype) -> "Metric":
        """Cast every floating state (and its default) to ``dst_type``; other states keep their types."""
        self._dtype = dst_type

        def cast(t: torch.Tensor) -> torch.Tensor:
            return t.to(dst_type) if t.is_floating_point() else t

        for key in ("_state", "_defaults"):
            store = self.__dict__[key]
            for k, v in store.items():
                store[k] = _map_tensors(v, cast)
        self._computed = None
        return self

    def to_device(self, device: Union[str, torch.device]) -> "Metric":
        """Move every state, list states included, and every default to ``device``, which becomes the metric's:
        later updates and ``compute`` run there. List states that ``compute_on_cpu`` keeps on the CPU stay there.
        Returns ``self``."""
        device = resolve_device(device)
        for key in ("_state", "_defaults"):
            store = self.__dict__[key]
            for k, v in store.items():
                if key == "_state" and isinstance(v, list) and self.compute_on_cpu:
                    continue
                store[k] = _map_tensors(v, lambda t: t.to(device))
        self.device = device
        self._computed = None
        return self

    def type(self, dst_type: torch.dtype) -> "Metric":
        return self.set_dtype(dst_type)

    def float(self) -> "Metric":
        return self.set_dtype(torch.float32)

    def double(self) -> "Metric":
        return self.set_dtype(torch.float64)

    def half(self) -> "Metric":
        """bfloat16, as the JAX package's ``half()``."""
        return self.set_dtype(torch.bfloat16)

    # ------------------------------------------------------------------ misc API
    def state_fingerprint(self) -> str:
        """Content digest of the live state: the class name, the update count, and each state in sorted name
        order with its length (a tensor counts as a list of one), and each tensor's numpy ``dtype.str``, shape
        and host bytes.

        Two metrics agree on it exactly when their states are bit-equal, wherever they live (a NaN hashes by
        its bits). The recipe is the JAX package's, so the digests agree wherever the two packages' state
        types do (bfloat16 hashes as ``<V2``, numpy's code for it there).
        """
        digest = hashlib.sha256(f"{type(self).__name__}:{int(self._update_count)}".encode())
        for name in sorted(self._defaults):
            v = self._state[name]
            parts = v if isinstance(v, list) else [v]
            digest.update(f"|{name}[{len(parts)}]".encode())
            for part in parts:
                arr, code = _host_bytes(part)
                digest.update(f":{code}{arr.shape}".encode())
                digest.update(arr.tobytes())
        return digest.hexdigest()

    def plot(self, val: Any = None, ax: Any = None):
        """Plot one or more values of the metric (its ``compute()`` when ``val`` is None) into a new figure or
        into the matplotlib axis ``ax``; returns ``(fig, ax)``. Needs matplotlib."""
        from metrics_tpu_torch.utils.plot import plot_single_or_multi_val

        val = val if val is not None else self.compute()
        return plot_single_or_multi_val(
            val,
            ax=ax,
            higher_is_better=self.higher_is_better,
            lower_bound=self.plot_lower_bound,
            upper_bound=self.plot_upper_bound,
            legend_name=self.plot_legend_name,
            name=self.__class__.__name__,
        )

    def _filter_kwargs(self, **kwargs: Any) -> Dict[str, Any]:
        """The keyword arguments that the update's signature takes."""
        params = self._update_signature.parameters
        if any(p.kind == inspect.Parameter.VAR_KEYWORD for p in params.values()):
            return kwargs
        return {k: v for k, v in kwargs.items() if k in params}

    def __hash__(self) -> int:
        """Per instance and per state: the hash changes as the states are replaced."""
        hash_vals: List[Any] = [self.__class__.__name__, id(self)]
        for key in self._defaults:
            val = self._state[key]
            hash_vals.append(tuple(id(v) for v in val) if isinstance(val, list) else id(val))
        return hash(tuple(hash_vals))

    def __repr__(self) -> str:
        return f"{self.__class__.__name__}()"

    # ------------------------------------------------------------------ composition operators
    def __add__(self, other): return CompositionalMetric(operator.add, self, other)
    def __radd__(self, other): return CompositionalMetric(operator.add, other, self)
    def __sub__(self, other): return CompositionalMetric(operator.sub, self, other)
    def __rsub__(self, other): return CompositionalMetric(operator.sub, other, self)
    def __mul__(self, other): return CompositionalMetric(operator.mul, self, other)
    def __rmul__(self, other): return CompositionalMetric(operator.mul, other, self)
    def __truediv__(self, other): return CompositionalMetric(operator.truediv, self, other)
    def __rtruediv__(self, other): return CompositionalMetric(operator.truediv, other, self)
    def __floordiv__(self, other): return CompositionalMetric(operator.floordiv, self, other)
    def __rfloordiv__(self, other): return CompositionalMetric(operator.floordiv, other, self)
    def __mod__(self, other): return CompositionalMetric(operator.mod, self, other)
    def __rmod__(self, other): return CompositionalMetric(operator.mod, other, self)
    def __pow__(self, other): return CompositionalMetric(operator.pow, self, other)
    def __rpow__(self, other): return CompositionalMetric(operator.pow, other, self)
    def __matmul__(self, other): return CompositionalMetric(operator.matmul, self, other)
    def __rmatmul__(self, other): return CompositionalMetric(operator.matmul, other, self)
    def __and__(self, other): return CompositionalMetric(operator.and_, self, other)
    def __rand__(self, other): return CompositionalMetric(operator.and_, other, self)
    def __or__(self, other): return CompositionalMetric(operator.or_, self, other)
    def __ror__(self, other): return CompositionalMetric(operator.or_, other, self)
    def __xor__(self, other): return CompositionalMetric(operator.xor, self, other)
    def __rxor__(self, other): return CompositionalMetric(operator.xor, other, self)
    def __eq__(self, other): return CompositionalMetric(operator.eq, self, other)
    def __ne__(self, other): return CompositionalMetric(operator.ne, self, other)
    def __ge__(self, other): return CompositionalMetric(operator.ge, self, other)
    def __gt__(self, other): return CompositionalMetric(operator.gt, self, other)
    def __le__(self, other): return CompositionalMetric(operator.le, self, other)
    def __lt__(self, other): return CompositionalMetric(operator.lt, self, other)
    def __abs__(self): return CompositionalMetric(operator.abs, self, None)
    def __neg__(self): return CompositionalMetric(_neg, self, None)
    def __pos__(self): return CompositionalMetric(operator.abs, self, None)
    def __inv__(self): return CompositionalMetric(_bitwise_not, self, None)
    def __invert__(self): return self.__inv__()
    def __getitem__(self, idx): return CompositionalMetric(_Indexer(idx), self, None)


def _map_tensors(value: Any, fn: Callable[[torch.Tensor], torch.Tensor]) -> Any:
    """``fn`` on a tensor state, or on each tensor of a list state."""
    if isinstance(value, list):
        return [fn(v) if isinstance(v, torch.Tensor) else v for v in value]
    return fn(value) if isinstance(value, torch.Tensor) else value


def _host_bytes(value: Any) -> tuple:
    """A state's value as a contiguous numpy array for hashing, and the numpy ``dtype.str`` it hashes under."""
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu()
        if value.dtype == torch.bfloat16:
            return np.ascontiguousarray(value.view(torch.int16).numpy()), "<V2"
        value = value.numpy()
    arr = np.ascontiguousarray(np.asarray(value))
    return arr, arr.dtype.str


def _neg(x: torch.Tensor) -> torch.Tensor:
    # the JAX package's (and its reference's) ``-metric`` is ``-abs(value)``
    return -torch.abs(x)


def _bitwise_not(x: torch.Tensor) -> torch.Tensor:
    # integer/bool complement, not the logical negation of floats
    return torch.bitwise_not(x)


class _Indexer:
    """Picklable ``x[idx]`` callable for ``Metric.__getitem__`` compositions."""

    def __init__(self, idx: Any) -> None:
        self.idx = idx

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return x[self.idx]


class CompositionalMetric(Metric):
    """Two metrics (or a metric and a constant) joined by an operator applied at compute.

    ``update`` feeds both children; each child syncs itself. The composition
    lives where its first child metric lives, unless ``device`` says otherwise.
    """

    def __init__(
        self,
        operator: Callable,
        metric_a: Union[Metric, float, int, torch.Tensor],
        metric_b: Union[Metric, float, int, torch.Tensor, None],
        device: Optional[Union[str, torch.device]] = None,
    ) -> None:
        if device is None:
            child = next((m for m in (metric_a, metric_b) if isinstance(m, (Metric, torch.Tensor))), None)
            device = child.device if child is not None else None
        super().__init__(device=device)
        self.op = operator
        self.metric_a = metric_a
        self.metric_b = metric_b

    def _sync_dist(self, dist_sync_fn: Optional[Callable] = None, process_group: Any = None) -> None:
        pass  # the children sync themselves

    def update(self, *args: Any, **kwargs: Any) -> None:
        if isinstance(self.metric_a, Metric):
            self.metric_a.update(*args, **self.metric_a._filter_kwargs(**kwargs))
        if isinstance(self.metric_b, Metric):
            self.metric_b.update(*args, **self.metric_b._filter_kwargs(**kwargs))

    def compute(self) -> Any:
        val_a = self.metric_a.compute() if isinstance(self.metric_a, Metric) else self.metric_a
        val_b = self.metric_b.compute() if isinstance(self.metric_b, Metric) else self.metric_b
        if val_b is None:
            return self.op(val_a)
        return self.op(val_a, val_b)

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        val_a = (
            self.metric_a(*args, **self.metric_a._filter_kwargs(**kwargs))
            if isinstance(self.metric_a, Metric)
            else self.metric_a
        )
        val_b = (
            self.metric_b(*args, **self.metric_b._filter_kwargs(**kwargs))
            if isinstance(self.metric_b, Metric)
            else self.metric_b
        )
        if val_a is None:
            return None
        if val_b is None:
            if isinstance(self.metric_b, Metric):
                return None
            return self.op(val_a)
        return self.op(val_a, val_b)

    def reset(self) -> None:
        if isinstance(self.metric_a, Metric):
            self.metric_a.reset()
        if isinstance(self.metric_b, Metric):
            self.metric_b.reset()

    def persistent(self, mode: bool = False) -> None:
        if isinstance(self.metric_a, Metric):
            self.metric_a.persistent(mode=mode)
        if isinstance(self.metric_b, Metric):
            self.metric_b.persistent(mode=mode)

    def __repr__(self) -> str:
        name = self.op.__name__ if hasattr(self.op, "__name__") else "op"
        return f"{self.__class__.__name__}(\n  {name}(\n    {self.metric_a!r},\n    {self.metric_b!r}\n  )\n)"


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
    """Squeeze one-element tensors to 0-d, through tuples, lists and dicts (as the JAX package's tree map
    does)."""
    if isinstance(data, torch.Tensor):
        return data.squeeze() if data.numel() == 1 and data.ndim > 0 else data
    if isinstance(data, (list, tuple)):
        return type(data)(_squeeze_if_scalar(x) for x in data)
    if isinstance(data, dict):
        return {k: _squeeze_if_scalar(v) for k, v in data.items()}
    return data
