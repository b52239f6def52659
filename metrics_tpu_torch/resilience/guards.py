"""Opt-in NaN/Inf input guard rails (counterpart of ``metrics_tpu/resilience/guards.py``).

``install_guard(metric, policy)`` arms one of three per-metric policies:

- ``propagate`` — record poisoned batches in the ``guard_poisoned`` counter
  state but let the values flow (the unguarded arithmetic, plus bookkeeping);
- ``skip_batch`` — quarantine the whole batch: every state keeps its pre-update
  value and only the counter advances;
- ``raise_on_host`` — ``skip_batch`` semantics, plus a host-side check after
  each update that raises :class:`PoisonedInputError`. This reads the counter
  back once per update (documented opt-in cost); the other policies never
  synchronize with the device.

The implementation is branch-free, as the JAX package's is: the poisoned flag
stays a device tensor (``~torch.isfinite(x).all()`` per float input, never
converted to a Python bool), inputs are sanitized with ``torch.where(isfinite,
x, 0)`` from the same ``isfinite`` pass, the update body runs, and the flag selects
the old or new value of every state with ``torch.where``. The old values are
the tensors the states held before the update: an update body replaces its
tensors and never writes into them (``metrics_tpu_torch/metric.py``), so those
references are an exact snapshot. The poisoned count is itself a metric state
(``count_dtype()``, int64 where the JAX package's is int32 under x32,
sum-merged), so it resets, syncs, checkpoints and merges like any other state.

``_guard_policy`` is part of the metric's config (``Metric.config_fingerprint``):
a guarded and an unguarded instance of one class are different configurations.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from metrics_tpu_torch.observe import recorder as _observe
from metrics_tpu_torch.utils.compute import count_dtype
from metrics_tpu_torch.utils.data import dim_zero_cat
from metrics_tpu_torch.utils.exceptions import TPUMetricsUserError

__all__ = ["GUARD_POLICIES", "GUARD_STATE", "PoisonedInputError", "install_guard", "poisoned_count"]

GUARD_POLICIES = ("propagate", "skip_batch", "raise_on_host")
GUARD_STATE = "guard_poisoned"


class PoisonedInputError(TPUMetricsUserError):
    """A ``raise_on_host``-guarded metric received a non-finite input batch.

    The batch was quarantined before the raise: payload states are untouched
    and only the ``guard_poisoned`` counter advanced — catching this error and
    continuing the stream is always safe.
    """


def install_guard(metric: Any, policy: str = "skip_batch") -> Any:
    """Arm a NaN/Inf input policy on ``metric``; returns the metric.

    Install right after construction. ``skip_batch`` and ``raise_on_host``
    need fixed-shape states to select old-vs-new with ``torch.where`` —
    metrics with list or cat-growable states only support ``propagate``.
    """
    if policy not in GUARD_POLICIES:
        raise TPUMetricsUserError(f"Unknown guard policy {policy!r}; choose one of {GUARD_POLICIES}")
    if policy != "propagate":
        growable = [
            k
            for k, v in metric._defaults.items()
            if isinstance(v, list) or metric._reductions[k] is dim_zero_cat
        ]
        if growable:
            raise TPUMetricsUserError(
                f"Guard policy {policy!r} needs fixed-shape states to quarantine batches branch-free, "
                f"but {type(metric).__name__} state(s) {growable} grow per update. Use policy='propagate'."
            )
    if GUARD_STATE not in metric._defaults:
        metric.add_state(
            GUARD_STATE, torch.zeros((), dtype=count_dtype(), device=metric.device), dist_reduce_fx="sum",
            persistent=True,
        )
    metric._guard_policy = policy
    metric.__dict__["_guard_seen"] = 0
    return metric


def _is_float_tensor(a: Any) -> bool:
    return isinstance(a, torch.Tensor) and (a.is_floating_point() or a.is_complex())


def _inspect(
    args: Tuple[Any, ...], kwargs: Dict[str, Any], device: torch.device, sanitize: bool
) -> Tuple[torch.Tensor, Tuple[Any, ...], Dict[str, Any]]:
    """One pass over the inputs: the 0-d bool tensor on ``device`` "some float input holds a non-finite value"
    (a Python float is a static flag), and, when ``sanitize``, the inputs with non-finite values replaced by
    zeros so that the (discarded) update arithmetic stays finite. Each float tensor is tested once."""
    bad = torch.zeros((), dtype=torch.bool, device=device)

    def visit(a: Any) -> Any:
        nonlocal bad
        if isinstance(a, bool) or a is None:
            return a
        if isinstance(a, float):
            if math.isfinite(a):
                return a
            bad = torch.ones((), dtype=torch.bool, device=device)
            return 0.0 if sanitize else a
        if _is_float_tensor(a):
            finite = torch.isfinite(a)
            bad = torch.logical_or(bad, torch.logical_not(finite.all()).to(device, non_blocking=True))
            return torch.where(finite, a, 0.0) if sanitize else a
        return a

    new_args = tuple(visit(a) for a in args)
    new_kwargs = {k: visit(v) for k, v in kwargs.items()}
    return bad, new_args, new_kwargs


def run_guarded_update(metric: Any, args: Tuple[Any, ...], kwargs: Dict[str, Any]) -> None:
    """The guarded update body — called by ``Metric._run_update_body`` for ``update`` and
    ``_functional_update`` alike."""
    state = metric.__dict__["_state"]
    prev_counter = state[GUARD_STATE]
    policy = metric.__dict__["_guard_policy"]
    bad, clean_args, clean_kwargs = _inspect(args, kwargs, prev_counter.device, sanitize=policy != "propagate")
    if policy == "propagate":
        metric._update_impl(*args, **kwargs)
    else:
        snapshot = {k: v for k, v in state.items() if k != GUARD_STATE}
        metric._update_impl(*clean_args, **clean_kwargs)
        after = metric.__dict__["_state"]
        for key, old in snapshot.items():
            after[key] = torch.where(bad, old, after[key])
    counter = prev_counter + bad.to(prev_counter.dtype)
    metric.__dict__["_state"][GUARD_STATE] = counter  # donlint: disable=ML001 — a fresh sum, held by nothing else


def poisoned_count(metric: Any) -> int:
    """Host-side read of the quarantine counter (synchronizes with the device)."""
    return int(metric.__dict__["_state"][GUARD_STATE].item())


def raise_if_quarantined(metric: Any) -> None:
    """``raise_on_host`` post-update hook (``metric.py``): compare the counter to the host watermark; new
    quarantines raise after recording telemetry."""
    current = poisoned_count(metric)
    seen = metric.__dict__.get("_guard_seen", 0)
    if current > seen:
        metric.__dict__["_guard_seen"] = current
        _observe.note_guard_quarantined(type(metric).__name__, current - seen)
        raise PoisonedInputError(
            f"{type(metric).__name__}: non-finite input batch quarantined "
            f"({current} poisoned batch(es) total). State is untouched apart from the "
            "guard counter; catching this error and continuing is safe."
        )
