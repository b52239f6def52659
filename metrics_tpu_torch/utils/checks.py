"""Input-validation helpers (counterpart of ``metrics_tpu/utils/checks.py``).

:func:`_is_traced` is the port's traced mode: an update body runs under
``torch.func.vmap`` when the fleet engine or a replica wrapper batches it, and
its tensors are then functorch wrappers, which cannot be read on the host; a
shape trace (``torch._subclasses.FakeTensorMode``, the abstract contracts) holds
fake tensors, which have no values at all. Value checks that the JAX package
skips under tracing are skipped there too, and the ones it refuses raise
:class:`~metrics_tpu_torch.utils.exceptions.TraceIneligibleError`.

A tensor validation that reads the card runs inside a ``validate:<task>`` span
(:func:`traced_validation`), and its read inside a ``host_read:<site>`` span
(:func:`_unique_values`), which the recorder's ``explicit_transfer`` counter
counts by site (:mod:`metrics_tpu_torch.observe`).
"""

from __future__ import annotations

import functools
from time import perf_counter
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensor

from metrics_tpu_torch.observe import recorder as _observe
from metrics_tpu_torch.observe import tracing as _tracing


def _is_traced(*xs: Any) -> bool:
    """True when any input is a tensor wrapped by ``torch.func`` (inside ``vmap`` or ``grad``) or a fake tensor
    (a shape trace): skip value checks."""
    return any(isinstance(x, torch.Tensor)
               and (isinstance(x, FakeTensor) or torch._C._functorch.is_functorch_wrapped_tensor(x)) for x in xs)


def _shape_trace_active() -> bool:
    """Is a ``FakeTensorMode`` on the dispatch stack (a shape trace, where every new tensor is fake)?"""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    return any(isinstance(mode, FakeTensorMode) for mode in _get_current_dispatch_mode_stack())


def device_constant_cache(maxsize: int) -> Callable[[Callable[..., Any]], Callable[..., Any]]:
    """``functools.lru_cache`` for functions that build per-device constant tensors, bypassed under a shape trace: a fake
    constant kept there would reach the next real call on the same device."""

    def decorate(fn: Callable[..., Any]) -> Callable[..., Any]:
        cached = functools.lru_cache(maxsize=maxsize)(fn)

        @functools.wraps(fn)
        def wrapper(*args: Any) -> Any:
            return fn(*args) if _shape_trace_active() else cached(*args)

        wrapper.cache_clear = cached.cache_clear  # type: ignore[attr-defined]
        return wrapper

    return decorate


def _check_same_shape(preds: torch.Tensor, target: torch.Tensor) -> None:
    """Raise unless predictions and target have the same shape."""
    if preds.shape != target.shape:
        raise RuntimeError(
            "Predictions and targets are expected to have the same shape, but got"
            f" {tuple(preds.shape)} and {tuple(target.shape)}."
        )


def traced_validation(task: str) -> Callable[[Callable[..., Any]], Callable[..., Any]]:
    """Run the decorated tensor validation inside a ``validate:<task>`` span."""

    def decorate(fn: Callable[..., Any]) -> Callable[..., Any]:
        @functools.wraps(fn)
        def wrapper(*args: Any, **kwargs: Any) -> Any:
            with _tracing.span("validate", task):
                return fn(*args, **kwargs)

        return wrapper

    return decorate


def _unique_values(x: torch.Tensor, site: str) -> list:
    """Sorted distinct values of ``x`` as Python numbers: one host read, inside a ``host_read:<site>`` span and
    counted as an explicit transfer of ``site``."""
    with _tracing.span("host_read", site):
        found = torch.unique(x).tolist()
    _observe.note_explicit_transfer(site)
    return found


def _host_bool(x: torch.Tensor, site: str) -> bool:
    """``bool(x)`` of a one-element tensor: one host read, inside a ``host_read:<site>`` span and counted as an
    explicit transfer of ``site``."""
    with _tracing.span("host_read", site):
        value = bool(x)
    _observe.note_explicit_transfer(site)
    return value


def _is_integer(x: torch.Tensor) -> bool:
    return not (x.is_floating_point() or x.is_complex() or x.dtype == torch.bool)


def _check_retrieval_shape(indexes: torch.Tensor, preds: torch.Tensor, target: torch.Tensor) -> None:
    """Raise unless ``indexes``, ``preds`` and ``target`` have one shape."""
    if indexes.shape != preds.shape or preds.shape != target.shape:
        raise IndexError("`indexes`, `preds` and `target` must be of the same shape")


def _check_retrieval_inputs(
    indexes: torch.Tensor,
    preds: torch.Tensor,
    target: torch.Tensor,
    allow_non_binary_target: bool = False,
    ignore_index: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Validate and flatten a retrieval batch; drop the rows whose target is ``ignore_index``.

    Returns int32 query ids, float32 scores and the targets in their own type,
    as the JAX package stores them. A non-binary target raises unless
    ``allow_non_binary_target`` (one host read of its range).
    """
    _check_retrieval_shape(indexes, preds, target)
    if not _is_integer(indexes):
        raise ValueError("`indexes` must be a tensor of integers")
    if not (_is_integer(target) or target.dtype == torch.bool):
        raise ValueError("`target` must be a tensor of booleans or integers")
    if not preds.is_floating_point():
        raise ValueError("`preds` must be a tensor of floats")
    indexes, preds, target = indexes.reshape(-1), preds.reshape(-1), target.reshape(-1)
    if ignore_index is not None:
        keep = target != ignore_index
        indexes, preds, target = indexes[keep], preds[keep], target[keep]
    if not _is_traced(target) and not allow_non_binary_target and target.numel() and target.dtype != torch.bool:
        if bool((target.max() > 1) | (target.min() < 0)):
            raise ValueError("`target` must contain binary values")
    return indexes.to(torch.int32), preds.to(torch.float32), target


def _allclose_recursive(res1: Any, res2: Any, atol: float = 1e-6) -> bool:
    """Two metric results close, through dicts, lists and tuples: tensors, arrays and numbers by
    ``allclose`` (rtol 1e-5) in their promoted type, anything else by equality."""
    if isinstance(res1, str):
        return res1 == res2
    if isinstance(res1, dict):
        return set(res1) == set(res2) and all(_allclose_recursive(res1[k], res2[k], atol) for k in res1)
    if isinstance(res1, (list, tuple)):
        return len(res1) == len(res2) and all(_allclose_recursive(a, b, atol) for a, b in zip(res1, res2))
    if isinstance(res1, (torch.Tensor, np.ndarray, int, float, bool)):
        a = torch.as_tensor(res1)
        b = torch.as_tensor(res2, device=a.device)
        dtype = torch.promote_types(a.dtype, b.dtype)
        return bool(torch.allclose(a.to(dtype), b.to(dtype), atol=atol))
    return res1 == res2


def check_forward_full_state_property(
    metric_class,
    init_args: Optional[dict] = None,
    input_args: Optional[dict] = None,
    num_update_to_compare=(10, 100, 1000),
    reps: int = 5,
) -> bool:
    """Find out whether ``full_state_update=False`` is safe, and faster, for a metric.

    Runs ``forward`` both ways over the same inputs, the two-update full-state path and the one-update
    reduce-state path, and compares every batch value and the final ``compute``; when they agree, times
    ``num_update_to_compare`` forwards of each (best of ``reps``). The metrics run on the device that
    ``init_args`` gives them; on a CUDA device each timed run ends in ``torch.cuda.synchronize()``. Prints the
    recommendation and returns ``True`` when ``full_state_update=False`` is both right and faster.
    """
    init_args = init_args or {}
    input_args = input_args or {}

    class _FullState(metric_class):
        full_state_update = True

    class _PartState(metric_class):
        full_state_update = False

    fullstate = _FullState(**init_args)
    partstate = _PartState(**init_args)

    equal = True
    try:  # a failure here means the update depends on the accumulated global state
        for _ in range(num_update_to_compare[0]):
            equal = equal and _allclose_recursive(fullstate(**input_args), partstate(**input_args))
        equal = equal and _allclose_recursive(fullstate.compute(), partstate.compute())
    except (RuntimeError, ValueError, TypeError):
        equal = False

    if not equal:
        print("Recommended setting `full_state_update=True`")
        return False

    on_card = fullstate.device.type == "cuda"
    timings = [[0.0] * len(num_update_to_compare) for _ in range(2)]
    for i, metric in enumerate((fullstate, partstate)):
        for j, steps in enumerate(num_update_to_compare):
            best = float("inf")
            for _ in range(reps):
                metric.reset()
                if on_card:
                    torch.cuda.synchronize(metric.device)
                start = perf_counter()
                for _ in range(steps):
                    metric(**input_args)
                if on_card:
                    torch.cuda.synchronize(metric.device)
                best = min(best, perf_counter() - start)
            timings[i][j] = best

    for j, steps in enumerate(num_update_to_compare):
        print(f"Full state for {steps} steps took: {timings[0][j]:0.4f}s")
        print(f"Partial state for {steps} steps took: {timings[1][j]:0.4f}s")

    faster = timings[1][-1] < timings[0][-1]
    print(f"Recommended setting `full_state_update={not faster}`")
    return faster
