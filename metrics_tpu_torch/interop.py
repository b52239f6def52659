"""Carry a metric's state from the JAX package (``metrics_tpu``) into the port.

A metric's state is the only "weights" it has. :func:`load_reference_state`
takes the dict that a ``metrics_tpu`` metric's ``state_dict()`` returns (numpy
arrays, list states as lists of arrays, and ``_update_count``) and installs it
into the port's metric of the same class and configuration, which then goes on
updating and computing as if it had seen the same batches. The JAX metric only
exports states marked persistent: call ``persistent(True)`` on it first.

This module reads numpy arrays only; it imports nothing of JAX.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from metrics_tpu_torch.metric import Metric, _dtype_kind

__all__ = ["load_reference_state"]

_NUMERIC_KINDS = "biuf"


def _as_array(value: Any, where: str) -> np.ndarray:
    arr = np.asarray(value)
    if arr.dtype.kind not in _NUMERIC_KINDS:
        raise ValueError(f"state {where!r}: expected a numeric array, got dtype {arr.dtype}")
    return arr


def load_reference_state(metric: Metric, state: Dict[str, Any]) -> Metric:
    """Install a ``metrics_tpu`` ``state_dict()`` into ``metric``; returns ``metric``.

    Every key, shape and dtype kind is validated before anything is
    installed, so a mismatch leaves the metric as it was:

    * the keys must be exactly the metric's states plus ``_update_count``;
    * a fixed-shape state must have the port's shape and dtype kind (bool,
      signed int, float): int32 counters load into int64 states;
    * a list state must be a list of numeric arrays that agree with one
      another in dtype kind and in every dimension but the first.
    """
    names = set(metric.metric_state)
    keys = set(state)
    if keys != names | {"_update_count"}:
        missing = sorted((names | {"_update_count"}) - keys)
        unknown = sorted(keys - names - {"_update_count"})
        raise ValueError(
            f"{type(metric).__name__}: reference state does not match (missing {missing}, unknown {unknown});"
            " the reference metric must be of the same class and configuration, with persistent(True)"
        )
    count = state["_update_count"]
    if isinstance(count, bool) or not isinstance(count, (int, np.integer)) or count < 0:
        raise ValueError(f"_update_count must be a non-negative int, got {count!r}")

    converted: Dict[str, Any] = {}
    for name in sorted(names):
        default = metric._defaults[name]
        value = state[name]
        if isinstance(default, list):
            if not isinstance(value, (list, tuple)):
                raise ValueError(f"state {name!r} is a list state; got {type(value).__name__}")
            arrays = [_as_array(v, name) for v in value]
            if arrays and (
                len({a.dtype.kind for a in arrays}) != 1 or len({a.shape[1:] for a in arrays}) != 1
            ):
                raise ValueError(f"state {name!r}: list elements disagree in dtype kind or trailing shape")
            converted[name] = [torch.from_numpy(np.array(a)).to(metric.device) for a in arrays]
        else:
            arr = _as_array(value, name)
            if arr.shape != tuple(default.shape) or arr.dtype.kind != _dtype_kind(default.dtype):
                raise ValueError(
                    f"state {name!r}: expected kind {_dtype_kind(default.dtype)!r} of shape {tuple(default.shape)},"
                    f" got {arr.dtype} of shape {arr.shape}"
                )
            converted[name] = torch.from_numpy(np.array(arr)).to(device=metric.device, dtype=default.dtype)
    for name, value in converted.items():
        metric._state[name] = value
    metric._update_count = int(count)
    metric._computed = None
    return metric
