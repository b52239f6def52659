"""Carry a metric's state from the JAX package (``metrics_tpu``) into the port.

A metric's state is the only "weights" it has. :func:`load_reference_state`
takes the dict that a ``metrics_tpu`` metric's ``state_dict()`` returns (numpy
arrays, list states as lists of arrays, and ``_update_count``) and installs it
into the port's metric of the same class and configuration, which then goes on
updating and computing as if it had seen the same batches: counters and
confusion matrices, an aggregator's value with its Neumaier ``_comp``
companion, list states such as Spearman's kept samples or a retrieval
metric's rows, the moments of Pearson, concordance, explained variance and
NRMSE, the image metrics' kept inputs (D_s's and QNR's four lists among them),
``DiceScore``'s per-sample sums, ``MeanAveragePrecision``'s per-image host arrays, the string stores of
ROUGE, TER, EED and SQuAD (which the JAX package's ``state_dict()`` leaves out: add its ``_preds_store`` and
``_target_store`` lists to the dict), and every wrapper's
children (a ``BootStrapper``'s or ``MultioutputWrapper``'s copies, a
``MetricTracker``'s steps, a ``MultitaskWrapper``'s tasks).
:func:`load_reference_collection_state` does the same for a whole
``MetricCollection``, compute groups included. The JAX metric only exports
states marked persistent: call ``persistent(True)`` on it first.

This module reads numpy arrays only; it imports nothing of JAX.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.collections import MetricCollection
from metrics_tpu_torch.metric import Metric, _dtype_kind
from metrics_tpu_torch.wrappers.abstract import WrapperMetric

__all__ = ["load_reference_collection_state", "load_reference_state"]

_NUMERIC_KINDS = "biuf"


def _as_array(value: Any, where: str) -> np.ndarray:
    arr = np.asarray(value)
    if arr.dtype.kind not in _NUMERIC_KINDS:
        raise ValueError(f"state {where!r}: expected a numeric array, got dtype {arr.dtype}")
    return arr


def load_reference_state(metric: Metric, state: Dict[str, Any]) -> Metric:
    """Install a ``metrics_tpu`` ``state_dict()`` into ``metric``; returns ``metric``.

    A wrapper's state dict holds each child's states under its dotted path
    (``metrics.0.tp`` for a ``BootStrapper``'s first copy), and each child takes
    its own. See :func:`_convert_reference_state` for what is validated;
    nothing is installed unless all of it holds, for the wrapper and every
    child.
    """
    for target, converted, count in _convert_tree(metric, state):
        _install(target, converted, count)
    return metric


def _convert_tree(metric: Metric, state: Dict[str, Any]) -> List[Tuple[Metric, Dict[str, Any], int]]:
    """(metric, converted states, update count) for ``metric`` and, if it is a wrapper, every child."""
    children = metric._children() if isinstance(metric, WrapperMetric) else []
    prefixes = tuple(f"{path}." for path, _ in children)
    own = {k: v for k, v in state.items() if not k.startswith(prefixes)} if prefixes else state
    out = [(metric, *_convert_reference_state(metric, own))]
    for (path, child), prefix in zip(children, prefixes):
        out += _convert_tree(child, {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)})
    return out


def _host_item(v: Any) -> Any:
    """One element of a host list state, copied: the JAX package's ``state_dict()`` exports ``None`` as a
    0-d object array, which becomes ``None`` again."""
    if isinstance(v, np.ndarray):
        return v.item() if v.dtype == object and v.ndim == 0 else np.array(v)
    return list(v) if isinstance(v, list) else v


def _install(metric: Metric, converted: Dict[str, Any], count: int) -> None:
    for name, value in converted.items():
        if name in metric._state:
            metric._state[name] = value
        else:
            setattr(metric, name, value)
    metric._update_count = count
    metric._computed = None


def _convert_reference_state(metric: Metric, state: Dict[str, Any]) -> Tuple[Dict[str, Any], int]:
    """The states of a ``metrics_tpu`` ``state_dict()`` as tensors on ``metric``'s device, and its update count.

    Every key, shape and dtype kind is validated before anything is
    installed, so a mismatch leaves the metric as it was:

    * the keys must be exactly the metric's states plus ``_update_count`` (and its host stores, if any);
    * a fixed-shape state must have the port's shape and dtype kind (bool,
      signed int, float): int32 counters load into int64 states; a state
      with ``dist_reduce_fx=None`` (moments the metric folds itself) may
      also carry leading dimensions (a stack of per-rank sets, or the
      outputs of a 0-d default);
    * a list state must be a list of numeric arrays that agree with one
      another in dtype kind and in every dimension but the first; a metric
      whose list states live on the host (``MeanAveragePrecision``: per-image
      arrays, ``None`` areas, empty mask lists) takes copies of them as they are.
    """
    names = set(metric._defaults)
    stores = set(getattr(metric, "_host_stores", ()))
    keys = set(state)
    expected = names | stores | {"_update_count"}
    if keys != expected:
        missing = sorted(expected - keys)
        unknown = sorted(keys - expected)
        raise ValueError(
            f"{type(metric).__name__}: reference state does not match (missing {missing}, unknown {unknown});"
            " the reference metric must be of the same class and configuration, with persistent(True)"
            + (f", and its {sorted(stores)} added to the dict" if stores else "")
        )
    count = state["_update_count"]
    if isinstance(count, bool) or not isinstance(count, (int, np.integer)) or count < 0:
        raise ValueError(f"_update_count must be a non-negative int, got {count!r}")

    converted: Dict[str, Any] = {}
    for name in sorted(stores):
        if not isinstance(state[name], (list, tuple)):
            raise ValueError(f"{name!r} must be a list of the reference metric's stored inputs")
        converted[name] = list(state[name])
    for name in sorted(names):
        default = metric._defaults[name]
        value = state[name]
        if isinstance(default, list):
            if not isinstance(value, (list, tuple)):
                raise ValueError(f"state {name!r} is a list state; got {type(value).__name__}")
            if getattr(metric, "_host_list_states", False):
                converted[name] = [_host_item(v) for v in value]
                continue
            arrays = [_as_array(v, name) for v in value]
            if arrays and (
                len({a.dtype.kind for a in arrays}) != 1 or len({a.shape[1:] for a in arrays}) != 1
            ):
                raise ValueError(f"state {name!r}: list elements disagree in dtype kind or trailing shape")
            converted[name] = [torch.from_numpy(np.array(a)).to(metric.device) for a in arrays]
        else:
            arr = _as_array(value, name)
            if metric._reductions[name] is None:
                # a state folded by the metric itself (Welford moments): it may hold a stack of per-rank sets
                # along a first dimension, and a 0-d default takes the outputs' shape at the first update
                shape_ok = arr.shape[arr.ndim - default.ndim:] == tuple(default.shape)
            else:
                shape_ok = arr.shape == tuple(default.shape)
            if not shape_ok or arr.dtype.kind != _dtype_kind(default.dtype):
                raise ValueError(
                    f"state {name!r}: expected kind {_dtype_kind(default.dtype)!r} of shape {tuple(default.shape)},"
                    f" got {arr.dtype} of shape {arr.shape}"
                )
            converted[name] = torch.from_numpy(np.array(arr)).to(device=metric.device, dtype=default.dtype)
    return converted, int(count)


def load_reference_collection_state(
    collection: MetricCollection,
    state: Dict[str, Dict[str, Any]],
    compute_groups: Optional[Union[Dict[int, List[str]], List[List[str]]]] = None,
) -> MetricCollection:
    """Install a ``metrics_tpu`` ``MetricCollection.state_dict()`` into the port's collection.

    ``state`` maps each member's name to its ``state_dict()``; the names must
    be exactly the collection's, and every member's state is validated before
    any is installed. ``compute_groups`` (the JAX collection's
    ``compute_groups``) installs its groups: the members of each then share
    their leader's tensors, and a member whose loaded state differs from its
    leader's is refused. Without it, detected groups are derived again at the
    next update. Returns ``collection``.
    """
    names = list(collection.keys(keep_base=True))
    if set(state) != set(names):
        raise ValueError(
            f"reference collection state does not match the members (missing {sorted(set(names) - set(state))},"
            f" unknown {sorted(set(state) - set(names))})"
        )
    converted = {name: _convert_reference_state(collection[name], state[name]) for name in names}
    groups = None
    if compute_groups is not None:
        groups = [list(g) for g in (compute_groups.values() if isinstance(compute_groups, dict) else compute_groups)]
        grouped = [n for g in groups for n in g]
        if sorted(grouped) != sorted(names):
            raise ValueError(f"compute_groups {groups} do not partition the members {names}")
        for group in groups:
            lead_states = converted[group[0]][0]
            for member in group[1:]:
                if not _same_states(lead_states, converted[member][0]):
                    raise ValueError(f"member {member!r} holds another state than its group's leader {group[0]!r}")
    for name in names:
        _install(collection[name], *converted[name])
    if groups is not None:
        collection._groups = dict(enumerate(groups))
        collection._groups_checked = True
        collection._share_leader_states()
    elif collection._enable_compute_groups is True:
        collection._init_compute_groups()
        collection._groups_checked = False
    return collection


def _same_states(a: Dict[str, Any], b: Dict[str, Any]) -> bool:
    if a.keys() != b.keys():
        return False
    for k in a:
        x, y = a[k], b[k]
        xs, ys = (x, y) if isinstance(x, list) else ([x], [y])
        if len(xs) != len(ys) or not all(
                torch.equal(u, v) if isinstance(u, torch.Tensor) else u == v for u, v in zip(xs, ys)):
            return False
    return True
