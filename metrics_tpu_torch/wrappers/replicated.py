"""Vmapped replica engine: N config-equal inner metrics, ONE batched call (counterpart of
``metrics_tpu/wrappers/replicated.py``).

Replica wrappers (``BootStrapper``, ``MultioutputWrapper``) hold N deep copies
of one base metric. Instead of N updates a batch, the replica states are
stacked into dicts of tensors with a leading replica axis and one
``torch.func.vmap`` of the pure update runs over them: one dispatch, and one
launch of each kernel the update reaches (their custom ops' ``vmap`` rules).

The dispatch machinery (gather/stacked vmap modes, the program LRU) lives in
:mod:`metrics_tpu_torch.engine.core`, shared with the fleet
:class:`~metrics_tpu_torch.engine.StreamEngine`. This module keeps the
replica-shaped entry points for the wrappers built on them.
``ReplicatedWrapper`` materializes per-replica states back out whenever user
code touches ``.metrics`` (state_dict, sync, merge, pickling all flow through
that path).
"""

from __future__ import annotations

from copy import deepcopy
from typing import Any, Dict, List, Optional, Tuple

import torch

from metrics_tpu_torch.engine.core import _REPLICA_JIT_CACHE
from metrics_tpu_torch.engine.core import TRACER_ERRORS as _TRACER_ERRORS
from metrics_tpu_torch.engine.core import engine_compute, engine_update
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.observe import recorder as _observe
from metrics_tpu_torch.wrappers.abstract import WrapperMetric

__all__ = ["ReplicatedWrapper", "replica_compute", "replica_update"]


def _engine_label(template: Metric, n: int) -> str:
    return f"{type(template).__name__}x{n}"


def replica_update(
    template: Metric,
    n: int,
    stacked: Dict[str, Any],
    args: Tuple[Any, ...],
    kwargs: Dict[str, Any],
    gather_idx: Optional[torch.Tensor] = None,
) -> Dict[str, Any]:
    """Run one vmapped update over ``n`` stacked replica states; returns the new stack.

    ``gather_idx`` (shape ``(n, batch)`` integer rows) selects each replica's resample of the shared batch
    inside the batched body; without it, tensor arguments are expected to already carry a leading replica
    axis.
    """
    label = _engine_label(template, n)
    new_stacked = engine_update(
        template, n, stacked, args, kwargs, gather_idx=gather_idx, cache=_REPLICA_JIT_CACHE, label=label
    )
    _observe.note_replica_dispatch(label)
    return new_stacked


def replica_compute(template: Metric, n: int, stacked: Dict[str, Any]) -> Any:
    """Vmapped compute over the stacked states: per-replica values with a leading axis.

    ``_squeeze_if_scalar`` runs inside the mapped body so each replica's value matches what its
    ``Metric.compute()`` would have returned.
    """
    label = _engine_label(template, n)
    out = engine_compute(template, n, stacked, cache=_REPLICA_JIT_CACHE, label=label)
    _observe.note_replica_dispatch(label)
    return out


class ReplicatedWrapper(WrapperMetric):
    """Base for wrappers holding N config-equal replicas of one inner metric.

    State lives in exactly one of two homes at any time:

    - materialized: each replica in ``self._replicas`` owns its ``_state`` (loops, sync, state_dict all
      work on it), or
    - stacked: ``self._stacked`` holds one dict of tensors with a leading replica axis, owned by the
      vmapped engine, and the replicas' own states are stale.

    ``_stack()`` / ``_materialize()`` convert between the two; every public surface that exposes replicas
    (the ``metrics`` property, ``_children``, pickling, deepcopy) materializes first, so the stacked layout
    is invisible outside the engine path.
    """

    def _init_replicas(self, base_metric: Metric, n: int) -> None:
        self._replicas = [deepcopy(base_metric) for _ in range(n)]
        self._stacked: Optional[Dict[str, Any]] = None
        self._stack_base_counts = [0] * n
        self._engine_updates = 0
        self._engine_failed = False

    @property
    def metrics(self) -> List[Metric]:
        self._materialize()
        return self._replicas

    def _stack(self) -> None:
        """Snapshot replica states into one leading-axis dict of tensors (``torch.stack`` copies)."""
        if self.__dict__.get("_stacked") is not None:
            return
        reps = self._replicas
        self.__dict__["_stacked"] = {
            k: torch.stack([m.__dict__["_state"][k] for m in reps], dim=0) for k in reps[0]._defaults
        }
        self._stack_base_counts = [m._update_count for m in reps]
        self._engine_updates = 0

    def _materialize(self) -> None:
        """Slice engine-owned stacked state back into the replicas (each row its own copy)."""
        st = self.__dict__.get("_stacked")
        if st is None:
            return
        for i, m in enumerate(self._replicas):
            for k in m._defaults:
                m.__dict__["_state"][k] = st[k][i].clone()
            m._update_count = self._stack_base_counts[i] + self._engine_updates
            m._computed = None
        self.__dict__["_stacked"] = None
        self._engine_updates = 0

    def _engine_ok(self, args: Tuple[Any, ...], kwargs: Dict[str, Any]) -> bool:
        t = self._replicas[0]
        return not self._engine_failed and t._config_key() is not None and t._jit_eligible(args, kwargs)

    def _engine_update(
        self, args: Tuple[Any, ...], kwargs: Dict[str, Any], gather_idx: Optional[torch.Tensor] = None
    ) -> bool:
        """Try ONE vmapped dispatch over all replicas; False means the caller runs its loop."""
        template = self._replicas[0]
        self._stack()
        try:
            new_stacked = replica_update(
                template, len(self._replicas), self.__dict__["_stacked"], args, kwargs, gather_idx=gather_idx
            )
        except _TRACER_ERRORS as exc:
            # a refusal leaves the stacked states intact: latch the loop for good and hand the replicas
            # their states back
            self._engine_failed = True
            _observe.note_replica_fallback(_engine_label(template, len(self._replicas)), exc)
            self._materialize()
            return False
        self.__dict__["_stacked"] = new_stacked
        self._engine_updates += 1
        return True

    def _children(self) -> List[Tuple[str, Metric]]:
        self._materialize()
        return [(f"metrics.{i}", m) for i, m in enumerate(self.__dict__.get("_replicas", ()))]

    def reset(self) -> None:
        # engine-owned state is discarded wholesale; replicas re-init from their defaults (the
        # _engine_failed latch persists)
        self.__dict__["_stacked"] = None
        self.__dict__["_engine_updates"] = 0
        for m in self.__dict__.get("_replicas", ()):
            m.reset()
        super().reset()

    def __deepcopy__(self, memo: Dict) -> "ReplicatedWrapper":
        self._materialize()
        return super().__deepcopy__(memo)

    def __getstate__(self) -> Dict[str, Any]:
        self._materialize()
        return super().__getstate__()

    def __setstate__(self, state: Dict[str, Any]) -> None:
        state.setdefault("_stacked", None)
        state.setdefault("_engine_updates", 0)
        state.setdefault("_engine_failed", False)
        state.setdefault("_stack_base_counts", [0] * len(state.get("_replicas", ())))
        super().__setstate__(state)
