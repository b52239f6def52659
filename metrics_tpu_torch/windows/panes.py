"""Exact sliding windows from a rotating stack of tumbling panes (counterpart of ``metrics_tpu/windows/panes.py``)."""

from __future__ import annotations

from typing import Any, Dict

import torch

from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.ops.decay import _as_f32, pane_id, pane_slot_onehot
from metrics_tpu_torch.utils.data import dim_zero_sum
from metrics_tpu_torch.utils.exceptions import TPUMetricsUserError
from metrics_tpu_torch.windows.decay import _base_clone, _base_spec, _TimedWrapper, _validate_decay_base

__all__ = ["TumblingWindow"]


class TumblingWindow(_TimedWrapper):
    """Exact sliding-window metrics over the last ``n_panes × pane_s`` seconds.

    Keeps the base metric's sum-algebra states per tumbling pane in a fixed
    ``(n_panes, ...)`` stack: pane ``floor(t / pane_s)`` lives in slot
    ``pane_id % n_panes``. ``compute()`` folds the panes inside the window
    that ends at the newest pane seen and runs the base's compute, exactly
    over that window. A batch older than what its slot holds has left the
    window and is dropped. Two replicas merge slot by slot, the newer pane
    winning and equal panes adding.

    ``update(t, *args, **kwargs)`` prepends a timestamp (nonnegative seconds,
    float32) to the base's update.

    >>> from metrics_tpu_torch import SumMetric
    >>> m = TumblingWindow(SumMetric(nan_strategy="disable", device="cpu"), pane_s=1.0, n_panes=2)
    >>> for t, v in ((0.5, 1.0), (1.5, 2.0), (2.5, 4.0)):
    ...     m.update(t, torch.tensor(v))
    >>> m.compute()  # pane 0 has rotated out
    tensor(6.)

    Args:
        metric: the base metric; every state must use the ``sum`` reduction. A reset copy is kept.
        pane_s: the pane width in seconds (> 0).
        n_panes: the number of live panes (>= 1).
    """

    is_differentiable = False
    higher_is_better = None
    full_state_update = False

    # the held base metric never enters the configuration key; `base_spec` does
    __jit_key_exclude__ = frozenset({"_base"})

    def __init__(self, metric: Metric, pane_s: float, n_panes: int, **kwargs: Any) -> None:
        super().__init__(metric, **kwargs)
        _validate_decay_base(metric, type(self).__name__)
        if not float(pane_s) > 0.0:
            raise ValueError(f"`pane_s` must be > 0, got {pane_s}")
        if int(n_panes) < 1:
            raise ValueError(f"`n_panes` must be >= 1, got {n_panes}")
        bad = [n for n, fn in metric._reductions.items() if fn is not dim_zero_sum]
        if bad:
            raise TPUMetricsUserError(
                f"{type(self).__name__} requires every base state to use the 'sum' "
                f"reduce algebra (panes fold by +); {type(metric).__name__} "
                f"states {bad} do not."
            )
        if "pane_ids" in metric._defaults:
            raise TPUMetricsUserError(
                f"{type(self).__name__} reserves the state name 'pane_ids'; "
                f"{type(metric).__name__} already registers it."
            )
        self.pane_s = float(pane_s)
        self.n_panes = int(n_panes)
        self._base = _base_clone(metric, self.device)
        self.base_spec = _base_spec(self._base)
        for name, default in self._base._defaults.items():
            stacked = torch.zeros((self.n_panes,) + tuple(default.shape), dtype=default.dtype) + default.cpu()
            self.add_state(name, default=stacked, dist_reduce_fx="sum")
        # the absolute pane number in each slot, -1 for never written; real merges take the slot-aligned override
        self.add_state("pane_ids", default=torch.full((self.n_panes,), -1, dtype=torch.int32), dist_reduce_fx="max")

    def _pane_mask(self, mask: torch.Tensor, name: str) -> torch.Tensor:
        """A (n_panes,) mask shaped to broadcast against the stacked state ``name``."""
        return mask.reshape((self.n_panes,) + (1,) * self._base._defaults[name].ndim)

    def update(self, t: Any, *args: Any, **kwargs: Any) -> None:
        batch = self._base._functional_update(self._base._fresh_state(), *args, **kwargs)
        cur = pane_id(_as_f32(t, self.device), self.pane_s)
        onehot = pane_slot_onehot(cur, self.n_panes)
        slot_prev = torch.sum(torch.where(onehot, self.pane_ids, 0))
        # a batch older than what its slot holds has rotated out of the window: dropped, not clobbering
        accept = cur >= slot_prev
        write = onehot & accept
        stale = write & (self.pane_ids != cur)
        for name in self._base._defaults:
            stacked = getattr(self, name)
            kept = torch.where(self._pane_mask(stale, name), torch.zeros_like(stacked), stacked)
            add = self._pane_mask(write, name).to(stacked.dtype) * torch.as_tensor(batch[name]).to(stacked.dtype)
            setattr(self, name, kept + add)
        self.pane_ids = torch.where(write, cur, self.pane_ids)

    def compute(self) -> Any:
        state = self.__dict__["_state"]
        ids = state["pane_ids"]
        live = (ids > torch.max(ids) - self.n_panes) & (ids >= 0)
        folded = {
            name: torch.sum(state[name] * self._pane_mask(live, name).to(state[name].dtype), dim=0)
            for name in self._base._defaults
        }
        return self._base._functional_compute(folded)

    def _merge_state_dicts(
        self, state_a: Dict[str, Any], state_b: Dict[str, Any], count_a: int, count_b: int
    ) -> Dict[str, Any]:
        # slot by slot the newest pane wins; equal ids mean both replicas saw the same pane, so their states add.
        # A losing slot's pane lies outside the merged window, which is why the per-state sums alone do not merge
        ids_a, ids_b = state_a["pane_ids"], state_b["pane_ids"]
        out_ids = torch.maximum(ids_a, ids_b)
        keep_a, keep_b = ids_a == out_ids, ids_b == out_ids
        out = {
            name: state_a[name] * self._pane_mask(keep_a, name).to(state_a[name].dtype)
            + state_b[name] * self._pane_mask(keep_b, name).to(state_b[name].dtype)
            for name in self._base._defaults
        }
        out["pane_ids"] = out_ids
        return out
