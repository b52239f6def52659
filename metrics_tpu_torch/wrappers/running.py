"""Running-window wrapper (counterpart of ``metrics_tpu/wrappers/running.py``).

The window is a deque of per-update state dicts; the base metric's state is
their merge, refolded on every update (O(window) merges per update, on
states that are never changed in place, so the deque holds snapshots).
"""

from __future__ import annotations

from collections import deque
from typing import Any

from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.wrappers.abstract import WrapperMetric


class Running(WrapperMetric):
    """A view over the last ``window`` updates of a base metric; it lives on the base metric's device.

    >>> import torch
    >>> from metrics_tpu_torch.aggregation import SumMetric
    >>> metric = Running(SumMetric(device="cpu"), window=2)
    >>> for i in range(5):
    ...     metric.update(torch.tensor(float(i)))
    >>> metric.compute()  # 3 + 4
    tensor(7.)
    """

    _extra_state_keys = ("_window_states",)

    def __init__(self, base_metric: Metric, window: int = 5, **kwargs: Any) -> None:
        if not isinstance(base_metric, Metric):
            raise ValueError(
                f"Expected argument `metric` to be an instance of `metrics_tpu_torch.Metric` but got {base_metric}"
            )
        kwargs.setdefault("device", base_metric.device)
        super().__init__(**kwargs)
        if not (isinstance(window, int) and window > 0):
            raise ValueError(f"Expected argument `window` to be a positive integer but got {window}")
        self.base_metric = base_metric
        self.window = window
        if base_metric.full_state_update or base_metric.full_state_update is None:
            raise ValueError(
                f"Expected attribute `full_state_update` set to `False` but got {base_metric.full_state_update}"
            )
        self._window_states: deque = deque(maxlen=window)
        self._window_persistent = False

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Push this update's own state onto the window."""
        fns = self.base_metric.functional()
        self._window_states.append(fns.update(fns.init(), *args, **kwargs))
        self._apply_window()

    def _apply_window(self) -> None:
        fns = self.base_metric.functional()
        states = list(self._window_states)
        merged = states[0]
        for i, st in enumerate(states[1:], start=1):
            # the accumulator holds i updates against the incoming one: mean states weigh so
            merged = fns.merge(merged, st, i, 1)
        self.base_metric.__dict__["_state"].update(merged)
        self.base_metric._update_count = len(states)
        self.base_metric._computed = None

    def merge_state(self, incoming_state: Any) -> None:
        """Merge by splicing the incoming window before this one; the deque keeps the newest ``window``."""
        if not isinstance(incoming_state, self.__class__):
            raise ValueError(
                f"Expected incoming state to be an instance of {self.__class__.__name__} "
                f"but got {type(incoming_state)}"
            )
        incoming_count = incoming_state._update_count
        combined = list(incoming_state._window_states) + list(self._window_states)
        self._window_states = deque(combined, maxlen=self.window)
        self._apply_window()
        self._update_count += incoming_count

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        """Update the window and return this batch's own value; :meth:`compute` gives the window's."""
        self.update(*args, **kwargs)
        return self.base_metric.functional().compute(self._window_states[-1])

    def compute(self) -> Any:
        """The value over the current window."""
        return self.base_metric.compute()

    def reset(self) -> None:
        """Clear the window and the base metric."""
        super().reset()
        self.base_metric.reset()
        self._window_states.clear()

    def persistent(self, mode: bool = False) -> None:
        """The window follows the persistence flag of the states it derives."""
        super().persistent(mode)
        self._window_persistent = mode

    def state_dict(self, destination=None, prefix: str = ""):
        """Persist the window itself: the merged view alone would lose the per-update boundaries."""
        destination = super().state_dict(destination, prefix)
        if self._window_persistent:
            destination[prefix + "_window_states"] = [
                {k: ([x.detach() for x in v] if isinstance(v, list) else v.detach()) for k, v in st.items()}
                for st in self._window_states
            ]
        return destination

    def load_state_dict(self, state_dict, prefix: str = "", strict: bool = True) -> None:
        """Restore the window and refold the base metric's view; without a saved window, start a new one."""
        super().load_state_dict(state_dict, prefix, strict)
        key = prefix + "_window_states"
        if key in state_dict:
            device = self.base_metric.device
            self._window_states = deque(
                ({k: ([x.to(device) for x in v] if isinstance(v, list) else v.to(device)) for k, v in st.items()}
                 for st in state_dict[key]),
                maxlen=self.window,
            )
            if self._window_states:
                self._apply_window()
        else:
            self._window_states.clear()
