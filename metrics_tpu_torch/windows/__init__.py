"""Windowed and time-decayed streaming metrics (counterpart of ``metrics_tpu/windows``).

Windowed aggregation as fixed-shape O(1) recurrences: no buffer of the
window is kept, and replicas merge by bringing both sides to a common
reference time before their own algebra applies.

* :class:`TimeDecayed`: exponential time decay as a scalar rescale of any
  sum-algebra base metric, ``state·2^(−Δt/half_life) + batch``.
* :class:`TumblingWindow`: exact sliding windows from a rotating stack of
  tumbling panes addressed by absolute pane number.
* :class:`DecayedDDSketch` / :class:`DecayedHLL`: time-decayed sketches by
  rescaling bucket counts and registers.
"""

from metrics_tpu_torch.windows.decay import TimeDecayed
from metrics_tpu_torch.windows.panes import TumblingWindow
from metrics_tpu_torch.windows.sketch_decay import DecayedDDSketch, DecayedHLL

__all__ = ["DecayedDDSketch", "DecayedHLL", "TimeDecayed", "TumblingWindow"]
