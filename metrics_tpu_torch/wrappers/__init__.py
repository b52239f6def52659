"""Wrapper metrics (counterpart of ``metrics_tpu/wrappers``).

Ported so far: ``WrapperMetric``, ``BootStrapper`` and ``Running``, on which
``RunningMean`` and ``RunningSum`` stand. The other wrappers (classwise,
min-max, multioutput, multitask, tracker, transformations, feature sharing,
replicated) are not ported yet.
"""

from metrics_tpu_torch.wrappers.abstract import WrapperMetric
from metrics_tpu_torch.wrappers.bootstrapping import BootStrapper
from metrics_tpu_torch.wrappers.running import Running

__all__ = ["BootStrapper", "Running", "WrapperMetric"]
