"""Drift detection as ordinary metrics (counterpart of ``metrics_tpu/drift``).

* :class:`PSI`: the Population Stability Index from paired binned histograms
  (reference against live).
* :class:`KSDistance`: the Kolmogorov-Smirnov distance ``max |CDF_ref −
  CDF_live|`` from the same histograms.
* :class:`CUSUM`: the two-sided cumulative-sum change detector, a fixed
  (4,) segment state per side that composes across shards in stream order.
"""

from metrics_tpu_torch.drift.cusum import CUSUM
from metrics_tpu_torch.drift.histogram import KSDistance, PSI

__all__ = ["CUSUM", "KSDistance", "PSI"]
