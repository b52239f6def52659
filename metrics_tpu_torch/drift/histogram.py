"""Distribution-drift scores from paired binned-histogram states (counterpart of ``metrics_tpu/drift/histogram.py``)."""

from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.compute import _flush_subnormals, acc_dtype
from metrics_tpu_torch.utils.data import bincount_fixed

__all__ = ["KSDistance", "PSI"]

_EPS = 1e-6


def _drift_histogram_delta(values: torch.Tensor, *, lo: float, hi: float, num_bins: int) -> torch.Tensor:
    """One batch binned into (num_bins + 2,) float32 counts.

    Bin 0 is the underflow (v < lo), bin num_bins + 1 the overflow (v >= hi),
    and the interior bins split [lo, hi) evenly. Non-finite values are
    dropped. The scale is ``(v − lo) · fl(fl(1/(hi − lo)) · num_bins)``, the
    product XLA compiles the JAX package's update into, so values at a bin
    edge land in its bin. A bin number at or above 2^31 wraps into the
    underflow bin, as the JAX package's int32 ``floor(scaled) + 1`` does
    (ROADMAP, reference caveats).
    """
    v = _flush_subnormals(values.to(torch.float32).reshape(-1))
    ok = torch.isfinite(v)
    scale = float(np.float32(np.float32(1.0) / np.float32(hi - lo)) * np.float32(num_bins))
    scaled = (v - float(np.float32(lo))) * scale
    floor = torch.floor(scaled)
    idx = torch.where(floor >= 2.0**31, 0, torch.clamp(floor, -1.0, float(num_bins)).to(torch.int64) + 1)
    dead = num_bins + 2
    return bincount_fixed(torch.where(ok, idx, dead), dead + 1)[:dead].to(torch.float32)


class _PairedHistogram(Metric):
    """Two ``(num_bins + 2,)`` count states over the same bins: ``ref_counts`` for the reference distribution,
    ``live_counts`` for the live traffic, both merged by ``+``. The two extra bins hold the under- and
    overflow, so mass outside ``[lo, hi)`` still counts.

    ``update(live, reference)`` feeds both sides; either may be an empty ``(0,)`` tensor.
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False

    def __init__(self, lo: float, hi: float, num_bins: int = 64, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not float(hi) > float(lo):
            raise ValueError(f"need `hi` > `lo`, got lo={lo}, hi={hi}")
        if int(num_bins) < 1:
            raise ValueError(f"`num_bins` must be >= 1, got {num_bins}")
        self.lo = float(lo)
        self.hi = float(hi)
        self.num_bins = int(num_bins)
        shape = (self.num_bins + 2,)
        self.add_state("ref_counts", default=torch.zeros(shape, dtype=acc_dtype()), dist_reduce_fx="sum")
        self.add_state("live_counts", default=torch.zeros(shape, dtype=acc_dtype()), dist_reduce_fx="sum")

    def update(self, live: torch.Tensor, reference: torch.Tensor) -> None:
        self.live_counts = self.live_counts + _drift_histogram_delta(
            torch.as_tensor(live, device=self.device), lo=self.lo, hi=self.hi, num_bins=self.num_bins
        )
        self.ref_counts = self.ref_counts + _drift_histogram_delta(
            torch.as_tensor(reference, device=self.device), lo=self.lo, hi=self.hi, num_bins=self.num_bins
        )

    def _proportions(self) -> Tuple[torch.Tensor, torch.Tensor]:
        state = self.__dict__["_state"]
        ref, live = state["ref_counts"], state["live_counts"]
        return ref / torch.clamp(torch.sum(ref), min=1.0), live / torch.clamp(torch.sum(live), min=1.0)


class PSI(_PairedHistogram):
    """Population Stability Index between the reference and the live distributions.

    ``PSI = Σ_b (p_live[b] − p_ref[b]) · ln(p_live[b] / p_ref[b])`` over the
    shared bins, the proportions clipped to 1e-6 first. The usual reading:
    below 0.1 stable, 0.1-0.25 a moderate shift, above 0.25 act. A
    never-updated metric scores 0.0.

    >>> m = PSI(lo=0.0, hi=1.0, num_bins=4, device="cpu")
    >>> m.update(torch.tensor([0.1, 0.2, 0.3, 0.9]), torch.tensor([0.1, 0.4, 0.6, 0.9]))
    >>> m.compute()
    tensor(3.2806)

    Args:
        lo / hi: the value range split into equal-width bins (with under- and overflow bins).
        num_bins: interior bins over ``[lo, hi)``.
    """

    def compute(self) -> torch.Tensor:
        p_ref, p_live = self._proportions()
        p_ref = torch.clamp(p_ref, _EPS, 1.0)
        p_live = torch.clamp(p_live, _EPS, 1.0)
        return torch.sum((p_live - p_ref) * torch.log(p_live / p_ref))


class KSDistance(_PairedHistogram):
    """Kolmogorov-Smirnov distance between the reference and the live distributions.

    ``D = max_b |CDF_ref[b] − CDF_live[b]|`` at the shared bin edges, the
    exact two-sample statistic of the binned distributions; in [0, 1], 0.0
    for an empty metric.

    Args: as :class:`PSI`.
    """

    def compute(self) -> torch.Tensor:
        p_ref, p_live = self._proportions()
        return torch.max(torch.abs(torch.cumsum(p_ref, 0) - torch.cumsum(p_live, 0)))
