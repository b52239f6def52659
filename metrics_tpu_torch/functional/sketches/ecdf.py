"""Binned-ECDF streaming curve metrics: AUROC and calibration error.

Counterpart of ``metrics_tpu/functional/sketches/ecdf.py``. Scores are
histogrammed into B equal-width bins over [0, 1], and the curve is evaluated
on the binned ECDF. The AUROC gives each (positive, negative) pair in
different bins its exact Mann-Whitney term and pairs sharing a bin half
credit, so ``|AUROC_binned − AUROC_exact| <= ½ Σ_b (pos_b/P)(neg_b/N)``
(:func:`binned_auroc_bound`). The binned ECE with the exact metric's bins is
not an approximation: binning is part of its definition.

Bins compare in float32 against float32 edges, as ``histogram_counts`` does;
counts are ``count_dtype()``. The reductions of :func:`binned_auroc`,
:func:`binned_auroc_bound` and :func:`binned_ece`, and each batch's confidence
sums, run in float64 and are rounded once to float32, where the JAX package
sums in float32: the values agree to float32 rounding.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from metrics_tpu_torch.functional.classification.precision_recall_curve import _linspace_thresholds
from metrics_tpu_torch.ops.binned_hist import _bucket_index
from metrics_tpu_torch.utils.data import bincount_fixed

__all__ = [
    "binned_auroc",
    "binned_auroc_bound",
    "binned_ece",
    "calibration_delta",
    "score_hist_delta",
    "uniform_edges",
]


def uniform_edges(num_bins: int) -> torch.Tensor:
    """B+1 equal-width bin edges over [0, 1] in the default float type (``jnp.linspace``'s values), on the CPU."""
    if num_bins < 2:
        raise ValueError(f"`num_bins` must be >= 2, got {num_bins}")
    return torch.from_numpy(_linspace_thresholds(num_bins + 1, torch.get_default_dtype()))


@functools.lru_cache(maxsize=32)
def _edges_f32(num_bins: int, default_dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The edges as float32 on ``device``, built once: an update copies nothing from the host."""
    return uniform_edges(num_bins).to(device=device, dtype=torch.float32)


def _bin_index(p: torch.Tensor, num_bins: int) -> torch.Tensor:
    """The bin of each float32 score in [0, 1]."""
    return _bucket_index(p, _edges_f32(num_bins, torch.get_default_dtype(), p.device))


def _scores(preds: torch.Tensor, valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    p = preds.to(torch.float32).reshape(-1)
    ok = torch.as_tensor(valid, dtype=torch.bool, device=p.device).reshape(-1) & torch.isfinite(p)
    return torch.clamp(p, 0.0, 1.0), ok


def score_hist_delta(
    preds: torch.Tensor, target: torch.Tensor, valid: torch.Tensor, *, num_bins: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One batch of scores split into ``(pos, neg)`` per-bin count deltas.

    ``preds`` are probability scores (clipped into [0, 1]); ``target`` is
    {0, 1}. Non-finite scores are dropped. Both histograms come from one count
    over ``2 * num_bins + 1`` bins.
    """
    p, ok = _scores(preds, valid)
    t = torch.as_tensor(target, device=p.device).reshape(-1)
    idx = _bin_index(p, num_bins)
    code = torch.where(ok, torch.where(t == 1, idx, num_bins + idx), 2 * num_bins)
    counts = bincount_fixed(code, 2 * num_bins + 1)
    return counts[:num_bins], counts[num_bins : 2 * num_bins]


def binned_auroc(pos: torch.Tensor, neg: torch.Tensor) -> torch.Tensor:
    """AUROC of the binned ECDF; () float32, 0.0 while either class is empty.

    ``Σ_b [neg_below_b · pos_b + ½ · pos_b · neg_b] / (P·N)``.
    """
    posf, negf = pos.to(torch.float64), neg.to(torch.float64)
    denom = torch.sum(posf) * torch.sum(negf)
    neg_below = torch.cumsum(negf, 0) - negf
    num = torch.sum(neg_below * posf + 0.5 * posf * negf)
    return torch.where(denom > 0, num / torch.clamp(denom, min=1.0), 0.0).to(torch.float32)


def binned_auroc_bound(pos: torch.Tensor, neg: torch.Tensor) -> torch.Tensor:
    """Worst-case |binned − exact| AUROC error from the sketch: the mass of (positive, negative) pairs sharing
    a bin, halved; () float32."""
    posf, negf = pos.to(torch.float64), neg.to(torch.float64)
    denom = torch.sum(posf) * torch.sum(negf)
    same_bin = torch.sum(posf * negf)
    return torch.where(denom > 0, 0.5 * same_bin / torch.clamp(denom, min=1.0), 0.0).to(torch.float32)


def calibration_delta(
    preds: torch.Tensor, target: torch.Tensor, valid: torch.Tensor, *, num_bins: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One binary batch into ``(conf_sum, count, correct)`` per-bin deltas.

    Top-label convention: the predicted label is ``p >= 0.5``, its confidence
    ``max(p, 1 − p)``, and a prediction is correct when the label equals
    ``target``. ``conf_sum`` is float32 (summed in float64), the counts
    ``count_dtype()``.
    """
    p, ok = _scores(preds, valid)
    t = torch.as_tensor(target, device=p.device).reshape(-1)
    label = (p >= 0.5).to(t.dtype)
    conf = torch.maximum(p, 1.0 - p)
    hit = ok & (label == t)
    idx = _bin_index(conf, num_bins)
    code = torch.where(ok, torch.where(hit, idx, num_bins + idx), 2 * num_bins)
    counts = bincount_fixed(code, 2 * num_bins + 1)
    correct = counts[:num_bins]
    count = correct + counts[num_bins : 2 * num_bins]
    weights = torch.where(ok, conf, 0.0).to(torch.float64)
    conf_sum = torch.zeros(num_bins + 1, dtype=torch.float64, device=p.device)
    conf_sum = conf_sum.index_add_(0, torch.where(ok, idx, num_bins), weights)[:num_bins].to(torch.float32)
    return conf_sum, count, correct


def binned_ece(conf_sum: torch.Tensor, count: torch.Tensor, correct: torch.Tensor) -> torch.Tensor:
    """Expected calibration error (L1) from the per-bin states; () float32."""
    cnt = count.to(torch.float64)
    n = torch.sum(cnt)
    safe = torch.clamp(cnt, min=1.0)
    gap = torch.abs(correct.to(torch.float64) / safe - conf_sum.to(torch.float64) / safe)
    return torch.where(n > 0, torch.sum(cnt * gap) / torch.clamp(n, min=1.0), 0.0).to(torch.float32)
