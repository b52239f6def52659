"""Binned-ECDF streaming AUROC and calibration error (counterpart of ``metrics_tpu/sketches/curve.py``)."""

from __future__ import annotations

from typing import Any

import torch

from metrics_tpu_torch.functional.sketches.ecdf import (
    binned_auroc,
    binned_auroc_bound,
    binned_ece,
    calibration_delta,
    score_hist_delta,
)
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.compute import acc_dtype, count_dtype

__all__ = ["StreamingAUROC", "StreamingCalibrationError"]


class StreamingAUROC(Metric):
    """Binary AUROC over an unbounded score stream in O(num_bins) memory.

    Two per-bin histograms of positive and negative scores over ``num_bins``
    equal-width bins of [0, 1] (``sum`` algebra). Cross-bin pairs contribute
    their exact Mann-Whitney term and same-bin pairs half credit, so
    ``|compute() − exact| <= error_bound()``.

    Args:
        num_bins: score histogram resolution.

    >>> metric = StreamingAUROC(num_bins=16, device="cpu")
    >>> metric.update(torch.tensor([0.1, 0.4, 0.35, 0.8]), torch.tensor([0, 0, 1, 1]))
    >>> metric.compute()
    tensor(0.7500)
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(self, num_bins: int = 2048, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if num_bins < 2:
            raise ValueError(f"`num_bins` must be >= 2, got {num_bins}")
        self.num_bins = int(num_bins)
        self.add_state("pos_hist", default=torch.zeros(self.num_bins, dtype=count_dtype()), dist_reduce_fx="sum")
        self.add_state("neg_hist", default=torch.zeros(self.num_bins, dtype=count_dtype()), dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        preds = torch.as_tensor(preds, device=self.device)
        d_pos, d_neg = score_hist_delta(
            preds, torch.as_tensor(target, device=self.device),
            torch.ones(preds.shape, dtype=torch.bool, device=self.device), num_bins=self.num_bins,
        )
        self.pos_hist = self.pos_hist + d_pos
        self.neg_hist = self.neg_hist + d_neg

    def compute(self) -> torch.Tensor:
        return binned_auroc(self.pos_hist, self.neg_hist)

    def error_bound(self) -> torch.Tensor:
        """Worst-case |compute() − exact AUROC|, from the current state."""
        return binned_auroc_bound(self.pos_hist, self.neg_hist)


class StreamingCalibrationError(Metric):
    """Top-label expected calibration error (L1) over an unbounded stream.

    Per-bin confidence sums and prediction and correct counts (``sum``
    algebra) over ``num_bins`` equal-width confidence bins. With the exact
    metric's bins it agrees with it to float rounding.

    Args:
        num_bins: confidence bins.

    >>> metric = StreamingCalibrationError(num_bins=10, device="cpu")
    >>> metric.update(torch.tensor([0.9, 0.2, 0.7]), torch.tensor([1, 0, 0]))
    >>> metric.compute()
    tensor(0.3333)
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False

    def __init__(self, num_bins: int = 15, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if num_bins < 2:
            raise ValueError(f"`num_bins` must be >= 2, got {num_bins}")
        self.num_bins = int(num_bins)
        self.add_state("conf_sum", default=torch.zeros(self.num_bins, dtype=acc_dtype()), dist_reduce_fx="sum")
        self.add_state("bin_count", default=torch.zeros(self.num_bins, dtype=count_dtype()), dist_reduce_fx="sum")
        self.add_state("bin_correct", default=torch.zeros(self.num_bins, dtype=count_dtype()), dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        preds = torch.as_tensor(preds, device=self.device)
        d_conf, d_count, d_correct = calibration_delta(
            preds, torch.as_tensor(target, device=self.device),
            torch.ones(preds.shape, dtype=torch.bool, device=self.device), num_bins=self.num_bins,
        )
        self.conf_sum = self.conf_sum + d_conf
        self.bin_count = self.bin_count + d_count
        self.bin_correct = self.bin_correct + d_correct

    def compute(self) -> torch.Tensor:
        return binned_ece(self.conf_sum, self.bin_count, self.bin_correct)
