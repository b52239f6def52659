"""ProcrustesDisparity (counterpart of ``metrics_tpu/shape/procrustes.py``): a running sum of disparities and a
count of point-cloud pairs."""

from __future__ import annotations

from typing import Any

import torch
from torch import Tensor

from metrics_tpu_torch.functional.shape.procrustes import procrustes_disparity
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.compute import count_dtype


class ProcrustesDisparity(Metric):
    """The mean (or sum) Procrustes disparity over every pair of point clouds seen so far.

    >>> import numpy as np
    >>> rng = np.random.RandomState(42)
    >>> metric = ProcrustesDisparity(device="cpu")
    >>> metric.update(torch.from_numpy(rng.rand(10, 3).astype(np.float32)),
    ...               torch.from_numpy(rng.rand(10, 3).astype(np.float32)))
    >>> round(float(metric.compute()), 4)
    0.7251
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, reduction: str = "mean", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if reduction not in ("mean", "sum"):
            raise ValueError(f"Argument `reduction` must be one of `mean` or `sum`, but got {reduction}")
        self.reduction = reduction
        self.add_state("disparity", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("total", torch.zeros((), dtype=count_dtype()), dist_reduce_fx="sum")

    def update(self, point_cloud1: Tensor, point_cloud2: Tensor) -> None:
        """Update state with a batch ``(N, M, D)`` (or a single pair ``(M, D)``) of point clouds."""
        if point_cloud1.ndim == 2:
            point_cloud1 = point_cloud1[None]
            point_cloud2 = point_cloud2[None]
        self.disparity = self.disparity + procrustes_disparity(point_cloud1, point_cloud2).sum()
        self.total = self.total + point_cloud1.shape[0]

    def compute(self) -> Tensor:
        """Compute metric."""
        if self.reduction == "mean":
            return self.disparity / self.total
        return self.disparity
