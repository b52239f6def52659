"""Image metrics (counterpart of ``metrics_tpu/image/metrics.py``): 2-D SSIM so far."""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple, Union

import torch

from metrics_tpu_torch.functional.image.ssim import _ssim_check_inputs, _ssim_update
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.data import dim_zero_cat


class StructuralSimilarityIndexMeasure(Metric):
    """SSIM over every (B, C, H, W) batch seen so far.

    >>> import numpy as np
    >>> rng = np.random.RandomState(42)
    >>> preds = torch.from_numpy(rng.rand(3, 3, 32, 32).astype(np.float32))
    >>> ssim = StructuralSimilarityIndexMeasure(data_range=1.0, device="cpu")
    >>> ssim.update(preds, preds * 0.75)
    >>> round(float(ssim.compute()), 4)
    0.9219
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False

    def __init__(
        self,
        gaussian_kernel: bool = True,
        sigma: Union[float, Sequence[float]] = 1.5,
        kernel_size: Union[int, Sequence[int]] = 11,
        reduction: Optional[str] = "elementwise_mean",
        data_range: Optional[Union[float, Tuple[float, float]]] = None,
        k1: float = 0.01,
        k2: float = 0.03,
        return_full_image: bool = False,
        return_contrast_sensitivity: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        valid_reduction = ("elementwise_mean", "sum", "none", None)
        if reduction not in valid_reduction:
            raise ValueError(f"Argument `reduction` must be one of {valid_reduction}, but got {reduction}")
        if reduction in ("elementwise_mean", "sum"):
            self.add_state("similarity", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        else:
            self.add_state("similarity", [], dist_reduce_fx="cat")
        self.add_state("total", torch.zeros((), dtype=torch.int64), dist_reduce_fx="sum")
        if return_full_image or return_contrast_sensitivity:
            self.add_state("image_return", [], dist_reduce_fx="cat")
        self.gaussian_kernel = gaussian_kernel
        self.sigma = sigma
        self.kernel_size = kernel_size
        self.reduction = reduction
        self.data_range = data_range
        self.k1 = k1
        self.k2 = k2
        self.return_full_image = return_full_image
        self.return_contrast_sensitivity = return_contrast_sensitivity

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        """Update state with predictions and targets."""
        preds, target = _ssim_check_inputs(preds, target)
        out = _ssim_update(
            preds, target, self.gaussian_kernel, self.sigma, self.kernel_size, self.data_range,
            self.k1, self.k2, self.return_full_image, self.return_contrast_sensitivity,
        )
        if isinstance(out, tuple):
            similarity, image = out
            self.image_return.append(image)
        else:
            similarity = out
        if self.reduction in ("elementwise_mean", "sum"):
            self.similarity = self.similarity + similarity.sum()
        else:
            self.similarity.append(similarity)
        self.total = self.total + preds.shape[0]

    def compute(self):
        """SSIM over every update so far."""
        if self.reduction == "elementwise_mean":
            similarity = self.similarity / self.total
        elif self.reduction == "sum":
            similarity = self.similarity
        else:
            similarity = dim_zero_cat(self.similarity)
        if self.return_full_image or self.return_contrast_sensitivity:
            return similarity, dim_zero_cat(self.image_return)
        return similarity
