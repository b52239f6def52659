"""Image metrics (counterpart of ``metrics_tpu/image/metrics.py``): PSNR, SSIM (2-D and 3-D) and MS-SSIM."""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple, Union

import torch

from metrics_tpu_torch.functional.image.psnr import _psnr_compute, _psnr_update
from metrics_tpu_torch.functional.image.ssim import _multiscale_ssim_update, _ssim_check_inputs, _ssim_update
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.compute import count_dtype
from metrics_tpu_torch.utils.data import dim_zero_cat
from metrics_tpu_torch.utils.prints import rank_zero_warn


class PeakSignalNoiseRatio(Metric):
    """PSNR over every batch seen so far.

    Without ``dim`` the states are the summed squared error and the count; with ``dim`` one value per
    remaining index is kept for each batch. Without ``data_range`` the span is that of every target seen,
    kept as ``min_target`` and ``max_target``.

    >>> psnr = PeakSignalNoiseRatio(device="cpu")
    >>> psnr.update(torch.tensor([[0.0, 1.0], [2.0, 3.0]]), torch.tensor([[3.0, 2.0], [1.0, 0.0]]))
    >>> psnr.compute()
    tensor(2.5527)
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False

    def __init__(
        self,
        data_range: Optional[Union[float, Tuple[float, float]]] = None,
        base: float = 10.0,
        reduction: Optional[str] = "elementwise_mean",
        dim: Optional[Union[int, Tuple[int, ...]]] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if dim is None and reduction != "elementwise_mean":
            rank_zero_warn(f"The `reduction={reduction}` will not have any effect when `dim` is None.")
        self.base = base
        self.reduction = reduction
        self.dim = tuple(dim) if isinstance(dim, Sequence) else dim
        self.clamp_range = None
        if dim is None:
            self.add_state("sum_squared_error", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
            self.add_state("total", torch.zeros((), dtype=count_dtype()), dist_reduce_fx="sum")
        else:
            self.add_state("sum_squared_error", [], dist_reduce_fx="cat")
            self.add_state("total", [], dist_reduce_fx="cat")
        if data_range is None:
            if dim is not None:
                raise ValueError("The `data_range` must be given when `dim` is not None.")
            self.data_range = None
            self.add_state("min_target", torch.tensor(float("inf")), dist_reduce_fx="min")
            self.add_state("max_target", torch.tensor(float("-inf")), dist_reduce_fx="max")
        elif isinstance(data_range, tuple):
            self.clamp_range = data_range
            self.data_range = torch.tensor(data_range[1] - data_range[0], dtype=torch.float32, device=self.device)
        else:
            self.data_range = torch.tensor(float(data_range), dtype=torch.float32, device=self.device)

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        """Update state with predictions and targets."""
        if self.clamp_range is not None:
            preds = preds.clamp(*self.clamp_range)
            target = target.clamp(*self.clamp_range)
        sum_squared_error, num_obs = _psnr_update(preds, target, dim=self.dim)
        if self.dim is None:
            if self.data_range is None:
                self.min_target = torch.minimum(target.min().float(), self.min_target)
                self.max_target = torch.maximum(target.max().float(), self.max_target)
            self.sum_squared_error = self.sum_squared_error + sum_squared_error
            self.total = self.total + num_obs
        else:
            sse = torch.atleast_1d(sum_squared_error)
            self.sum_squared_error.append(sse)
            self.total.append(torch.atleast_1d(num_obs).expand(sse.shape))

    def compute(self) -> torch.Tensor:
        """PSNR over every update so far."""
        data_range = self.data_range if self.data_range is not None else self.max_target - self.min_target
        if self.dim is None:
            return _psnr_compute(self.sum_squared_error, self.total, data_range, self.base, self.reduction)
        return _psnr_compute(
            dim_zero_cat(self.sum_squared_error), dim_zero_cat(self.total), data_range, self.base, self.reduction
        )


class StructuralSimilarityIndexMeasure(Metric):
    """SSIM over every (B, C, H, W) or (B, C, D, H, W) batch seen so far.

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
        self.add_state("total", torch.zeros((), dtype=count_dtype()), dist_reduce_fx="sum")
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


class MultiScaleStructuralSimilarityIndexMeasure(Metric):
    """MS-SSIM over every (B, C, H, W) batch seen so far: one window-kernel launch per scale on the card.

    >>> import numpy as np
    >>> rng = np.random.RandomState(42)
    >>> preds = torch.from_numpy(rng.rand(3, 3, 180, 180).astype(np.float32))
    >>> ms_ssim = MultiScaleStructuralSimilarityIndexMeasure(data_range=1.0, device="cpu")
    >>> ms_ssim.update(preds, preds * 0.75)
    >>> round(float(ms_ssim.compute()), 4)
    0.963
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False

    def __init__(
        self,
        gaussian_kernel: bool = True,
        kernel_size: Union[int, Sequence[int]] = 11,
        sigma: Union[float, Sequence[float]] = 1.5,
        reduction: Optional[str] = "elementwise_mean",
        data_range: Optional[Union[float, Tuple[float, float]]] = None,
        k1: float = 0.01,
        k2: float = 0.03,
        betas: Tuple[float, ...] = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333),
        normalize: Optional[str] = "relu",
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
        self.add_state("total", torch.zeros((), dtype=count_dtype()), dist_reduce_fx="sum")
        if not isinstance(betas, tuple) or not all(isinstance(b, float) for b in betas):
            raise ValueError("Argument `betas` is expected to be of a type tuple of floats.")
        if normalize not in ("relu", "simple", None):
            raise ValueError("Argument `normalize` to be expected either `None` or one of 'relu' or 'simple'")
        self.gaussian_kernel = gaussian_kernel
        self.kernel_size = kernel_size
        self.sigma = sigma
        self.reduction = reduction
        self.data_range = data_range
        self.k1 = k1
        self.k2 = k2
        self.betas = betas
        self.normalize = normalize

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        """Update state with predictions and targets."""
        preds, target = _ssim_check_inputs(preds, target)
        similarity = _multiscale_ssim_update(
            preds, target, self.gaussian_kernel, self.sigma, self.kernel_size, self.data_range,
            self.k1, self.k2, self.betas, self.normalize,
        )
        if self.reduction in ("elementwise_mean", "sum"):
            self.similarity = self.similarity + similarity.sum()
        else:
            self.similarity.append(similarity)
        self.total = self.total + preds.shape[0]

    def compute(self) -> torch.Tensor:
        """MS-SSIM over every update so far."""
        if self.reduction == "elementwise_mean":
            return self.similarity / self.total
        if self.reduction == "sum":
            return self.similarity
        return dim_zero_cat(self.similarity)
