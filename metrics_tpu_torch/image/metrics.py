"""Image metrics (counterpart of ``metrics_tpu/image/metrics.py``).

PSNR, SSIM (2-D and 3-D) and MS-SSIM keep sums or per-image values; UQI, SAM,
ERGAS, RASE, RMSE-SW, SCC, PSNR-B, VIF and D_lambda keep every input in "cat"
list states and compute over their concatenation (``_SampleStoreImageMetric``),
as D_s and QNR do with their four lists; total variation keeps a sum and a
count, or the per-image scores.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch

from metrics_tpu_torch.functional.image.metrics import (
    error_relative_global_dimensionless_synthesis,
    peak_signal_noise_ratio_with_blocked_effect,
    quality_with_no_reference,
    relative_average_spectral_error,
    root_mean_squared_error_using_sliding_window,
    spatial_correlation_coefficient,
    spatial_distortion_index,
    spectral_angle_mapper,
    spectral_distortion_index,
    total_variation,
    universal_image_quality_index,
    visual_information_fidelity,
)
from metrics_tpu_torch.functional.image.psnr import _psnr_compute, _psnr_update
from metrics_tpu_torch.functional.image.ssim import _multiscale_ssim_update, _ssim_check_inputs, _ssim_update
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.compute import acc_dtype, count_dtype
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
    plot_lower_bound = 0.0

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
            self.add_state("sum_squared_error", torch.zeros((), dtype=acc_dtype()), dist_reduce_fx="sum")
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
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

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
            self.add_state("similarity", torch.zeros((), dtype=acc_dtype()), dist_reduce_fx="sum")
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
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

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
            self.add_state("similarity", torch.zeros((), dtype=acc_dtype()), dist_reduce_fx="sum")
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


class _SampleStoreImageMetric(Metric):
    """An image metric that keeps every batch of predictions and targets in "cat" list states and computes over
    their concatenation."""

    is_differentiable = True
    full_state_update = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("preds", [], dist_reduce_fx="cat")
        self.add_state("target", [], dist_reduce_fx="cat")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        """Update state with predictions and targets."""
        self.preds.append(preds)
        self.target.append(target)


class UniversalImageQualityIndex(_SampleStoreImageMetric):
    """UQI over every (B, C, H, W) batch seen so far: one window-kernel launch at ``compute()`` on the card.

    >>> import numpy as np
    >>> rng = np.random.RandomState(42)
    >>> preds = torch.from_numpy(rng.rand(2, 3, 32, 32).astype(np.float32))
    >>> uqi = UniversalImageQualityIndex(device="cpu")
    >>> uqi.update(preds, preds * 0.75)
    >>> round(float(uqi.compute()), 4)
    0.9216
    """

    higher_is_better = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        kernel_size: Sequence[int] = (11, 11),
        sigma: Sequence[float] = (1.5, 1.5),
        reduction: Optional[str] = "elementwise_mean",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.kernel_size = kernel_size
        self.sigma = sigma
        self.reduction = reduction

    def compute(self) -> torch.Tensor:
        """UQI over every update so far."""
        return universal_image_quality_index(
            dim_zero_cat(self.preds), dim_zero_cat(self.target), self.kernel_size, self.sigma, self.reduction
        )


class SpectralAngleMapper(_SampleStoreImageMetric):
    """SAM, in radians, over every batch seen so far."""

    higher_is_better = False
    plot_lower_bound = 0.0

    def __init__(self, reduction: Optional[str] = "elementwise_mean", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.reduction = reduction

    def compute(self) -> torch.Tensor:
        """SAM over every update so far."""
        return spectral_angle_mapper(dim_zero_cat(self.preds), dim_zero_cat(self.target), self.reduction)


class ErrorRelativeGlobalDimensionlessSynthesis(_SampleStoreImageMetric):
    """ERGAS over every batch seen so far; ``ratio`` is the ratio of high to low resolution."""

    higher_is_better = False
    plot_lower_bound = 0.0

    def __init__(self, ratio: float = 4, reduction: Optional[str] = "elementwise_mean", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.ratio = ratio
        self.reduction = reduction

    def compute(self) -> torch.Tensor:
        """ERGAS over every update so far."""
        return error_relative_global_dimensionless_synthesis(
            dim_zero_cat(self.preds), dim_zero_cat(self.target), self.ratio, self.reduction
        )


def _check_window_size(window_size: Any) -> None:
    if not isinstance(window_size, int) or window_size < 1:
        raise ValueError(f"Argument `window_size` is expected to be a positive integer, but got {window_size}")


class RelativeAverageSpectralError(_SampleStoreImageMetric):
    """RASE over every batch seen so far: two window-kernel launches at ``compute()`` on the card."""

    higher_is_better = False
    plot_lower_bound = 0.0

    def __init__(self, window_size: int = 8, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        _check_window_size(window_size)
        self.window_size = window_size

    def compute(self) -> torch.Tensor:
        """RASE over every update so far."""
        return relative_average_spectral_error(dim_zero_cat(self.preds), dim_zero_cat(self.target), self.window_size)


class RootMeanSquaredErrorUsingSlidingWindow(_SampleStoreImageMetric):
    """Sliding-window RMSE over every batch seen so far: one window-kernel launch at ``compute()`` on the card."""

    higher_is_better = False
    plot_lower_bound = 0.0

    def __init__(self, window_size: int = 8, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        _check_window_size(window_size)
        self.window_size = window_size

    def compute(self) -> torch.Tensor:
        """RMSE-SW over every update so far."""
        return root_mean_squared_error_using_sliding_window(
            dim_zero_cat(self.preds), dim_zero_cat(self.target), self.window_size
        )


class TotalVariation(Metric):
    """Total variation of every image seen so far: with ``reduction`` "sum" or "mean" a running sum and count,
    with "none" or None every image's score.

    >>> import numpy as np
    >>> rng = np.random.RandomState(42)
    >>> tv = TotalVariation(device="cpu")
    >>> tv.update(torch.from_numpy(rng.rand(2, 3, 16, 16).astype(np.float32)))
    >>> float(tv.compute()) > 0
    True
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, reduction: Optional[str] = "sum", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if reduction is not None and reduction not in ("sum", "mean", "none"):
            raise ValueError("Expected argument `reduction` to either be 'sum', 'mean', 'none' or None")
        self.reduction = reduction
        if reduction in ("sum", "mean"):
            self.add_state("score", torch.zeros((), dtype=acc_dtype()), dist_reduce_fx="sum")
            self.add_state("num_elements", torch.zeros((), dtype=count_dtype()), dist_reduce_fx="sum")
        else:
            self.add_state("score_list", [], dist_reduce_fx="cat")

    def update(self, img: torch.Tensor) -> None:
        """Update state with a batch of images."""
        score = total_variation(img, reduction="none")
        if self.reduction in ("sum", "mean"):
            self.score = self.score + score.sum()
            self.num_elements = self.num_elements + img.shape[0]
        else:
            self.score_list.append(score)

    def compute(self) -> torch.Tensor:
        """Total variation over every update so far."""
        if self.reduction == "sum":
            return self.score
        if self.reduction == "mean":
            return self.score / self.num_elements
        return dim_zero_cat(self.score_list)


class SpatialCorrelationCoefficient(_SampleStoreImageMetric):
    """SCC over every batch seen so far: one window-kernel launch at ``compute()`` on the card."""

    higher_is_better = True
    plot_lower_bound = -1.0
    plot_upper_bound = 1.0

    def __init__(self, hp_filter: Optional[torch.Tensor] = None, window_size: int = 8, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.hp_filter = hp_filter
        self.window_size = window_size

    def compute(self) -> torch.Tensor:
        """SCC over every update so far."""
        return spatial_correlation_coefficient(
            dim_zero_cat(self.preds), dim_zero_cat(self.target), self.hp_filter, self.window_size
        )


class PeakSignalNoiseRatioWithBlockedEffect(_SampleStoreImageMetric):
    """PSNR-B over every grayscale batch seen so far, pooled."""

    higher_is_better = True
    plot_lower_bound = 0.0

    def __init__(self, block_size: int = 8, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(block_size, int) or block_size < 1:
            raise ValueError("Argument `block_size` should be a positive integer")
        self.block_size = block_size

    def compute(self) -> torch.Tensor:
        """PSNR-B over every update so far."""
        return peak_signal_noise_ratio_with_blocked_effect(
            dim_zero_cat(self.preds), dim_zero_cat(self.target), self.block_size
        )


class VisualInformationFidelity(_SampleStoreImageMetric):
    """VIF-p over every batch seen so far: seven window-kernel launches at ``compute()`` on the card."""

    higher_is_better = True
    plot_lower_bound = 0.0

    def __init__(self, sigma_n_sq: float = 2.0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(sigma_n_sq, (float, int)) or sigma_n_sq < 0:
            raise ValueError(f"Argument `sigma_n_sq` is expected to be a positive float or int, but got {sigma_n_sq}")
        self.sigma_n_sq = float(sigma_n_sq)

    def compute(self) -> torch.Tensor:
        """VIF over every update so far."""
        return visual_information_fidelity(dim_zero_cat(self.preds), dim_zero_cat(self.target), self.sigma_n_sq)


class SpectralDistortionIndex(_SampleStoreImageMetric):
    """D_lambda over every batch seen so far: two window-kernel launches at ``compute()`` on the card."""

    higher_is_better = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(self, p: int = 1, reduction: Optional[str] = "elementwise_mean", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(p, int) or p <= 0:
            raise ValueError(f"Expected `p` to be a positive integer. Got p: {p}.")
        self.p = p
        self.reduction = reduction

    def compute(self) -> torch.Tensor:
        """D_lambda over every update so far."""
        return spectral_distortion_index(dim_zero_cat(self.preds), dim_zero_cat(self.target), self.p, self.reduction)


class SpatialDistortionIndex(Metric):
    """D_s over every batch seen so far; the target is a dict ``{"ms", "pan"[, "pan_lr"]}``, kept in four "cat"
    list states."""

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(self, norm_order: int = 1, window_size: int = 7, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.norm_order = norm_order
        self.window_size = window_size
        self.add_state("preds", [], dist_reduce_fx="cat")
        self.add_state("ms", [], dist_reduce_fx="cat")
        self.add_state("pan", [], dist_reduce_fx="cat")
        self.add_state("pan_lr", [], dist_reduce_fx="cat")

    def update(self, preds: torch.Tensor, target: Dict[str, torch.Tensor]) -> None:
        """Update state with the fused image and the ``{ms, pan[, pan_lr]}`` dict."""
        if not isinstance(target, dict) or "ms" not in target or "pan" not in target:
            raise ValueError("Expected `target` to be a dict with keys ('ms', 'pan').")
        self.preds.append(preds)
        self.ms.append(target["ms"])
        self.pan.append(target["pan"])
        if "pan_lr" in target:
            self.pan_lr.append(target["pan_lr"])

    def _target_dict(self) -> Dict[str, torch.Tensor]:
        target = {"ms": dim_zero_cat(self.ms), "pan": dim_zero_cat(self.pan)}
        if self.pan_lr:
            target["pan_lr"] = dim_zero_cat(self.pan_lr)
        return target

    def compute(self) -> torch.Tensor:
        """D_s over every update so far."""
        return spatial_distortion_index(
            dim_zero_cat(self.preds), self._target_dict(), norm_order=self.norm_order, window_size=self.window_size
        )


class QualityWithNoReference(SpatialDistortionIndex):
    """QNR over every batch seen so far, on D_s's four list states."""

    higher_is_better = True

    def __init__(
        self, alpha: float = 1.0, beta: float = 1.0, norm_order: int = 1, window_size: int = 7, **kwargs: Any
    ) -> None:
        super().__init__(norm_order, window_size, **kwargs)
        self.alpha = alpha
        self.beta = beta

    def compute(self) -> torch.Tensor:
        """QNR over every update so far."""
        return quality_with_no_reference(
            dim_zero_cat(self.preds),
            self._target_dict(),
            alpha=self.alpha,
            beta=self.beta,
            norm_order=self.norm_order,
            window_size=self.window_size,
        )
