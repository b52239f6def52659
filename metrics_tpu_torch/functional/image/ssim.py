"""SSIM (counterpart of ``metrics_tpu/functional/image/ssim.py``), 2-D images.

The five window sums (of p, t, p², t² and p·t) run as one pass over the 5·B·C
stacked reflect-padded planes through :func:`metrics_tpu_torch.ops.ssim_window.ssim_window`:
the CUDA kernel on the card, the shifted-slice cascade on the CPU.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.functional.image._helpers import _reflect_pad, reduce
from metrics_tpu_torch.ops.ssim_window import windowed_sum_nchw
from metrics_tpu_torch.utils.checks import _check_same_shape


def _gaussian_taps_np(kernel_size: int, sigma: float) -> np.ndarray:
    """1-D gaussian taps in float32, computed on the host with the JAX package's formula."""
    dist = np.arange((1 - kernel_size) / 2, (1 + kernel_size) / 2, 1.0, dtype=np.float32)
    gauss = np.exp(-(dist**2) / np.float32(2 * sigma**2))
    return (gauss / gauss.sum()).astype(np.float32)


def _ssim_check_inputs(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shape validation and the cast to float32."""
    _check_same_shape(preds, target)
    if preds.ndim != 4:
        raise ValueError(
            f"Expected `preds` and `target` to have BxCxHxW shape (3-D images are not ported yet). Got preds:"
            f" {tuple(preds.shape)}"
        )
    return preds.float(), target.float()


def _ssim_update(
    preds: torch.Tensor,
    target: torch.Tensor,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    data_range: Optional[Union[float, Tuple[float, float]]] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    return_full_image: bool = False,
    return_contrast_sensitivity: bool = False,
):
    """Per-image SSIM of (B, C, H, W) images."""
    if not isinstance(kernel_size, Sequence):
        kernel_size = 2 * [kernel_size]
    if not isinstance(sigma, Sequence):
        sigma = 2 * [sigma]
    if len(kernel_size) != 2 or len(sigma) != 2:
        raise ValueError(
            f"`kernel_size` has dimension {len(kernel_size)}, but expected to be two less than target"
            f" dimensionality, which is: {preds.ndim}"
        )
    if any(x % 2 == 0 or x <= 0 for x in kernel_size):
        raise ValueError(f"Expected `kernel_size` to have odd positive number. Got {kernel_size}.")
    if any(y <= 0 for y in sigma):
        raise ValueError(f"Expected `sigma` to have positive number. Got {sigma}.")
    if return_full_image and return_contrast_sensitivity:
        raise ValueError("Arguments `return_full_image` and `return_contrast_sensitivity` are mutually exclusive.")

    if data_range is None:  # taken from this batch, as the JAX package does
        data_range = torch.maximum(preds.max() - preds.min(), target.max() - target.min())
    elif isinstance(data_range, tuple):
        preds = preds.clamp(data_range[0], data_range[1])
        target = target.clamp(data_range[0], data_range[1])
        data_range = data_range[1] - data_range[0]

    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    gauss_kernel_size = [int(3.5 * s + 0.5) * 2 + 1 for s in sigma]
    eff_size = gauss_kernel_size if gaussian_kernel else kernel_size
    pads = [(k - 1) // 2 for k in eff_size]

    preds_p = _reflect_pad(preds, pads)
    target_p = _reflect_pad(target, pads)
    if gaussian_kernel:
        taps = [_gaussian_taps_np(k, s) for k, s in zip(gauss_kernel_size, sigma)]
    else:
        taps = [np.ones(k, dtype=np.float32) / k for k in kernel_size]

    input_list = torch.cat((preds_p, target_p, preds_p * preds_p, target_p * target_p, preds_p * target_p))
    outputs = windowed_sum_nchw(input_list, taps)
    b = preds.shape[0]
    mu_pred, mu_target, s_pp, s_tt, s_pt = outputs.split(b)

    mu_pred_sq = mu_pred**2
    mu_target_sq = mu_target**2
    mu_pred_target = mu_pred * mu_target
    sigma_pred_sq = (s_pp - mu_pred_sq).clamp(min=0.0)
    sigma_target_sq = (s_tt - mu_target_sq).clamp(min=0.0)
    sigma_pred_target = s_pt - mu_pred_target

    upper = 2 * sigma_pred_target + c2
    lower = sigma_pred_sq + sigma_target_sq + c2
    ssim_full = ((2 * mu_pred_target + c1) * upper) / ((mu_pred_sq + mu_target_sq + c1) * lower)

    per_image = ssim_full.reshape(b, -1).mean(-1)
    if return_contrast_sensitivity:
        # the contrast term is averaged over the unpadded region only
        cs = upper / lower
        for d, p in enumerate(pads):
            if p:
                cs = cs.narrow(2 + d, p, cs.shape[2 + d] - 2 * p)
        return per_image, cs.reshape(b, -1).mean(-1)
    if return_full_image:
        return per_image, ssim_full
    return per_image


def structural_similarity_index_measure(
    preds: torch.Tensor,
    target: torch.Tensor,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    reduction: Optional[str] = "elementwise_mean",
    data_range: Optional[Union[float, Tuple[float, float]]] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    return_full_image: bool = False,
    return_contrast_sensitivity: bool = False,
):
    """SSIM of (B, C, H, W) images, computed on their device.

    >>> rng = np.random.RandomState(42)
    >>> preds = torch.from_numpy(rng.rand(3, 3, 32, 32).astype(np.float32))
    >>> round(float(structural_similarity_index_measure(preds, preds * 0.75)), 4)
    0.9219
    """
    preds, target = _ssim_check_inputs(preds, target)
    out = _ssim_update(
        preds, target, gaussian_kernel, sigma, kernel_size, data_range, k1, k2,
        return_full_image, return_contrast_sensitivity,
    )
    if isinstance(out, tuple):
        return reduce(out[0], reduction), out[1]
    return reduce(out, reduction)
