"""SSIM and MS-SSIM (counterpart of ``metrics_tpu/functional/image/ssim.py``).

For 2-D images the five window sums (of p, t, p², t² and p·t) run as one pass
over the 5·B·C stacked reflect-padded planes through
:func:`metrics_tpu_torch.ops.ssim_window.ssim_window`: the CUDA kernel on the
card, the shifted-slice cascade on the CPU. MS-SSIM makes that pass once per
scale. 3-D volumes (B, C, D, H, W) take the shifted-slice cascade on their
device, one 1-D pass per axis, as the JAX package gives them no kernel either.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.functional.image._helpers import _gaussian_taps_np, _reflect_pad, avg_pool2d, reduce
from metrics_tpu_torch.ops.ssim_window import separable_depthwise_conv, windowed_sum_nchw
from metrics_tpu_torch.utils.checks import _check_same_shape


def _ssim_check_inputs(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shape validation and the cast to float32."""
    _check_same_shape(preds, target)
    if preds.ndim not in (4, 5):
        raise ValueError(
            f"Expected `preds` and `target` to have BxCxHxW or BxCxDxHxW shape. Got preds: {tuple(preds.shape)}"
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
    """Per-image SSIM of (B, C, H, W) images or (B, C, D, H, W) volumes."""
    is_3d = preds.ndim == 5
    n_spatial = 3 if is_3d else 2
    if not isinstance(kernel_size, Sequence):
        kernel_size = n_spatial * [kernel_size]
    if not isinstance(sigma, Sequence):
        sigma = n_spatial * [sigma]
    if len(kernel_size) != n_spatial or len(sigma) != n_spatial:
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
    if is_3d:
        outputs = separable_depthwise_conv(input_list, [torch.from_numpy(t).to(input_list.device) for t in taps])
    else:
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
    """SSIM of (B, C, H, W) images or (B, C, D, H, W) volumes, computed on their device.

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


def _multiscale_ssim_update(
    preds: torch.Tensor,
    target: torch.Tensor,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    data_range: Optional[Union[float, Tuple[float, float]]] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    betas: Tuple[float, ...] = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333),
    normalize: Optional[str] = "relu",
) -> torch.Tensor:
    """Per-image MS-SSIM: one SSIM pass per scale (one window-kernel launch each on the card), halving the
    images between scales."""
    if preds.ndim == 5:
        raise ValueError("`multiscale_ssim` does not support 3D images")
    sizes = kernel_size if isinstance(kernel_size, Sequence) else [kernel_size] * 2
    if preds.shape[-1] < 2 ** len(betas) * sizes[-1] // 2 or preds.shape[-2] < 2 ** len(betas) * sizes[0] // 2:
        raise ValueError(
            f"For a given number of `betas` parameters {len(betas)}, the image height and width should be larger"
            f" than {(2 ** len(betas)) * sizes[0] // 2} after being reduced {len(betas) - 1} times."
        )
    sim_list = []
    cur_p, cur_t = preds, target
    for i in range(len(betas)):
        sim, contrast = _ssim_update(
            cur_p, cur_t, gaussian_kernel, sigma, kernel_size, data_range, k1, k2,
            return_contrast_sensitivity=True,
        )
        sim_list.append(sim if i == len(betas) - 1 else contrast)
        if i < len(betas) - 1:
            cur_p = avg_pool2d(cur_p, 2)
            cur_t = avg_pool2d(cur_t, 2)
    stacked = torch.stack(sim_list)  # (scales, B)
    if normalize == "relu":
        stacked = stacked.clamp(min=0.0)
    betas_t = torch.tensor(betas, dtype=torch.float32, device=stacked.device)[:, None]
    out = torch.prod(stacked**betas_t, dim=0)
    if normalize == "simple":
        out = (out + 1) / 2
    return out


def multiscale_structural_similarity_index_measure(
    preds: torch.Tensor,
    target: torch.Tensor,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    reduction: Optional[str] = "elementwise_mean",
    data_range: Optional[Union[float, Tuple[float, float]]] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    betas: Tuple[float, ...] = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333),
    normalize: Optional[str] = "relu",
) -> torch.Tensor:
    """MS-SSIM of (B, C, H, W) images, computed on their device.

    >>> rng = np.random.RandomState(42)
    >>> preds = torch.from_numpy(rng.rand(3, 3, 180, 180).astype(np.float32))
    >>> round(float(multiscale_structural_similarity_index_measure(preds, preds * 0.75, data_range=1.0)), 4)
    0.963
    """
    if not isinstance(betas, tuple) or not all(isinstance(b, float) for b in betas):
        raise ValueError("Argument `betas` is expected to be of a type tuple of floats.")
    if normalize not in ("relu", "simple", None):
        raise ValueError("Argument `normalize` to be expected either `None` or one of 'relu' or 'simple'")
    preds, target = _ssim_check_inputs(preds, target)
    out = _multiscale_ssim_update(
        preds, target, gaussian_kernel, sigma, kernel_size, data_range, k1, k2, betas, normalize
    )
    return reduce(out, reduction)
