"""The rest of the image-quality functions (counterpart of ``metrics_tpu/functional/image/metrics.py``).

UQI, SAM, ERGAS, RMSE-SW, RASE, total variation, SCC, PSNR-B, VIF, D_lambda,
D_s, QNR and image gradients, in the JAX package's order. Every gaussian or
uniform window goes through the window kernel
(:func:`metrics_tpu_torch.ops.ssim_window.windowed_sum_nchw`) as two 1-D
windows, one launch for each stack of planes; on a CPU tensor the same call
runs the kernel's plain version. The launches per call:

* UQI 1 (the five moment planes of every image and channel in one stack);
* RMSE-SW 1 and RASE 2 (the scipy-style uniform filter);
* SCC 1 (the five window statistics; its 3 x 3 high-pass filter is not
  separable and runs as :func:`depthwise_conv`);
* VIF 7 (scale 0: the five statistics; scales 1-3: the low-pass of preds and
  target together, then the statistics);
* D_lambda 2 (every band pair of the fused image in one UQI, then the low-
  resolution image's);
* D_s 2 with ``pan_lr``, 3 without (the uniform filter before the resize),
  every channel in one UQI for each resolution; QNR adds D_lambda's 2.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from metrics_tpu_torch.functional.image._helpers import (
    _gaussian_taps_np,
    _reflect_pad,
    _symmetric_pad,
    _uniform_taps_np,
    depthwise_conv,
    reduce,
    resize_bilinear,
    scipy_uniform_filter,
)
from metrics_tpu_torch.ops.ssim_window import windowed_sum_nchw
from metrics_tpu_torch.utils.checks import _check_same_shape


# --------------------------------------------------------------------------- UQI
def universal_image_quality_index(
    preds: torch.Tensor,
    target: torch.Tensor,
    kernel_size: Sequence[int] = (11, 11),
    sigma: Sequence[float] = (1.5, 1.5),
    reduction: Optional[str] = "elementwise_mean",
) -> torch.Tensor:
    """Universal image quality index of (B, C, H, W) images; ``reduction="none"`` returns the map, cropped by
    the window's half-width.

    >>> rng = np.random.RandomState(42)
    >>> preds = torch.from_numpy(rng.rand(2, 3, 32, 32).astype(np.float32))
    >>> round(float(universal_image_quality_index(preds, preds * 0.75)), 4)
    0.9216
    """
    _check_same_shape(preds, target)
    preds = preds.float()
    target = target.float()
    pads = [(k - 1) // 2 for k in kernel_size]
    preds_p = _reflect_pad(preds, pads)
    target_p = _reflect_pad(target, pads)
    input_list = torch.cat((preds_p, target_p, preds_p * preds_p, target_p * target_p, preds_p * target_p))
    taps = [_gaussian_taps_np(k, s) for k, s in zip(kernel_size, sigma)]
    mu_p, mu_t, s_pp, s_tt, s_pt = windowed_sum_nchw(input_list, taps).split(preds.shape[0])
    mu_p_sq, mu_t_sq, mu_pt = mu_p**2, mu_t**2, mu_p * mu_t
    sigma_p_sq = (s_pp - mu_p_sq).clamp(min=0.0)
    sigma_t_sq = (s_tt - mu_t_sq).clamp(min=0.0)
    sigma_pt = s_pt - mu_pt
    upper = 2 * sigma_pt
    lower = sigma_p_sq + sigma_t_sq
    eps = torch.finfo(torch.float32).eps
    uqi_map = ((2 * mu_pt) * upper) / ((mu_p_sq + mu_t_sq) * lower + eps)
    # the map is cropped to the unpadded region before it is reduced
    uqi_map = uqi_map[..., pads[0] : uqi_map.shape[-2] - pads[0], pads[1] : uqi_map.shape[-1] - pads[1]]
    return reduce(uqi_map, reduction)


# --------------------------------------------------------------------------- SAM
def spectral_angle_mapper(
    preds: torch.Tensor, target: torch.Tensor, reduction: Optional[str] = "elementwise_mean"
) -> torch.Tensor:
    """Spectral angle mapper in radians: each image's mean angle between the pixels' spectra, then reduced.

    >>> rng = np.random.RandomState(42)
    >>> preds = torch.from_numpy(rng.rand(2, 3, 16, 16).astype(np.float32))
    >>> target = torch.from_numpy(rng.rand(2, 3, 16, 16).astype(np.float32))
    >>> round(float(spectral_angle_mapper(preds, target)), 4)
    0.6218
    """
    _check_same_shape(preds, target)
    if preds.ndim != 4 or preds.shape[1] <= 1:
        raise ValueError(
            "Expected both `preds` and `target` to have BxCxHxW shape with C > 1."
            f" Got preds: {tuple(preds.shape)}"
        )
    preds = preds.float()
    target = target.float()
    dot = torch.sum(preds * target, dim=1)
    denom = torch.linalg.norm(preds, dim=1) * torch.linalg.norm(target, dim=1)
    angle = torch.arccos((dot / denom.clamp(min=1e-12)).clamp(-1.0, 1.0))
    return reduce(angle.reshape(angle.shape[0], -1).mean(-1), reduction)


# --------------------------------------------------------------------------- ERGAS
def error_relative_global_dimensionless_synthesis(
    preds: torch.Tensor, target: torch.Tensor, ratio: float = 4, reduction: Optional[str] = "elementwise_mean"
) -> torch.Tensor:
    """ERGAS of (B, C, H, W) images: ``100 / ratio`` times the root mean over bands of (band RMSE / band mean)².
    A band of mean 0 gives inf, as in the JAX package.

    >>> rng = np.random.RandomState(42)
    >>> preds = torch.from_numpy(rng.rand(2, 3, 16, 16).astype(np.float32))
    >>> float(error_relative_global_dimensionless_synthesis(preds, preds * 0.75)) > 0
    True
    """
    _check_same_shape(preds, target)
    if preds.ndim != 4:
        raise ValueError(f"Expected `preds` and `target` to have BxCxHxW shape. Got preds: {tuple(preds.shape)}")
    preds = preds.float()
    target = target.float()
    b, c = preds.shape[:2]
    diff = (preds - target).reshape(b, c, -1)
    rmse_per_band = torch.sqrt(torch.mean(diff**2, dim=2))
    mean_target = torch.mean(target.reshape(b, c, -1), dim=2)
    ergas_score = 100 / ratio * torch.sqrt(torch.mean((rmse_per_band / mean_target) ** 2, dim=1))
    return reduce(ergas_score, reduction)


# --------------------------------------------------------------------------- RMSE-SW / RASE
def _rmse_sw_maps(preds: torch.Tensor, target: torch.Tensor, window_size: int) -> torch.Tensor:
    """Per-image sliding-window RMSE maps, (B, C, H, W): the root of the uniform-filtered squared error."""
    if not isinstance(window_size, int) or window_size < 1:
        raise ValueError("Argument `window_size` is expected to be a positive integer.")
    _check_same_shape(preds, target)
    if preds.ndim != 4:
        raise ValueError(f"Expected `preds` and `target` to have BxCxHxW shape. But got {tuple(preds.shape)}.")
    if round(window_size / 2) >= preds.shape[2] or round(window_size / 2) >= preds.shape[3]:
        raise ValueError(
            f"Parameter `round(window_size / 2)` is expected to be smaller than"
            f" {min(preds.shape[2], preds.shape[3])} but got {round(window_size / 2)}."
        )
    err = scipy_uniform_filter((target.float() - preds.float()) ** 2, window_size)
    return torch.sqrt(err.clamp(min=0.0))


def root_mean_squared_error_using_sliding_window(
    preds: torch.Tensor, target: torch.Tensor, window_size: int = 8, return_rmse_map: bool = False
):
    """Sliding-window RMSE: the mean of the maps with ``round(window_size / 2)`` border rows and columns
    cropped; with ``return_rmse_map`` also the batch mean of the uncropped maps.

    >>> rng = np.random.RandomState(42)
    >>> preds = torch.from_numpy(rng.rand(2, 3, 16, 16).astype(np.float32))
    >>> round(float(root_mean_squared_error_using_sliding_window(preds, preds * 0.75)), 4)
    0.1427
    """
    rmse_map = _rmse_sw_maps(preds, target, window_size)
    crop = round(window_size / 2)
    rmse = rmse_map[..., crop:-crop, crop:-crop].mean()
    if return_rmse_map:
        return rmse, rmse_map.mean(0)
    return rmse


def relative_average_spectral_error(preds: torch.Tensor, target: torch.Tensor, window_size: int = 8) -> torch.Tensor:
    """RASE: the windowed RMSE and windowed target maps are averaged over the batch first, then one RASE map is
    formed and averaged inside the crop. The windowed target mean is divided by ``window_size**2`` a second
    time, as in the JAX package, which scales the result by ``window_size**2``.

    >>> rng = np.random.RandomState(42)
    >>> preds = torch.from_numpy(rng.rand(2, 3, 16, 16).astype(np.float32))
    >>> round(float(relative_average_spectral_error(preds, preds * 0.75)), 1)
    2484.2
    """
    rmse_map = _rmse_sw_maps(preds, target, window_size).mean(0)  # (C, H, W)
    target_mean = (scipy_uniform_filter(target.float(), window_size) / window_size**2).mean(0).mean(0)
    rase_map = 100.0 / target_mean * torch.sqrt(torch.mean(rmse_map**2, dim=0))
    crop = round(window_size / 2)
    return rase_map[crop:-crop, crop:-crop].mean()


# --------------------------------------------------------------------------- Total variation
def total_variation(img: torch.Tensor, reduction: Optional[str] = "sum") -> torch.Tensor:
    """Total variation of (B, C, H, W) images: the absolute differences of neighbouring pixels, summed per image.

    >>> rng = np.random.RandomState(42)
    >>> img = torch.from_numpy(rng.rand(2, 3, 16, 16).astype(np.float32))
    >>> float(total_variation(img)) > 0
    True
    """
    if img.ndim != 4:
        raise RuntimeError(f"Expected input `img` to be an 4D tensor, but got {tuple(img.shape)}")
    diff1 = img[..., 1:, :] - img[..., :-1, :]
    diff2 = img[..., :, 1:] - img[..., :, :-1]
    res1 = diff1.abs().reshape(img.shape[0], -1).sum(-1)
    res2 = diff2.abs().reshape(img.shape[0], -1).sum(-1)
    score = res1 + res2
    if reduction == "mean":
        return score.mean()
    return reduce(score, reduction)


# --------------------------------------------------------------------------- SCC
_LAPLACIAN = ((-1.0, -1.0, -1.0), (-1.0, 8.0, -1.0), (-1.0, -1.0, -1.0))


def spatial_correlation_coefficient(
    preds: torch.Tensor,
    target: torch.Tensor,
    hp_filter: Optional[torch.Tensor] = None,
    window_size: int = 8,
    reduction: Optional[str] = "elementwise_mean",
) -> torch.Tensor:
    """Spatial correlation coefficient: both images high-pass filtered (a true convolution over symmetric
    padding, times 2), then the Pearson correlation of the responses in every window, averaged.

    >>> rng = np.random.RandomState(42)
    >>> preds = torch.from_numpy(rng.rand(2, 3, 16, 16).astype(np.float32))
    >>> round(float(spatial_correlation_coefficient(preds, preds * 0.75)), 4)
    1.0
    """
    hp_filter = torch.tensor(_LAPLACIAN) if hp_filter is None else torch.as_tensor(hp_filter).float()
    if preds.ndim == 3:
        preds = preds[:, None]
        target = target[:, None]
    _check_same_shape(preds, target)
    if reduction is None:
        reduction = "none"
    if reduction not in ("mean", "none", "elementwise_mean"):
        raise ValueError(f"Expected reduction to be 'mean' or 'none', but got {reduction}")
    preds = preds.float()
    target = target.float()
    channel = preds.shape[1]
    kh, kw = hp_filter.shape
    hp_kernel = torch.flip(hp_filter, (0, 1)).expand(channel, 1, kh, kw)
    pads = [((kh - 1) // 2, kh // 2), ((kw - 1) // 2, kw // 2)]
    hp = depthwise_conv(_symmetric_pad(torch.cat((preds, target)), pads), hp_kernel) * 2.0
    hp_p, hp_t = hp.split(preds.shape[0])

    # the window statistics over zero-padded maps: ws // 2 before, (ws - 1) // 2 after
    stack = torch.cat((hp_p, hp_t, hp_p * hp_p, hp_t * hp_t, hp_p * hp_t))
    before, after = window_size // 2, (window_size - 1) // 2
    stack = torch.nn.functional.pad(stack, (before, after, before, after))
    taps = _uniform_taps_np(window_size)
    b = preds.shape[0]
    mu_p, mu_t, s_pp, s_tt, s_pt = windowed_sum_nchw(stack, [taps, taps]).split(b)
    var_p = (s_pp - mu_p**2).clamp(min=0.0)
    var_t = (s_tt - mu_t**2).clamp(min=0.0)
    cov = s_pt - mu_p * mu_t
    den = torch.sqrt(var_t) * torch.sqrt(var_p)
    scc_map = torch.where(den == 0, torch.zeros_like(den), cov / torch.where(den == 0, torch.ones_like(den), den))
    if reduction == "none":
        return scc_map.reshape(b, -1).mean(-1)
    return scc_map.mean()


# --------------------------------------------------------------------------- PSNR-B
def _blocking_effect_factor(img: torch.Tensor, block_size: int = 8) -> torch.Tensor:
    """Blocking effect factor of a (B, 1, H, W) batch: the squared differences across block boundaries and
    inside blocks are summed over the whole batch but divided by one image's counts (float division), as in
    the JAX package."""
    if img.shape[1] > 1:
        raise ValueError(f"`psnrb` metric expects grayscale images, but got images with {img.shape[1]} channels.")
    h, w = img.shape[-2:]
    h_b = np.arange(block_size - 1, w - 1, block_size)
    h_bc = np.setdiff1d(np.arange(w - 1), h_b)
    v_b = np.arange(block_size - 1, h - 1, block_size)
    v_bc = np.setdiff1d(np.arange(h - 1), v_b)

    def cols(idx):
        return torch.as_tensor(idx, dtype=torch.long, device=img.device)

    def across(dim, idx):
        return ((img.index_select(dim, cols(idx)) - img.index_select(dim, cols(idx + 1))) ** 2).sum()

    d_b = across(3, h_b) + across(2, v_b)
    d_bc = across(3, h_bc) + across(2, v_bc)
    n_hb = h * (w / block_size) - 1
    n_hbc = (h * (w - 1)) - n_hb
    n_vb = w * (h / block_size) - 1
    n_vbc = (w * (h - 1)) - n_vb
    d_b = d_b / (n_hb + n_vb)
    d_bc = d_bc / (n_hbc + n_vbc)
    t = float(np.log2(block_size) / np.log2(min(h, w)))
    return torch.where(d_b > d_bc, t * (d_b - d_bc), torch.zeros_like(d_b))


def peak_signal_noise_ratio_with_blocked_effect(
    preds: torch.Tensor, target: torch.Tensor, block_size: int = 8
) -> torch.Tensor:
    """PSNR-B of grayscale (B, 1, H, W) images: PSNR over the pooled batch with the blocking effect factor added
    to the MSE; the numerator is 1.0 when the target's range is at most 2.

    >>> rng = np.random.RandomState(42)
    >>> preds = torch.from_numpy(rng.rand(2, 1, 16, 16).astype(np.float32))
    >>> target = torch.from_numpy(rng.rand(2, 1, 16, 16).astype(np.float32))
    >>> float(peak_signal_noise_ratio_with_blocked_effect(preds, target)) > 0
    True
    """
    _check_same_shape(preds, target)
    preds = preds.float()
    target = target.float()
    data_range = target.max() - target.min()
    bef = _blocking_effect_factor(preds, block_size)
    mse_b = ((preds - target) ** 2).mean() + bef
    return torch.where(data_range > 2, 10 * torch.log10(data_range**2 / mse_b), 10 * torch.log10(1.0 / mse_b))


# --------------------------------------------------------------------------- VIF
def visual_information_fidelity(preds: torch.Tensor, target: torch.Tensor, sigma_n_sq: float = 2.0) -> torch.Tensor:
    """VIF-p in the pixel domain over four scales (gaussian windows of 17, 9, 5 and 3 taps, VALID); the images
    are averaged over their channels first.

    >>> rng = np.random.RandomState(42)
    >>> preds = torch.from_numpy(rng.rand(2, 1, 41, 41).astype(np.float32))
    >>> float(visual_information_fidelity(preds, preds.clone())) > 0.99
    True
    """
    if preds.shape[-2] < 41 or preds.shape[-1] < 41:
        raise ValueError(f"Invalid size of preds. Expected at least 41x41, but got {tuple(preds.shape[-2:])}!")
    _check_same_shape(preds, target)
    preds = preds.float().mean(dim=1, keepdim=True)  # luminance
    target = target.float().mean(dim=1, keepdim=True)
    eps = 1e-10
    b = preds.shape[0]
    preds_vif = torch.zeros(b, device=preds.device)
    target_vif = torch.zeros(b, device=preds.device)
    cur_p, cur_t = preds, target
    for scale in range(4):
        n = 2.0 ** (4 - scale) + 1
        taps = _gaussian_taps_np(int(n), n / 5.0)
        if scale > 0:
            low = windowed_sum_nchw(torch.cat((cur_p, cur_t)), [taps, taps])[..., ::2, ::2]
            cur_p, cur_t = low.split(b)
        stack = torch.cat((cur_t, cur_p, cur_t * cur_t, cur_p * cur_p, cur_t * cur_p))
        mu_t, mu_p, s_tt, s_pp, s_tp = windowed_sum_nchw(stack, [taps, taps]).split(b)
        sigma_t_sq = (s_tt - mu_t**2).clamp(min=0.0)
        sigma_p_sq = (s_pp - mu_p**2).clamp(min=0.0)
        sigma_tp = s_tp - mu_t * mu_p
        g = sigma_tp / (sigma_t_sq + eps)
        sv_sq = sigma_p_sq - g * sigma_tp
        zero = torch.zeros_like(g)
        g = torch.where(sigma_t_sq >= eps, g, zero)
        sv_sq = torch.where(sigma_t_sq >= eps, sv_sq, sigma_p_sq)
        sigma_t_sq = torch.where(sigma_t_sq >= eps, sigma_t_sq, zero)
        g = torch.where(sigma_p_sq >= eps, g, zero)
        sv_sq = torch.where(sigma_p_sq >= eps, sv_sq, zero)
        sv_sq = torch.where(g >= 0, sv_sq, sigma_p_sq)
        g = g.clamp(min=0.0)
        sv_sq = sv_sq.clamp(min=eps)
        preds_vif_scale = torch.log10(1.0 + (g**2) * sigma_t_sq / (sv_sq + sigma_n_sq))
        preds_vif = preds_vif + preds_vif_scale.reshape(b, -1).sum(-1)
        target_vif = target_vif + torch.log10(1.0 + sigma_t_sq / sigma_n_sq).reshape(b, -1).sum(-1)
    return (preds_vif / target_vif).mean()


# --------------------------------------------------------------------------- D_lambda / D_s / QNR
def _band_uqi_matrix(x: torch.Tensor) -> torch.Tensor:
    """(C, C) UQI between every pair of bands of (B, C, H, W): the upper triangle's pairs stacked along the
    batch into one UQI call (one window launch), each pair's value the mean of its maps; symmetric, 0 on the
    diagonal."""
    c = x.shape[1]
    i_idx, j_idx = torch.triu_indices(c, c, offset=1, device=x.device)
    lhs = x[:, i_idx].transpose(0, 1).reshape(-1, 1, *x.shape[2:])
    rhs = x[:, j_idx].transpose(0, 1).reshape(-1, 1, *x.shape[2:])
    maps = universal_image_quality_index(lhs, rhs, reduction="none")
    q = maps.reshape(len(i_idx), -1).mean(-1)  # the mean of each pair's (b, 1, h, w) maps
    mat = torch.zeros((c, c), device=x.device)
    mat[i_idx, j_idx] = q
    mat[j_idx, i_idx] = q
    return mat


def spectral_distortion_index(
    preds: torch.Tensor, target: torch.Tensor, p: int = 1, reduction: Optional[str] = "elementwise_mean"
) -> torch.Tensor:
    """Spectral distortion index D_lambda of a pan-sharpened (B, C, H, W) image against the low-resolution
    multispectral image (same B and C, any H and W): the p-mean of the differences of their band-pair UQIs.

    >>> rng = np.random.RandomState(42)
    >>> preds = torch.from_numpy(rng.rand(2, 3, 16, 16).astype(np.float32))
    >>> float(spectral_distortion_index(preds, preds.clone())) < 1e-4
    True
    """
    if not isinstance(p, int) or p <= 0:
        raise ValueError(f"Expected `p` to be a positive integer. Got p: {p}.")
    if preds.ndim != 4 or target.ndim != 4:
        raise ValueError(f"Expected `preds` and `target` to have BxCxHxW shape. Got preds: {tuple(preds.shape)}.")
    if preds.shape[:2] != target.shape[:2]:
        raise ValueError(
            "Expected `preds` and `target` to have the same batch and channel sizes."
            f" Got preds: {tuple(preds.shape)} and target: {tuple(target.shape)}."
        )
    c = preds.shape[1]
    if c == 1:
        q_fused = universal_image_quality_index(preds, preds)
        q_lr = universal_image_quality_index(target, target)
        out = torch.abs(q_fused - q_lr) ** (1.0 / p)
    else:
        diff = torch.abs(_band_uqi_matrix(preds) - _band_uqi_matrix(target)) ** p
        # the mean off the diagonal; the diagonal is 0
        out = (diff.sum() / (c * (c - 1))) ** (1.0 / p)
    return reduce(out, "elementwise_mean" if reduction in ("mean", "elementwise_mean") else reduction)


def _unpack_ms_pan(ms, pan, pan_lr):
    """The (ms, pan, pan_lr) of either signature: arrays, or a target dict ``{"ms", "pan"[, "pan_lr"]}``
    after which no positional argument is taken."""
    if isinstance(ms, dict):
        if "ms" not in ms or "pan" not in ms:
            raise ValueError("Expected `target` to be a dict with keys ('ms', 'pan').")
        if pan is not None or pan_lr is not None:
            raise ValueError(
                "When the target is a dict, pass norm_order/window_size as keyword arguments"
                " — positional arguments after the dict are not accepted."
            )
        return ms["ms"], ms["pan"], ms.get("pan_lr")
    if ms is None or pan is None:
        raise ValueError("Expected `ms` and `pan` inputs.")
    return ms, pan, pan_lr


def spatial_distortion_index(
    preds: torch.Tensor,
    ms=None,
    pan: Optional[torch.Tensor] = None,
    pan_lr: Optional[torch.Tensor] = None,
    norm_order: int = 1,
    window_size: int = 7,
    reduction: Optional[str] = "elementwise_mean",
) -> torch.Tensor:
    """Spatial distortion index D_s: per band, the difference of UQI(ms, pan_lr) and UQI(preds, pan). Without
    ``pan_lr``, pan is uniform-filtered and resized (antialiased bilinear) to the ms grid. Every band of one
    resolution goes through one UQI call.

    >>> rng = np.random.RandomState(42)
    >>> preds = torch.from_numpy(rng.rand(2, 3, 32, 32).astype(np.float32))
    >>> ms = torch.from_numpy(rng.rand(2, 3, 16, 16).astype(np.float32))
    >>> pan = torch.from_numpy(rng.rand(2, 3, 32, 32).astype(np.float32))
    >>> float(spatial_distortion_index(preds, ms, pan)) > 0
    True
    """
    ms, pan, pan_lr = _unpack_ms_pan(ms, pan, pan_lr)
    if not isinstance(norm_order, int) or norm_order <= 0:
        raise ValueError(f"Expected `norm_order` to be a positive integer. Got norm_order: {norm_order}.")
    for name, arr in (("ms", ms), ("pan", pan)) + ((("pan_lr", pan_lr),) if pan_lr is not None else ()):
        if arr.ndim != 4:
            raise ValueError(f"Expected `{name}` to have BxCxHxW shape. Got {name}: {tuple(arr.shape)}.")
        if preds.shape[:2] != arr.shape[:2]:
            raise ValueError(
                f"Expected `preds` and `{name}` to have the same batch and channel sizes."
                f" Got preds: {tuple(preds.shape)} and {name}: {tuple(arr.shape)}."
            )
    ms_h, ms_w = ms.shape[-2:]
    if window_size >= ms_h or window_size >= ms_w:
        raise ValueError(
            f"Expected `window_size` to be smaller than dimension of `ms`. Got window_size: {window_size}."
        )
    if pan_lr is None:
        pan_lr = resize_bilinear(scipy_uniform_filter(pan.float(), window_size), (ms_h, ms_w))
    q_lr = universal_image_quality_index(ms, pan_lr, reduction="none").mean((0, 2, 3))
    q_hr = universal_image_quality_index(preds, pan, reduction="none").mean((0, 2, 3))
    vals = torch.abs(q_lr - q_hr) ** norm_order
    return reduce(vals, reduction) ** (1.0 / norm_order)


def quality_with_no_reference(
    preds: torch.Tensor,
    ms=None,
    pan: Optional[torch.Tensor] = None,
    pan_lr: Optional[torch.Tensor] = None,
    alpha: float = 1.0,
    beta: float = 1.0,
    norm_order: int = 1,
    window_size: int = 7,
    reduction: Optional[str] = "elementwise_mean",
) -> torch.Tensor:
    """QNR: ``(1 - D_lambda)^alpha * (1 - D_s)^beta``, D_lambda against ms.

    >>> rng = np.random.RandomState(42)
    >>> preds = torch.from_numpy(rng.rand(2, 3, 32, 32).astype(np.float32))
    >>> ms = torch.from_numpy(rng.rand(2, 3, 16, 16).astype(np.float32))
    >>> pan = torch.from_numpy(rng.rand(2, 3, 32, 32).astype(np.float32))
    >>> float(quality_with_no_reference(preds, ms, pan)) < 1
    True
    """
    ms, pan, pan_lr = _unpack_ms_pan(ms, pan, pan_lr)
    d_lambda = spectral_distortion_index(preds, ms, p=norm_order, reduction=reduction)
    d_s = spatial_distortion_index(preds, ms, pan, pan_lr, norm_order, window_size, reduction)
    return (1 - d_lambda) ** alpha * (1 - d_s) ** beta


def image_gradients(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Finite-difference gradients ``(dy, dx)`` of (N, C, H, W) images, the last row or column 0.

    >>> image = torch.arange(25, dtype=torch.float32).reshape(1, 1, 5, 5)
    >>> dy, dx = image_gradients(image)
    >>> dy[0, 0, 0, :]
    tensor([5., 5., 5., 5., 5.])
    """
    img = torch.as_tensor(img)
    if img.ndim != 4:
        raise RuntimeError(f"The size of the image tensor {tuple(img.shape)} does not match (N, C, H, W)")
    dy = torch.nn.functional.pad(img[..., 1:, :] - img[..., :-1, :], (0, 0, 0, 1))
    dx = torch.nn.functional.pad(img[..., :, 1:] - img[..., :, :-1], (0, 1, 0, 0))
    return dy, dx
