"""Plain reference of the DIV2K evaluation: PSNR, SSIM and MS-SSIM of a pass of (SR, HR) frame pairs.

Written from the metrics' definitions in plain PyTorch, in the precision asked for (float64 for the
reference, bfloat16 for the control), one frame at a time, over the benchmark's own inputs. It
imports nothing of the program.

* PSNR, data range R: ``10 log10(R^2 / mse)`` with the mean squared error over every pixel of the pass.
* SSIM (Wang et al. 2004), window a k x k gaussian of ``sigma`` (the taps ``exp(-x^2 / 2 sigma^2)``
  normalised to sum 1), frames reflect-padded by (k - 1) / 2 (the edge not repeated), constants
  ``(0.01 R)^2`` and ``(0.03 R)^2``; a frame's SSIM is the mean of its map over every pixel; the pass
  reports the mean over frames.
* MS-SSIM (Wang et al. 2003), weights ``betas``: at each scale the SSIM map's contrast-structure term
  averaged over the pixels away from the padding, the last scale's full SSIM instead, each clamped
  at 0, raised to its weight and multiplied; between scales a 2 x 2 average pool that drops an odd
  last row or column. The pass reports the mean over frames.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F


def gaussian_taps(kernel: int, sigma: float, dtype: torch.dtype, device) -> torch.Tensor:
    x = torch.arange(kernel, dtype=torch.float64, device=device) - (kernel - 1) / 2
    g = torch.exp(-(x * x) / (2 * sigma * sigma))
    return (g / g.sum()).to(dtype)


def _window(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """VALID separable window sums over the last two dims."""
    k = taps.numel()
    h = x.shape[-2] - k + 1
    v = sum(taps[i] * x[..., i:i + h, :] for i in range(k))
    w = x.shape[-1] - k + 1
    return sum(taps[i] * v[..., :, i:i + w] for i in range(k))


def ssim_terms(x: torch.Tensor, y: torch.Tensor, taps: torch.Tensor, data_range: float):
    """(mean SSIM over the map, mean contrast-structure term away from the padding) of one (C, H, W) pair,
    in the pair's type."""
    pad = (taps.numel() - 1) // 2
    xp = F.pad(x[None], [pad] * 4, mode="reflect")[0]
    yp = F.pad(y[None], [pad] * 4, mode="reflect")[0]
    mu_x, mu_y = _window(xp, taps), _window(yp, taps)
    s_xx, s_yy, s_xy = _window(xp * xp, taps), _window(yp * yp, taps), _window(xp * yp, taps)
    var_x = (s_xx - mu_x * mu_x).clamp(min=0)
    var_y = (s_yy - mu_y * mu_y).clamp(min=0)
    cov = s_xy - mu_x * mu_y
    c1, c2 = (0.01 * data_range) ** 2, (0.03 * data_range) ** 2
    cs_map = (2 * cov + c2) / (var_x + var_y + c2)
    ssim_map = (2 * mu_x * mu_y + c1) / (mu_x * mu_x + mu_y * mu_y + c1) * cs_map
    return ssim_map.mean(), cs_map[..., pad:-pad, pad:-pad].mean()


def _pool2(x: torch.Tensor) -> torch.Tensor:
    c, h, w = x.shape
    return x[:, : h // 2 * 2, : w // 2 * 2].reshape(c, h // 2, 2, w // 2, 2).mean(dim=(2, 4))


def evaluate(preds: torch.Tensor, target: torch.Tensor, data_range: float, kernel: int, sigma: float,
             betas: Sequence[float], dtype: torch.dtype = torch.float64) -> Dict[str, object]:
    """``{"values": {"psnr", "ssim", "ms_ssim"}, "counts": None}`` of the (N, C, H, W) pairs."""
    taps = gaussian_taps(kernel, sigma, dtype, preds.device)
    w = torch.tensor(list(betas), dtype=dtype, device=preds.device)
    sse = torch.zeros((), dtype=dtype, device=preds.device)
    ssim_sum = torch.zeros((), dtype=dtype, device=preds.device)
    ms_sum = torch.zeros((), dtype=dtype, device=preds.device)
    for x, y in zip(preds, target):
        xs, ys = x.to(dtype), y.to(dtype)
        sse = sse + ((xs - ys) ** 2).sum()
        terms = []
        for i in range(len(betas)):
            sim_i, cs_i = ssim_terms(xs, ys, taps, data_range)
            if i == 0:
                ssim_sum = ssim_sum + sim_i
            terms.append(sim_i if i == len(betas) - 1 else cs_i)
            xs, ys = _pool2(xs), _pool2(ys)
        ms_sum = ms_sum + torch.prod(torch.stack(terms).clamp(min=0) ** w)
    n = preds.shape[0]
    mse = sse / preds[0].numel() / n
    psnr = 10 * torch.log10(torch.tensor(data_range * data_range, dtype=dtype, device=preds.device) / mse)
    return {"values": {"psnr": float(psnr), "ssim": float(ssim_sum / n), "ms_ssim": float(ms_sum / n)},
            "counts": None}
