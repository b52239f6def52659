"""Image-metric helpers (counterpart of ``metrics_tpu/functional/image/_helpers.py``).

Every gaussian or uniform window is an outer product of two 1-D windows, so the
metrics send it through :func:`metrics_tpu_torch.ops.ssim_window.windowed_sum_nchw`:
the window kernel on the card, its shifted-slice plain version on the CPU. The
JAX package convolves with the dense 2-D kernel instead; the two differ only in
rounding. :func:`depthwise_conv` is for the filters that are not separable (SCC's
high-pass filter).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# the shifted-slice cascade is the plain version of the SSIM window kernel, so it lives beside it
from metrics_tpu_torch.ops.ssim_window import separable_depthwise_conv, windowed_sum_nchw  # noqa: F401

# Cephes' polynomial for exp(r), |r| <= ln(2) / 2, as XLA's CPU backend evaluates float32 exp
_EXP_POLY = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)


def reduce(x: torch.Tensor, reduction: Optional[str] = "elementwise_mean") -> torch.Tensor:
    """Reduce a tensor of per-sample values."""
    if reduction == "elementwise_mean":
        return x.mean()
    if reduction == "sum":
        return x.sum()
    if reduction is None or reduction == "none":
        return x
    raise ValueError("Reduction parameter unknown.")


def _fma32(a: np.ndarray, b, c) -> np.ndarray:
    """float32 ``a * b + c`` rounded once (the product of two float32 values is exact in float64)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64) + np.asarray(c, np.float64)).astype(np.float32)


def _exp32(x: np.ndarray) -> np.ndarray:
    """float32 exp as the JAX package's CPU backend computes it: Cephes' range reduction and polynomial with
    fused multiply-adds, subnormal results flushed to 0. numpy's and torch's exp differ from it by an ulp on
    some inputs, and the windows' taps are held equal to the JAX package's."""
    x = np.clip(np.asarray(x, np.float32), np.float32(-104.0), np.float32(88.8))
    n = np.clip(np.floor(_fma32(x, np.float32(1.44269504088896341), np.float32(0.5))), -127, 127).astype(np.float32)
    r = _fma32(n, np.float32(-0.693359375), x)
    r = _fma32(n, np.float32(2.12194440e-4), r)
    z = _fma32(r, np.float32(_EXP_POLY[0]), np.float32(_EXP_POLY[1]))
    for c in _EXP_POLY[2:]:
        z = _fma32(z, r, np.float32(c))
    z = (np.float32(1.0) + _fma32(z, r * r, r)).astype(np.float32)
    out = (z * np.ldexp(np.float32(1.0), n.astype(np.int32))).astype(np.float32)
    return np.where(out < np.finfo(np.float32).tiny, np.float32(0.0), out)


def _gaussian_taps_np(kernel_size: int, sigma: float) -> np.ndarray:
    """1-D gaussian taps in float32, computed on the host with the JAX package's formula and its CPU backend's
    float32 operations (a sequential sum, as its reduction over up to 32 values), so that the taps are equal to
    its ``_gaussian``."""
    dist = np.arange((1 - kernel_size) / 2, (1 + kernel_size) / 2, 1.0, dtype=np.float32)
    gauss = _exp32(-(dist * dist) / np.float32(2 * sigma**2))
    total = np.float32(0.0)
    for v in gauss:
        total = np.float32(total + v)
    return (gauss / total).astype(np.float32)


def _gaussian(kernel_size: int, sigma: float) -> torch.Tensor:
    """1-D gaussian kernel of shape (1, kernel_size), float32 on the CPU."""
    return torch.from_numpy(_gaussian_taps_np(kernel_size, sigma))[None, :]


def _gaussian_kernel_2d(channel: int, kernel_size: Sequence[int], sigma: Sequence[float]) -> torch.Tensor:
    """The dense depthwise gaussian kernel (channel, 1, kh, kw) that the JAX package convolves with; the port
    applies its two 1-D factors instead."""
    g1 = _gaussian(kernel_size[0], sigma[0])
    g2 = _gaussian(kernel_size[1], sigma[1])
    return (g1.T @ g2).expand(channel, 1, kernel_size[0], kernel_size[1])


def _uniform_kernel(channel: int, kernel_size: Sequence[int]) -> torch.Tensor:
    """The dense depthwise uniform kernel (channel, 1, *kernel_size), float32."""
    return torch.ones((channel, 1, *kernel_size)) / float(np.prod(kernel_size))


def _uniform_taps_np(window_size: int) -> np.ndarray:
    """1-D uniform taps, ``1 / window_size`` in float32."""
    return np.ones(window_size, dtype=np.float32) / np.float32(window_size)


def _reflect_pad(x: torch.Tensor, pads: Sequence[int]) -> torch.Tensor:
    """Reflect-pad the two or three trailing spatial dims (edge not repeated, as ``numpy.pad(mode="reflect")``);
    one pad per dim."""
    pad_arg = []
    for p in reversed(pads):  # F.pad lists the last dim first
        pad_arg += [p, p]
    return F.pad(x, pad_arg, mode="reflect")


def _symmetric_pad(x: torch.Tensor, pads: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Pad the trailing spatial dims by (before, after) each, repeating the edge (``numpy.pad(mode="symmetric")``),
    through a gather of mirrored indices."""
    for d, (before, after) in enumerate(pads):
        dim = x.ndim - len(pads) + d
        n = x.shape[dim]
        idx = torch.arange(-before, n + after, device=x.device) % (2 * n)
        idx = torch.where(idx >= n, 2 * n - 1 - idx, idx)
        x = x.index_select(dim, idx)
    return x


def depthwise_conv(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Depthwise VALID correlation of (B, C, *spatial) with a dense (C, 1, *window) kernel, as a sum of
    shifted slices in float32 on the input's device, taps in row-major order. For filters that are not outer
    products of 1-D windows; no TF32 rounding, as a cuDNN convolution would take by default."""
    window = kernel.shape[2:]
    out_shape = [s - k + 1 for s, k in zip(x.shape[2:], window)]
    kernel = kernel.to(device=x.device, dtype=x.dtype)
    out = None
    for offset in np.ndindex(*window):
        part = x
        for d, (o, n) in enumerate(zip(offset, out_shape)):
            part = part.narrow(2 + d, o, n)
        term = part * kernel[(slice(None), 0, *offset)].reshape(1, -1, *([1] * len(window)))
        out = term if out is None else out + term
    return out


def scipy_uniform_filter(x: torch.Tensor, window_size: int) -> torch.Tensor:
    """Same-size mean filter of (B, C, H, W) with scipy-style asymmetric reflect padding (``ws // 2`` mirrored
    rows before, ``ws // 2 + ws % 2 - 1`` after, the edge repeated), then a VALID uniform window through
    :func:`windowed_sum_nchw`: one window-kernel launch on the card."""
    pad, outer = window_size // 2, window_size % 2
    x = _symmetric_pad(x, [(pad, pad + outer - 1)] * 2)
    taps = _uniform_taps_np(window_size)
    return windowed_sum_nchw(x, [taps, taps])


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Half-pixel-centers bilinear resize of (B, C, H, W) to ``size``, antialiased when it shrinks, as the JAX
    package's ``jax.image.resize(method="linear")`` is (its docstring says ``antialias=False``; its code
    antialiases)."""
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False, antialias=True)


def avg_pool2d(x: torch.Tensor, kernel: int = 2) -> torch.Tensor:
    """Average pool of (B, C, H, W) with stride = kernel, VALID: an odd last row or column is dropped (MS-SSIM's
    downsampling)."""
    return F.avg_pool2d(x, kernel)
