"""Image-metric helpers (counterpart of ``metrics_tpu/functional/image/_helpers.py``)."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

# the shifted-slice cascade is the plain version of the SSIM window kernel, so it lives beside it
from metrics_tpu_torch.ops.ssim_window import separable_depthwise_conv  # noqa: F401


def reduce(x: torch.Tensor, reduction: Optional[str] = "elementwise_mean") -> torch.Tensor:
    """Reduce a tensor of per-sample values."""
    if reduction == "elementwise_mean":
        return x.mean()
    if reduction == "sum":
        return x.sum()
    if reduction is None or reduction == "none":
        return x
    raise ValueError("Reduction parameter unknown.")


def _reflect_pad(x: torch.Tensor, pads: Sequence[int]) -> torch.Tensor:
    """Reflect-pad the two or three trailing spatial dims (edge not repeated, as ``numpy.pad(mode="reflect")``);
    one pad per dim."""
    pad_arg = []
    for p in reversed(pads):  # F.pad lists the last dim first
        pad_arg += [p, p]
    return F.pad(x, pad_arg, mode="reflect")


def avg_pool2d(x: torch.Tensor, kernel: int = 2) -> torch.Tensor:
    """Average pool of (B, C, H, W) with stride = kernel, VALID: an odd last row or column is dropped (MS-SSIM's
    downsampling)."""
    return F.avg_pool2d(x, kernel)
