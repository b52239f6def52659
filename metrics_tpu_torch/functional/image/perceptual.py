"""Functional LPIPS / PerceptualPathLength entry points (counterpart of
``metrics_tpu/functional/image/perceptual.py``).

Imports are deferred so that ``metrics_tpu_torch.functional.image`` stays free of a cycle with
``metrics_tpu_torch.image``.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from metrics_tpu_torch.utils.checks import _is_traced

__all__ = ["learned_perceptual_image_patch_similarity", "perceptual_path_length"]


def learned_perceptual_image_patch_similarity(
    img1: torch.Tensor,
    img2: torch.Tensor,
    net_type: str = "alex",
    reduction: str = "mean",
    normalize: bool = False,
) -> torch.Tensor:
    """LPIPS between two image batches with the named backbone from local weights, on the images' device.

    ``reduction``: 'mean' or 'sum' over the batch.
    """
    if net_type not in ("alex", "vgg", "squeeze"):
        raise ValueError(f"Argument `net_type` must be one of 'alex', 'vgg', 'squeeze', but got {net_type}")
    if reduction not in ("mean", "sum"):
        raise ValueError(f"Argument `reduction` must be one of 'sum' or 'mean' but got {reduction}")
    img1, img2 = torch.as_tensor(img1), torch.as_tensor(img2)
    _validate_lpips_images(img1, img2, normalize)
    from metrics_tpu_torch.models.hub import load_lpips

    d = load_lpips(net_type, device=img1.device)(img1, img2, normalize)
    return d.mean() if reduction == "mean" else d.sum()


def _validate_lpips_images(img1: torch.Tensor, img2: torch.Tensor, normalize: bool) -> None:
    """(N, 3, H, W) inputs in [0, 1] when ``normalize`` else [-1, 1] (one host read of each batch's range).

    Traced inputs (under ``vmap`` or a fake-tensor trace) are held to the shape check only: their values cannot
    be read on the host, as in the JAX package."""

    def bounds(img: torch.Tensor) -> Tuple[float, float]:
        lo, hi = torch.aminmax(img)
        return float(lo), float(hi)

    def ok(img: torch.Tensor) -> bool:
        if img.ndim != 4 or img.shape[1] != 3:
            return False
        if _is_traced(img):
            return True
        lo, hi = bounds(img)
        return (hi <= 1.0 and lo >= 0.0) if normalize else lo >= -1.0

    if not (ok(img1) and ok(img2)):
        ranges = ""
        if img1.numel() and img2.numel() and not _is_traced(img1, img2):
            ranges = f" and values in range {list(bounds(img1))} and {list(bounds(img2))}"
        raise ValueError(
            "Expected both input arguments to be normalized tensors with shape [N, 3, H, W]."
            f" Got input with shape {tuple(img1.shape)} and {tuple(img2.shape)}{ranges}"
            f" when all values are expected to be in the {[0, 1] if normalize else [-1, 1]} range."
        )


def perceptual_path_length(
    generator: Any,
    num_samples: int = 10_000,
    conditional: bool = False,
    batch_size: int = 64,
    interpolation_method: str = "lerp",
    epsilon: float = 1e-4,
    resize: Optional[int] = 64,
    lower_discard: Optional[float] = 0.01,
    upper_discard: Optional[float] = 0.99,
    sim_net: Optional[Callable] = None,
    seed: int = 0,
) -> tuple:
    """Perceptual path length of a generator: see :func:`metrics_tpu_torch.image.lpips.perceptual_path_length`."""
    from metrics_tpu_torch.image.lpips import perceptual_path_length as _ppl

    return _ppl(
        generator,
        num_samples=num_samples,
        conditional=conditional,
        batch_size=batch_size,
        interpolation_method=interpolation_method,
        epsilon=epsilon,
        resize=resize,
        lower_discard=lower_discard,
        upper_discard=upper_discard,
        sim_net=sim_net,
        seed=seed,
    )
