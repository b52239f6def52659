"""Builder of the DIV2K super-resolution evaluation: frame pairs from the seed, the port's collection,
and its reference.

The frames follow the port's smoke script (``div2k_pair``), copied here so that a change to the
program cannot move the yardstick, and drawn for the whole pass in one set of calls.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from benchlib.cells import load_module


def div2k_pairs(g: torch.Generator, n: int, channels: int, h: int, w: int, device: torch.device):
    """(super-resolved, high-resolution) pairs of (n, C, h, w) float32 images in [0, 1]: a smooth image
    (bilinear upsampling of h/16 x w/16 noise, plus fine grain) and the same image with the error of a
    reconstruction."""
    coarse = torch.rand((n, channels, h // 16, w // 16), generator=g, device=device)
    target = F.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=False)
    del coarse
    target.add_(0.03 * torch.randn(target.shape, generator=g, device=device)).clamp_(0, 1)
    preds = (target + 0.04 * torch.randn(target.shape, generator=g, device=device)).clamp_(0, 1)
    return preds, target


def make_data(config: Dict[str, Any], seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    preds, target = div2k_pairs(g, config["units_per_pass"], config["channels"], config["height"],
                                config["width"], device)
    return {"preds": preds, "target": target}


def restrict(data: Dict[str, torch.Tensor], start: int, stop: int) -> Dict[str, torch.Tensor]:
    return {k: v[start:stop].clone() for k, v in data.items()}


def take(data: Dict[str, torch.Tensor], start: int, stop: int) -> Tuple[torch.Tensor, torch.Tensor]:
    return data["preds"][start:stop], data["target"][start:stop]


def data_bytes(data: Dict[str, torch.Tensor]) -> int:
    return sum(v.numel() * v.element_size() for v in data.values())


def make_collection(config: Dict[str, Any], mix: Dict[str, Any], device: torch.device):
    from metrics_tpu_torch import MetricCollection
    from metrics_tpu_torch.image import (
        MultiScaleStructuralSimilarityIndexMeasure,
        PeakSignalNoiseRatio,
        StructuralSimilarityIndexMeasure,
    )

    r, k, s = config["data_range"], config["gaussian_kernel"], config["gaussian_sigma"]
    return MetricCollection({
        "psnr": PeakSignalNoiseRatio(data_range=r, device=device),
        "ssim": StructuralSimilarityIndexMeasure(data_range=r, kernel_size=k, sigma=s, device=device),
        "ms_ssim": MultiScaleStructuralSimilarityIndexMeasure(
            data_range=r, kernel_size=k, sigma=s, betas=tuple(config["ms_ssim_betas"]), device=device),
    })


def read_values(result: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v) for k, v in result.items()}


def pass_state(collection, mix: Dict[str, Any]) -> Optional[torch.Tensor]:
    return None


def path(mix: Dict[str, Any]) -> str:
    return "frames"


def reference(config: Dict[str, Any], mix: Dict[str, Any], data: Dict[str, torch.Tensor],
              dtype: torch.dtype = torch.float64) -> Dict[str, Any]:
    evaluate = load_module(Path(__file__).with_name("div2k_sr_eval_reference.py")).evaluate
    return evaluate(data["preds"], data["target"], config["data_range"], config["gaussian_kernel"],
                    config["gaussian_sigma"], config["ms_ssim_betas"], dtype)
