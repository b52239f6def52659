"""A small feature extractor (counterpart of ``metrics_tpu/models/simple_cnn.py``).

Stands in for a downloaded backbone so that the FID/KID/IS/LPIPS injection path runs end to end offline.
The convolutions pad as flax's ``"SAME"`` does (the larger half of an odd total at the end).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from metrics_tpu_torch.metric import resolve_device
from metrics_tpu_torch.models._backbone import DeviceLike, exact_fp32, seeded_init_, to_torch, to_torch_weight

__all__ = ["SimpleFeatureCNN", "from_flax_variables"]


def _same_pad(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    pads = []
    for size in (x.shape[3], x.shape[2]):  # F.pad takes the last dimension first
        total = max((-(-size // s) - 1) * s + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class SimpleFeatureCNN(nn.Module):
    """Tiny conv tower producing (N, features) embeddings from NCHW images."""

    def __init__(self, features: int = 64, widths: Sequence[int] = (16, 32)) -> None:
        super().__init__()
        chans = [3] + list(widths)
        self.convs = nn.ModuleList(nn.Conv2d(a, b, 3, stride=2) for a, b in zip(chans[:-1], chans[1:]))
        self.dense = nn.Linear(chans[-1], features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv in self.convs:
            x = F.relu(conv(_same_pad(x, 3, 2)))
        return self.dense(x.mean(dim=(2, 3)))

    def bind_apply(self, rng_seed: int = 0, device: DeviceLike = None) -> Callable:
        """Initialize from ``torch.Generator().manual_seed(rng_seed)`` on ``device`` (the card unless named) and
        return a plain ``images → features`` function."""
        seeded_init_(self, rng_seed)
        dev = resolve_device(device)
        self.to(dev).eval()

        def apply(imgs: Any) -> torch.Tensor:
            with torch.inference_mode(), exact_fp32():
                return self(torch.as_tensor(imgs).to(dev, torch.float32))

        return apply


def from_flax_variables(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's flax variables (``Conv_<i>``, ``Dense_0``; as numpy) as this module's state dict."""
    out: Dict[str, torch.Tensor] = {}
    for mod, p in variables["params"].items():
        name = "dense" if mod.startswith("Dense") else f"convs.{mod.split('_')[1]}"
        out[f"{name}.weight"] = to_torch_weight(np.asarray(p["kernel"]))
        out[f"{name}.bias"] = to_torch(p["bias"])
    return out
