"""InceptionV3, FID variant: the default backbone of FID, KID, IS and MiFID (counterpart of
``metrics_tpu/models/inception_v3.py``).

The published FID network (TF-slim InceptionV3 with the FID pooling quirks), as torch-fidelity defines it:

* every convolution is bias-free and followed by BatchNorm(eps=1e-3), run in eval mode, and ReLU;
* InceptionA/C and Mixed_7b average-pool 3×3 with the padding EXCLUDED from the divisor; Mixed_7c max-pools,
  the known quirk of the original FID weights;
* inputs are uint8-range images resized to 299×299 with ``F.interpolate(bilinear, align_corners=False,
  antialias=False)`` and scaled with the FID normalization ``(x - 128) / 128``.

Parameter names are torch-fidelity's (``Conv2d_1a_3x3.conv.weight``, ``Mixed_5b.branch1x1.bn.running_mean``,
``fc.weight``), so a torch-fidelity or pytorch-fid state dict loads through :func:`convert_torch_state_dict`,
which only drops the entries the FID forward does not use. The convolutions and pools are ``F.conv2d`` and
friends, run with TF32 off (:func:`~metrics_tpu_torch.models._backbone.exact_fp32`).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from metrics_tpu_torch.metric import resolve_device
from metrics_tpu_torch.models._backbone import (
    DeviceLike,
    as_state_dict,
    exact_fp32,
    seeded_init_,
    to_torch,
    to_torch_weight,
)

__all__ = [
    "InceptionV3FID",
    "convert_torch_state_dict",
    "from_flax_variables",
    "init_inception_params",
    "make_feature_extractor",
]

class _BatchNorm(nn.Module):
    """Eval-mode batch norm with torch-fidelity's parameter names and no ``num_batches_tracked``."""

    def __init__(self, channels: int, eps: float = 1e-3) -> None:
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, self.eps)


class BasicConv2d(nn.Module):
    """Conv (no bias) + BatchNorm(eps=1e-3) + ReLU."""

    def __init__(self, in_ch: int, out_ch: int, kernel: Any, stride: int = 1, padding: Any = 0) -> None:
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride=stride, padding=padding, bias=False)
        self.bn = _BatchNorm(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _avg_pool_nopad(x: torch.Tensor) -> torch.Tensor:
    """3×3 stride-1 average pool with the padding excluded from the divisor (the FID quirk)."""
    return F.avg_pool2d(x, kernel_size=3, stride=1, padding=1, count_include_pad=False)


class FIDInceptionA(nn.Module):
    def __init__(self, in_ch: int, pool_features: int) -> None:
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 64, 1)
        self.branch5x5_1 = BasicConv2d(in_ch, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(in_ch, pool_features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool_nopad(x))
        return torch.cat([b1, b5, b3, bp], 1)


class FIDInceptionB(nn.Module):
    def __init__(self, in_ch: int) -> None:
        super().__init__()
        self.branch3x3 = BasicConv2d(in_ch, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = F.max_pool2d(x, kernel_size=3, stride=2)
        return torch.cat([b3, bd, bp], 1)


class FIDInceptionC(nn.Module):
    def __init__(self, in_ch: int, channels_7x7: int) -> None:
        super().__init__()
        c7 = channels_7x7
        self.branch1x1 = BasicConv2d(in_ch, 192, 1)
        self.branch7x7_1 = BasicConv2d(in_ch, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(in_ch, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(in_ch, 192, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for layer in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4, self.branch7x7dbl_5):
            bd = layer(bd)
        bp = self.branch_pool(_avg_pool_nopad(x))
        return torch.cat([b1, b7, bd, bp], 1)


class FIDInceptionD(nn.Module):
    def __init__(self, in_ch: int) -> None:
        super().__init__()
        self.branch3x3_1 = BasicConv2d(in_ch, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(in_ch, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_4(self.branch7x7x3_3(self.branch7x7x3_2(self.branch7x7x3_1(x))))
        bp = F.max_pool2d(x, kernel_size=3, stride=2)
        return torch.cat([b3, b7, bp], 1)


class FIDInceptionE(nn.Module):
    """Mixed_7b (``pool="avg"``, padding-excluding) / Mixed_7c (``pool="max"``)."""

    def __init__(self, in_ch: int, pool: str = "avg") -> None:
        super().__init__()
        self.pool = pool
        self.branch1x1 = BasicConv2d(in_ch, 320, 1)
        self.branch3x3_1 = BasicConv2d(in_ch, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(in_ch, 192, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        if self.pool == "avg":
            bp = _avg_pool_nopad(x)
        else:
            bp = F.max_pool2d(x, kernel_size=3, stride=1, padding=1)
        bp = self.branch_pool(bp)
        return torch.cat([b1, b3, bd, bp], 1)


class InceptionV3FID(nn.Module):
    """Full FID InceptionV3; ``forward`` returns the requested feature taps.

    Taps (torch-fidelity names): ``64`` after the first max pool, ``192`` after the second, ``768`` after
    Mixed_6e (these three NCHW), ``2048`` after the global average pool, ``"logits_unbiased"`` the final fc
    without its bias and ``"logits"`` with it. Takes (N, 3, H, W) images in [0, 255] of any size.
    """

    def __init__(self, num_classes: int = 1008) -> None:
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = FIDInceptionA(192, 32)
        self.Mixed_5c = FIDInceptionA(256, 64)
        self.Mixed_5d = FIDInceptionA(288, 64)
        self.Mixed_6a = FIDInceptionB(288)
        self.Mixed_6b = FIDInceptionC(768, 128)
        self.Mixed_6c = FIDInceptionC(768, 160)
        self.Mixed_6d = FIDInceptionC(768, 160)
        self.Mixed_6e = FIDInceptionC(768, 192)
        self.Mixed_7a = FIDInceptionD(768)
        self.Mixed_7b = FIDInceptionE(1280, pool="avg")
        self.Mixed_7c = FIDInceptionE(2048, pool="max")
        self.fc = nn.Linear(2048, num_classes)
        self.eval()

    def forward(self, x: torch.Tensor, features: Sequence[Any] = (2048,)) -> Dict[Any, torch.Tensor]:
        x = F.interpolate(x.to(torch.float32), size=(299, 299), mode="bilinear", align_corners=False,
                          antialias=False)
        x = (x - 128.0) / 128.0
        out: Dict[Any, torch.Tensor] = {}
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, kernel_size=3, stride=2)
        if 64 in features:
            out[64] = x
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, kernel_size=3, stride=2)
        if 192 in features:
            out[192] = x
        for block in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d, self.Mixed_6a, self.Mixed_6b, self.Mixed_6c,
                      self.Mixed_6d, self.Mixed_6e):
            x = block(x)
        if 768 in features:
            out[768] = x
        x = self.Mixed_7c(self.Mixed_7b(self.Mixed_7a(x)))
        x = x.mean(dim=(2, 3))  # global average pool: (N, 2048)
        if 2048 in features:
            out[2048] = x
        if "logits_unbiased" in features or "logits" in features:
            unbiased = x @ self.fc.weight.T
            if "logits" in features:
                out["logits"] = unbiased + self.fc.bias
            if "logits_unbiased" in features:
                out["logits_unbiased"] = unbiased
        return out


StateLike = Union[nn.Module, Mapping[str, Any]]


def init_inception_params(rng_seed: int = 0, device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Random weights for offline testing (real ones come through :func:`convert_torch_state_dict`): a state
    dict drawn from ``torch.Generator().manual_seed(rng_seed)``, on ``device`` (the card unless named)."""
    model = seeded_init_(InceptionV3FID(), rng_seed)
    return {k: v.to(resolve_device(device)) for k, v in model.state_dict().items()}


def _module(variables: StateLike, device: DeviceLike) -> InceptionV3FID:
    if isinstance(variables, InceptionV3FID):
        return variables.eval()
    if device is None:
        first = next(iter(variables.values()), None)
        device = first.device if isinstance(first, torch.Tensor) else resolve_device(None)
    model = InceptionV3FID()
    model.load_state_dict(as_state_dict(variables))
    return model.to(device).eval()


def make_feature_extractor(variables: StateLike, feature: Any = 2048, device: DeviceLike = None):
    """A plain ``images (N, 3, H, W) → features`` function for one tap, on the module's device (a state dict's:
    the device its tensors are on). Spatial taps are average-pooled to (N, C), as torch-fidelity pools them."""
    model = _module(variables, device)
    dev = next(model.parameters()).device

    def extract(imgs: Any) -> torch.Tensor:
        imgs = torch.as_tensor(imgs)
        with torch.inference_mode(), exact_fp32():
            f = model(imgs.to(dev), features=(feature,))[feature]
            return f.mean(dim=(2, 3)) if f.ndim == 4 else f

    return extract


def convert_torch_state_dict(state_dict: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A torch-fidelity / pytorch-fid InceptionV3 state dict (tensors or numpy arrays) as this module's state
    dict: the names are the module's own, so only ``num_batches_tracked`` and the auxiliary-logits entries,
    which the FID forward never reads, are dropped."""
    wanted = set(InceptionV3FID().state_dict())
    return {k: v for k, v in as_state_dict(state_dict).items() if k in wanted}


def _walk(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def from_flax_variables(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's flax variables (``params`` + ``batch_stats``, as numpy) as this module's state dict:
    HWIO kernels become OIHW, the fc kernel (in, out) becomes ``fc.weight`` (out, in), BatchNorm ``scale`` /
    ``mean`` / ``var`` become ``weight`` / ``running_mean`` / ``running_var``."""
    out: Dict[str, torch.Tensor] = {}
    for path, v in _walk(variables["params"]):
        *mods, leaf = path
        name = ".".join(mods)
        if leaf == "kernel":
            out[f"{name}.weight"] = to_torch_weight(np.asarray(v))
        elif leaf == "scale":
            out[f"{name}.weight"] = to_torch(v)
        else:
            out[f"{name}.{leaf}"] = to_torch(v)
    for path, v in _walk(variables.get("batch_stats", {})):
        *mods, leaf = path
        out[".".join(mods) + (".running_mean" if leaf == "mean" else ".running_var")] = to_torch(v)
    return out
