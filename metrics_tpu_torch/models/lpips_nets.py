"""VGG16 / AlexNet / SqueezeNet-1.1 feature towers and the LPIPS linear heads (counterpart of
``metrics_tpu/models/lpips_nets.py``).

The towers are torchvision's ``features`` trunks with torchvision's own layer indices, so a torchvision state
dict (``features.<idx>.weight``, ``features.<idx>.<squeeze|expand1x1|expand3x3>.weight`` for SqueezeNet) loads
as it is; the heads read the LPIPS layout (``lin<i>.model.1.weight``, (1, C, 1, 1)). Each tower returns the
canonical LPIPS taps, NCHW.

LPIPS pipeline (as published): shift and scale the input by fixed constants, run the tower, unit-normalize
each tap across channels, square the difference, apply the 1×1 head (non-negative weights), average
spatially, sum the taps. The two image batches go through the tower as one batch, with TF32 off.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Sequence, Tuple

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
    "AlexNetFeatures",
    "SqueezeNetFeatures",
    "VGG16Features",
    "build_lpips",
    "convert_torch_backbone",
    "convert_torch_lin",
    "from_flax_variables",
    "init_lpips",
    "lpips_score",
]

# fixed input normalization constants of the published LPIPS implementation
_SHIFT = np.asarray([-0.030, -0.088, -0.188], dtype=np.float32)
_SCALE = np.asarray([0.458, 0.448, 0.450], dtype=np.float32)

VGG16_TAPS = (64, 128, 256, 512, 512)
ALEX_TAPS = (64, 192, 384, 256, 256)
SQUEEZE_TAPS = (64, 128, 256, 384, 384, 512, 512)


class _Tower(nn.Module):
    """A torchvision ``features`` Sequential plus the indices whose outputs are the LPIPS taps."""

    taps_after: Tuple[int, ...] = ()

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        taps: List[torch.Tensor] = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in self.taps_after:
                taps.append(x)
        return taps


class VGG16Features(_Tower):
    """torchvision VGG16 ``features`` trunk, taps after relu1_2, relu2_2, relu3_3, relu4_3 and relu5_3."""

    taps_after = (3, 8, 15, 22, 29)

    def __init__(self) -> None:
        super().__init__()
        layers: List[nn.Module] = []
        ch = 3
        for item in (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512):
            if item == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(ch, item, 3, padding=1), nn.ReLU()]
                ch = item
        self.features = nn.Sequential(*layers)


class AlexNetFeatures(_Tower):
    """torchvision AlexNet ``features`` trunk, taps after each of its five ReLUs."""

    taps_after = (1, 4, 7, 9, 11)

    def __init__(self) -> None:
        super().__init__()
        self.features = nn.Sequential(
            nn.Conv2d(3, 64, 11, stride=4, padding=2), nn.ReLU(), nn.MaxPool2d(3, 2),
            nn.Conv2d(64, 192, 5, padding=2), nn.ReLU(), nn.MaxPool2d(3, 2),
            nn.Conv2d(192, 384, 3, padding=1), nn.ReLU(),
            nn.Conv2d(384, 256, 3, padding=1), nn.ReLU(),
            nn.Conv2d(256, 256, 3, padding=1), nn.ReLU(),
        )


class _Fire(nn.Module):
    """SqueezeNet fire module: 1×1 squeeze, ReLU, then (1×1 ∥ 3×3) expand, ReLU."""

    def __init__(self, in_ch: int, squeeze: int, expand: int) -> None:
        super().__init__()
        self.squeeze = nn.Conv2d(in_ch, squeeze, 1)
        self.expand1x1 = nn.Conv2d(squeeze, expand, 1)
        self.expand3x3 = nn.Conv2d(squeeze, expand, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.squeeze(x))
        return torch.cat([F.relu(self.expand1x1(x)), F.relu(self.expand3x3(x))], 1)


class SqueezeNetFeatures(_Tower):
    """torchvision SqueezeNet-1.1 ``features`` trunk (its pools in ceil mode) with the 7 LPIPS taps."""

    taps_after = (1, 4, 7, 9, 10, 11, 12)

    def __init__(self) -> None:
        super().__init__()
        self.features = nn.Sequential(
            nn.Conv2d(3, 64, 3, stride=2), nn.ReLU(), nn.MaxPool2d(3, 2, ceil_mode=True),
            _Fire(64, 16, 64), _Fire(128, 16, 64), nn.MaxPool2d(3, 2, ceil_mode=True),
            _Fire(128, 32, 128), _Fire(256, 32, 128), nn.MaxPool2d(3, 2, ceil_mode=True),
            _Fire(256, 48, 192), _Fire(384, 48, 192), _Fire(384, 64, 256), _Fire(512, 64, 256),
        )


_TAPS = {"vgg": VGG16_TAPS, "alex": ALEX_TAPS, "squeeze": SQUEEZE_TAPS}


def _net_for(net_type: str) -> _Tower:
    if net_type == "vgg":
        return VGG16Features()
    if net_type == "squeeze":
        return SqueezeNetFeatures()
    return AlexNetFeatures()


def _unit_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return x / (torch.sqrt(torch.sum(x * x, dim=1, keepdim=True)) + eps)


def lpips_score(
    net_apply: Callable[[torch.Tensor], List[torch.Tensor]],
    lin_weights: Sequence[torch.Tensor],
    img1: torch.Tensor,
    img2: torch.Tensor,
    normalize: bool = False,
) -> torch.Tensor:
    """Per-pair LPIPS distance from a tower and its heads.

    ``img*``: (N, 3, H, W); [-1, 1] by default, [0, 1] with ``normalize=True``. ``lin_weights[i]``: (C_i,)
    non-negative 1×1 head of tap i. Both batches go through ``net_apply`` as one batch of 2N.
    """
    if normalize:
        img1 = 2 * img1 - 1
        img2 = 2 * img2 - 1
    shift = torch.as_tensor(_SHIFT, device=img1.device).view(1, 3, 1, 1)
    scale = torch.as_tensor(_SCALE, device=img1.device).view(1, 3, 1, 1)
    n = img1.shape[0]
    feats = net_apply((torch.cat([img1, img2], 0) - shift) / scale)
    total = None
    for f, w in zip(feats, lin_weights):
        diff = (_unit_normalize(f[:n]) - _unit_normalize(f[n:])) ** 2
        layer = (diff * w.reshape(1, -1, 1, 1)).sum(1).mean(dim=(1, 2))  # 1×1 conv, no bias; spatial mean
        total = layer if total is None else total + layer
    return total


def _tower(net_type: str, variables: Mapping[str, Any], device: DeviceLike) -> _Tower:
    if isinstance(variables, _Tower):
        return variables.eval()
    net = _net_for(net_type)
    net.load_state_dict(convert_torch_backbone(variables, net_type))
    return net.to(resolve_device(device)).eval()


def build_lpips(
    net_type: str, variables: Any, lin_weights: Sequence[Any], device: DeviceLike = None
) -> Callable:
    """``(img1, img2, normalize=False) → (N,)`` distances for a tower (a module or its state dict) and its
    heads, on ``device`` (the card unless named; a module stays where it is)."""
    net = _tower(net_type, variables, device)
    dev = next(net.parameters()).device
    lin = [torch.as_tensor(np.asarray(w.detach().cpu() if isinstance(w, torch.Tensor) else w),
                           dtype=torch.float32).to(dev) for w in lin_weights]

    def score(img1: Any, img2: Any, normalize: bool = False) -> torch.Tensor:
        with torch.inference_mode(), exact_fp32():
            return lpips_score(net, lin, torch.as_tensor(img1).to(dev), torch.as_tensor(img2).to(dev), normalize)

    return score


def init_lpips(net_type: str, rng_seed: int = 0, device: DeviceLike = None) -> Tuple[Dict[str, torch.Tensor],
                                                                                     List[torch.Tensor]]:
    """Random tower weights from ``torch.Generator().manual_seed(rng_seed)`` and uniform heads (offline
    testing; real weights come through the converters), on ``device`` (the card unless named)."""
    dev = resolve_device(device)
    net = seeded_init_(_net_for(net_type), rng_seed)
    lin = [torch.ones(c, device=dev) / c for c in _TAPS.get(net_type, ALEX_TAPS)]
    return {k: v.to(dev) for k, v in net.state_dict().items()}, lin


def convert_torch_backbone(state_dict: Mapping[str, Any], net_type: str) -> Dict[str, torch.Tensor]:
    """A torchvision ``features.*`` state dict (with or without the ``features.`` prefix, tensors or numpy) as
    the tower's state dict: the names are torchvision's own, so only the classifier's entries are dropped."""
    wanted = set(_net_for(net_type).state_dict())
    out: Dict[str, torch.Tensor] = {}
    for k, v in as_state_dict(state_dict).items():
        name = k if k.startswith("features.") else f"features.{k}"
        if name in wanted:
            out[name] = v
    return out


def convert_torch_lin(state_dict: Mapping[str, Any]) -> List[torch.Tensor]:
    """The LPIPS head state dict (``lin<i>.model.1.weight``, (1, C, 1, 1)) as a list of (C,) tensors."""
    sd = as_state_dict(state_dict)
    n = len([k for k in sd if ".weight" in k])
    return [next(v for k, v in sd.items() if k.startswith(f"lin{i}.") and k.endswith("weight")).reshape(-1)
            for i in range(n)]


def from_flax_variables(variables: Mapping[str, Any], net_type: str) -> Dict[str, torch.Tensor]:
    """The JAX package's flax tower variables (as numpy) as the tower's state dict: ``conv_<idx>`` and
    ``fire_<idx>/<sub>`` become torchvision's ``features.<idx>[.<sub>]``, HWIO kernels OIHW."""
    out: Dict[str, torch.Tensor] = {}
    for mod, leaves in variables["params"].items():
        idx = mod.split("_", 1)[1]
        subs = leaves.items() if "kernel" not in leaves else [("", leaves)]
        for sub, p in subs:
            name = f"features.{idx}" + (f".{sub}" if sub else "")
            out[f"{name}.weight"] = to_torch_weight(np.asarray(p["kernel"]))
            out[f"{name}.bias"] = to_torch(p["bias"])
    return out
