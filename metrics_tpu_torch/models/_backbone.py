"""What every backbone of ``models/`` shares: exact float32 forwards, seeded initialization, weight loading.

PyTorch lets cuDNN convolutions (and, where enabled, matmuls) run in TF32 on an Ampere or newer card, which
leaves float32 parity with the CPU by about 1e-3. :func:`exact_fp32` turns TF32 off for the span of one
backbone forward and restores the caller's settings after it; nothing is changed globally.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, Mapping, Optional, Union

import numpy as np
import torch
from torch import nn

DeviceLike = Optional[Union[str, torch.device]]


@contextlib.contextmanager
def exact_fp32() -> Iterator[None]:
    """TF32 off for cuDNN convolutions and CUDA matmuls inside the block; the previous flags after it."""
    conv, matmul = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = conv, matmul


def seeded_init_(module: nn.Module, rng_seed: int) -> nn.Module:
    """Random weights from one ``torch.Generator``: He-normal convolution and linear weights (so activations
    keep their scale through ReLU stacks), zero biases, identity batch-norm statistics. Parameters are drawn
    on the CPU in ``named_parameters`` order, so a seed gives the same weights on every device."""
    gen = torch.Generator().manual_seed(int(rng_seed))
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if p.ndim >= 2:
                fan_in = int(np.prod(p.shape[1:]))
                p.copy_(torch.randn(p.shape, generator=gen) * math.sqrt(2.0 / fan_in))
            elif leaf == "weight":  # a batch-norm scale
                p.fill_(1.0)
            else:
                p.zero_()
        for name, b in module.named_buffers():
            b.fill_(1.0 if name.endswith("running_var") else 0.0)
    return module


def as_state_dict(state: Mapping[str, object]) -> Dict[str, torch.Tensor]:
    """``{name: tensor or array}`` as float32 CPU tensors (a ``torch.load`` result or numpy arrays)."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in state.items():
        t = v.detach().cpu() if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))
        out[k] = t.to(torch.float32)
    return out


def to_torch_weight(kernel: np.ndarray) -> torch.Tensor:
    """A flax kernel in torch's layout: HWIO convolution kernels become OIHW, (in, out) dense kernels (out, in)."""
    a = np.asarray(kernel, dtype=np.float32)
    a = np.transpose(a, (3, 2, 0, 1)) if a.ndim == 4 else a.T
    return torch.from_numpy(np.ascontiguousarray(a))


def to_torch(v: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(v, dtype=np.float32))
