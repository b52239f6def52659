"""Separable windowed sum over image planes: the CUDA kernel behind 2-D SSIM.

Counterpart of ``metrics_tpu/ops/ssim_window.py``. :func:`ssim_window` maps
(N, H + Kh - 1, W + Kw - 1) float32 planes to (N, H, W): ``Kh`` vertical taps,
then ``Kw`` horizontal taps, VALID. On a CUDA tensor it launches the kernel of
``csrc/ssim_window.cu``; on a CPU tensor it runs :func:`ssim_window_plain`, the
shifted-slice cascade, which is also the kernel's oracle.

It is also the ``torch.library`` custom op ``metrics_tpu_torch::ssim_window``
with a ``vmap`` rule, which the wrapper calls when its planes are batched by
``torch.func.vmap`` (an SSIM bucket of the fleet engine): (R, P, H, W) planes
become the (R·P, H, W) planes of one call, so a bucket launches the kernel
once, and each plane is windowed on its own, as in R calls. An unbatched call
skips the op and runs the same eager body directly, so that SSIM as a loss on
the CPU keeps the plain version's gradient: the op has no autograd formula.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Iterator, List, Sequence

import torch

from metrics_tpu_torch.ops import _native
from metrics_tpu_torch.utils.checks import _is_traced

__all__ = ["separable_depthwise_conv", "ssim_window", "ssim_window_plain", "windowed_sum_nchw"]


def _shifted_sum_1d(x: torch.Tensor, k1: torch.Tensor, axis: int) -> torch.Tensor:
    """VALID 1-D correlation along ``axis`` as a sum of shifted slices, taps in order."""
    n = x.shape[axis] - k1.shape[-1] + 1
    out = None
    for i in range(k1.shape[-1]):
        term = x.narrow(axis, i, n) * k1[i]
        out = term if out is None else out + term
    return out


def separable_depthwise_conv(x: torch.Tensor, kernels_1d: Sequence[torch.Tensor]) -> torch.Tensor:
    """Depthwise VALID window with an outer-product kernel, as one 1-D pass per spatial dim.

    ``x`` is (B, C, *spatial) and ``kernels_1d`` holds one 1-D kernel per
    spatial dim (the shifted-slice cascade of ``functional/image/_helpers.py``
    in the JAX package).
    """
    for d, k1 in enumerate(kernels_1d):
        x = _shifted_sum_1d(x, k1, 2 + d)
    return x


def ssim_window_plain(x: torch.Tensor, kh: Sequence[float], kw: Sequence[float]) -> torch.Tensor:
    """The plain PyTorch version: the vertical, then the horizontal shifted-slice sum."""
    taps = [torch.tensor(k, dtype=torch.float32, device=x.device) for k in (kh, kw)]
    return separable_depthwise_conv(x.unsqueeze(1), taps).squeeze(1)


def _library() -> ctypes.CDLL:
    lib = _native.load("ssim_window")
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.ssim_window_launch.argtypes = [p, p, ctypes.c_longlong, i, i, p, i, p, i, p]
    lib.ssim_window_launch.restype = ctypes.c_int
    lib.ssim_window_max_taps.restype = ctypes.c_int
    return lib


def _ssim_window_eager(x: torch.Tensor, kh: Sequence[float], kw: Sequence[float]) -> torch.Tensor:
    if x.device.type == "cpu":
        return ssim_window_plain(x, kh, kw)
    if x.device.type != "cuda":
        raise ValueError(f"ssim_window runs on CUDA or CPU tensors, got {x.device}")
    if x.dtype != torch.float32 or x.ndim != 3 or not x.is_contiguous():
        raise ValueError(f"ssim_window expects contiguous (N, H, W) float32 planes, got {x.dtype} {tuple(x.shape)}")
    lib = _library()
    n, hp, wp = x.shape
    kh, kw = [float(v) for v in kh], [float(v) for v in kw]
    if not (1 <= len(kh) <= lib.ssim_window_max_taps() and 1 <= len(kw) <= lib.ssim_window_max_taps()):
        raise ValueError(f"ssim_window takes 1 to {lib.ssim_window_max_taps()} taps per axis, got {len(kh)}, {len(kw)}")
    if hp < len(kh) or wp < len(kw):
        raise ValueError(f"ssim_window cannot window planes of shape {tuple(x.shape)} with {len(kh)}x{len(kw)} taps")
    taps_v = (ctypes.c_float * len(kh))(*kh)
    taps_h = (ctypes.c_float * len(kw))(*kw)
    with torch.cuda.device(x.device):
        out = torch.empty((n, hp - len(kh) + 1, wp - len(kw) + 1), dtype=torch.float32, device=x.device)
        rc = lib.ssim_window_launch(
            x.data_ptr(), out.data_ptr(), n, hp, wp, taps_v, len(kh), taps_h, len(kw),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _native.check(lib, rc, "ssim_window kernel")
    ssim_window.launches += 1
    return out


@torch.library.custom_op("metrics_tpu_torch::ssim_window", mutates_args=())
def _ssim_window_op(x: torch.Tensor, kh: List[float], kw: List[float]) -> torch.Tensor:
    return _ssim_window_eager(x, kh, kw)


@_ssim_window_op.register_vmap
def _ssim_window_vmap(info, in_dims, x, kh, kw):
    x = x.movedim(in_dims[0], 0) if in_dims[0] is not None else x.expand(info.batch_size, *x.shape)
    rows, planes = x.shape[0], x.shape[1]
    out = _ssim_window_op(x.reshape(rows * planes, *x.shape[2:]).contiguous(), kh, kw)
    return out.reshape(rows, planes, *out.shape[1:]), 0


_THROUGH_OP = [0]


@contextlib.contextmanager
def through_custom_op() -> Iterator[None]:
    """Eager calls go through the custom op inside the block too, so that a dispatch mode (a cost count,
    ``observe/costs.py``) sees the kernel as one op on either device; the op has no autograd formula."""
    _THROUGH_OP[0] += 1
    try:
        yield
    finally:
        _THROUGH_OP[0] -= 1


def ssim_window(x: torch.Tensor, kh: Sequence[float], kw: Sequence[float]) -> torch.Tensor:
    """Windowed sum of (N, H_pad, W_pad) float32 planes: the kernel on CUDA, the plain version on the CPU.

    Under ``torch.func.vmap`` (or :func:`through_custom_op`) it calls the custom op, whose rule makes one call
    of the batch's planes.
    """
    if _is_traced(x) or _THROUGH_OP[0]:
        return _ssim_window_op(x, [float(v) for v in kh], [float(v) for v in kw])
    return _ssim_window_eager(x, kh, kw)


ssim_window.launches = 0


def windowed_sum_nchw(x: torch.Tensor, kernels_1d: Sequence[Sequence[float]]) -> torch.Tensor:
    """(B, C, H_pad, W_pad) to (B, C, H, W) through :func:`ssim_window`."""
    b, c, h_pad, w_pad = x.shape
    out = ssim_window(x.reshape(b * c, h_pad, w_pad), kernels_1d[0], kernels_1d[1])
    return out.reshape(b, c, out.shape[1], out.shape[2])
