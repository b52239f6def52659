"""Peak signal-to-noise ratio (counterpart of ``metrics_tpu/functional/image/psnr.py``)."""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch

from metrics_tpu_torch.functional.image._helpers import reduce
from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.compute import count_dtype
from metrics_tpu_torch.utils.prints import rank_zero_warn


def _psnr_compute(
    sum_squared_error: torch.Tensor,
    num_obs: torch.Tensor,
    data_range: torch.Tensor,
    base: float = 10.0,
    reduction: Optional[str] = "elementwise_mean",
) -> torch.Tensor:
    """PSNR from the summed squared error and the count of observations, in float32."""
    psnr_base_e = 2 * torch.log(data_range) - torch.log(sum_squared_error / num_obs)
    psnr_vals = psnr_base_e * (10 / math.log(base))
    return reduce(psnr_vals, reduction)


def _psnr_update(
    preds: torch.Tensor,
    target: torch.Tensor,
    dim: Optional[Union[int, Tuple[int, ...]]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The summed squared error and the count of observations (``count_dtype()``, so that a running total
    does not wrap at 2^31), over everything or over ``dim``."""
    _check_same_shape(preds, target)
    preds = preds.float()
    target = target.float()
    if dim is None:
        sum_squared_error = torch.sum((preds - target) ** 2)
        return sum_squared_error, torch.tensor(target.numel(), dtype=count_dtype(), device=target.device)
    diff = preds - target
    sum_squared_error = torch.sum(diff * diff, dim=dim)
    num = 1
    for d in [dim] if isinstance(dim, int) else list(dim):
        num *= preds.shape[d]
    return sum_squared_error, torch.tensor(num, dtype=count_dtype(), device=target.device)


def peak_signal_noise_ratio(
    preds: torch.Tensor,
    target: torch.Tensor,
    data_range: Optional[Union[float, Tuple[float, float]]] = None,
    base: float = 10.0,
    reduction: Optional[str] = "elementwise_mean",
    dim: Optional[Union[int, Tuple[int, ...]]] = None,
) -> torch.Tensor:
    """PSNR of ``preds`` against ``target``, computed on their device.

    ``data_range`` is the span of the values: taken from both inputs when None, or a (min, max) pair to which
    both are clamped first.

    >>> pred = torch.tensor([[0.0, 1.0], [2.0, 3.0]])
    >>> target = torch.tensor([[3.0, 2.0], [1.0, 0.0]])
    >>> peak_signal_noise_ratio(pred, target)
    tensor(2.5527)
    """
    if dim is None and reduction != "elementwise_mean":
        rank_zero_warn(f"The `reduction={reduction}` will not have any effect when `dim` is None.")
    if data_range is None:
        if dim is not None:
            raise ValueError("The `data_range` must be given when `dim` is not None.")
        data_range_t = torch.maximum(target.max(), preds.max()) - torch.minimum(target.min(), preds.min())
        data_range_t = data_range_t.float()
    elif isinstance(data_range, tuple):
        preds = preds.clamp(data_range[0], data_range[1])
        target = target.clamp(data_range[0], data_range[1])
        data_range_t = torch.tensor(data_range[1] - data_range[0], dtype=torch.float32, device=preds.device)
    else:
        data_range_t = torch.tensor(float(data_range), dtype=torch.float32, device=preds.device)
    sum_squared_error, num_obs = _psnr_update(preds, target, dim=dim)
    return _psnr_compute(sum_squared_error, num_obs, data_range_t, base=base, reduction=reduction)
