"""DDSketch streaming quantiles: fixed-shape log-γ bucket histograms.

Counterpart of ``metrics_tpu/functional/sketches/ddsketch.py``. |v| is
bucketed by ``key = ceil(log_γ |v|)`` with ``γ = (1+α)/(1−α)``, clamped into a
fixed window of ``num_buckets`` keys from ``key_offset``; the representative
``2·γ^k/(γ+1)`` of the bucket holding the q-th rank is within relative error α
of every value inside it. The state is three count histograms (positive,
negative, zero), merged by ``+``.

The key is ``ceil(log|v| * fl(1/ln γ))``: the product with the float32
reciprocal is how XLA compiles the JAX package's update. Its ``log`` is
XLA's float32 polynomial, which differs from ``torch.log`` by an ulp on some
inputs; the keys agree except where ``log|v| / ln γ`` lies within an ulp of
an integer, that is for values within about an ulp of a bucket edge ``γ^k``.
Such a value moves to the next bucket, whose representative is still within
α of it.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple

import numpy as np
import torch

from metrics_tpu_torch.functional.image._helpers import _exp32
from metrics_tpu_torch.utils.compute import _flush_subnormals, count_dtype
from metrics_tpu_torch.utils.data import bincount_fixed

__all__ = ["ddsketch_delta", "ddsketch_gamma", "ddsketch_quantiles"]


def ddsketch_gamma(alpha: float) -> float:
    """Bucket growth factor for relative accuracy ``alpha``."""
    if not 0.0 < alpha < 1.0:
        raise ValueError(f"`alpha` must be in (0, 1), got {alpha}")
    return (1.0 + alpha) / (1.0 - alpha)


def ddsketch_delta(
    values: torch.Tensor,
    valid: torch.Tensor,
    *,
    alpha: float,
    key_offset: int,
    num_buckets: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One batch bucketed into count deltas ``(pos, neg, zero)``.

    ``pos``/``neg`` are (num_buckets,) histograms of the keys clamped into
    ``[key_offset, key_offset + num_buckets)``, ``zero`` the () count of exact
    zeros, all ``count_dtype()``. Non-finite and masked values count nowhere.
    Both histograms come from one count over ``2 * num_buckets + 1`` bins, and
    nothing is read back from the device.
    """
    inv_ln_gamma = float(np.float32(1.0) / np.float32(math.log(ddsketch_gamma(alpha))))
    v = _flush_subnormals(values.to(torch.float32).reshape(-1))  # a subnormal counts as a zero, as in the JAX package
    ok = torch.as_tensor(valid, dtype=torch.bool, device=v.device).reshape(-1) & torch.isfinite(v)
    mag = torch.abs(v)
    # guard log(0): the argument only matters where mag > 0
    key = torch.ceil(torch.log(torch.where(mag > 0, mag, torch.ones_like(mag))) * inv_ln_gamma)
    idx = torch.clamp(torch.nan_to_num(key, nan=0.0) - key_offset, 0, num_buckets - 1).to(torch.int64)
    code = torch.where(ok & (v > 0), idx, torch.where(ok & (v < 0), num_buckets + idx, 2 * num_buckets))
    counts = bincount_fixed(code, 2 * num_buckets + 1)
    zero = torch.sum(ok & (v == 0)).to(count_dtype())
    return counts[:num_buckets], counts[num_buckets : 2 * num_buckets], zero


@functools.lru_cache(maxsize=64)
def _representatives(alpha: float, key_offset: int, num_buckets: int) -> np.ndarray:
    """``2·γ^k/(γ+1)`` for the window's keys in float32, with the JAX package's float32 operations and its CPU
    backend's ``exp``; they depend on the configuration only."""
    gamma = ddsketch_gamma(alpha)
    keys = np.arange(num_buckets, dtype=np.float32) + np.float32(key_offset)
    power = _exp32((keys * np.float32(math.log(gamma))).astype(np.float32))
    return ((np.float32(2.0) * power) / np.float32(gamma + 1.0)).astype(np.float32)


def ddsketch_quantiles(
    pos: torch.Tensor,
    neg: torch.Tensor,
    zero: torch.Tensor,
    quantiles: Sequence[float],
    *,
    alpha: float,
    key_offset: int,
) -> torch.Tensor:
    """Quantile estimates from the three count states; (len(quantiles),) float32.

    Buckets lie on the line as ``[−rep(B−1) … −rep(0), 0, rep(0) … rep(B−1)]``;
    the q-th estimate is the representative of the first bucket whose
    cumulative count exceeds ``q·(n−1)``. An empty sketch gives 0.0. The
    running count is exact (int64, or float64 for fractional counts) and is
    rounded once to float32, where the JAX package's float32 running sum is
    exact below 2^24.
    """
    num_buckets = pos.shape[0]
    device = pos.device
    rep = torch.tensor(_representatives(float(alpha), int(key_offset), num_buckets), device=device)
    line = torch.cat([-rep.flip(0), torch.zeros(1, dtype=torch.float32, device=device), rep])
    counts = torch.cat([neg.flip(0), zero.reshape(1), pos])
    wide = torch.float64 if counts.is_floating_point() else torch.int64
    cum = torch.cumsum(counts.to(wide), 0).to(torch.float32)
    n = cum[-1]
    q = torch.tensor([float(x) for x in quantiles], dtype=torch.float32, device=device)
    rank = q * torch.clamp(n - 1.0, min=0.0)
    bucket = torch.searchsorted(cum, rank, right=True)
    out = line[torch.clamp(bucket, 0, line.shape[0] - 1)]
    return torch.where(n > 0, out, torch.zeros_like(out))
