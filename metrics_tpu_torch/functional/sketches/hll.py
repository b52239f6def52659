"""HyperLogLog distinct counting on 32-bit hashes (counterpart of ``metrics_tpu/functional/sketches/hll.py``).

Each hash splits into a ``p``-bit register index and a ``32 - p`` bit suffix
whose leading-zero rank the register keeps as a running maximum. The update
returns a register delta (a batch folded into all-zero registers) that the
metric folds with ``torch.maximum``. Registers are int32 ranks, equal to the
JAX package's bit for bit.
"""

from __future__ import annotations

import math

import torch

from metrics_tpu_torch.functional.sketches.hashing import hash32
from metrics_tpu_torch.ops.decay import _exp2_f32

__all__ = ["hll_delta", "hll_estimate", "hll_std_error"]


def hll_std_error(p: int) -> float:
    """Theoretical standard error of the estimate: 1.04/√(2^p)."""
    return 1.04 / math.sqrt(float(1 << p))


def _clz32(word: torch.Tensor) -> torch.Tensor:
    """Leading zeros of int64 words in ``[0, 2^32)`` as 32-bit words (32 for 0), exactly: a word below 2^32 is
    exact in float64, and ``frexp`` gives ``word = m * 2^e`` with ``m`` in [0.5, 1), so ``clz = 32 - e``."""
    _, exponent = torch.frexp(word.to(torch.float64))
    return 32 - exponent.to(torch.int64)


def hll_delta(values: torch.Tensor, valid: torch.Tensor, *, p: int, seed: int = 0) -> torch.Tensor:
    """One batch folded into a fresh (2^p,) int32 register array.

    Invalid rows (masked, or non-finite floats) contribute rank 0, the
    register identity under max. ``p`` must be in [4, 16].
    """
    if not 4 <= p <= 16:
        raise ValueError(f"`p` must be in [4, 16], got {p}")
    m = 1 << p
    v = torch.as_tensor(values).reshape(-1)
    ok = torch.as_tensor(valid, dtype=torch.bool, device=v.device).reshape(-1)
    if v.is_floating_point():
        ok = ok & torch.isfinite(v)
    h = hash32(v, seed)
    idx = h >> (32 - p)
    suffix = (h << p) & 0xFFFFFFFF  # suffix bits left-aligned; low p bits zero
    rank = torch.clamp(_clz32(suffix) + 1, max=32 - p + 1)
    rank = torch.where(ok, rank, 0).to(torch.int32)
    return torch.zeros(m, dtype=torch.int32, device=v.device).scatter_reduce_(0, idx, rank, "amax")


def hll_estimate(registers: torch.Tensor) -> torch.Tensor:
    """Cardinality estimate from a register array; () float32.

    The raw harmonic-mean estimate with linear counting while it is small and
    empty registers remain, and the 32-bit collision correction near 2^32.
    ``2^-r`` is computed as the JAX package's CPU backend computes float32
    ``exp2``; the sums run in another order, so the estimate agrees to
    rounding.
    """
    m = registers.shape[0]
    alpha_m = {16: 0.673, 32: 0.697, 64: 0.709}.get(m, 0.7213 / (1.0 + 1.079 / m))
    regs = registers.to(torch.float32)
    raw = alpha_m * m * m / torch.sum(_exp2_f32(-regs))
    zeros = torch.sum(registers == 0).to(torch.float32)
    linear = m * torch.log(m / torch.clamp(zeros, min=1.0))
    est = torch.where((raw <= 2.5 * m) & (zeros > 0), linear, raw)
    two32 = 4294967296.0
    large = -two32 * torch.log(torch.clamp(1.0 - est / two32, min=1e-12))
    return torch.where(est > two32 / 30.0, large, est)
